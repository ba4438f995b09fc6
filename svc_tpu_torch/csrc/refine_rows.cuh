// The SAD arithmetic of the lane-per-anchor-row refine kernels: K3's
// specialised kernel (refine_sads.cu, window rows loaded from dense planes
// in global memory; also K7's, refine_mads.cu, and K9's at 4x4 and 8x8
// blocks, candidate_sads.cu) and the K8 refine (refine_sads_pitched.cu,
// window rows read from a band of column-pitched subplanes staged in
// shared memory).
// Each kernel gets its window rows its own way; from the rows on both run
// this code, so both give the same bits.
//
// A CTA of kThreads lanes handles kThreads / BH MV blocks of one block row
// (BW x BH blocks, BW columns and BH rows, each 4, 8, 16 or 32; search
// radius R = 1 to 4, and 5 to 8 at 32 x 32, 16 x 16, 8 x 8 and 4 x 4, a
// candidate row at a time; the K8 refine 16 x 16 at R = 1); lane i of a
// block owns
// anchor row i (BW / 4 words). A window row is Window<BW, R>::kWords words
// from the window's first byte (ox = 0) on; it needs BW + 2R of those
// bytes.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCand = 9;  // (2r + 1)^2 at r = 1: the K8 refine, block_sads
constexpr unsigned kFull = 0xffffffffu;

// The word counts of a window row of BW-column blocks at radius R, and the
// window rows a lane of a BH-row block holds. A row is fetched from a base
// aligned to kGrain bytes (BW, 16 at most: the widest load a lane issues)
// as kChunks aligned chunks of kGrain bytes and kExtra words.
template <int BW, int R, int BH = BW>
struct Window {
  static constexpr int kGrain = BW < 16 ? BW : 16;  // bytes of an aligned chunk
  static constexpr int kChunks = BW / kGrain + 1;   // chunks a row spans
  static constexpr int kExtra = (2 * R + 3) / 4;  // words past the BW / 4 of a block
  static constexpr int kWords = BW / 4 + kExtra;  // a row from its first byte
  static constexpr int kFetch = kChunks * kGrain / 4 + kExtra;  // from an aligned base
  // window rows a lane holds at R >= 2 (rows i, i + BH, ...)
  static constexpr int kSlots = 1 + (2 * R + BH - 1) / BH;
  static constexpr int kCand = (2 * R + 1) * (2 * R + 1);
  static constexpr int kPacked = (kCand + 1) / 2;  // two 16-bit sums a word
};

// al: the kWords words of a row from byte s on (0 <= s < kGrain), given w,
// the kFetch words of the row from an aligned base. v[j] = w[s / 4 + j] by
// selects (register arrays take no runtime index; kGrain / 4 - 1 a word, so
// 32-column blocks at a 16-byte grain take 3, not 7), then a funnel shift
// by s % 4 bytes.
template <int BW, int R = 1>
__device__ __forceinline__ void align_window_row(const uint32_t (&w)[Window<BW, R>::kFetch],
                                                 int s,
                                                 uint32_t (&al)[Window<BW, R>::kWords]) {
  constexpr int kG = Window<BW, R>::kGrain / 4;
  constexpr int kWords = Window<BW, R>::kWords;
  const int q = s >> 2;
  uint32_t v[kWords + 1];
#pragma unroll
  for (int j = 0; j < kWords + 1; ++j) {
    uint32_t r = w[j];
#pragma unroll
    for (int t = 1; t < kG; ++t) r = q == t ? w[t + j] : r;
    v[j] = r;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) al[j] = __funnelshift_r(v[j], v[j + 1], 8 * (s & 3));
}

// Adds one window row's share of the three candidates ox = 0, 1, 2 to
// acc[0..2]; al holds the row from its first byte on.
template <int BW>
__device__ __forceinline__ void sad_row(const uint32_t (&al)[BW / 4 + 1],
                                        const uint32_t (&a)[BW / 4],
                                        uint32_t* acc) {
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
#pragma unroll
    for (int j = 0; j < BW / 4; ++j) {
      const uint32_t c = ox == 0 ? al[j] : __funnelshift_r(al[j], al[j + 1], 8 * ox);
      acc[ox] = __vsadu4(c, a[j]) + acc[ox];
    }
  }
}

// The 9 SADs of each MV block of the CTA into s_out[c][blk]. r0: lane i's
// window row at oy = 0 (window row i); ext: window row i + 2 on lanes BH - 2
// and BH - 1 (unused elsewhere). The block's lanes share the window's first
// column, so their rows are aligned alike: the rows of oy = 1, 2 come from
// the next lanes by shuffles, and the sums reduce over the block's BH lanes
// by log2(BH) xor shuffles. Every lane of the warp calls it (full-mask
// shuffles).
template <int BW, int BH = BW>
__device__ __forceinline__ void block_sads(const uint32_t (&r0)[BW / 4 + 1],
                                           const uint32_t (&ext)[BW / 4 + 1],
                                           const uint32_t (&a)[BW / 4], unsigned i,
                                           unsigned blk,
                                           int32_t (*s_out)[kThreads / BH]) {
  constexpr int kWords = BW / 4 + 1;
  uint32_t r1[kWords], r2[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t down1 = __shfl_down_sync(kFull, r0[k], 1, BH);
    const uint32_t down2 = __shfl_down_sync(kFull, r0[k], 2, BH);
    const uint32_t up1 = __shfl_up_sync(kFull, ext[k], 1, BH);
    r1[k] = i == BH - 1 ? up1 : down1;
    r2[k] = i >= BH - 2 ? ext[k] : down2;
  }

  uint32_t acc[kCand];
#pragma unroll
  for (int c = 0; c < kCand; ++c) acc[c] = 0;
  sad_row<BW>(r0, a, acc);
  sad_row<BW>(r1, a, acc + 3);
  sad_row<BW>(r2, a, acc + 6);

#pragma unroll
  for (int c = 0; c < kCand; ++c) {
#pragma unroll
    for (int off = BH / 2; off > 0; off >>= 1) {
      acc[c] += __shfl_xor_sync(kFull, acc[c], off, BH);
    }
    if (i == static_cast<unsigned>(c % BH)) s_out[c][blk] = static_cast<int32_t>(acc[c]);
  }
}

// One transposed xor step over lane offset H of a group of L lanes, then
// the steps below it down to offset Lo + 1 (Lo = 0: every step): of each
// pair (v[k], v[k + M]), M = ceil(N / 2), a lane keeps the one its bit H
// picks and adds its partner's, so every step halves what a lane holds
// (N + N / 2 + ... shuffles where plain xor steps take N log2(L)). A single
// value takes plain xor steps.
template <int N, int H, int L, int Lo = 0>
__device__ __forceinline__ void reduce_transposed(uint32_t* v, unsigned i) {
  if constexpr (H > Lo) {
    constexpr int M = (N + 1) / 2;
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(kFull, v[0], H, L);
    } else {
      const bool upper = i & H;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const uint32_t lo = v[k];
        const uint32_t hi = k + M < N ? v[k + M] : 0u;
        v[k] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, H, L);
      }
    }
    reduce_transposed<M, H / 2, L, Lo>(v, i);
  }
}

// How many values a lane holds after reduce_transposed<N, H, L, Lo>.
template <int N, int H, int Lo = 0>
__host__ __device__ constexpr int reduced_count() {
  if constexpr (H <= Lo || N == 1) {
    return N;
  } else {
    return reduced_count<(N + 1) / 2, H / 2, Lo>();
  }
}

// The index (into the N values) whose group sum lane i holds in v[k] after
// reduce_transposed<N, H, L, Lo>, or -1 where it holds none (a pad, or the
// upper lane of a plain xor step, whose copy the lower lane keeps).
template <int N, int H, int Lo = 0>
__device__ __forceinline__ int reduced_index(int k, unsigned i) {
  if constexpr (H <= Lo) {
    return k < N ? k : -1;
  } else if constexpr (N == 1) {
    return (i & H) ? -1 : reduced_index<1, H / 2, Lo>(k, i);
  } else {
    constexpr int M = (N + 1) / 2;
    const int inner = reduced_index<M, H / 2, Lo>(k, i);
    const int idx = inner + ((i & H) ? M : 0);
    return inner >= 0 && idx < N ? idx : -1;
  }
}

// Lane i's N words of 16-bit sums (candidates 2p and 2p + 1 in word p)
// reduced over its group of L lanes, each candidate's block sum handed
// once to `put(c, sum)` (c < kCount) on one lane. A lane's sums cover
// kPixels pixels (its anchor rows' bytes); a pair stays packed while its
// sums cover at most 256 of them (255 x 256 < 2^16): over the steps at
// lane offsets L / 2 down to Lo + 1, Lo = L / (2 * 256 / kPixels). Past
// that (a 32-column block reaches 255 x 1024 on 32 lanes, 32 x 16 and 16 x
// 32 blocks 255 x 512) the words a lane still holds unpack into 32-bit
// sums for the steps at offsets Lo down to 1. Lo = 0 keeps every step
// packed.
template <int N, int L, int kPixels, int kCount, class Put>
__device__ __forceinline__ void reduce_pairs(uint32_t (&packed)[N], unsigned i, Put put) {
  static_assert(kPixels <= 256, "a lane's sums must fit 16 bits");
  constexpr int Lo = L / (2 * (256 / kPixels));
  reduce_transposed<N, L / 2, L, Lo>(packed, i);
  constexpr int kHeld = reduced_count<N, L / 2, Lo>();
  if constexpr (Lo == 0) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const int p = reduced_index<N, L / 2>(k, i);
      if (p >= 0) {
        put(2 * p, packed[k] & 0xffffu);
        if (2 * p + 1 < kCount) put(2 * p + 1, packed[k] >> 16);
      }
    }
  } else {
    uint32_t v[2 * kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      v[2 * k] = packed[k] & 0xffffu;
      v[2 * k + 1] = packed[k] >> 16;
    }
    reduce_transposed<2 * kHeld, Lo, L>(v, i);
    constexpr int kLeft = reduced_count<2 * kHeld, Lo>();
#pragma unroll
    for (int k = 0; k < kLeft; ++k) {
      // value q of the unpacked words: half q % 2 of the lane's word q / 2,
      // which held pair p after the packed steps (the packed steps' lane
      // bits lie above Lo, so the lanes of a 32-bit step agree on p)
      const int q = reduced_index<2 * kHeld, Lo>(k, i);
      const int p = q >= 0 ? reduced_index<N, L / 2, Lo>(q >> 1, i) : -1;
      const int c = 2 * p + (q & 1);
      if (p >= 0 && c < kCount) put(c, v[k]);
    }
  }
}

// reduce_pairs of a lane's words of kCand candidates, each block sum
// stored to s_out[c][blk].
template <int N, int L, int kPixels, int kCand, int kBlocks>
__device__ __forceinline__ void reduce_store(uint32_t (&packed)[N], unsigned i,
                                             unsigned blk, int32_t (*s_out)[kBlocks]) {
  reduce_pairs<N, L, kPixels, kCand>(packed, i, [&](int c, uint32_t sum) {
    s_out[c][blk] = static_cast<int32_t>(sum);
  });
}

// The (2R + 1)^2 SADs at R >= 2 of each MV block of the CTA into
// s_out[c][blk]. rows[k]: window row i + k BH on lane i (rows past the
// window unused). Lane i takes window row i + oy of candidate row oy from
// lane (i + oy) mod BH, slot (i + oy) / BH; each lane sends the slot its
// taker wants, so a row costs one shuffle a word (none where oy is a
// multiple of BH: the lane's own slot). A candidate is BW / 4 __vsadu4 over
// the lane's anchor row; the lane's sums (at most 255 BW < 2^16) go two to
// a word in raster order, and the words reduce over the block's BH lanes by
// reduce_store: packed while a sum covers at most 256 pixels (every step
// up to 16 x 16 blocks), then as 32-bit sums (a block's reaches 255 BW BH,
// 261,120 at 32 x 32). Every lane of the warp calls it (full-mask
// shuffles).
template <int BW, int BH, int R>
__device__ __forceinline__ void block_sads_wide(
    uint32_t (&rows)[Window<BW, R, BH>::kSlots][Window<BW, R, BH>::kWords],
    const uint32_t (&a)[BW / 4], unsigned i, unsigned blk,
    int32_t (*s_out)[kThreads / BH]) {
  using W = Window<BW, R, BH>;
  constexpr int kSide = 2 * R + 1;
  uint32_t packed[W::kPacked];
#pragma unroll
  for (int oy = 0; oy < kSide; ++oy) {
    const int q = oy / BH;
    const int rho = oy % BH;
    uint32_t row[W::kWords];
#pragma unroll
    for (int k = 0; k < W::kWords; ++k) {
      if (rho == 0) {
        row[k] = rows[q][k];
      } else {
        const uint32_t send = static_cast<int>(i) < rho ? rows[q + 1][k] : rows[q][k];
        row[k] = __shfl_sync(kFull, send, static_cast<int>(i) + rho, BH);
      }
    }
#pragma unroll
    for (int ox = 0; ox < kSide; ++ox) {
      const int wo = ox / 4;
      const int d = ox % 4;
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < BW / 4; ++j) {
        uint32_t c;
        if (d == 0) {
          c = row[j + wo];
        } else {
          c = __funnelshift_r(row[j + wo], row[j + wo + 1], 8 * d);
        }
        sum = __vsadu4(c, a[j]) + sum;
      }
      const int cand = oy * kSide + ox;
      if (cand % 2 == 0) {
        packed[cand / 2] = sum;
      } else {
        packed[cand / 2] = __byte_perm(packed[cand / 2], sum, 0x5410);
      }
    }
  }
  reduce_store<W::kPacked, BH, BW, W::kCand>(packed, i, blk, s_out);
}

// The 2R + 1 sums of one candidate row (16-bit pairs, ox 2p and 2p + 1 in
// word p of `packed`; a lane's cover kPixels pixels) reduced over a group
// of L lanes by reduce_pairs: on pairs while a sum covers at most 256
// pixels (every step up to 16 x 16 blocks), then as 32-bit sums (a 32 x
// 32 block's reaches 261,120: the steps at lane offsets 2 and 1). Then
// `put(ox, sum)` for each sum lane i holds, each ox on one lane of the
// group. Every lane of the warp calls it (full-mask shuffles).
template <int R, int L, int kPixels, class Put>
__device__ __forceinline__ void reduce_row(uint32_t (&packed)[R + 1], unsigned i, Put put) {
  reduce_pairs<R + 1, L, kPixels, 2 * R + 1>(packed, i, put);
}

// block_sads_wide at R >= 5, one candidate row at a time: (2R + 1)^2 sums
// a lane would outgrow its registers (145 words of pairs at R = 8), so
// each oy's row i + oy comes from lane (i + oy) mod BH as there, its 2R + 1
// sums go two to a word and reduce over the block's BH lanes at once
// (reduce_row), each block sum of candidate c = oy (2R + 1) + ox to
// `put(c, sum)` on one lane (the kernel's: into s_out[c][blk], or at 4x4
// straight to the output): registers for 2R + 1 sums, one small reduction
// a row. The oy loop runs at run time (its code fits the instruction
// cache); the slot a lane sends is picked by selects (register arrays take
// no runtime index). A lane's row sums (255 BW at most) fit 16 bits.
template <int BW, int BH, int R, class Put>
__device__ __forceinline__ void block_sads_by_row(
    const uint32_t (&rows)[Window<BW, R, BH>::kSlots][Window<BW, R, BH>::kWords],
    const uint32_t (&a)[BW / 4], unsigned i, Put put) {
  using W = Window<BW, R, BH>;
  constexpr int kSide = 2 * R + 1;
#pragma unroll 1
  for (int oy = 0; oy < kSide; ++oy) {
    const int q = oy / BH;
    const int rho = oy % BH;
    const int send_slot = static_cast<int>(i) < rho ? q + 1 : q;
    uint32_t row[W::kWords];
#pragma unroll
    for (int k = 0; k < W::kWords; ++k) {
      uint32_t send = rows[0][k];
#pragma unroll
      for (int s = 1; s < W::kSlots; ++s) send = send_slot == s ? rows[s][k] : send;
      row[k] = __shfl_sync(kFull, send, static_cast<int>(i) + rho, BH);
    }
    uint32_t packed[R + 1];
#pragma unroll
    for (int ox = 0; ox < kSide; ++ox) {
      const int wo = ox / 4;
      const int d = ox % 4;
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < BW / 4; ++j) {
        const uint32_t c =
            d == 0 ? row[j + wo] : __funnelshift_r(row[j + wo], row[j + wo + 1], 8 * d);
        sum = __vsadu4(c, a[j]) + sum;
      }
      if (ox % 2 == 0) {
        packed[ox / 2] = sum;
      } else {
        packed[ox / 2] = __byte_perm(packed[ox / 2], sum, 0x5410);
      }
    }
    reduce_row<R, BH, BW>(packed, i, [&](int ox, uint32_t sum) { put(oy * kSide + ox, sum); });
  }
}

// The CTA's SADs (s_out, after a barrier; kBlocks MV blocks, kThreads / BH
// unless given) to out (t_count, (2R + 1)^2, mfh, mfw) of Out (int32 for K3
// / K7 / K8, float32 for K9): runs of consecutive block columns of each
// candidate plane.
template <int BH, int R = 1, int kBlocks = kThreads / BH, class Out>
__device__ __forceinline__ void store_sads(int32_t (*s_out)[kBlocks],
                                           Out* __restrict__ out, int t, int by,
                                           int mfh, int mfw) {
  constexpr int kC = Window<BH, R>::kCand;
  const size_t plane_out = static_cast<size_t>(mfh) * mfw;
  const int bx0 = blockIdx.x * kBlocks;
  Out* o = out + (static_cast<size_t>(t) * kC * mfh + by) * mfw + bx0;
  for (unsigned e = threadIdx.x; e < kC * kBlocks; e += kThreads) {
    const unsigned c = e / kBlocks;
    const unsigned b = e % kBlocks;
    if (bx0 + static_cast<int>(b) < mfw) {
      o[c * plane_out + b] = sad_as<Out>(static_cast<uint32_t>(s_out[c][b]));
    }
  }
}

}  // namespace
