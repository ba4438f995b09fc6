// The SAD arithmetic of the lane-per-anchor-row refine kernels: K3's
// specialised kernel (refine_sads.cu, window rows loaded from dense planes
// in global memory) and the K8 refine (refine_sads_pitched.cu, window rows
// read from a band of column-pitched subplanes staged in shared memory).
// Each kernel gets its window rows its own way; from the rows on both run
// this code, so both give the same bits.
//
// A CTA of kThreads lanes handles kThreads / B MV blocks of one block row
// (square B x B blocks, r = 1); lane i of a block owns anchor row i (B / 4
// words). A window row is B / 4 + 1 words from the window's first byte
// (ox = 0) on; it needs B + 2 of those bytes.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCand = 9;  // (2r + 1)^2 at r = 1
constexpr unsigned kFull = 0xffffffffu;

// al: the B / 4 + 1 words of a row from byte s on (0 <= s < B), given w,
// the B / 2 + 1 words of the row from an aligned base. v[j] = w[s / 4 + j]
// by selects (register arrays take no runtime index), then a funnel shift
// by s % 4 bytes.
template <int B>
__device__ __forceinline__ void align_window_row(const uint32_t (&w)[B / 2 + 1], int s,
                                                 uint32_t (&al)[B / 4 + 1]) {
  constexpr int kW = B / 4;
  const int q = s >> 2;
  uint32_t v[kW + 2];
#pragma unroll
  for (int j = 0; j < kW + 2; ++j) {
    uint32_t r = w[j];
#pragma unroll
    for (int t = 1; t < kW; ++t) r = q == t ? w[t + j] : r;
    v[j] = r;
  }
#pragma unroll
  for (int j = 0; j <= kW; ++j) al[j] = __funnelshift_r(v[j], v[j + 1], 8 * (s & 3));
}

// Adds one window row's share of the three candidates ox = 0, 1, 2 to
// acc[0..2]; al holds the row from its first byte on.
template <int B>
__device__ __forceinline__ void sad_row(const uint32_t (&al)[B / 4 + 1],
                                        const uint32_t (&a)[B / 4],
                                        uint32_t* acc) {
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
#pragma unroll
    for (int j = 0; j < B / 4; ++j) {
      const uint32_t c = ox == 0 ? al[j] : __funnelshift_r(al[j], al[j + 1], 8 * ox);
      acc[ox] = __vsadu4(c, a[j]) + acc[ox];
    }
  }
}

// The 9 SADs of each MV block of the CTA into s_out[c][blk]. r0: lane i's
// window row at oy = 0 (window row i); ext: window row i + 2 on lanes B - 2
// and B - 1 (unused elsewhere). The block's lanes share the window's first
// column, so their rows are aligned alike: the rows of oy = 1, 2 come from
// the next lanes by shuffles, and the sums reduce over the block's B lanes
// by log2(B) xor shuffles. Every lane of the warp calls it (full-mask
// shuffles).
template <int B>
__device__ __forceinline__ void block_sads(const uint32_t (&r0)[B / 4 + 1],
                                           const uint32_t (&ext)[B / 4 + 1],
                                           const uint32_t (&a)[B / 4], unsigned i,
                                           unsigned blk,
                                           int32_t (*s_out)[kThreads / B]) {
  constexpr int kWords = B / 4 + 1;
  uint32_t r1[kWords], r2[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t down1 = __shfl_down_sync(kFull, r0[k], 1, B);
    const uint32_t down2 = __shfl_down_sync(kFull, r0[k], 2, B);
    const uint32_t up1 = __shfl_up_sync(kFull, ext[k], 1, B);
    r1[k] = i == B - 1 ? up1 : down1;
    r2[k] = i >= B - 2 ? ext[k] : down2;
  }

  uint32_t acc[kCand];
#pragma unroll
  for (int c = 0; c < kCand; ++c) acc[c] = 0;
  sad_row<B>(r0, a, acc);
  sad_row<B>(r1, a, acc + 3);
  sad_row<B>(r2, a, acc + 6);

#pragma unroll
  for (int c = 0; c < kCand; ++c) {
#pragma unroll
    for (int off = B / 2; off > 0; off >>= 1) {
      acc[c] += __shfl_xor_sync(kFull, acc[c], off, B);
    }
    if (i == static_cast<unsigned>(c % B)) s_out[c][blk] = static_cast<int32_t>(acc[c]);
  }
}

// The CTA's SADs (s_out, after a barrier) to out (t_count, kCand, mfh,
// mfw): runs of consecutive block columns of each candidate plane.
template <int B>
__device__ __forceinline__ void store_sads(int32_t (*s_out)[kThreads / B],
                                           int32_t* __restrict__ out, int t, int by,
                                           int mfh, int mfw) {
  constexpr int kBlocks = kThreads / B;
  const size_t plane_out = static_cast<size_t>(mfh) * mfw;
  const int bx0 = blockIdx.x * kBlocks;
  int32_t* o = out + (static_cast<size_t>(t) * kCand * mfh + by) * mfw + bx0;
  for (unsigned e = threadIdx.x; e < kCand * kBlocks; e += kThreads) {
    const unsigned c = e / kBlocks;
    const unsigned b = e % kBlocks;
    if (bx0 + static_cast<int>(b) < mfw) o[c * plane_out + b] = s_out[c][b];
  }
}

}  // namespace
