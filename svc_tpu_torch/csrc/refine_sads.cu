// K3 refine_sads: candidate SADs of one hierarchical motion refinement
// level for a whole frame stack, specialised for square B x B MV blocks
// (B = 4, 8, 16 here; B = 2 on K9's 2x2 kernel, candidate_sads.cu) and
// search radius R = 1 to 4: the refinement levels of the encoder's search
// at 16x16 MV blocks and 4 pyramid levels, range 8 (R = 1, the default) to
// 39 (R = range / 8), and at 8x8 MV blocks or 2, 3 or 5 levels (--mv-block-
// w/-h, --pyr-lvl-count). The same kernel is K7's for one frame pair
// (refine_mads.cu) and K9's at 4x4 and 8x8 blocks with float32 output
// (candidate_sads.cu), through the launchers of refine_sads.cuh: it reads
// frame t's tracked plane and its anchor from two bases a per-frame stride
// apart, so K3 passes (stack, stack + plane, plane), K7 (tracked, anchor,
// 0) and K9 (tracked, anchor, plane).
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pallas (:887,
// pallas_call in _refine_stack_call :1093) and, for K7, refine_mads_pallas
// (:541). Every other block shape or range runs refine_sads_general.cu /
// refine_mads_general.cu (window_sads.cuh); ops/motion.py dispatches. The
// contract is the general kernel's: frame t tracked against its anchor
// (frame t+1 of K3's stack), SAD of candidate (oy, ox) in raster order at
//   sum_{i,j<B} |trk(t, by*B + mvy + oy - R + i, bx*B + mvx + ox - R + j)
//                - anc(t, by*B + i, bx*B + j)|
// with tracked pixels outside the frame read as 0: exact integer sums,
// bit-equal to the general kernel and to refine_sads_plain on every
// candidate, valid or not.
//
// Bound: bytes at R = 1 and 2 (each anchor and tracked pixel read once,
// each SAD written once: 0.0099 and 0.0137 ms for the three 1080p levels
// of an 8-frame batch on an H100), the (2R + 1)^2 B^2 / 4 SIMD SADs a
// block at the integer rate at level 0 from R = 3. The general kernel
// gives one warp to each MV block (half its lanes idle on 4x4 blocks),
// divides by runtime sizes per pixel and works byte by byte. Design:
//   - a lane owns one anchor row of one block (B / 4 words in registers);
//     the B lanes of a block are neighbours in a warp, 256 / B blocks of
//     one block row per CTA, so every lane is busy at every level;
//   - window rows arrive as two aligned B-byte chunks (16-, 8- or 4-byte
//     loads through the read-only path) plus Window<B, R>::kExtra words
//     (one at R <= 2, two at R = 3, 4) when the window reaches past them; a
//     chunk outside the frame (rows outside [0, fh), columns outside [0,
//     fw); fw is a multiple of B) reads as 0 by one predicate per chunk.
//     The load instructions per warp, each touching up to 32 rows, set the
//     pace (L1 wavefronts), so fewer, wider ones;
//   - each lane loads only its own window rows: at R = 1 row i, the rows
//     of oy = 1, 2 come from the next lanes by shuffles and the last two
//     lanes of a block load the two rows below it; at R >= 2 (B = 4, 8)
//     lane i loads rows i, i + B, ... of the window's B + 2R, and takes
//     row i + oy from lane (i + oy) mod B by one shuffle a word, that lane
//     sending the row its taker wants;
//   - selects and __funnelshift_r align the words to each candidate
//     column, and __vsadu4 sums four absolute differences at once;
//   - all index math is compile-time (B and R are template parameters);
//   - at R = 1 the 9 sums of a block reduce over its B lanes by log2(B)
//     xor shuffles; at R >= 2 a lane's (2R + 1)^2 sums fit 16 bits and go
//     two to a word, and the words reduce by transposed xor steps (each
//     halves what a lane holds: 41 shuffles for R = 4 at 16 lanes, not
//     324); then through shared memory, leaving as runs of consecutive
//     block columns of each candidate plane;
//   - at B = 16 and R >= 2 the ALU work of the shifts, the row shuffles
//     and the reduction outweighs the SADs, so refine_sads_split_kernel
//     gives a block 4 lanes of 4 anchor rows each: every lane loads its
//     4 + 2R window rows itself, a row's shifted words serve up to 4
//     anchor rows, and the reduction spans 4 lanes (22-27% faster at R =
//     2, 3 and 9% at R = 4 than 16 lanes of one row, in turns on an H100;
//     at B = 8 it was no faster, 16% slower at R = 4: twice the row loads).
//     Its CTAs hold 64 blocks, so it runs only where its grid has two
//     CTAs an SM or more (K3's stack); a single 1080p pair (K7) keeps the
//     one-row-a-lane kernel's 544 CTAs.
// From the window rows on, the one-row-a-lane kernel runs refine_rows.cuh,
// shared with the K8 refine (refine_sads_pitched.cu, R = 1).
#include "refine_rows.cuh"
#include "refine_sads.cuh"

namespace {

// Anchor rows a lane owns in the split kernel (B = 16, R >= 2).
constexpr int kSplitRows = 4;

// One aligned B-byte chunk (16, 8 or 4 bytes) as B / 4 words.
template <int B>
__device__ __forceinline__ void load_chunk(const uint8_t* p, uint32_t* w) {
  if constexpr (B == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (B == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Bytes [x0, x0 + 4 kWords) of row y of a plane as Window<B, R>::kWords
// words, the first starting at byte x0 (the window row needs B + 2R of
// them). It loads the two aligned B-byte chunks from floor(x0 / B) * B on,
// and the kExtra words after them when the window reaches them; a chunk
// outside the frame, and every chunk when the row lies outside it or the
// lane is disabled, reads as 0 (fw is a multiple of B, so a chunk is
// wholly in or out).
template <int B, int R>
__device__ __forceinline__ void load_window_row(const uint8_t* __restrict__ plane,
                                                int y, int x0, int fh, int fw,
                                                bool enabled,
                                                uint32_t (&al)[Window<B, R>::kWords]) {
  constexpr int kW = B / 4;
  const bool row_in = enabled && y >= 0 && y < fh;
  const uint8_t* row = plane + static_cast<size_t>(row_in ? y : 0) * fw;
  const int xb = x0 & ~(B - 1);  // floor to a multiple of B
  const int s = x0 - xb;         // 0 .. B-1
  uint32_t w[Window<B, R>::kFetch];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int x = xb + c * B;
    if (row_in && x >= 0 && x < fw) {
      load_chunk<B>(row + x, w + c * kW);
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k) w[c * kW + k] = 0u;
    }
  }
  const int x2 = xb + 2 * B;  // the window's last bytes lie here when s is large
  if constexpr (R == 1) {
    w[2 * kW] = (row_in && s == B - 1 && x2 >= 0 && x2 < fw)
                    ? __ldg(reinterpret_cast<const unsigned int*>(row + x2)) : 0u;
  } else if constexpr (B == 4) {
    // chunks of one word: word e is needed when s + 4 + 2R > 8 + 4e
#pragma unroll
    for (int e = 0; e < Window<B, R>::kExtra; ++e) {
      const int x = x2 + 4 * e;
      w[2 + e] = (row_in && s > 4 * e + 4 - 2 * R && x >= 0 && x < fw)
                     ? __ldg(reinterpret_cast<const unsigned int*>(row + x)) : 0u;
    }
  } else {
    // B >= 8: the kExtra (1 or 2) words lie in one chunk, 8-byte aligned
    const bool need = row_in && s > B - 2 * R && x2 >= 0 && x2 < fw;
    if constexpr (Window<B, R>::kExtra == 1) {
      w[2 * kW] = need ? __ldg(reinterpret_cast<const unsigned int*>(row + x2)) : 0u;
    } else {
      uint2 v = make_uint2(0u, 0u);
      if (need) v = __ldg(reinterpret_cast<const uint2*>(row + x2));
      w[2 * kW] = v.x;
      w[2 * kW + 1] = v.y;
    }
  }
  align_window_row<B, R>(w, s, al);
}

template <int B, int R, class Out>
__global__ void __launch_bounds__(kThreads)
refine_sads_kernel(const uint8_t* __restrict__ tracked,
                   const uint8_t* __restrict__ anchor, size_t frame_stride,
                   const int32_t* __restrict__ mv, Out* __restrict__ out,
                   int fh, int fw, int mfh, int mfw) {
  constexpr int kBlocks = kThreads / B;  // MV blocks of one block row
  using W = Window<B, R>;
  __shared__ int32_t s_out[W::kCand][kBlocks];

  const unsigned i = threadIdx.x % B;  // anchor row of this lane
  const unsigned blk = threadIdx.x / B;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole B-lane group is in or out

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }
  const uint8_t* trk = tracked + t * frame_stride;
  uint32_t a[B / 4] = {};
  if (active) {
    load_chunk<B>(anchor + t * frame_stride +
                      static_cast<size_t>(by * B + i) * fw + bx * B, a);
  }

  const int x0 = bx * B + mvx - R;  // first window column (ox = 0)
  const int y0 = by * B + mvy - R + static_cast<int>(i);  // row at oy = 0
  if constexpr (R == 1) {
    uint32_t r0[W::kWords], ext[W::kWords];
    load_window_row<B, R>(trk, y0, x0, fh, fw, active, r0);
    // lanes B-2 and B-1 also load rows B and B+1 of the window
    load_window_row<B, R>(trk, y0 + 2, x0, fh, fw, active && i >= B - 2, ext);
    block_sads<B>(r0, ext, a, i, blk, s_out);
  } else {
    // lane i holds window rows i, i + B, ...: those inside the window
    uint32_t rows[W::kSlots][W::kWords];
#pragma unroll
    for (int k = 0; k < W::kSlots; ++k) {
      const bool inside = k == 0 || static_cast<int>(i) + k * B < B + 2 * R;
      load_window_row<B, R>(trk, y0 + k * B, x0, fh, fw, active && inside, rows[k]);
    }
    block_sads_wide<B, R>(rows, a, i, blk, s_out);
  }
  __syncthreads();
  store_sads<B, R>(s_out, out, t, by, mfh, mfw);
}

// K3 at B = 16 and R >= 2: four lanes a block, lane l owning anchor rows
// 4l .. 4l + 3 and loading its own window rows 4l .. 4l + 3 + 2R (no row
// shuffles); a window row's shifted words serve each of the lane's anchor
// rows it meets, the 16-bit sums accumulate two to a word as they come
// (at most 4 * 16 * 255 a lane), and the words reduce over the 4 lanes by
// two transposed xor steps. 64 blocks a CTA.
template <int R>
__global__ void __launch_bounds__(kThreads)
refine_sads_split_kernel(const uint8_t* __restrict__ tracked,
                         const uint8_t* __restrict__ anchor, size_t frame_stride,
                         const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                         int fh, int fw, int mfh, int mfw) {
  constexpr int B = 16;
  constexpr int kRows = kSplitRows;
  constexpr int kLanes = B / kRows;
  constexpr int kBlocks = kThreads / kLanes;
  constexpr int kSide = 2 * R + 1;
  using W = Window<B, R>;
  __shared__ int32_t s_out[W::kCand][kBlocks];

  const unsigned l = threadIdx.x % kLanes;  // this lane's anchor rows: 4l ..
  const unsigned blk = threadIdx.x / kLanes;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole 4-lane group is in or out

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }
  const uint8_t* trk = tracked + t * frame_stride;
  uint32_t a[kRows][B / 4];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < B / 4; ++j) a[m][j] = 0u;
    if (active) {
      load_chunk<B>(anchor + t * frame_stride +
                        static_cast<size_t>(by * B + kRows * l + m) * fw + bx * B, a[m]);
    }
  }
  const int x0 = bx * B + mvx - R;  // first window column (ox = 0)
  const int y0 = by * B + mvy - R + kRows * static_cast<int>(l);  // the lane's first row
  uint32_t packed[W::kPacked];
#pragma unroll
  for (int p = 0; p < W::kPacked; ++p) packed[p] = 0u;
#pragma unroll
  for (int k = 0; k < kRows + 2 * R; ++k) {
    uint32_t row[W::kWords];
    load_window_row<B, R>(trk, y0 + k, x0, fh, fw, active, row);
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int oy = k - m;  // the candidate row window row k meets anchor row m in
      if (oy < 0 || oy > 2 * R) continue;
#pragma unroll
      for (int ox = 0; ox < kSide; ++ox) {
        const int wo = ox / 4;
        const int d = ox % 4;
        const int cand = oy * kSide + ox;
        uint32_t sum = cand % 2 == 0 ? packed[cand / 2] : 0u;
#pragma unroll
        for (int j = 0; j < B / 4; ++j) {
          uint32_t c;
          if (d == 0) {
            c = row[j + wo];
          } else {
            c = __funnelshift_r(row[j + wo], row[j + wo + 1], 8 * d);
          }
          sum = __vsadu4(c, a[m][j]) + sum;
        }
        if (cand % 2 == 0) {
          packed[cand / 2] = sum;
        } else {
          packed[cand / 2] += sum << 16;
        }
      }
    }
  }
  reduce_transposed<W::kPacked, kLanes / 2, kLanes>(packed, l);
  constexpr int kHeld = reduced_count<W::kPacked, kLanes / 2>();
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int p = reduced_index<W::kPacked, kLanes / 2>(k, l);
    if (p >= 0) {
      s_out[2 * p][blk] = static_cast<int32_t>(packed[k] & 0xffffu);
      if (2 * p + 1 < W::kCand) {
        s_out[2 * p + 1][blk] = static_cast<int32_t>(packed[k] >> 16);
      }
    }
  }
  __syncthreads();
  store_sads<B, R, kBlocks>(s_out, out, t, by, mfh, mfw);
}

template <int B, int R, class Out>
int launch(const void* tracked, const void* anchor, size_t frame_stride,
           const void* mv, Out* o, int t_count, int fh, int fw,
           void* stream) {
  const int mfh = fh / B;
  const int mfw = fw / B;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* trk = static_cast<const uint8_t*>(tracked);
  const auto* anc = static_cast<const uint8_t*>(anchor);
  const auto* m = static_cast<const int32_t*>(mv);
  if constexpr (B == 16 && R >= 2) {
    // the split kernel where its 64-block CTAs still fill the card twice
    // over (a stack of 1080p frames); one pair's 136 run the one-row kernel
    constexpr int kBlocks = kThreads / (B / kSplitRows);
    const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (static_cast<long long>(grid.x) * grid.y * grid.z >= 2LL * sms) {
      refine_sads_split_kernel<R><<<grid, kThreads, 0, st>>>(trk, anc, frame_stride, m,
                                                              o, fh, fw, mfh, mfw);
      return static_cast<int>(cudaGetLastError());
    }
  }
  constexpr int kBlocks = kThreads / B;
  const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
  refine_sads_kernel<B, R, Out><<<grid, kThreads, 0, st>>>(trk, anc, frame_stride, m,
                                                           o, fh, fw, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instance of radius r for B x B blocks.
template <int B, class Out>
int launch_refine_rows(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, Out* out,
                       int t_count, int fh, int fw, int r, void* stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 16 ||
      reinterpret_cast<uintptr_t>(anchor) % 16 || frame_stride % 16 || fh % B ||
      fw % B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (r) {
    case 1: return launch<B, 1>(tracked, anchor, frame_stride, mv, out,
                                t_count, fh, fw, stream);
    case 2: return launch<B, 2>(tracked, anchor, frame_stride, mv, out,
                                t_count, fh, fw, stream);
    case 3: return launch<B, 3>(tracked, anchor, frame_stride, mv, out,
                                t_count, fh, fw, stream);
    case 4: return launch<B, 4>(tracked, anchor, frame_stride, mv, out,
                                t_count, fh, fw, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 and K7 at 4x4, 8x8 and 16x16 blocks; K9 at 4x4 and 8x8
#define SVC_REFINE_ROWS(B, Out)                                              \
  template int launch_refine_rows<B, Out>(const void*, const void*, size_t, \
                                          const void*, Out*, int, int, int, \
                                          int, void*);
SVC_REFINE_ROWS(4, int32_t)
SVC_REFINE_ROWS(8, int32_t)
SVC_REFINE_ROWS(16, int32_t)
SVC_REFINE_ROWS(4, float)
SVC_REFINE_ROWS(8, float)
#undef SVC_REFINE_ROWS

int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int block, int r,
                       void* stream) {
  auto* o = static_cast<int32_t*>(out);
  switch (block) {
    case 2:  // its frames lie a plane apart (K3) or it has one (K7)
      if (t_count > 1 && frame_stride != static_cast<size_t>(fh) * fw) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_block2_sads<int32_t>(tracked, anchor, mv, o, t_count, fh, fw, r,
                                         stream);
    case 4: return launch_refine_rows<4, int32_t>(tracked, anchor, frame_stride, mv,
                                                  o, t_count, fh, fw, r, stream);
    case 8: return launch_refine_rows<8, int32_t>(tracked, anchor, frame_stride, mv,
                                                  o, t_count, fh, fw, r, stream);
    case 16: return launch_refine_rows<16, int32_t>(tracked, anchor, frame_stride, mv,
                                                    o, t_count, fh, fw, r, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stack: (t_count + 1, fh, fw) uint8, 16-byte aligned; mv: (t_count,
// fh/block, fw/block, 2) int32 (x, y); out: (t_count, (2r + 1)^2,
// fh/block, fw/block) int32. All contiguous; block in {2, 4, 8, 16}
// divides fh and fw; 1 <= r <= 4. Refuses (cudaErrorInvalidValue) anything
// else.
SVC_EXPORT int svc_refine_sads(const void* stack, const void* mv, void* out,
                               int t_count, int fh, int fw, int block, int r,
                               void* stream) {
  const size_t plane = static_cast<size_t>(fh) * fw;
  return launch_refine_sads(stack, static_cast<const uint8_t*>(stack) + plane,
                            plane, mv, out, t_count, fh, fw, block, r, stream);
}
