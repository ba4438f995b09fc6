// K3 refine_sads: candidate SADs of one hierarchical motion refinement
// level for a whole frame stack, specialised for square B x B MV blocks
// (B = 4, 8, 16) and search radius r = 1: the three refinement levels of
// the default encoder (16x16 MV blocks, range 8, 4 pyramid levels). The
// same kernel is K7's for one frame pair (refine_mads.cu, through
// launch_refine_sads, refine_sads.cuh): it reads frame t's tracked plane
// and its anchor from two bases a per-frame stride apart, so K3 passes
// (stack, stack + plane, plane) and K7 (tracked, anchor, 0).
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pallas (:887,
// pallas_call in _refine_stack_call :1093) and, for K7, refine_mads_pallas
// (:541). Every other block shape or range runs refine_sads_general.cu /
// refine_mads_general.cu (window_sads.cuh); ops/motion.py dispatches. The
// contract is the general kernel's: frame t tracked against its anchor
// (frame t+1 of K3's stack), SAD of candidate (oy, ox) in raster order at
//   sum_{i,j<B} |trk(t, by*B + mvy + oy - 1 + i, bx*B + mvx + ox - 1 + j)
//                - anc(t, by*B + i, bx*B + j)|
// with tracked pixels outside the frame read as 0: exact integer sums,
// bit-equal to the general kernel and to refine_sads_plain on every
// candidate, valid or not.
//
// Bound: bytes (each anchor and tracked pixel read once: 0.01 ms for the
// three 1080p levels of an 8-frame batch on an H100). The general kernel
// gives one warp to each MV block (half its lanes idle on 4x4 blocks),
// divides by runtime sizes per pixel and works byte by byte. Design:
//   - a lane owns one anchor row of one block (B / 4 words in registers);
//     the B lanes of a block are neighbours in a warp, 256 / B blocks of
//     one block row per CTA, so every lane is busy at every level;
//   - window rows arrive as two aligned B-byte chunks (16-, 8- or 4-byte
//     loads through the read-only path) plus one word when the window
//     reaches a third; a chunk outside the frame (rows outside [0, fh),
//     columns outside [0, fw); fw is a multiple of B) reads as 0 by one
//     predicate per chunk. The load instructions per warp, each touching
//     up to 32 rows, set the pace (L1 wavefronts), so fewer, wider ones;
//   - each lane loads only its own window row; the rows of oy = 1, 2 come
//     from the next lanes by shuffles, and the last two lanes of a block
//     load the two rows below it;
//   - selects and __funnelshift_r align the words to each candidate
//     column, and __vsadu4 sums four absolute differences at once;
//   - all index math is compile-time (B is a template parameter);
//   - the 9 sums of a block reduce over its B lanes by log2(B) xor
//     shuffles, go through shared memory, and leave as runs of
//     consecutive block columns of each candidate plane.
// Everything from the window rows on lives in refine_rows.cuh, shared with
// the K8 refine (refine_sads_pitched.cu).
#include "refine_rows.cuh"
#include "refine_sads.cuh"

namespace {

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

// Bytes [x0, x0 + B + 4) of row y of a plane as B / 4 + 1 words, the
// first starting at byte x0 (the window row needs B + 2 of them). It loads
// the two aligned B-byte chunks from floor(x0 / B) * B on, and the first
// word of a third when the window reaches it; a chunk outside the frame,
// and every chunk when the row lies outside it or the lane is disabled,
// reads as 0 (fw is a multiple of B, so a chunk is wholly in or out).
template <int B>
__device__ __forceinline__ void load_window_row(const uint8_t* __restrict__ plane,
                                                int y, int x0, int fh, int fw,
                                                bool enabled,
                                                uint32_t (&al)[B / 4 + 1]) {
  constexpr int kW = B / 4;
  const bool row_in = enabled && y >= 0 && y < fh;
  const uint8_t* row = plane + static_cast<size_t>(row_in ? y : 0) * fw;
  const int xb = x0 & ~(B - 1);  // floor to a multiple of B
  const int s = x0 - xb;         // 0 .. B-1
  uint32_t w[2 * kW + 1];
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
  const int x2 = xb + 2 * B;  // the last window byte lies here when s = B-1
  w[2 * kW] = (row_in && s == B - 1 && x2 >= 0 && x2 < fw)
                  ? __ldg(reinterpret_cast<const unsigned int*>(row + x2)) : 0u;
  align_window_row<B>(w, s, al);
}

template <int B>
__global__ void __launch_bounds__(kThreads)
refine_sads_kernel(const uint8_t* __restrict__ tracked,
                   const uint8_t* __restrict__ anchor, size_t frame_stride,
                   const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                   int fh, int fw, int mfh, int mfw) {
  constexpr int kBlocks = kThreads / B;  // MV blocks of one block row
  constexpr int kWords = B / 4 + 1;      // window words per row
  __shared__ int32_t s_out[kCand][kBlocks];

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

  const int x0 = bx * B + mvx - 1;  // first window column (ox = 0)
  const int y0 = by * B + mvy - 1 + static_cast<int>(i);  // row at oy = 0
  uint32_t r0[kWords], ext[kWords];
  load_window_row<B>(trk, y0, x0, fh, fw, active, r0);
  // lanes B-2 and B-1 also load rows B and B+1 of the window
  load_window_row<B>(trk, y0 + 2, x0, fh, fw, active && i >= B - 2, ext);
  block_sads<B>(r0, ext, a, i, blk, s_out);
  __syncthreads();
  store_sads<B>(s_out, out, t, by, mfh, mfw);
}

template <int B>
int launch(const void* tracked, const void* anchor, size_t frame_stride,
           const void* mv, void* out, int t_count, int fh, int fw,
           void* stream) {
  constexpr int kBlocks = kThreads / B;
  const int mfh = fh / B;
  const int mfw = fw / B;
  const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
  refine_sads_kernel<B><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tracked), static_cast<const uint8_t*>(anchor),
      frame_stride, static_cast<const int32_t*>(mv), static_cast<int32_t*>(out),
      fh, fw, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int block, void* stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 16 ||
      reinterpret_cast<uintptr_t>(anchor) % 16 || block < 4 || fh % block ||
      fw % block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (block) {
    case 4: return launch<4>(tracked, anchor, frame_stride, mv, out,
                             t_count, fh, fw, stream);
    case 8: return launch<8>(tracked, anchor, frame_stride, mv, out,
                             t_count, fh, fw, stream);
    case 16: return launch<16>(tracked, anchor, frame_stride, mv, out,
                               t_count, fh, fw, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stack: (t_count + 1, fh, fw) uint8, 16-byte aligned; mv: (t_count,
// fh/block, fw/block, 2) int32 (x, y); out: (t_count, 9, fh/block,
// fw/block) int32. All contiguous; block in {4, 8, 16} divides fh and fw;
// r = 1. Refuses (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_refine_sads(const void* stack, const void* mv, void* out,
                               int t_count, int fh, int fw, int block,
                               void* stream) {
  const size_t plane = static_cast<size_t>(fh) * fw;
  return launch_refine_sads(stack, static_cast<const uint8_t*>(stack) + plane,
                            plane, mv, out, t_count, fh, fw, block, stream);
}
