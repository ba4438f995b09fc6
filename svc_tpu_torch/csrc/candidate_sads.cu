// K9 candidate_sads: per-block SADs of the 9 candidates around each
// block's MV, for T separate (tracked, anchor) plane pairs, as float32,
// specialised for square 2x2 MV blocks at search radius r = 1: the
// encoder's top-level EBMA (16x16 blocks, 4 pyramid levels, range 8), in
// hbma_stack and per-frame hbma alike.
//
// Replaces svc_tpu/ops/motion_pallas.py candidate_sads (:121) at that
// shape; every other shape runs candidate_sads_general.cu
// (window_sads.cuh), and ops/motion.py dispatches. The contract is the
// general kernel's: SAD of candidate (oy, ox) in raster order at
//   sum_{i,j<2} |trk(t, 2*by + mvy + oy - 1 + i, 2*bx + mvx + ox - 1 + j)
//               - anc(t, 2*by + i, 2*bx + j)|
// for any int32 MVs, with tracked pixels outside the frame read as 0:
// exact integer sums, bit-equal to the general kernel and to
// candidate_sads_plain on every entry, valid or not.
//
// Bound: bytes, and mostly the output (9 float32 per block against 8
// bytes read: 2.35 MB of 2.87 MB at 1080p, T = 8; 0.0009 ms on an H100).
// The general kernel gives a warp to each block (4 of 32 lanes busy at
// 2x2), stages both tiles in shared memory, divides by runtime sizes and
// reduces each of the 9 sums by five shuffles. Design:
//   - a thread per MV block; consecutive threads take consecutive block
//     columns of one block row, so the window-row loads and the stores of
//     each of the nine candidate planes coalesce across the warp;
//   - the two anchor rows are 16-bit loads (2*bx is even, fw is even);
//   - each of the 4 window rows, bytes x0 .. x0+3 with x0 = 2*bx + mvx - 1
//     at any alignment, is two aligned 32-bit words (planes are 4-byte
//     aligned and fh*fw is a multiple of 4) joined by __funnelshift_r. A
//     word is loaded only where it meets the row's bytes, so no load
//     leaves the plane; a byte mask then zeroes what lies outside [0, fw)
//     (fw is even but need not be a multiple of 4, so a word can straddle
//     the row's edge) and a row outside [0, fh) reads as 0;
//   - __vsadu4 of a window word shifted to candidate column ox (low two
//     bytes) against an anchor row (high bytes 0) adds that row's two
//     absolute differences: 18 of them make the 9 sums;
//   - no shared memory, no shuffles; all index math is compile-time but
//     the block's own origin.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // block columns per CTA
constexpr int kCand = 9;       // (2r + 1)^2 at r = 1

// Bytes [x0, x0 + 4) of row y of a frame as one word (byte k at bits 8k),
// bytes outside the frame 0. frame is 4-byte aligned and holds fh rows of
// fw bytes, fh * fw a multiple of 4.
__device__ __forceinline__ uint32_t window_row(const uint8_t* __restrict__ frame,
                                               int y, int x0, int fh, int fw) {
  if (y < 0 || y >= fh || x0 <= -4 || x0 >= fw) return 0u;
  const int row0 = y * fw;
  const int row1 = row0 + fw;
  const int o = row0 + x0;
  const int a = o & ~3;  // floor to a multiple of 4 (o >= -3)
  const int s = o - a;   // 0 .. 3
  const uint32_t lo = (a + 4 > row0)
      ? __ldg(reinterpret_cast<const unsigned int*>(frame + a)) : 0u;
  const uint32_t hi = (s != 0 && a + 4 < row1)
      ? __ldg(reinterpret_cast<const unsigned int*>(frame + a + 4)) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * s);
  const int first = max(0, -x0);    // first byte inside the row
  const int last = min(4, fw - x0);  // one past the last
  const uint32_t below_last = last >= 4 ? 0xffffffffu : (1u << (8 * last)) - 1u;
  return v & below_last & (0xffffffffu << (8 * first));
}

__global__ void __launch_bounds__(kThreads)
candidate_sads_kernel(const uint8_t* __restrict__ tracked,
                      const uint8_t* __restrict__ anchor,
                      const int32_t* __restrict__ mv, float* __restrict__ out,
                      int fh, int fw, int mfh, int mfw) {
  const int bx = blockIdx.x * kThreads + threadIdx.x;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  if (bx >= mfw) return;

  const size_t plane = static_cast<size_t>(fh) * fw;
  const uint8_t* trk = tracked + t * plane;
  const uint8_t* anc = anchor + t * plane + static_cast<size_t>(2 * by) * fw + 2 * bx;
  const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
  const int mvx = __ldg(m);
  const int mvy = __ldg(m + 1);
  const uint32_t a0 = __ldg(reinterpret_cast<const unsigned short*>(anc));
  const uint32_t a1 = __ldg(reinterpret_cast<const unsigned short*>(anc + fw));

  const int x0 = 2 * bx + mvx - 1;  // window column of ox = 0
  const int y0 = 2 * by + mvy - 1;  // window row of oy = 0
  uint32_t acc[kCand];
#pragma unroll
  for (int c = 0; c < kCand; ++c) acc[c] = 0u;
  // window row wr meets anchor row 0 in candidate row oy = wr and anchor
  // row 1 in oy = wr - 1
#pragma unroll
  for (int wr = 0; wr < 4; ++wr) {
    const uint32_t w = window_row(trk, y0 + wr, x0, fh, fw);
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) {
      const uint32_t c = (w >> (8 * ox)) & 0xffffu;
      if (wr <= 2) acc[wr * 3 + ox] = __vsadu4(c, a0) + acc[wr * 3 + ox];
      if (wr >= 1) acc[(wr - 1) * 3 + ox] = __vsadu4(c, a1) + acc[(wr - 1) * 3 + ox];
    }
  }

  const size_t plane_out = static_cast<size_t>(mfh) * mfw;
  float* o = out + (static_cast<size_t>(t) * kCand * mfh + by) * mfw + bx;
#pragma unroll
  for (int c = 0; c < kCand; ++c) o[c * plane_out] = static_cast<float>(acc[c]);
}

}  // namespace

// tracked, anchor: (t_count, fh, fw) uint8, tracked 4-byte and anchor
// 2-byte aligned; mv: (t_count, fh/2, fw/2, 2) int32 (x, y); out:
// (t_count, 9, fh/2, fw/2) float32. All contiguous; fh and fw even; 2x2
// blocks, r = 1. Refuses (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_candidate_sads(const void* tracked, const void* anchor,
                                  const void* mv, void* out, int t_count,
                                  int fh, int fw, void* stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 4 ||
      reinterpret_cast<uintptr_t>(anchor) % 2 || fh % 2 || fw % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mfh = fh / 2;
  const int mfw = fw / 2;
  const dim3 grid((mfw + kThreads - 1) / kThreads, mfh, t_count);
  candidate_sads_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tracked), static_cast<const uint8_t*>(anchor),
      static_cast<const int32_t*>(mv), static_cast<float*>(out), fh, fw, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}
