// K3 refine_sads: candidate SADs of one hierarchical motion refinement
// level, for a whole frame stack.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pallas (:887,
// pallas_call in _refine_stack_call :1093). Frame t is tracked against
// anchor t+1 (the reference's pyramid swap). For MV block (by, bx) of
// frame t with rounded propagated MV (mvx, mvy) and candidate (oy, ox) in
// [0, 2r] x [0, 2r] (raster order), the SAD is
//   sum_{i<bh, j<bw} |tracked[by*bh + mvy + oy - r + i][bx*bw + mvx + ox - r + j]
//                     - anchor[by*bh + i][bx*bw + j]|
// with tracked pixels outside the frame read as 0. Candidates whose window
// leaves the frame are invalid; the caller (ops/motion.py _refine_select)
// masks them. Exact int32 arithmetic: bit-equal to the TPU kernel.
//
// Bound: memory and latency. Each MV block reads its bh x bw anchor block
// and a (bh+2r) x (bw+2r) tracked window once; the (2r+1)^2 SADs re-read
// them from shared memory. Design: one warp per MV block (four per CTA, on
// neighbouring block columns so their rows share cache lines), both tiles
// staged in shared memory with the frame-edge zero fill done on load, each
// lane summing a strided share of the block's pixels per candidate and a
// shuffle reduction producing the SAD. The window is chosen per block from
// its own MV, so no padded or re-pitched copy of the frame is built (the TPU
// kernel's block-pitched q tensor has no counterpart here).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
refine_sads_kernel(const uint8_t* __restrict__ stack,
                   const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                   int fh, int fw, int bw, int bh, int r) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mfh = fh / bh;
  const int mfw = fw / bw;
  const int bx = blockIdx.x * kWarps + warp;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  if (bx >= mfw) return;  // whole warp leaves together: no shuffle hazard

  const int side = 2 * r + 1;
  const int ww = bw + 2 * r;
  const int wh = bh + 2 * r;
  const int area = bw * bh;
  uint8_t* anc = smem + warp * (area + wh * ww);
  uint8_t* win = anc + area;

  const uint8_t* tracked = stack + static_cast<size_t>(t) * fh * fw;
  const uint8_t* anchor = stack + static_cast<size_t>(t + 1) * fh * fw;
  const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
  const int mvx = m[0];
  const int mvy = m[1];
  const int ay0 = by * bh;
  const int ax0 = bx * bw;

  for (int p = lane; p < area; p += 32) {
    const int i = p / bw;
    const int j = p % bw;
    anc[p] = anchor[static_cast<size_t>(ay0 + i) * fw + ax0 + j];
  }
  const int wy0 = ay0 + mvy - r;
  const int wx0 = ax0 + mvx - r;
  for (int p = lane; p < wh * ww; p += 32) {
    const int y = wy0 + p / ww;
    const int x = wx0 + p % ww;
    win[p] = (y >= 0 && y < fh && x >= 0 && x < fw)
                 ? tracked[static_cast<size_t>(y) * fw + x]
                 : 0;
  }
  __syncwarp();

  const int ncand = side * side;
  for (int c = 0; c < ncand; ++c) {
    const int oy = c / side;
    const int ox = c % side;
    int s = 0;
    for (int p = lane; p < area; p += 32) {
      const int i = p / bw;
      const int j = p % bw;
      s += abs(static_cast<int>(win[(oy + i) * ww + ox + j]) -
               static_cast<int>(anc[p]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      out[((static_cast<size_t>(t) * ncand + c) * mfh + by) * mfw + bx] = s;
    }
  }
}

}  // namespace

// stack: (t_count + 1, fh, fw) uint8; mv: (t_count, fh/bh, fw/bw, 2) int32
// (x, y); out: (t_count, (2r+1)^2, fh/bh, fw/bw) int32. All contiguous.
SVC_EXPORT int svc_refine_sads(const void* stack, const void* mv, void* out,
                               int t_count, int fh, int fw, int bw, int bh,
                               int r, void* stream) {
  const int mfh = fh / bh;
  const int mfw = fw / bw;
  const int smem = kWarps * (bw * bh + (bh + 2 * r) * (bw + 2 * r));
  if (smem > kSvcDefaultSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((mfw + kWarps - 1) / kWarps, mfh, t_count);
  refine_sads_kernel<<<grid, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stack), static_cast<const int32_t*>(mv),
      static_cast<int32_t*>(out), fh, fw, bw, bh, r);
  return static_cast<int>(cudaGetLastError());
}
