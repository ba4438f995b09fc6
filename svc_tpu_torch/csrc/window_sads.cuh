// The candidate-SAD kernel behind the general kernels of K3, K7, K8
// (refine) and K9, templated on the plane layout and the output type.
//
// For MV block (by, bx) of frame t with rounded MV (mvx, mvy) and candidate
// (oy, ox) in [0, 2r] x [0, 2r] (raster order), the SAD is
//   sum_{i<bh, j<bw} |trk(t, by*bh + mvy + oy - r + i, bx*bw + mvx + ox - r + j)
//                     - anc(t + anchor_offset, by*bh + i, bx*bw + j)|
// with tracked pixels outside the frame read as 0. Candidates whose window
// leaves the frame are invalid; callers mask them. Exact integer sums, so
// an int32 and a float32 store (< 2^24 for blocks up to 256 x 256) are both
// exact.
//
// Bound: memory and latency. Each MV block reads its bh x bw anchor block
// and a (bh+2r) x (bw+2r) tracked window once; the (2r+1)^2 SADs re-read
// them from shared memory. Design: one warp per MV block (four per CTA, on
// neighbouring block columns so their rows share cache lines), both tiles
// staged in shared memory with the frame-edge zero fill done on load, each
// lane summing a strided share of the block's pixels per candidate and a
// shuffle reduction producing the SAD. The window is placed per block from
// its own MV, so MVs need no bound and no padded or re-pitched copy of the
// frame is built.
#pragma once

#include "planes.cuh"

namespace {

constexpr int kSadWarps = 4;

template <class Planes, class Out>
__global__ void __launch_bounds__(kSadWarps * 32)
window_sads_kernel(Planes trk, Planes anc, int anchor_offset,
                   const int32_t* __restrict__ mv, Out* __restrict__ out,
                   int fh, int fw, int bw, int bh, int r) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mfh = fh / bh;
  const int mfw = fw / bw;
  const int bx = blockIdx.x * kSadWarps + warp;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  if (bx >= mfw) return;  // whole warp leaves together: no shuffle hazard

  const int side = 2 * r + 1;
  const int ww = bw + 2 * r;
  const int wh = bh + 2 * r;
  const int area = bw * bh;
  uint8_t* a_tile = smem + warp * (area + wh * ww);
  uint8_t* w_tile = a_tile + area;

  const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
  const int mvx = m[0];
  const int mvy = m[1];
  const int ay0 = by * bh;
  const int ax0 = bx * bw;

  for (int p = lane; p < area; p += 32) {
    a_tile[p] = anc.at(t + anchor_offset, ay0 + p / bw, ax0 + p % bw);
  }
  const int wy0 = ay0 + mvy - r;
  const int wx0 = ax0 + mvx - r;
  for (int p = lane; p < wh * ww; p += 32) {
    const int y = wy0 + p / ww;
    const int x = wx0 + p % ww;
    w_tile[p] = (y >= 0 && y < fh && x >= 0 && x < fw) ? trk.at(t, y, x) : 0;
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
      s += abs(static_cast<int>(w_tile[(oy + i) * ww + ox + j]) -
               static_cast<int>(a_tile[p]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      out[((static_cast<size_t>(t) * ncand + c) * mfh + by) * mfw + bx] =
          static_cast<Out>(s);
    }
  }
}

// mv: (t_count, fh/bh, fw/bw, 2) int32 (x, y); out: (t_count, (2r+1)^2,
// fh/bh, fw/bw) of Out. Refuses (cudaErrorInvalidValue) a window that does
// not fit the default shared memory.
template <class Planes, class Out>
int launch_window_sads(Planes trk, Planes anc, int anchor_offset,
                       const void* mv, void* out, int t_count, int fh, int fw,
                       int bw, int bh, int r, void* stream) {
  const int mfh = fh / bh;
  const int mfw = fw / bw;
  const long long smem =
      static_cast<long long>(kSadWarps) *
      (bw * bh + static_cast<long long>(bh + 2 * r) * (bw + 2 * r));
  if (smem > kSvcDefaultSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((mfw + kSadWarps - 1) / kSadWarps, mfh, t_count);
  window_sads_kernel<Planes, Out>
      <<<grid, kSadWarps * 32, static_cast<int>(smem),
         static_cast<cudaStream_t>(stream)>>>(
          trk, anc, anchor_offset, static_cast<const int32_t*>(mv),
          static_cast<Out*>(out), fh, fw, bw, bh, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
