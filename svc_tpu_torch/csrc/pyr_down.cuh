// One cv::pyrDown level of a batch of uint8 planes, templated on the input
// layout (planes.cuh): K4 reads dense planes, K8 column-pitched subplanes.
//
// Computes out[y][x] = (sum_{a,b} t[a] t[b] in[r(2y-2+a)][r(2x-2+b)] + 128)
// >> 8 with taps t = {1, 4, 6, 4, 1} and r() = BORDER_REFLECT_101, for any
// input size (output (h+1)/2 x (w+1)/2). Integer arithmetic: bit-exact.
//
// Bound: memory. Each input byte is read once and a quarter byte written;
// the multiply-adds per output are far below the card's integer rate.
// Design: one CTA per 16x64 output tile stages its (2*16+3) x (2*64+3)
// input tile, 2-pixel reflect-101 halo included, in shared memory, runs the
// horizontal 5-tap pass into a second shared tile, then the vertical pass
// straight to the output. The halo is re-read by the neighbouring CTA
// (about 10% extra reads) instead of exchanged.
#pragma once

#include "planes.cuh"

namespace {

constexpr int kPyrTileH = 16;  // output rows per CTA
constexpr int kPyrTileW = 64;  // output columns per CTA
constexpr int kPyrInH = 2 * kPyrTileH + 3;
constexpr int kPyrInW = 2 * kPyrTileW + 3;
constexpr int kPyrThreads = 256;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  // tail tiles ask for positions far past the edge whose outputs are never
  // stored; clamp them first so the reflection below stays a short loop
  i = min(max(i, -2), n + 1);
  while (i < 0 || i >= n) i = (i < 0) ? -i : 2 * n - 2 - i;
  return i;
}

template <class Planes>
__global__ void __launch_bounds__(kPyrThreads)
pyr_down_kernel(Planes src, uint8_t* __restrict__ dst, int h, int w, int oh,
                int ow) {
  __shared__ uint8_t tile[kPyrInH][kPyrInW + 1];
  __shared__ int hsum[kPyrInH][kPyrTileW];

  const int plane = blockIdx.z;
  const int oy0 = blockIdx.y * kPyrTileH;
  const int ox0 = blockIdx.x * kPyrTileW;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;

  for (int idx = threadIdx.x; idx < kPyrInH * kPyrInW; idx += blockDim.x) {
    const int r = idx / kPyrInW;
    const int c = idx % kPyrInW;
    tile[r][c] = src.at(plane, reflect101(iy0 + r, h), reflect101(ix0 + c, w));
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kPyrInH * kPyrTileW; idx += blockDim.x) {
    const int r = idx / kPyrTileW;
    const int c = idx % kPyrTileW;
    const uint8_t* p = &tile[r][2 * c];
    hsum[r][c] = p[0] + 4 * p[1] + 6 * p[2] + 4 * p[3] + p[4];
  }
  __syncthreads();

  uint8_t* out = dst + static_cast<size_t>(plane) * oh * ow;
  for (int idx = threadIdx.x; idx < kPyrTileH * kPyrTileW; idx += blockDim.x) {
    const int r = idx / kPyrTileW;
    const int c = idx % kPyrTileW;
    const int oy = oy0 + r;
    const int ox = ox0 + c;
    if (oy < oh && ox < ow) {
      const int s = hsum[2 * r][c] + 4 * hsum[2 * r + 1][c] +
                    6 * hsum[2 * r + 2][c] + 4 * hsum[2 * r + 3][c] +
                    hsum[2 * r + 4][c];
      out[static_cast<size_t>(oy) * ow + ox] =
          static_cast<uint8_t>((s + 128) >> 8);
    }
  }
}

// n planes of h x w read through src; dst: (n, (h+1)/2, (w+1)/2) uint8.
template <class Planes>
int launch_pyr_down(Planes src, void* dst, int n, int h, int w, void* stream) {
  const int oh = (h + 1) / 2;
  const int ow = (w + 1) / 2;
  const dim3 grid((ow + kPyrTileW - 1) / kPyrTileW,
                  (oh + kPyrTileH - 1) / kPyrTileH, n);
  pyr_down_kernel<Planes>
      <<<grid, kPyrThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          src, static_cast<uint8_t*>(dst), h, w, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
