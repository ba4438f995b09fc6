// K4 pyr_down_u8: one cv::pyrDown level of a batch of uint8 planes.
//
// Replaces svc_tpu/ops/pyramid_pallas.py pyr_down_mxu_pallas (:271) and
// pyr_down_pallas (:95), and the odd-size path of svc_tpu/ops/pyramid.py
// (_pyr_down_general, :92). The MXU band matrices of the TPU kernel are
// dropped: on this card the filter is integer adds.
//
// Computes out[y][x] = (sum_{a,b} t[a] t[b] in[r(2y-2+a)][r(2x-2+b)] + 128)
// >> 8 with taps t = {1, 4, 6, 4, 1} and r() = BORDER_REFLECT_101, for any
// input size (output (h+1)/2 x (w+1)/2). Integer arithmetic: bit-exact.
//
// Bound: memory. Each input byte is read once and a quarter byte written;
// the 25 multiply-adds per output are far below the card's integer rate.
// Design: one CTA per 16x64 output tile stages its (2*16+3) x (2*64+3)
// input tile, 2-pixel reflect-101 halo included, in shared memory with
// coalesced row reads, runs the horizontal 5-tap pass into a second shared
// tile, then the vertical pass straight to the output. The halo is re-read
// by the neighbouring CTA (about 10% extra reads) instead of exchanged.
#include "common.cuh"

namespace {

constexpr int kTileH = 16;  // output rows per CTA
constexpr int kTileW = 64;  // output columns per CTA
constexpr int kInH = 2 * kTileH + 3;
constexpr int kInW = 2 * kTileW + 3;
constexpr int kThreads = 256;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  // tail tiles ask for positions far past the edge whose outputs are never
  // stored; clamp them first so the reflection below stays a short loop
  i = min(max(i, -2), n + 1);
  while (i < 0 || i >= n) i = (i < 0) ? -i : 2 * n - 2 - i;
  return i;
}

__global__ void __launch_bounds__(kThreads)
pyr_down_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int h, int w, int oh, int ow) {
  __shared__ uint8_t tile[kInH][kInW + 1];
  __shared__ int hsum[kInH][kTileW];

  const int plane = blockIdx.z;
  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;
  const uint8_t* in = src + static_cast<size_t>(plane) * h * w;

  for (int idx = threadIdx.x; idx < kInH * kInW; idx += blockDim.x) {
    const int r = idx / kInW;
    const int c = idx % kInW;
    const int y = reflect101(iy0 + r, h);
    const int x = reflect101(ix0 + c, w);
    tile[r][c] = in[static_cast<size_t>(y) * w + x];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kInH * kTileW; idx += blockDim.x) {
    const int r = idx / kTileW;
    const int c = idx % kTileW;
    const uint8_t* p = &tile[r][2 * c];
    hsum[r][c] = p[0] + 4 * p[1] + 6 * p[2] + 4 * p[3] + p[4];
  }
  __syncthreads();

  uint8_t* out = dst + static_cast<size_t>(plane) * oh * ow;
  for (int idx = threadIdx.x; idx < kTileH * kTileW; idx += blockDim.x) {
    const int r = idx / kTileW;
    const int c = idx % kTileW;
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

}  // namespace

// src: (n, h, w) uint8, dst: (n, (h+1)/2, (w+1)/2) uint8, both contiguous.
SVC_EXPORT int svc_pyr_down_u8(const void* src, void* dst, int n, int h,
                               int w, void* stream) {
  const int oh = (h + 1) / 2;
  const int ow = (w + 1) / 2;
  const dim3 grid((ow + kTileW - 1) / kTileW, (oh + kTileH - 1) / kTileH, n);
  pyr_down_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), h, w, oh,
      ow);
  return static_cast<int>(cudaGetLastError());
}
