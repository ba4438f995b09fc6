// Dequantize + inverse DCT of a tile of transform blocks into pixel planes
// in shared memory: the first half of the decoder's display kernels, K1
// (idct_display.cu) and K6 (idct_resize.cu).
//
// Per element, in this order (all IEEE float32, no fast-math):
//   dequant  q = copysign(floor(|c / s| + 0.5) * s, c / s)   (C std::round,
//            half away from zero, true division — quant.py:19-31)
//   rows     a[i][l] = sum_k q[k][l] * dh[k][i]             (k ascending)
//   cols     p[i][j] = sum_l a[i][l] * dw[l][j]             (l ascending)
#pragma once

#include "common.cuh"

// Block rows [br0, br0 + rows) x block columns [bc0, bc0 + cols) of frame
// t, all `channels`, into planes[c][r * bh + i][b * bw + j] (row pitch
// cols * bw). Blocks past the frame read as zero coefficients. `planes` and
// `scratch` each hold rows * cols * channels * bh * bw floats. Every thread
// of the block calls it; it ends with __syncthreads().
__device__ __forceinline__ void idct_tile(
    const float* __restrict__ coeffs, const float* __restrict__ steps,
    const float* __restrict__ dh, const float* __restrict__ dw, int t,
    int nby, int nbx, int br0, int rows, int bc0, int cols, int channels,
    int bh, int bw, float* planes, float* scratch) {
  const int n = bh * bw;
  const int cn = channels * n;
  const int per = rows * cols * cn;

  // 1. load + dequantize, block layout planes[rb][blk][c][k][l]
  for (int idx = threadIdx.x; idx < per; idx += blockDim.x) {
    const int rb = idx / (cols * cn);
    const int blk = (idx / cn) % cols;
    const int e = idx % cn;
    const int br = br0 + rb;
    const int bc = bc0 + blk;
    float v = 0.f;
    if (br < nby && bc < nbx) {
      const size_t b = (static_cast<size_t>(t) * nby + br) * nbx + bc;
      const float s = steps[b];
      const float y = __fdiv_rn(coeffs[b * cn + e], s);
      const float mag = __fmul_rn(floorf(__fadd_rn(fabsf(y), 0.5f)), s);
      v = copysignf(mag, y);
    }
    planes[idx] = v;
  }
  __syncthreads();

  // 2. rows stage: scratch[rb][blk][c][i][l] = sum_k q[k][l] * dh[k][i]
  for (int idx = threadIdx.x; idx < per; idx += blockDim.x) {
    const int e = idx % n;
    const int i = e / bw;
    const int l = e % bw;
    const float* q = planes + (idx - e) + l;  // q[k][l] at q[k * bw]
    float acc = 0.f;
    for (int k = 0; k < bh; ++k) acc = fmaf(q[k * bw], dh[k * bh + i], acc);
    scratch[idx] = acc;
  }
  __syncthreads();

  // 3. cols stage into planes[c][rb * bh + i][blk * bw + j]
  const int pitch = cols * bw;
  const int plane_rows = rows * bh;
  for (int idx = threadIdx.x; idx < per; idx += blockDim.x) {
    const int j = idx % bw;
    const int i = (idx / bw) % bh;
    const int c = (idx / n) % channels;
    const int blk = (idx / cn) % cols;
    const int rb = idx / (cols * cn);
    const float* arow = scratch + (idx - j);  // a[i][0]
    float acc = 0.f;
    for (int l = 0; l < bw; ++l) acc = fmaf(arow[l], dw[l * bw + j], acc);
    planes[(c * plane_rows + rb * bh + i) * pitch + blk * bw + j] = acc;
  }
  __syncthreads();
}

// Bilinear blend a * (1 - f) + b * f, each operation rounded on its own
// (an FMA would differ from the plain version's separate products).
__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

// Display byte: round half to even (like torch.round), clip to [0, 255].
__device__ __forceinline__ uint8_t display_byte(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}
