// Dequantize + inverse DCT of transform blocks of BH rows and BW columns
// (BH, BW in {4, 8, 16}; K1 also a side of 1 or 2), one block row of a
// strip of blocks at a time: the machinery the two templated display
// kernels share, K1 (idct_display_sq.cu) and K6 (idct_resize_sq.cu).
//
// A strip's block row is one contiguous run of coefficients in the wire
// layout (T, nby, nbx, 3 * BH * BW); it arrives by cp.async into a
// shared-memory slot whose pair g (block * 3 + channel) holds element (k,
// l) at g * kGroup + k * kPitch + l, padded per shape by each kernel
// against bank conflicts. Thread (pair g, column r) then dequantizes and
// transforms column r of its pair in place (sq_column_stage); each kernel
// forms the rows itself. Per element the arithmetic is idct_tile.cuh's
// (__fdiv_rn dequantize with half-away rounding, fmaf over k then over l,
// in ascending order), so the templated kernels give the general ones'
// bits.
#pragma once

#include "idct8x8.cuh"

// The two DCT matrices, passed to a kernel by value; a square carries one.
template <int BH, int BW>
struct DctF {
  float h[BH * BH];
  float w[BW * BW];
};
template <int B>
struct DctF<B, B> {
  float h[B * B];
};

// The matrices from HOST pointers to the (BH, BH) and (BW, BW) float32
// DCT-II matrices (a square reads dh only).
template <int BH, int BW>
inline DctF<BH, BW> dct_from_host(const void* dh, const void* dw) {
  DctF<BH, BW> m;
  for (int i = 0; i < BH * BH; ++i) m.h[i] = static_cast<const float*>(dh)[i];
  if constexpr (BH != BW) {
    for (int i = 0; i < BW * BW; ++i) m.w[i] = static_cast<const float*>(dw)[i];
  }
  return m;
}

// Entry i of the (BW, BW) matrix.
template <int BH, int BW>
__device__ __forceinline__ float dw_at(const DctF<BH, BW>& d, int i) {
  if constexpr (BH == BW) {
    return d.h[i];
  } else {
    return d.w[i];
  }
}

// Coefficients and steps of blocks [blk0, blk0 + nblk) (flat block index)
// into a slot, as one cp.async group per thread of a kThreads-thread CTA.
// At BW = 2 a 16-byte chunk holds two coefficient rows, so a pair's rows
// are contiguous in the slot (kPitch = 2).
template <int BH, int BW, int kPitch, int kGroup, int kThreads>
__device__ __forceinline__ void fetch_sq_row(const float* __restrict__ coeffs,
                                             const float* __restrict__ steps,
                                             size_t blk0, int nblk,
                                             float* slot, float* slot_steps) {
  constexpr int kPairChunks = BH * BW / 4;  // 16-byte chunks of a pair
  const float* src = coeffs + blk0 * (3 * BH * BW);
  for (int ch = threadIdx.x; ch < nblk * 3 * kPairChunks; ch += kThreads) {
    const int g = ch / kPairChunks;
    const int e = ch & (kPairChunks - 1);
    if constexpr (BW >= 4) {
      constexpr int kRowChunks = BW / 4;  // of a coefficient row
      cp_async16(slot + g * kGroup + (e / kRowChunks) * kPitch +
                     (e & (kRowChunks - 1)) * 4,
                 src + ch * 4);
    } else {
      static_assert(BW == 2 && kPitch == 2 && kGroup % 4 == 0,
                    "two contiguous rows a chunk");
      cp_async16(slot + g * kGroup + e * 4, src + ch * 4);
    }
  }
  if (threadIdx.x < nblk) {
    cp_async4(slot_steps + threadIdx.x, steps + blk0 + threadIdx.x);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Columns of pair g: dequantize + inverse transform of column r, in place.
template <int BH, int BW, int kPitch>
__device__ __forceinline__ void sq_column_stage(float* grp, float step,
                                                const DctF<BH, BW>& d, int r) {
  float q[BH];
#pragma unroll
  for (int k = 0; k < BH; ++k) {
    const float y = __fdiv_rn(grp[k * kPitch + r], step);
    const float mag = __fmul_rn(floorf(__fadd_rn(fabsf(y), 0.5f)), step);
    q[k] = copysignf(mag, y);
  }
#pragma unroll
  for (int i = 0; i < BH; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < BH; ++k) acc = fmaf(q[k], d.h[k * BH + i], acc);
    grp[i * kPitch + r] = acc;
  }
}
