// Dequantize + inverse DCT of the codec's default transform block (8x8, 3
// channels), one block row of a strip of blocks at a time: the machinery
// the two specialised display kernels share, K1 (idct_display.cu) and K6
// (idct_resize.cu).
//
// A strip's block row is one contiguous run of coefficients in the wire
// layout (T, nby, nbx, 192); it arrives by cp.async into a shared-memory
// slot. Thread (pair g = block * 3 + channel, lane r) then dequantizes and
// transforms column r of its pair in place (column_stage), and after a
// barrier row r into registers (row_stage). Per element the arithmetic is
// idct_tile.cuh's (__fdiv_rn dequantize with half-away rounding, fmaf over
// k then over l, in ascending order), so the specialised kernels give the
// general ones' bits.
#pragma once

#include "idct_tile.cuh"

// coefficient slot: element (k, l) of pair g at g * kCoefGroup + k *
// kCoefPitch + l (column stage lanes along l, row stage 16-byte loads
// along k: both conflict-free)
constexpr int kCoefPitch = 12;
constexpr int kCoefGroup = 104;

struct Dct8f {
  float m[64];
};

// The DCT-II matrix from a HOST pointer, to pass to a kernel by value.
inline Dct8f dct8_from_host(const void* d) {
  Dct8f m;
  for (int i = 0; i < 64; ++i) m.m[i] = static_cast<const float*>(d)[i];
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Coefficients and steps of blocks [blk0, blk0 + nblk) (flat block index)
// into a slot, as one cp.async group per thread of a kThreads-thread CTA.
template <int kThreads>
__device__ __forceinline__ void fetch_block_row(
    const float* __restrict__ coeffs, const float* __restrict__ steps,
    size_t blk0, int nblk, float* slot, float* slot_steps) {
  const float* src = coeffs + blk0 * 192;
  for (int ch = threadIdx.x; ch < nblk * 48; ch += kThreads) {
    const int g = ch >> 4;          // 16 chunks of 4 floats per pair
    const int k = (ch & 15) >> 1;   // 2 chunks per coefficient row
    cp_async16(slot + g * kCoefGroup + k * kCoefPitch + (ch & 1) * 4,
               src + ch * 4);
  }
  if (threadIdx.x < nblk) {
    cp_async4(slot_steps + threadIdx.x, steps + blk0 + threadIdx.x);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Columns of pair g: dequantize + inverse transform of column r, in place.
__device__ __forceinline__ void column_stage(float* grp, float step,
                                             const Dct8f& d, int r) {
  float q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float y = __fdiv_rn(grp[k * kCoefPitch + r], step);
    const float mag = __fmul_rn(floorf(__fadd_rn(fabsf(y), 0.5f)), step);
    q[k] = copysignf(mag, y);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(q[k], d.m[k * 8 + i], acc);
    grp[i * kCoefPitch + r] = acc;
  }
}

// Rows of pair g: the 8 pixels of row r, j ascending, into px.
__device__ __forceinline__ void row_stage(const float* grp, const Dct8f& d,
                                          int r, float px[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(grp + r * kCoefPitch);
  const float4 hi = *reinterpret_cast<const float4*>(grp + r * kCoefPitch + 4);
  const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) acc = fmaf(a[l], d.m[l * 8 + j], acc);
    px[j] = acc;
  }
}
