// Dequantize + inverse DCT of transform blocks of BH rows and BW columns
// (BH, BW in {1, 2, 4, 8, 16}), one walk step of a strip of blocks at a
// time: the machinery the two templated display kernels share, K1
// (idct_display_sq.cu) and K6 (idct_resize_sq.cu).
//
// A strip's block row is one contiguous run of coefficients in the wire
// layout (T, nby, nbx, 3 * BH * BW); a walk step is kStep block rows (one,
// or 8 / BH where a side is 1 or 2), whose runs arrive by cp.async into a
// shared-memory slot (fetch_step) whose pair g (block * 3 + channel) holds
// element (k, l) of block row m at g * kGroup + (m * BH + k) * kPitch + l,
// padded per shape by each kernel against bank conflicts: the step's rows
// stand as those of one (kStep * BH) x BW block. Thread (pair g, column r)
// then dequantizes and transforms column r of its pair in place, block row
// by block row (sq_step_columns); each kernel forms the rows itself. Per
// element the arithmetic is idct_tile.cuh's (__fdiv_rn dequantize with
// half-away rounding, fmaf over k then over l, in ascending order), so the
// templated kernels give the general ones' bits.
//
// A slot row of steps holds kBlocks blocks (K1 its strip, K6 its strip and
// the halo block); nblk of them are in the frame.
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

// At BW = 1, a pair's S slot rows (one slot column) from its group into
// v: float4s where the pair stride is a multiple of 4, else floats.
template <int S, int kGroup>
__device__ __forceinline__ void load_column(const float* grp, float* v) {
  if constexpr (kGroup % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(grp + 4 * q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = grp[i];
  }
}

// load_column's inverse.
template <int S, int kGroup>
__device__ __forceinline__ void store_column(float* grp, const float* v) {
  if constexpr (kGroup % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      *reinterpret_cast<float4*>(grp + 4 * q) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) grp[i] = v[i];
  }
}

template <int W>
__device__ __forceinline__ void cp_async_floats(float* smem, const float* gmem) {
  if constexpr (W == 4) {
    cp_async16(smem, gmem);
  } else if constexpr (W == 2) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    cp_async4(smem, gmem);
  }
}

// A side of 1: step b's runs (a block row's is nblk * 3 * BH * BW floats,
// 1 to 16 a block) and steps into a slot in one pass, kW floats a copy
// (16-byte copies where a pair is whole 4-float chunks), each to the slot
// place of its (pair, row, column): one cp.async group. A copy never
// crosses a pair, so every copy is aligned to its size wherever the run
// starts.
template <int BH, int BW, int kStep, int kBlocks, int kPitch, int kGroup,
          int kThreads>
__device__ __forceinline__ void fetch_side_1(const float* __restrict__ coeffs,
                                             const float* __restrict__ steps,
                                             size_t blk_row0, int b, int nby,
                                             int nbx, int nblk, float* slot,
                                             float* slot_steps) {
  constexpr int kPair = BH * BW;              // floats of a pair
  constexpr int kW = kPair < 4 ? kPair : 4;   // floats a copy
  constexpr int kCopies = kBlocks * 3 * kPair / kW;  // a whole run
  const int n = nblk * 3 * kPair / kW;        // this strip's, a run
  // the step's block rows in the frame, and its first block row's run
  // and steps
  const int rows = kStep == 1 ? 1 : min(kStep, nby - b * kStep);
  const size_t blk0 = blk_row0 + static_cast<size_t>(b) * kStep * nbx;
  const float* run = coeffs + blk0 * (3 * kPair);
  for (int c = threadIdx.x; c < kStep * kCopies; c += kThreads) {
    const int m = c / kCopies;
    const int e = c - m * kCopies;
    if (e < n && m < rows) {
      const int g = e * kW / kPair;
      const int w = e * kW - g * kPair;  // (row, column) w / BW, w % BW
      cp_async_floats<kW>(
          slot + g * kGroup + (m * BH + w / BW) * kPitch + w % BW,
          run + m * nbx * (3 * kPair) + e * kW);
    }
  }
  for (int e = threadIdx.x; e < kStep * kBlocks; e += kThreads) {
    const int m = e / kBlocks;
    const int blk = e - m * kBlocks;
    if (blk < nblk && m < rows) {
      cp_async4(slot_steps + e, steps + blk0 + m * nbx + blk);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The coefficients and steps of step b's block rows (those below nby)
// into a slot: at a side of 1 in one pass, else block row by block row.
template <int BH, int BW, int kStep, int kBlocks, int kPitch, int kGroup,
          int kThreads>
__device__ __forceinline__ void fetch_step(const float* __restrict__ coeffs,
                                           const float* __restrict__ steps,
                                           size_t blk_row0, int b, int nby,
                                           int nbx, int nblk, float* slot,
                                           float* slot_steps) {
  if constexpr (BH == 1 || BW == 1) {
    fetch_side_1<BH, BW, kStep, kBlocks, kPitch, kGroup, kThreads>(
        coeffs, steps, blk_row0, b, nby, nbx, nblk, slot, slot_steps);
  } else {
#pragma unroll
    for (int m = 0; m < kStep; ++m) {
      const int by = b * kStep + m;
      if (kStep == 1 || by < nby) {
        fetch_sq_row<BH, BW, kPitch, kGroup, kThreads>(
            coeffs, steps, blk_row0 + static_cast<size_t>(by) * nbx, nblk,
            slot + m * BH * kPitch, slot_steps + m * kBlocks);
      }
    }
  }
}

// The column stage of a slot's kStep block rows: column r of pair g, whose
// group grp points at (at BW = 1 the pair's kStep * BH rows read and
// written at once, transformed in registers), with the steps of its block
// blk.
template <int BH, int BW, int kStep, int kBlocks, int kPitch, int kGroup>
__device__ __forceinline__ void sq_step_columns(float* grp,
                                                const float* slot_steps,
                                                const DctF<BH, BW>& d, int blk,
                                                int r) {
  if constexpr (BW == 1) {
    constexpr int kS = kStep * BH;
    float v[kS];
    load_column<kS, kGroup>(grp, v);
#pragma unroll
    for (int m = 0; m < kStep; ++m) {
      sq_column_stage<BH, 1, 1>(v + m * BH, slot_steps[m * kBlocks + blk], d,
                                0);
    }
    store_column<kS, kGroup>(grp, v);
  } else {
#pragma unroll
    for (int m = 0; m < kStep; ++m) {
      sq_column_stage<BH, BW, kPitch>(grp + m * BH * kPitch,
                                      slot_steps[m * kBlocks + blk], d, r);
    }
  }
}
