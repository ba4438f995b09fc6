// Device helpers shared by the two K5 Lloyd kernels (lloyd.cu, the
// cluster kernel; lloyd_general.cu, one CTA per (frame, attempt)): the
// first-wins assignment with each operation rounded on its own, and the
// fixed-tree block reductions that keep two runs bit-identical.
#pragma once

#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxK = 16;  // clusters
constexpr int kMaxD = 7;   // features
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kOffMask = 0xff;  // label byte of a point off the mask

// First-wins argmin over the k centers cen[j * kMaxD + d]: the label and
// its squared distance (__fsub_rn / __fmul_rn / __fadd_rn, d ascending: an
// FMA would flip near-tie labels against the plain version).
__device__ __forceinline__ int nearest(const float (&xv)[kMaxD],
                                       const float* cen, int k, int d,
                                       float& best) {
  int lab = 0;
  for (int j = 0; j < k; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i < d) {
        const float diff = __fsub_rn(xv[i], cen[j * kMaxD + i]);
        const float sq = __fmul_rn(diff, diff);
        acc = i == 0 ? sq : __fadd_rn(acc, sq);
      }
    }
    if (j == 0 || acc < best) {
      best = acc;
      lab = j;
    }
  }
  return lab;
}

// nearest() for P points at once: each center is read once for all P,
// and the P dependency chains interleave.
template <int P>
__device__ __forceinline__ void nearest_n(const float (&xv)[P][kMaxD],
                                          const float* cen, int k, int d,
                                          float (&best)[P], int (&lab)[P]) {
  for (int j = 0; j < k; ++j) {
    float c[kMaxD];
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) c[i] = i < d ? cen[j * kMaxD + i] : 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) {
        if (i < d) {
          const float diff = __fsub_rn(xv[q][i], c[i]);
          const float sq = __fmul_rn(diff, diff);
          acc = i == 0 ? sq : __fadd_rn(acc, sq);
        }
      }
      if (j == 0 || acc < best[q]) {
        best[q] = acc;
        lab[q] = j;
      }
    }
  }
}

// The larger of two (value, index) pairs, the lower index among equals.
__device__ __forceinline__ void keep_larger(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide maximum of (v, i) pairs, the lowest index among equal maxima;
// every thread receives the pair.
template <int kWarps>
__device__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    keep_larger(v, i, __shfl_down_sync(kFull, v, off),
                __shfl_down_sync(kFull, i, off));
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -FLT_MAX;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      keep_larger(v, i, __shfl_down_sync(kFull, v, off),
                  __shfl_down_sync(kFull, i, off));
    }
    if (lane == 0) {
      red_v[kWarps] = v;
      red_i[kWarps] = i;
    }
  }
  __syncthreads();
  v = red_v[kWarps];
  i = red_i[kWarps];
}

// Block-wide sum in double over a fixed tree; every thread receives it.
template <int kWarps>
__device__ double block_sum(double v, double* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

}  // namespace
