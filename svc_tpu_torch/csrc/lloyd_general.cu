// K5 lloyd_general: every Lloyd attempt of every frame of an encode batch
// with the default config's global_farthest empty-cluster repair —
// assignment, centers update, repair, epsilon freeze with a real early
// exit — then the final assignment and compactness. One CTA per (frame,
// attempt): the kernel for the sizes whose slice does not fit the cluster
// kernel's shared memory (lloyd.cu), and the yardstick it is held against.
//
// Replaces svc_tpu/ops/kmeans_pallas.py lloyd_pallas_batched (:485, body
// _make_lloyd_batched_kernel :300) and its per-frame twin lloyd_pallas
// (:216). Same algorithm as svc_tpu/ops/kmeans.py _lloyd_attempt
// (:168-271, repair="global_farthest") and as lloyd_plain in
// svc_tpu_torch/ops/kmeans.py, which the results equal bit for bit.
//
// Per (frame, attempt), per iteration, in this order:
//   assign  d2[j] = sum_d (x_d - c_jd)^2, d ascending, each operation
//           rounded on its own (lloyd.cuh nearest); the label is the first
//           j of the minimum; pd2 = max(d2, 0) is parked for valid points
//           and -1 for invalid ones
//   update  counts and per-cluster sums of the valid points, summed in
//           double and rounded once to float (exact for integer-valued
//           features at any frame size; a float sum passes 2^24 at 4K);
//           new = __fdiv_rn(sum, max(count, 1))
//   repair  the r-th empty cluster (by index) takes the coordinates of the
//           r-th farthest valid point: sequential argmaxes over the parked
//           pre-update distances, ties to the lowest index, each taken
//           point set to -1
//   freeze  shift2 = max_j sum_d (new - c)^2; the update that sets done
//           still applies, and a done attempt stops iterating
// then labels of every point, centers, and compactness = sum of the valid
// points' pd2 in double, rounded once.
//
// Bound: latency of a small iterative problem, not bandwidth. A batch of 8
// frames x 3 attempts is 24 CTAs; each sweeps its frame's points a few
// times per iteration, from L2. Design: centers, candidates, counts and the
// done flag in shared memory; the current labels as one byte per point in
// dynamic shared memory; parked distances in a global scratch of A*F*N
// floats. One warp sums one cluster (k <= 16 warps), and every reduction
// runs over a fixed thread partition and a fixed shuffle tree, so two runs
// give the same bits.
#include "lloyd.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= kMaxK, "one warp per cluster in the sums stage");

__device__ __forceinline__ void load_point(const float* xf, int n, int d,
                                           int p, float (&xv)[kMaxD]) {
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) {
    xv[i] = i < d ? xf[static_cast<size_t>(i) * n + p] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
lloyd_general_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ init,
                     int32_t* __restrict__ labels,
                     float* __restrict__ centers, float* __restrict__ compact,
                     float* scratch, int n_frames, int n, int d, int k,
                     int max_iter, float eps2) {
  extern __shared__ uint8_t s_lab[];  // (n,) this iteration's labels
  __shared__ float s_cen[kMaxK * kMaxD];
  __shared__ float s_cand[kMaxK * kMaxD];
  __shared__ int s_cnt[kMaxK];
  __shared__ int s_rank[kMaxK];  // rank among the empty clusters, or -1
  __shared__ int s_far[kMaxK];
  __shared__ int s_n_empty;
  __shared__ int s_done;
  __shared__ float s_red_v[kWarps + 1];
  __shared__ int s_red_i[kWarps + 1];
  __shared__ double s_red_d[kWarps + 1];

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t fa = static_cast<size_t>(blockIdx.y) * n_frames + f;
  const float* xf = x + static_cast<size_t>(f) * d * n;
  const uint8_t* mf = mask + static_cast<size_t>(f) * n;
  // parked distances; written and re-read inside this CTA, so plain
  // (coherent) loads, never the read-only path
  float* park = scratch + fa * n;
  const int kd = k * d;

  if (tid < kd) s_cen[(tid / d) * kMaxD + tid % d] = init[fa * kd + tid];
  if (tid == 0) s_done = 0;
  __syncthreads();

  for (int it = 0; it < max_iter && !s_done; ++it) {
    // 1. assignment; park each point's distance for the repair
    for (int p = tid; p < n; p += kThreads) {
      float xv[kMaxD];
      load_point(xf, n, d, p, xv);
      float best = 0.f;
      const int lab = nearest(xv, s_cen, k, d, best);
      const bool valid = mf[p] != 0;
      s_lab[p] = valid ? static_cast<uint8_t>(lab) : kOffMask;
      park[p] = valid ? fmaxf(best, 0.f) : -1.f;
    }
    __syncthreads();

    // 2. counts and sums: warp j sums cluster j (lane-strided, then a
    //    fixed shuffle tree), in double; new center = sum / max(count, 1)
    if (warp < k) {
      double acc[kMaxD];
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) acc[i] = 0.0;
      int cnt = 0;
      for (int p = lane; p < n; p += 32) {
        if (s_lab[p] == warp) {
          ++cnt;
#pragma unroll
          for (int i = 0; i < kMaxD; ++i) {
            if (i < d) acc[i] += static_cast<double>(xf[static_cast<size_t>(i) * n + p]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_down_sync(kFull, cnt, off);
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) acc[i] += __shfl_down_sync(kFull, acc[i], off);
      }
      if (lane == 0) {
        s_cnt[warp] = cnt;
        const float denom = static_cast<float>(max(cnt, 1));
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) {
          if (i < d) {
            s_cand[warp * kMaxD + i] = __fdiv_rn(__double2float_rn(acc[i]), denom);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int e = 0;
      for (int j = 0; j < k; ++j) s_rank[j] = s_cnt[j] == 0 ? e++ : -1;
      s_n_empty = e;
    }
    __syncthreads();

    // 3. global_farthest repair: the r-th farthest valid point, r < the
    //    number of empty clusters (usually none)
    const int n_empty = s_n_empty;
    for (int r = 0; r < n_empty; ++r) {
      float v = -FLT_MAX;
      int i = INT_MAX;
      for (int p = tid; p < n; p += kThreads) {
        const float q = park[p];
        if (q > v) {
          v = q;
          i = p;
        }
      }
      block_argmax<kWarps>(v, i, s_red_v, s_red_i);
      if (tid == 0) {
        s_far[r] = i;
        park[i] = -1.f;
      }
      __syncthreads();
    }
    if (n_empty > 0 && tid < kd) {
      const int j = tid / d;
      const int i = tid % d;
      if (s_rank[j] >= 0) {
        s_cand[j * kMaxD + i] = xf[static_cast<size_t>(i) * n + s_far[s_rank[j]]];
      }
    }
    __syncthreads();

    // 4. shift and freeze; the update that sets done still applies
    if (tid == 0) {
      float shift2 = 0.f;
      for (int j = 0; j < k; ++j) {
        float s = 0.f;
        for (int i = 0; i < d; ++i) {
          const float diff = __fsub_rn(s_cand[j * kMaxD + i], s_cen[j * kMaxD + i]);
          const float sq = __fmul_rn(diff, diff);
          s = i == 0 ? sq : __fadd_rn(s, sq);
        }
        shift2 = j == 0 ? s : fmaxf(shift2, s);
      }
      s_done = shift2 <= eps2;
    }
    __syncthreads();
    if (tid < kd) {
      const int c = (tid / d) * kMaxD + tid % d;
      s_cen[c] = s_cand[c];
    }
    __syncthreads();
  }

  // final assignment: labels of every point, compactness of the valid ones
  int32_t* lab_out = labels + fa * n;
  double part = 0.0;
  for (int p = tid; p < n; p += kThreads) {
    float xv[kMaxD];
    load_point(xf, n, d, p, xv);
    float best = 0.f;
    lab_out[p] = nearest(xv, s_cen, k, d, best);
    if (mf[p]) part += static_cast<double>(fmaxf(best, 0.f));
  }
  const double total = block_sum<kWarps>(part, s_red_d);
  if (tid == 0) compact[fa] = __double2float_rn(total);
  if (tid < kd) centers[fa * kd + tid] = s_cen[(tid / d) * kMaxD + tid % d];
}

}  // namespace

// x: (n_frames, d, n) float32 features; mask: (n_frames, n) uint8 validity;
// init: (n_attempts, n_frames, k, d) float32 seeds; labels: (n_attempts,
// n_frames, n) int32; centers: like init; compact: (n_attempts, n_frames)
// float32; scratch: (n_attempts, n_frames, n) float32. eps2 is the squared
// stop threshold.
SVC_EXPORT int svc_lloyd_general(const void* x, const void* mask,
                                 const void* init, void* labels,
                                 void* centers, void* compact, void* scratch,
                                 int n_attempts, int n_frames, int n, int d,
                                 int k, int max_iter,
                                 float eps2,
                                 void* stream) {
  if (k < 1 || k > kMaxK || d < 1 || d > kMaxD || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (n + 15) / 16 * 16;
  // set on every call: the static part also counts against the default
  // 48 KB, and an earlier call's limit must not decide this one
  const cudaError_t e = cudaFuncSetAttribute(
      lloyd_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_frames, n_attempts);
  lloyd_general_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(init), static_cast<int32_t*>(labels),
      static_cast<float*>(centers), static_cast<float*>(compact),
      static_cast<float*>(scratch), n_frames, n, d, k, max_iter,
      eps2);
  return static_cast<int>(cudaGetLastError());
}
