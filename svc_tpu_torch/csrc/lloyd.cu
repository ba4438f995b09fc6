// K5 lloyd: every Lloyd attempt of every frame of an encode batch with the
// default config's global_farthest empty-cluster repair, on one thread
// block cluster of 8 CTAs per (frame, attempt).
//
// Replaces svc_tpu/ops/kmeans_pallas.py lloyd_pallas_batched (:485, body
// _make_lloyd_batched_kernel :300) and lloyd_pallas (:216). The algorithm
// and its order of operations are lloyd_general.cu's (first-wins argmin
// with each operation rounded on its own; double sums rounded once;
// __fdiv_rn centers; the r-th empty cluster takes the r-th farthest valid
// point, ties to the lowest point index; the previous-done freeze), and
// lloyd_plain's in svc_tpu_torch/ops/kmeans.py. ops/kmeans.py takes this
// kernel whenever a slice fits shared memory and lloyd_general.cu
// otherwise.
//
// Bound: latency of ~10 dependent iterations over a few thousand points.
// The general kernel runs one CTA per (frame, attempt) — 24 CTAs on 132
// SMs at batch 8 — re-reads the features from L2 every pass, sums each
// cluster with one warp scanning every label of the frame, and leaves
// serial loops to thread 0. Design:
//   - one cluster of kCluster CTAs per (frame, attempt): 192 CTAs at batch
//     8. CTA `rank` owns the contiguous slice [rank * S, (rank + 1) * S) of
//     the frame's points (S = ceil(N / kCluster); a slice may be empty);
//   - the slice's features are staged once into shared memory, beside its
//     labels (one byte each) and parked distances: nothing per iteration
//     goes to global memory;
//   - assignment: two points per thread at a time, each center read once
//     for both and the two dependency chains interleaved;
//   - sums: thread (j = tid % 16, q = tid / 16) scans the label words
//     q, q + 32, q + 64, ... of the slice (four labels a word; neighbouring
//     q on neighbouring words, so no bank conflicts) for cluster j, in
//     point order; chunk pairs meet by one xor shuffle, warps in warp
//     order. Every warp is busy (each holds all 16 j). A CTA whose slice
//     holds only integers of magnitude <= 2^20 (the encoder's MVs and
//     block coordinates) sums them exactly in int32 — the value of the
//     double sum in any order — and every other slice in double: the
//     per-point float-to-double conversions and dependent double adds set
//     the scan's pace, and the int path halves it;
//   - the encoder's D = 4 is a compile-time instance (every feature loop
//     unrolled without predicates); other D read it at run time;
//   - the CTAs' partials meet through distributed shared memory: after
//     one cluster.sync every CTA sums the kCluster partials in rank order
//     and computes the same new centers, so nothing is broadcast. Partials
//     are double-buffered by iteration parity, so one cluster.sync per
//     iteration suffices;
//   - repair round r: each CTA's argmax of its parked distances, one
//     cluster.sync, then every CTA takes the maximum over ranks in rank
//     order, ties to the lower global index (the slices are in index
//     order, so this is the plain rule) and reads the winner's features
//     from its owner's shared memory;
//   - empty ranks by one ballot, shift and freeze by one warp's max (max
//     is order-free: its bits are exact), computed alike in every CTA, so
//     every CTA leaves the loop at the same iteration.
// Exactness: sums of integer-valued features are exact in any order, so
// labels and centers equal lloyd_plain's bit for bit; the fixed order
// keeps the kernel deterministic for any features. Compactness is a double
// sum in rank order, rounded once.
#include <cooperative_groups.h>

#include "lloyd.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per (frame, attempt)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = kThreads / kMaxK;  // label-word chunks of the scan
constexpr uint8_t kPadLabel = 0xfe;        // label byte past the slice end
constexpr int kMaxSmemBytes = 227 * 1024;  // static + dynamic, one CTA

// Label words each chunk holds: the slice padded to kChunks * 4 points.
__host__ __device__ inline int chunk_words(int n) {
  const int slice = (n + kCluster - 1) / kCluster;
  return ((slice + 3) / 4 + kChunks - 1) / kChunks;
}

// Integer-valued features of magnitude <= 2^20 are summed exactly in
// int32 per thread: x + 1.5 * 2^23 puts the integer in the low mantissa
// bits (no conversion unit), and 2^11 such terms still fit.
constexpr float kIntMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kIntMagicBits = 0x4B400000;
constexpr float kIntLimit = 1048576.0f;  // 2^20

__device__ __forceinline__ void add_term(int& acc, float v) {
  acc += __float_as_int(__fadd_rn(v, kIntMagic)) - kIntMagicBits;
}
__device__ __forceinline__ void add_term(double& acc, float v) {
  acc += static_cast<double>(v);
}

// Count and sums of cluster j over the label words q, q + kChunks, ... of
// a slice, in point order. The words hold four labels each.
template <typename Acc>
__device__ __forceinline__ int scan_cluster(const uint8_t* s_lab,
                                            const float* s_x, int pitch,
                                            int n_words, int q, int j, int d,
                                            Acc (&acc)[kMaxD]) {
  const uint32_t jj = 0x01010101u * static_cast<uint32_t>(j);
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(s_lab);
  int cnt = 0;
  for (int w = q; w < n_words; w += kChunks) {
    // 0x80 in each byte equal to j, 0 elsewhere (no carry crosses a byte)
    const uint32_t y = lw[w] ^ jj;
    uint32_t hit = ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y | 0x7f7f7f7fu);
    while (hit) {
      const int p = 4 * w + ((__ffs(hit) - 1) >> 3);
      hit &= hit - 1;
      ++cnt;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) {
        if (i < d) add_term(acc[i], s_x[i * pitch + p]);
      }
    }
  }
  return cnt;
}

// kFixedD > 0 fixes the feature count at compile time (the encoder's 4);
// 0 reads it from d.
template <int kFixedD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lloyd_cluster_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ init,
                     int32_t* __restrict__ labels,
                     float* __restrict__ centers, float* __restrict__ compact,
                     int n_frames, int n, int d_arg, int k, int max_iter,
                     float eps2) {
  const int d = kFixedD > 0 ? kFixedD : d_arg;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_cen[kMaxK * kMaxD];
  __shared__ float s_cand[kMaxK * kMaxD];
  __shared__ double s_part[2][kMaxK * kMaxD];  // this CTA's sums
  __shared__ int s_pcnt[2][kMaxK];             // and counts, by parity
  __shared__ double s_wsum[kWarps][kMaxK * kMaxD];
  __shared__ int s_wcnt[kWarps][kMaxK];
  __shared__ int s_cnt[kMaxK];   // the cluster's counts
  __shared__ int s_rank[kMaxK];  // rank among the empty clusters, or -1
  __shared__ float s_far[kMaxK * kMaxD];
  __shared__ float s_arg_v[2];  // this CTA's repair candidate, by parity
  __shared__ int s_arg_i[2];
  __shared__ float s_red_v[kWarps + 1];
  __shared__ int s_red_i[kWarps + 1];
  __shared__ double s_red_d[kWarps + 1];
  __shared__ double s_compact;
  __shared__ int s_n_empty;
  __shared__ int s_done;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int f = blockIdx.x / kCluster;
  const size_t fa = static_cast<size_t>(blockIdx.y) * n_frames + f;
  const int kd = k * d;

  const int slice = (n + kCluster - 1) / kCluster;
  const int words = chunk_words(n);
  const int pitch = kChunks * 4 * words;  // >= slice
  const int p0 = min(n, rank * slice);
  const int len = min(n, p0 + slice) - p0;
  float* s_x = reinterpret_cast<float*>(smem);  // (d, pitch) features
  float* s_pd = s_x + d * pitch;                // parked distances
  uint8_t* s_lab = reinterpret_cast<uint8_t*>(s_pd + pitch);
  uint8_t* s_ok = s_lab + pitch;  // mask

  const float* xf = x + static_cast<size_t>(f) * d * n + p0;
  const uint8_t* mf = mask + static_cast<size_t>(f) * n + p0;
  bool integral = true;
  for (int i = 0; i < d; ++i) {
    for (int p = tid; p < len; p += kThreads) {
      const float v = xf[static_cast<size_t>(i) * n + p];
      s_x[i * pitch + p] = v;
      integral = integral && v == rintf(v) && fabsf(v) <= kIntLimit;
    }
  }
  for (int p = tid; p < pitch; p += kThreads) {
    s_ok[p] = p < len ? mf[p] : 0;
    s_lab[p] = kPadLabel;
  }
  if (tid < kd) s_cen[(tid / d) * kMaxD + tid % d] = init[fa * kd + tid];
  if (tid == 0) s_done = 0;
  // a CTA sums an integral slice in int32: the exact value of the double
  // sum in any order, so the partial is the same either way
  const bool exact_int = __syncthreads_and(integral) != 0;

  for (int it = 0; it < max_iter && !s_done; ++it) {
    const int buf = it & 1;
    // 1. assignment of the slice, points p and p + kThreads together;
    //    park each point's distance (the padded tail computes and drops)
    for (int p = tid; p < len; p += 2 * kThreads) {
      float xv[2][kMaxD];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) {
          xv[q][i] = i < d ? s_x[i * pitch + min(p + q * kThreads, pitch - 1)] : 0.f;
        }
      }
      float best[2];
      int lab[2];
      nearest_n<2>(xv, s_cen, k, d, best, lab);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int pq = p + q * kThreads;
        if (pq < len) {
          const bool valid = s_ok[pq] != 0;
          s_lab[pq] = valid ? static_cast<uint8_t>(lab[q]) : kOffMask;
          s_pd[pq] = valid ? fmaxf(best[q], 0.f) : -1.f;
        }
      }
    }
    __syncthreads();

    // 2. this CTA's counts and sums: cluster j over the label words of
    //    chunk q, in point order
    {
      const int j = tid % kMaxK;
      const int q = tid / kMaxK;
      double acc[kMaxD];
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) acc[i] = 0.0;
      int cnt = 0;
      if (j < k && exact_int) {
        int iacc[kMaxD] = {};
        cnt = scan_cluster(s_lab, s_x, pitch, kChunks * words, q, j, d, iacc);
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) acc[i] = iacc[i];
      } else if (j < k) {
        cnt = scan_cluster(s_lab, s_x, pitch, kChunks * words, q, j, d, acc);
      }
      // chunks 2w and 2w + 1 share warp w: one xor step (a + b == b + a)
      cnt += __shfl_xor_sync(kFull, cnt, 16);
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], 16);
      if (lane < kMaxK) {
        s_wcnt[warp][j] = cnt;
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) s_wsum[warp][j * kMaxD + i] = acc[i];
      }
    }
    __syncthreads();
    if (tid < kMaxK * (kMaxD + 1)) {  // thread (j, i): warps in order
      const int j = tid / (kMaxD + 1);
      const int i = tid % (kMaxD + 1);
      if (j < k && i < d) {
        double v[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v[w] = s_wsum[w][j * kMaxD + i];
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += v[w];
        s_part[buf][j * kMaxD + i] = s;
      } else if (j < k && i == kMaxD) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += s_wcnt[w][j];
        s_pcnt[buf][j] = c;
      }
    }
    cluster.sync();

    // 3. the cluster's sums in rank order; the same centers in every CTA
    if (tid < kMaxK * (kMaxD + 1)) {
      const int j = tid / (kMaxD + 1);
      const int i = tid % (kMaxD + 1);
      if (j < k && (i < d || i == kMaxD)) {
        // every remote load in flight before the first add
        int cr[kCluster];
        double vr[kCluster];
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          cr[r] = cluster.map_shared_rank(s_pcnt[buf], r)[j];
          vr[r] = i < d ? cluster.map_shared_rank(s_part[buf], r)[j * kMaxD + i] : 0.0;
        }
        int c = 0;
        double s = 0.0;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          c += cr[r];
          s += vr[r];
        }
        if (i == kMaxD) {
          s_cnt[j] = c;
        } else {
          s_cand[j * kMaxD + i] =
              __fdiv_rn(__double2float_rn(s), static_cast<float>(max(c, 1)));
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      const bool empty = lane < k && s_cnt[lane] == 0;
      const unsigned ballot = __ballot_sync(kFull, empty);
      if (lane < k) s_rank[lane] = empty ? __popc(ballot & ((1u << lane) - 1)) : -1;
      if (lane == 0) s_n_empty = __popc(ballot);
    }
    __syncthreads();

    // 4. global_farthest repair (usually no empty cluster)
    const int n_empty = s_n_empty;
    for (int r = 0; r < n_empty; ++r) {
      float v = -FLT_MAX;
      int i = INT_MAX;
      for (int p = tid; p < len; p += kThreads) {
        const float q = s_pd[p];
        if (q > v) {
          v = q;
          i = p;
        }
      }
      block_argmax<kWarps>(v, i, s_red_v, s_red_i);
      if (tid == 0) {
        s_arg_v[r & 1] = v;
        s_arg_i[r & 1] = i == INT_MAX ? INT_MAX : p0 + i;
      }
      cluster.sync();
      float bv = -FLT_MAX;
      int bi = INT_MAX;
      for (int o = 0; o < kCluster; ++o) {
        keep_larger(bv, bi, *cluster.map_shared_rank(&s_arg_v[r & 1], o),
                    *cluster.map_shared_rank(&s_arg_i[r & 1], o));
      }
      const int owner = bi / slice;
      const int local = bi - owner * slice;
      if (tid < d) {
        s_far[r * kMaxD + tid] =
            cluster.map_shared_rank(s_x, owner)[tid * pitch + local];
      }
      if (tid == 0 && owner == rank) s_pd[local] = -1.f;
      __syncthreads();
    }
    if (n_empty > 0) {
      if (tid < kd) {
        const int j = tid / d;
        const int i = tid % d;
        if (s_rank[j] >= 0) s_cand[j * kMaxD + i] = s_far[s_rank[j] * kMaxD + i];
      }
      __syncthreads();
    }

    // 5. shift and freeze (one warp); the update that sets done applies
    if (warp == 0) {
      float s = 0.f;
      if (lane < k) {
        for (int i = 0; i < d; ++i) {
          const float diff = __fsub_rn(s_cand[lane * kMaxD + i], s_cen[lane * kMaxD + i]);
          const float sq = __fmul_rn(diff, diff);
          s = i == 0 ? sq : __fadd_rn(s, sq);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, off));
      __syncwarp();
      for (int e = lane; e < kd; e += 32) {
        const int c = (e / d) * kMaxD + e % d;
        s_cen[c] = s_cand[c];
      }
      if (lane == 0) s_done = s <= eps2;
    }
    __syncthreads();
  }

  // final assignment of the slice; compactness summed in rank order
  int32_t* lab_out = labels + fa * n + p0;
  double part = 0.0;
  for (int p = tid; p < len; p += kThreads) {
    float xv[kMaxD];
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) xv[i] = i < d ? s_x[i * pitch + p] : 0.f;
    float best = 0.f;
    lab_out[p] = nearest(xv, s_cen, k, d, best);
    if (s_ok[p]) part += static_cast<double>(fmaxf(best, 0.f));
  }
  const double total = block_sum<kWarps>(part, s_red_d);
  if (tid == 0) s_compact = total;
  cluster.sync();
  if (rank == 0) {
    if (tid == 0) {
      double c = 0.0;
      for (int r = 0; r < kCluster; ++r) c += *cluster.map_shared_rank(&s_compact, r);
      compact[fa] = __double2float_rn(c);
    }
    if (tid < kd) centers[fa * kd + tid] = s_cen[(tid / d) * kMaxD + tid % d];
  }
  // no CTA leaves while rank 0 may still read its shared memory
  cluster.sync();
}

// The instance for d features: the encoder's 4 at compile time.
auto cluster_kernel(int d) {
  return d == 4 ? lloyd_cluster_kernel<4> : lloyd_cluster_kernel<0>;
}

// Dynamic shared memory of one CTA: features, parked distances, labels and
// mask of a slice padded to kChunks whole chunks of label words.
int dynamic_smem(int n, int d) {
  return kChunks * 4 * chunk_words(n) * (4 * d + 4 + 1 + 1);
}

}  // namespace

// x: (n_frames, d, n) float32 features; mask: (n_frames, n) uint8 validity;
// init: (n_attempts, n_frames, k, d) float32 seeds; labels: (n_attempts,
// n_frames, n) int32; centers: like init; compact: (n_attempts, n_frames)
// float32. eps2 is the squared stop threshold. Refuses
// (cudaErrorInvalidValue) a slice that does not fit shared memory.
SVC_EXPORT int svc_lloyd(const void* x, const void* mask, const void* init,
                         void* labels, void* centers, void* compact,
                         int n_attempts, int n_frames, int n, int d, int k,
                         int max_iter, float eps2, void* stream) {
  if (k < 1 || k > kMaxK || d < 1 || d > kMaxD || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = cluster_kernel(d);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = dynamic_smem(n, d);
  if (smem + static_cast<int>(attr.sharedSizeBytes) > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Set on every call: without it a launch may use 48 KB less the static
  // part, and the limit an earlier call set must not decide this one.
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_frames * kCluster, n_attempts);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(init), static_cast<int32_t*>(labels),
      static_cast<float*>(centers), static_cast<float*>(compact), n_frames, n,
      d, k, max_iter, eps2);
  return static_cast<int>(cudaGetLastError());
}
