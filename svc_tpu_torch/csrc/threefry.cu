// K11 threefry2x32: the 20-round Threefry-2x32 block cipher of
// jax.random (jax_threefry_partitionable=True) for L keys x N counts in
// one launch.
//
// Replaces jax.random's threefry, which svc_tpu leaves to XLA (no
// pl.pallas_call: an XLA fusion inside the encoder's compiled program;
// the k-means++ seeding draw at svc_tpu/ops/kmeans.py:72 is the largest).
// The port's plain version (ops/prng.py threefry2x32) holds each 32-bit
// word in int64 and masks every add, multiply and shift: ~170 eager
// elementwise ops a call. Here each word is a native uint32 in a
// register, and the output words equal the plain int64-held words bit for
// bit (same rotations, key schedule and injections).
//
// Contract: keys (L, 2) int64 holding uint32 words; element (l, j) is
// threefry2x32(keys[l], (0, x1)) with x1 = j, or x1 = data[l * N + j]
// when data is given ((L, N) int64, low 32 bits read). Output (int64,
// values in [0, 2^32)): (L, N) words x0 ^ x1 (random_bits), or (L, N, 2)
// words (x0, x1) when both is set (split, fold_in).
//
// Bound: bytes. The seeding draw of an 8-frame 1080p batch is 8 x 3 keys
// x (10 x 8160) counts = 1.96M int64 words written, 15.7 MB: 4.7 us at
// 3.35 TB/s, against ~120 integer operations a word (3.5 us at 67 T/s).
// Design: a thread per element, grid-stride; a warp's elements share a key
// row, so the key loads broadcast; the output writes coalesce; rotations
// are funnel shifts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// four mix steps of one round group
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

__global__ void __launch_bounds__(kThreads)
threefry2x32_kernel(const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ data,
                    int64_t* __restrict__ out, int64_t n_keys,
                    int64_t n_counts, int both) {
  const int64_t total = n_keys * n_counts;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    const int64_t l = e / n_counts;
    const int64_t j = e - l * n_counts;
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * l]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * l + 1]);
    const uint32_t k2 = k0 ^ k1 ^ kParity;
    const uint32_t c = data != nullptr ? static_cast<uint32_t>(data[e])
                                       : static_cast<uint32_t>(j);
    uint32_t x0 = k0;  // 0 + ks[0]
    uint32_t x1 = c + k1;
    mix4(x0, x1, 13, 15, 26, 6);
    x0 += k1; x1 += k2 + 1u;
    mix4(x0, x1, 17, 29, 16, 24);
    x0 += k2; x1 += k0 + 2u;
    mix4(x0, x1, 13, 15, 26, 6);
    x0 += k0; x1 += k1 + 3u;
    mix4(x0, x1, 17, 29, 16, 24);
    x0 += k1; x1 += k2 + 4u;
    mix4(x0, x1, 13, 15, 26, 6);
    x0 += k2; x1 += k0 + 5u;
    if (both) {
      out[2 * e] = static_cast<int64_t>(x0);
      out[2 * e + 1] = static_cast<int64_t>(x1);
    } else {
      out[e] = static_cast<int64_t>(x0 ^ x1);
    }
  }
}

}  // namespace

// keys: (n_keys, 2) int64; data: (n_keys, n_counts) int64 or null (the
// counts 0 .. n_counts-1); out: (n_keys, n_counts) int64, or
// (n_keys, n_counts, 2) when both is set.
SVC_EXPORT int svc_threefry2x32(const void* keys, const void* data, void* out,
                                long long n_keys, long long n_counts,
                                int both, void* stream) {
  if (n_keys < 0 || n_counts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n_keys * n_counts;
  if (total == 0) return static_cast<int>(cudaSuccess);
  // a wave of 132 SMs x 8 CTAs is plenty; larger draws grid-stride
  const long long want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  threefry2x32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(data),
      static_cast<int64_t*>(out), n_keys, n_counts, both);
  return static_cast<int>(cudaGetLastError());
}
