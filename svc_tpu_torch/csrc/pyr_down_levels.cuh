// Pyramid levels 1..D (D <= 3 halvings) of a batch of uint8 planes in one
// launch, each level bit-equal to chained cv::pyrDown (pyr_down.cuh: 5-tap
// [1 4 6 4 1] in both dimensions, BORDER_REFLECT_101 at each level's own
// edges, (n + 1) / 2 outputs, (s + 128) >> 8): K4's fused kernel
// (pyr_down_levels.cu), templated on how level 0 is read. K4 reads dense
// planes (DenseLevel0, below); the K8 pyramid column-pitched subplanes
// (pyr_down_pitched_levels.cu). Everything after level 0 is one code.
//
// Design:
//   - a CTA per kTH x kTW tile of the coarsest level (8 x 16 at D = 3; the
//     tile doubles per missing halving, so the level-0 region is about the
//     same). The tile needs a (2h+3) x (2w+3) region of the level below,
//     and so on down to level 0 (85 x 149 bytes at D = 3, loaded as 85 x
//     160, ~1.66x the tile's own share); each CTA recomputes its halo at
//     every finer level instead of exchanging it (the overlap between
//     neighbours is mostly read from L2). A tile of
//     8 x 32 (48 KB of shared memory, 4 CTAs per SM) ran slower on the
//     card, likely for fewer CTAs to hide each one's barriers;
//   - a region position outside its level takes the value at its
//     reflect-101 image, which lies in the same region wherever a stored
//     output reads it (tests/test_torch_pyramid_ebma_dispatch.py replays
//     the walk on the CPU); the image is clamped into the region so that
//     no index leaves it;
//   - level 0 arrives as 16-byte chunks (their base is a multiple of 16;
//     the loader's vector loads where its rows are aligned), all of a
//     thread's loads issued before its first shared store; only a chunk
//     across the frame's edge takes byte loads. Its reflect-101 halo is
//     then filled from shared memory (byte loads through reflect101 made
//     the edge CTAs several times slower to load than the others);
//   - each level is a horizontal pass (four outputs from 16 shared bytes,
//     their even and odd bytes split into 16-bit halves so that each add
//     serves two outputs) into 16-bit sums, then a vertical pass on the
//     same packed pairs (no sum reaches 2^16) back into bytes. Two shared
//     buffers hold the level regions and the sums in turn (26,520 bytes
//     at D = 3);
//   - the vertical pass writes each CTA's own part of every level as it
//     goes (16-bit stores on intermediate levels, 32-bit on the coarsest,
//     where the rows are aligned); intermediate levels never round-trip
//     through device memory. Level-0 positions outside [-2, n + 1] hold 0:
//     no stored output reads them.
#pragma once

#include "pyr_down.cuh"

namespace {

constexpr int kLvThreads = 256;
constexpr int kLvRow0 = 160;  // level-0 shared row: 10 16-byte chunks

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
struct Geo {
  static constexpr int kTH = 64 >> D;   // coarsest-level tile rows
  static constexpr int kTW = 128 >> D;  // and columns
  // region rows / columns at level l (0..D)
  __host__ __device__ static constexpr int R(int l) {
    return l == D ? kTH : 2 * R(l + 1) + 3;
  }
  __host__ __device__ static constexpr int C(int l) {
    return l == D ? kTW : 2 * C(l + 1) + 3;
  }
  // region column 0 within the level-0 shared row (the chunk base is the
  // region's first column floored to a multiple of 16)
  static constexpr int kOff0 = 18 - (2 << D);
  // shared row stride of the level-l region: its padded width, and room
  // for the next horizontal pass's last 16-byte read
  __host__ __device__ static constexpr int S(int l) {
    return l == 0 ? kLvRow0 : cmax(pad4(C(l)), 8 * (pad4(C(l + 1)) / 4) + 8);
  }
  __host__ __device__ static constexpr int a_bytes() {
    int m = R(0) * kLvRow0;
    for (int l = 1; l < D; ++l) m = cmax(m, R(l) * S(l));
    return m;
  }
  __host__ __device__ static constexpr int b_halves() {
    int m = 0;
    for (int l = 1; l <= D; ++l) m = cmax(m, R(l - 1) * pad4(C(l)));
    return m;
  }
};

struct LevelsArgs {
  uint8_t* dst[3];
  int h[4], w[4];
  int row_align[3];  // level-l rows 4-, 2- or 1-byte aligned
};

// The level-0 loaders: chunk(plane, y, x, h0, w0) is bytes [x, x + 16) of
// row y (inside the frame) of a level-0 plane, x a multiple of 16, bytes
// outside [0, w0) 0. K4 reads dense planes (n, h0, w0):
struct DenseLevel0 {
  const uint8_t* src;
  int vec;  // rows 16-byte aligned
  __device__ __forceinline__ uint4 chunk(int plane, int y, int x, int h0, int w0) const {
    const uint8_t* row = src + (static_cast<size_t>(plane) * h0 + y) * w0;
    if (vec && x >= 0 && x + 16 <= w0) {
      return __ldg(reinterpret_cast<const uint4*>(row + x));
    }
    // a chunk across the frame's edge (or unaligned rows)
    uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (x + j >= 0 && x + j < w0) {
        u[j >> 2] |= static_cast<uint32_t>(__ldg(row + x + j)) << (8 * (j & 3));
      }
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// reflect101 of q at a level of n, clamped into the region [q0, q0 + len)
__device__ __forceinline__ int region_image(int q, int n, int q0, int len) {
  return min(max(reflect101(q, n), q0), q0 + len - 1);
}

// (x[2h], x[2h + 2]) as two 16-bit halves, from e[i] = (x[4i], x[4i + 2])
__device__ __forceinline__ uint32_t halves_at(const uint32_t (&e)[4], int h) {
  return (h & 1) ? __funnelshift_r(e[h >> 1], e[(h >> 1) + 1], 16) : e[h >> 1];
}

// Level L's horizontal pass: 16-bit sums of the level-(L-1) region rows in
// A at the level-L region's columns, into B (rows of pad4(C(L)) sums).
template <int D, int L>
__device__ __forceinline__ void hpass(const uint8_t* A, uint16_t* B, int q0, int wl) {
  using G = Geo<D>;
  constexpr int kRin = G::R(L - 1);
  constexpr int kCout = pad4(G::C(L));
  constexpr int kGroups = kCout / 4;
  constexpr int kSin = G::S(L - 1);
  constexpr int kOff = L == 1 ? G::kOff0 : 0;
  static_assert(8 * (kGroups - 1) + (kOff & ~3) + 16 <= kSin, "row overrun");
  for (int i = threadIdx.x; i < kRin * kGroups; i += kLvThreads) {
    const int r = i / kGroups;
    const int g = i % kGroups;
    const int c = 4 * g;
    const uint8_t* row = A + r * kSin;
    uint32_t s[4];
    if (q0 + c >= 0 && q0 + c + 3 < wl) {
      // 16 bytes from the group's first word on; their even and odd bytes
      // as 16-bit halves, so that one add serves two outputs
      const uint8_t* base = row + 8 * g + (kOff & ~3);
      uint32_t w[4];
      if constexpr ((kOff & 7) < 4) {  // 8-byte aligned: two 64-bit loads
        static_assert(kSin % 8 == 0, "rows of 64-bit loads");
        const uint2 u = *reinterpret_cast<const uint2*>(base);
        const uint2 v = *reinterpret_cast<const uint2*>(base + 8);
        w[0] = u.x; w[1] = u.y; w[2] = v.x; w[3] = v.y;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = reinterpret_cast<const uint32_t*>(base)[k];
      }
      uint32_t ev[4], od[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ev[k] = __byte_perm(w[k], 0u, 0x4240);  // bytes 0 and 2
        od[k] = __byte_perm(w[k], 0u, 0x4341);  // bytes 1 and 3
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // outputs 2q and 2q + 1
        const int h = (kOff & 3) / 2 + 2 * q;
        const uint32_t pair = halves_at(ev, h) + 4 * halves_at(od, h) +
                              6 * halves_at(ev, h + 1) + 4 * halves_at(od, h + 1) +
                              halves_at(ev, h + 2);
        s[2 * q] = pair & 0xffffu;
        s[2 * q + 1] = pair >> 16;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rq = region_image(q0 + c + j, wl, q0, G::C(L));
        const uint8_t* p = row + kOff + 2 * (rq - q0);
        s[j] = p[0] + 4 * p[1] + 6 * p[2] + 4 * p[3] + p[4];
      }
    }
    *reinterpret_cast<uint2*>(B + r * kCout + c) =
        make_uint2(s[0] | (s[1] << 16), s[2] | (s[3] << 16));
  }
}

// Level L's vertical pass: four output bytes of one region row from the
// sums in B, packed in a word; L < D into the level-L region in A, L = D
// straight to the output.
template <int D, int L>
__device__ __forceinline__ void vpass(const uint16_t* B, uint8_t* A, int p0, int q0,
                                      int hl, int wl, uint8_t* out, int row_align) {
  using G = Geo<D>;
  constexpr int kRout = G::R(L);
  constexpr int kCout = pad4(G::C(L));
  constexpr int kGroups = kCout / 4;
  // the CTA's own part of an intermediate level's region: rows and
  // columns [kO, kO + kOH) x [kO, kO + kOW) (kO even, so each 16-bit half
  // of a word is wholly in or out)
  constexpr int kO = (2 << (D - L)) - 2;
  constexpr int kOH = G::kTH << (D - L);
  constexpr int kOW = G::kTW << (D - L);
  for (int i = threadIdx.x; i < kRout * kGroups; i += kLvThreads) {
    const int pr = i / kGroups;
    const int g = i % kGroups;
    const int p = p0 + pr;
    const int rp = (p >= 0 && p < hl) ? p : region_image(p, hl, p0, kRout);
    const uint16_t* col = B + 2 * (rp - p0) * kCout + 4 * g;
    uint32_t lo = 0x00800080u, hi = 0x00800080u;  // + 128 in each half
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const uint2 v = *reinterpret_cast<const uint2*>(col + a * kCout);
      const uint32_t tap = (a == 0 || a == 4) ? 1u : (a == 2 ? 6u : 4u);
      lo += tap * v.x;
      hi += tap * v.y;
    }
    const uint32_t word = __byte_perm(lo, hi, 0x7531);  // (s + 128) >> 8, x4
    if constexpr (L < D) {
      *reinterpret_cast<uint32_t*>(A + pr * G::S(L) + 4 * g) = word;
      if (pr < kO || pr >= kO + kOH || p >= hl) continue;
      uint8_t* orow = out + static_cast<size_t>(p) * wl;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 4 * g + 2 * k;
        const int x = q0 + c;  // even
        if (c < kO || c >= kO + kOW || x >= wl) continue;
        const uint32_t half = (word >> (16 * k)) & 0xffffu;
        if (row_align >= 2 && x + 2 <= wl) {
          *reinterpret_cast<uint16_t*>(orow + x) = static_cast<uint16_t>(half);
        } else {
          orow[x] = half & 0xffu;
          if (x + 1 < wl) orow[x + 1] = half >> 8;
        }
      }
    } else {
      const int x = q0 + 4 * g;
      if (p >= hl || x >= wl) continue;
      uint8_t* o = out + static_cast<size_t>(p) * wl + x;
      if (row_align == 4 && x + 4 <= wl) {
        *reinterpret_cast<uint32_t*>(o) = word;
      } else {
        for (int j = 0; j < 4 && x + j < wl; ++j) o[j] = (word >> (8 * j)) & 0xffu;
      }
    }
  }
}

template <int D, int L>
__device__ __forceinline__ void level(uint8_t* A, uint16_t* B, const int (&p0)[D + 1],
                                      const int (&q0)[D + 1], const LevelsArgs& a,
                                      int plane) {
  const int hl = a.h[L], wl = a.w[L];
  uint8_t* out = a.dst[L - 1] + static_cast<size_t>(plane) * hl * wl;
  hpass<D, L>(A, B, q0[L], wl);
  __syncthreads();
  vpass<D, L>(B, A, p0[L], q0[L], hl, wl, out, a.row_align[L - 1]);
  if constexpr (L < D) {
    __syncthreads();
    level<D, L + 1>(A, B, p0, q0, a, plane);
  }
}

template <int D, class Level0>
__global__ void __launch_bounds__(kLvThreads)
pyr_down_levels_kernel(LevelsArgs a, Level0 src) {
  using G = Geo<D>;
  static_assert(G::kOff0 + G::C(0) <= kLvRow0, "level-0 region overruns its row");
  __shared__ __align__(16) uint8_t A[G::a_bytes()];
  __shared__ __align__(16) uint16_t B[G::b_halves()];
  const int plane = blockIdx.z;
  int p0[D + 1], q0[D + 1];  // region origins per level
  p0[D] = blockIdx.y * G::kTH;
  q0[D] = blockIdx.x * G::kTW;
#pragma unroll
  for (int l = D - 1; l >= 0; --l) {
    p0[l] = 2 * p0[l + 1] - 2;
    q0[l] = 2 * q0[l + 1] - 2;
  }

  const int h0 = a.h[0], w0 = a.w[0];
  const int cb = q0[0] - G::kOff0;  // first column of the level-0 chunks
  // the frame's own pixels first: every load of the thread is issued
  // before its first shared store, so that the CTA waits for one round
  // trip to memory, not one per chunk
  constexpr int kChunks = kLvRow0 / 16;
  constexpr int kR0 = G::R(0);
  constexpr int kItems = kR0 * kChunks;
  constexpr int kIters = (kItems + kLvThreads - 1) / kLvThreads;
  uint4 v[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kLvThreads;
    const int y = p0[0] + i / kChunks;
    const int x = cb + 16 * (i % kChunks);
    v[it] = make_uint4(0u, 0u, 0u, 0u);
    if (i >= kItems || y < 0 || y >= h0 || x + 16 <= 0 || x >= w0) continue;
    v[it] = src.chunk(plane, y, x, h0, w0);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kLvThreads;
    if (i < kItems) {
      *reinterpret_cast<uint4*>(A + (i / kChunks) * kLvRow0 + 16 * (i % kChunks)) = v[it];
    }
  }
  __syncthreads();
  // then the reflect-101 halo, from shared memory: columns -2, -1, w0 and
  // w0 + 1 of the rows inside the frame, then rows -2, -1, h0 and h0 + 1
  // as copies of their images (always inside the frame, so never written
  // here). No stored output reads a position further out (those hold 0).
  for (int i = threadIdx.x; i < kR0 * 4; i += kLvThreads) {
    const int r = i / 4;
    const int e = i % 4;
    const int y = p0[0] + r;
    const int x = e < 2 ? e - 2 : w0 + e - 2;
    const int c = x - cb;
    if (y < 0 || y >= h0 || c < 0 || c >= kLvRow0) continue;
    const int sc = min(max(reflect101(x, w0) - cb, 0), kLvRow0 - 1);
    A[r * kLvRow0 + c] = A[r * kLvRow0 + sc];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kItems; i += kLvThreads) {
    const int r = i / kChunks;
    const int y = p0[0] + r;
    if ((y >= 0 && y < h0) || y < -2 || y > h0 + 1) continue;
    const int sr = min(max(reflect101(y, h0) - p0[0], 0), kR0 - 1);
    const int k = i % kChunks;
    *reinterpret_cast<uint4*>(A + r * kLvRow0 + 16 * k) =
        *reinterpret_cast<const uint4*>(A + sr * kLvRow0 + 16 * k);
  }
  __syncthreads();
  level<D, 1>(A, B, p0, q0, a, plane);
}

template <int D, class Level0>
int launch_levels(const LevelsArgs& a, const Level0& src, int n, cudaStream_t stream) {
  using G = Geo<D>;
  const dim3 grid((a.w[D] + G::kTW - 1) / G::kTW, (a.h[D] + G::kTH - 1) / G::kTH, n);
  pyr_down_levels_kernel<D, Level0><<<grid, kLvThreads, 0, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

// Levels 1..halvings of n planes of h x w read through src into dst1..3
// ((n, h_l, w_l) uint8, h_l = (h_{l-1} + 1) / 2, likewise w; unused
// pointers null). Refuses (cudaErrorInvalidValue) halvings outside 1..3,
// empty planes or a missing output.
template <class Level0>
int launch_pyr_down_levels(const Level0& src, void* dst1, void* dst2, void* dst3,
                           int n, int h, int w, int halvings, void* stream) {
  if (halvings < 1 || halvings > 3 || n < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelsArgs a{};
  a.dst[0] = static_cast<uint8_t*>(dst1);
  a.dst[1] = static_cast<uint8_t*>(dst2);
  a.dst[2] = static_cast<uint8_t*>(dst3);
  a.h[0] = h;
  a.w[0] = w;
  for (int l = 1; l <= 3; ++l) {
    a.h[l] = (a.h[l - 1] + 1) / 2;
    a.w[l] = (a.w[l - 1] + 1) / 2;
  }
  for (int l = 1; l <= halvings; ++l) {
    if (a.dst[l - 1] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t base = reinterpret_cast<uintptr_t>(a.dst[l - 1]);
    a.row_align[l - 1] = (base % 4 == 0 && a.w[l] % 4 == 0)   ? 4
                         : (base % 2 == 0 && a.w[l] % 2 == 0) ? 2 : 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (halvings) {
    case 1: return launch_levels<1>(a, src, n, s);
    case 2: return launch_levels<2>(a, src, n, s);
    default: return launch_levels<3>(a, src, n, s);
  }
}

}  // namespace
