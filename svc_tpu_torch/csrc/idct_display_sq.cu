// K1 for square transform blocks of 4 and 16 (idct4x4_display,
// idct16x16_display): the decoder's display hot path — dequantize, inverse
// B x B DCT, bilinear row resample from the padded height to the display
// height, round, clip, interleaved BGR bytes — one kernel template
// instantiated at B = 4 and B = 16 for 3 channels.
//
// Replaces svc_tpu/ops/dct_pallas.py idct_wire_to_pitched_pallas (:692,
// pallas_call :807; its zero-excess mode is the identity rows here) and
// idct_wire_resample_pallas (:1077, :1189) at those shapes. Same contract as
// the general kernel (idct_display_general.cu), which serves every other
// block shape and channel count, and the same per-element arithmetic as
// idct_tile.cuh states (__fdiv_rn dequantize with half-away rounding, fmaf
// over k then over l, in ascending order), then lerp_rn and display_byte,
// so the two kernels' bytes are equal.
//
// Bound: memory — 4 bytes of coefficient read per display byte written
// (250 MB per 8-frame 1080p batch, 0.075 ms at every B; the 4B float32
// operations per pixel and channel take 0.048 ms at B = 16). The design is
// idct_display.cu's, its CTA shape kept and every constant a function of B:
//  - one CTA of 192 threads per (frame, strip of 64 pixels — 16 block
//    columns at B = 4, 4 at B = 16 —, band of output rows). It walks down
//    the band's source block rows one at a time; each is dequantized and
//    transformed once, plus one halo block row per band. A ring of the
//    last 2B pixel rows carries the previous block row, which the row lerp
//    of an output row may still need (y1 <= y0 + 1);
//  - the coefficients of the block row after next (one contiguous run of
//    strip * 3 * B^2 floats: 3 KB at B = 4, 12 KB at B = 16) and their
//    steps arrive by cp.async into one of two shared-memory slots while
//    the current block row is emitted and the next one transformed;
//  - columns: thread (block, channel, column l) dequantizes its B
//    coefficients and transforms them in registers, writing the result
//    back in place; rows: thread (block, channel, row i) transforms a row
//    (16-byte loads) and stores its B pixels interleaved into the ring.
//    The slot is padded per B so that neither stage conflicts on banks;
//  - output: a thread blends one 16-byte run of an output row and stores
//    it with one 16-byte store;
//  - host tables carry the geometry (ops/dct.py _band_tables with the
//    block size and the strip), so one kernel serves the resample route
//    and, with y0 = y1 = Y and f = 0, the identity route. Every index in
//    the loops is a compile-time constant or a shift.
#include "idct8x8.cuh"

namespace {

constexpr int kThreads = 192;
constexpr int kStripPixels = 64;
constexpr int kRowBytes = kStripPixels * 3;  // display bytes of a strip row
constexpr int kChunks = kRowBytes / 16;      // 16-byte output runs per row
// pixel ring row: interleaved byte position e of a strip row at
// (e >> 4) * 20 + (e & 15), so 16-byte runs start 20 floats apart and a
// quarter-warp's 16-byte loads hit distinct banks (as idct_display.cu)
constexpr int kRingPitch = kChunks * 20 + 4;
// a band's per-row tables: two ring offsets and a weight per output row
constexpr int kMaxBandRows = 128;

// Per block size B: element (k, l) of pair g at g * kCoefGroup + k *
// kCoefPitch + l in a coefficient slot (floats), and the CTAs an SM holds.
// Column stage (lanes along l, 4-byte accesses): the pairs of a warp start
// at distinct multiples of 4 banks (B = 4: kCoefGroup / 4 odd) or 16 (B =
// 16). Row stage (lanes along k, 16-byte loads): a quarter-warp's rows
// start at distinct multiples of 4 banks (B = 4: row stride 8 and odd pair
// offsets; B = 16: row stride 20, 5 groups of 4 banks).
template <int B> struct SqGeom;
template <> struct SqGeom<4> { static constexpr int kCoefPitch = 8, kCoefGroup = 36, kMinCtas = 6; };
template <> struct SqGeom<16> { static constexpr int kCoefPitch = 20, kCoefGroup = 336, kMinCtas = 3; };

template <int B>
struct Sq {
  static constexpr int kStrip = kStripPixels / B;  // block columns per CTA
  static constexpr int kGroups = kStrip * 3;       // (block, channel) pairs
  static constexpr int kSlot = kGroups * SqGeom<B>::kCoefGroup;
  static constexpr int kRingRows = 2 * B;  // the current and previous block row
  static constexpr int kSmemBytes =
      (2 * kSlot + kRingRows * kRingPitch + 2 * kStrip + 3 * kMaxBandRows) *
      static_cast<int>(sizeof(float));
  static_assert(kGroups * B == kThreads, "a thread per column of a pair");
  static_assert(SqGeom<B>::kCoefGroup >= B * SqGeom<B>::kCoefPitch,
                "slot rows fit");
};

template <int B>
struct DctF {
  float m[B * B];
};

// Coefficients and steps of blocks [blk0, blk0 + nblk) (flat block index)
// into a slot, as one cp.async group per thread.
template <int B>
__device__ __forceinline__ void fetch_sq_row(const float* __restrict__ coeffs,
                                             const float* __restrict__ steps,
                                             size_t blk0, int nblk,
                                             float* slot, float* slot_steps) {
  constexpr int kPairChunks = B * B / 4;  // 16-byte chunks of a pair
  constexpr int kRowChunks = B / 4;       // of a coefficient row
  const float* src = coeffs + blk0 * (3 * B * B);
  for (int ch = threadIdx.x; ch < nblk * 3 * kPairChunks; ch += kThreads) {
    const int g = ch / kPairChunks;
    const int e = ch & (kPairChunks - 1);
    cp_async16(slot + g * SqGeom<B>::kCoefGroup +
                   (e / kRowChunks) * SqGeom<B>::kCoefPitch +
                   (e & (kRowChunks - 1)) * 4,
               src + ch * 4);
  }
  if (threadIdx.x < nblk) {
    cp_async4(slot_steps + threadIdx.x, steps + blk0 + threadIdx.x);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Columns of pair g: dequantize + inverse transform of column r, in place.
template <int B>
__device__ __forceinline__ void sq_column_stage(float* grp, float step,
                                                const DctF<B>& d, int r) {
  constexpr int kPitch = SqGeom<B>::kCoefPitch;
  float q[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float y = __fdiv_rn(grp[k * kPitch + r], step);
    const float mag = __fmul_rn(floorf(__fadd_rn(fabsf(y), 0.5f)), step);
    q[k] = copysignf(mag, y);
  }
#pragma unroll
  for (int i = 0; i < B; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < B; ++k) acc = fmaf(q[k], d.m[k * B + i], acc);
    grp[i * kPitch + r] = acc;
  }
}

// Rows of pair g (block blk, channel c): the B pixels of row r, j
// ascending, into ring row `dst`, interleaved.
template <int B>
__device__ __forceinline__ void sq_ring_row(const float* grp, float* dst,
                                            const DctF<B>& d, int r, int blk,
                                            int c) {
  float a[B];
#pragma unroll
  for (int q = 0; q < B / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        grp + r * SqGeom<B>::kCoefPitch + 4 * q);
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < B; ++l) acc = fmaf(a[l], d.m[l * B + j], acc);
    const int e = (blk * B + j) * 3 + c;
    dst[(e >> 4) * 20 + (e & 15)] = acc;
  }
}

__device__ __forceinline__ uint32_t pack4(float4 v) {
  return static_cast<uint32_t>(display_byte(v.x)) |
         static_cast<uint32_t>(display_byte(v.y)) << 8 |
         static_cast<uint32_t>(display_byte(v.z)) << 16 |
         static_cast<uint32_t>(display_byte(v.w)) << 24;
}

template <int B>
__global__ void __launch_bounds__(kThreads, SqGeom<B>::kMinCtas)
idct_sq_display_kernel(const float* __restrict__ coeffs,
                       const float* __restrict__ steps, const DctF<B> d,
                       const int32_t* __restrict__ y0,
                       const int32_t* __restrict__ y1,
                       const float* __restrict__ fy,
                       const int32_t* __restrict__ row_lo,
                       const int32_t* __restrict__ band_b,
                       uint8_t* __restrict__ out, int out_h, int nby,
                       int nbx, int band_rows) {
  constexpr int kStrip = Sq<B>::kStrip;
  constexpr int kSlot = Sq<B>::kSlot;
  constexpr int kRingRows = Sq<B>::kRingRows;
  constexpr int kGroup = SqGeom<B>::kCoefGroup;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 2 * kSlot;
  float* slot_steps = ring + kRingRows * kRingPitch;
  // per output row of the band: ring offsets of y0 and y1, and fy
  int* band_r0 = reinterpret_cast<int*>(slot_steps + 2 * kStrip);
  int* band_r1 = band_r0 + kMaxBandRows;
  float* band_f = reinterpret_cast<float*>(band_r1 + kMaxBandRows);

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int bx0 = blockIdx.x * kStrip;
  const int nblk = min(kStrip, nbx - bx0);
  const int valid = nblk * B * 3;  // display bytes of this strip's rows
  const int yb0 = band * band_rows;
  const int yb1 = min(out_h, yb0 + band_rows);
  const int b_first = band_b[2 * band];
  const int b_last = band_b[2 * band + 1];
  const size_t row_bytes = static_cast<size_t>(nbx) * B * 3;
  const bool aligned = (row_bytes & 15) == 0;  // every row start is
  uint8_t* out_t = out + static_cast<size_t>(t) * out_h * row_bytes +
                   static_cast<size_t>(bx0) * B * 3;
  const size_t blk_row0 = static_cast<size_t>(t) * nby * nbx + bx0;

  const int g = threadIdx.x / B;        // block * 3 + channel
  const int r = threadIdx.x & (B - 1);  // column l, then row i
  const int blk = g / 3;
  const int c = g - 3 * blk;

  fetch_sq_row<B>(coeffs, steps,
                  blk_row0 + static_cast<size_t>(b_first) * nbx, nblk, smem,
                  slot_steps);
  for (int i = threadIdx.x; i < yb1 - yb0; i += kThreads) {
    band_r0[i] = (y0[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_r1[i] = (y1[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_f[i] = fy[yb0 + i];
  }
  cp_async_wait_all();
  __syncthreads();
  if (b_first < b_last) {
    fetch_sq_row<B>(coeffs, steps,
                    blk_row0 + static_cast<size_t>(b_first + 1) * nbx, nblk,
                    smem + kSlot, slot_steps + kStrip);
  }
  sq_column_stage<B>(smem + g * kGroup, slot_steps[blk], d, r);

  // Per block row b, two phases: (1) the rows stage of b into the ring;
  // (2) the output rows that b completes, the next block row's column
  // stage, and the copy of the one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    sq_ring_row<B>(smem + s * kSlot + g * kGroup,
                   ring + ((b * B + r) & (kRingRows - 1)) * kRingPitch, d, r,
                   blk, c);
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_sq_row<B>(coeffs, steps,
                      blk_row0 + static_cast<size_t>(b + 2) * nbx, nblk,
                      smem + s * kSlot, slot_steps + s * kStrip);
    }
    for (int task = threadIdx.x; task < (yz - ya) * kChunks;
         task += kThreads) {
      const int row = task / kChunks;
      const int q = task - row * kChunks;
      if (q * 16 >= valid) continue;
      const int yo = ya + row;
      const float f = band_f[yo - yb0];
      const float4* p0 =
          reinterpret_cast<const float4*>(ring + band_r0[yo - yb0] + q * 20);
      const float4* p1 =
          reinterpret_cast<const float4*>(ring + band_r1[yo - yb0] + q * 20);
      uint32_t w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float4 v = p0[m];
        if (f != 0.f) {
          const float4 u = p1[m];
          v.x = lerp_rn(v.x, u.x, f);
          v.y = lerp_rn(v.y, u.y, f);
          v.z = lerp_rn(v.z, u.z, f);
          v.w = lerp_rn(v.w, u.w, f);
        }
        w[m] = pack4(v);
      }
      uint8_t* dst = out_t + static_cast<size_t>(yo) * row_bytes + q * 16;
      if (aligned && q * 16 + 16 <= valid) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (q * 16 + n < valid) {
            dst[n] = static_cast<uint8_t>(w[n >> 2] >> (8 * (n & 3)));
          }
        }
      }
    }
    if (b == b_last) break;
    sq_column_stage<B>(smem + (s ^ 1) * kSlot + g * kGroup,
                       slot_steps[(s ^ 1) * kStrip + blk], d, r);
  }
}

template <int B>
int launch_sq(const void* coeffs, const void* steps, const void* d,
              const void* y0, const void* y1, const void* fy,
              const void* row_lo, const void* band_b, void* out, int t_count,
              int out_h, int nby, int nbx, int band_rows, int n_bands,
              void* stream) {
  DctF<B> m;
  for (int i = 0; i < B * B; ++i) m.m[i] = static_cast<const float*>(d)[i];
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      idct_sq_display_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sq<B>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<B>::kStrip - 1) / Sq<B>::kStrip, n_bands,
                  t_count);
  idct_sq_display_kernel<B><<<grid, kThreads, Sq<B>::kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps), m,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(band_b), static_cast<uint8_t*>(out), out_h,
      nby, nbx, band_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs: (t_count, nby, nbx, 3*B*B) float32 wire coefficients, 16-byte
// aligned; steps: (t_count, nby, nbx) float32; d: HOST pointer to the
// (B, B) float32 DCT-II matrix (passed to the kernel by value); y0, y1, fy:
// (out_h,) source rows and weights; row_lo: (nby + 1,) first output row
// whose last source row lies in block row b or later; band_b: (n_bands, 2)
// first and last source block row of each band of band_rows output rows;
// out: (t_count, out_h, nbx*B*3) uint8.
SVC_EXPORT int svc_idct4x4_display(const void* coeffs, const void* steps,
                                   const void* d, const void* y0,
                                   const void* y1, const void* fy,
                                   const void* row_lo, const void* band_b,
                                   void* out, int t_count, int out_h, int nby,
                                   int nbx, int band_rows, int n_bands,
                                   void* stream) {
  return launch_sq<4>(coeffs, steps, d, y0, y1, fy, row_lo, band_b, out,
                      t_count, out_h, nby, nbx, band_rows, n_bands, stream);
}

SVC_EXPORT int svc_idct16x16_display(const void* coeffs, const void* steps,
                                     const void* d, const void* y0,
                                     const void* y1, const void* fy,
                                     const void* row_lo, const void* band_b,
                                     void* out, int t_count, int out_h,
                                     int nby, int nbx, int band_rows,
                                     int n_bands, void* stream) {
  return launch_sq<16>(coeffs, steps, d, y0, y1, fy, row_lo, band_b, out,
                       t_count, out_h, nby, nbx, band_rows, n_bands, stream);
}
