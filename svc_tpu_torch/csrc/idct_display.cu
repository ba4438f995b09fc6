// K1 idct_display: the decoder's display hot path — dequantize, inverse
// 8x8 DCT, bilinear row resample from the padded height to the display
// height, round, clip, interleaved BGR bytes — specialised at compile time
// for the codec's default transform block (8x8) and channel count (3).
//
// Replaces svc_tpu/ops/dct_pallas.py idct_wire_resample_pallas (:1077,
// pallas_call :1189) and, with identity row tables, the zero-excess
// merged-minor mode of idct_wire_to_pitched_pallas (:692, :807). Same
// contract as the general kernel (idct_display_general.cu), which serves
// every other block shape and channel count, and the same per-element
// arithmetic as idct_tile.cuh states (__fdiv_rn dequantize with half-away
// rounding, fmaf over k then over l, in ascending order), then lerp_rn and
// display_byte, so the two kernels' bytes are equal.
//
// Bound: memory — 4 bytes of coefficient read per display byte written
// (250 MB per 8-frame 1080p batch). Design:
//  - one CTA of 192 threads per (frame, strip of 8 block columns, band of
//    output rows). It walks down the band's source block rows one at a
//    time; each is dequantized and transformed once, plus one halo block
//    row per band (the neighbouring band's first). A ring of the last 16
//    pixel rows carries the previous block row, which the row lerp of an
//    output row may still need (y1 <= y0 + 1, so y0 lies in the current or
//    the previous block row of the row that completes it);
//  - the coefficients (one contiguous 6 KB run) and steps of the block row
//    after next arrive by cp.async into one of two shared-memory slots
//    while the current one is emitted and the next one transformed: two
//    barriers per block row, one after its rows stage and one before;
//  - columns: thread (block, channel, column l) dequantizes its 8
//    coefficients and transforms them in registers, writing the result back
//    in place; rows: thread (block, channel, row i) transforms a row and
//    stores its 8 pixels interleaved (B, G, R) into the ring. Both layouts
//    are padded so that no access conflicts on banks;
//  - output: a thread blends one 16-byte run of an output row and stores it
//    with one 16-byte store;
//  - host tables carry the geometry (y0, y1, fy per output row, copied to
//    shared memory per band as ring offsets; per source block row the first
//    output row it completes; per band its first and last block row), so
//    one kernel serves the resample route and, with
//    y0 = y1 = Y and f = 0, the identity route. Every index in the loops is
//    a compile-time constant or a shift.
#include "idct8x8.cuh"

namespace {

constexpr int kStrip = 8;                    // block columns per CTA
constexpr int kGroups = kStrip * 3;          // (block, channel) pairs
constexpr int kThreads = kGroups * 8;        // one per column / row of a pair
constexpr int kRowBytes = kStrip * 8 * 3;    // display bytes of a strip row
constexpr int kChunks = kRowBytes / 16;      // 16-byte output runs per row
constexpr int kSlot = kGroups * kCoefGroup;  // coefficient slot (idct8x8.cuh)
// pixel ring: source row y at row y & 15; interleaved byte position e of
// a strip row at (e >> 4) * 20 + (e & 15), so 16-byte runs start 20 floats
// apart and a quarter-warp's 16-byte loads hit distinct banks
constexpr int kRingRows = 16;
constexpr int kRingPitch = kChunks * 20 + 4;
// a band's per-row tables: two ring offsets and a weight per output row
constexpr int kMaxBandRows = 128;
constexpr int kSmemBytes =
    (2 * kSlot + kRingRows * kRingPitch + 2 * kStrip + 3 * kMaxBandRows) *
    static_cast<int>(sizeof(float));

__device__ __forceinline__ uint32_t pack4(float4 v) {
  return static_cast<uint32_t>(display_byte(v.x)) |
         static_cast<uint32_t>(display_byte(v.y)) << 8 |
         static_cast<uint32_t>(display_byte(v.z)) << 16 |
         static_cast<uint32_t>(display_byte(v.w)) << 24;
}

// Rows of pair g (block blk, channel c): row r into ring row `dst`,
// interleaved.
__device__ __forceinline__ void ring_row(const float* grp, float* dst,
                                         const Dct8f& d, int r, int blk,
                                         int c) {
  float px[8];
  row_stage(grp, d, r, px);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = (blk * 8 + j) * 3 + c;
    dst[(e >> 4) * 20 + (e & 15)] = px[j];
  }
}

__global__ void __launch_bounds__(kThreads, 6)
idct8x8_display_kernel(const float* __restrict__ coeffs,
                       const float* __restrict__ steps, const Dct8f d,
                       const int32_t* __restrict__ y0,
                       const int32_t* __restrict__ y1,
                       const float* __restrict__ fy,
                       const int32_t* __restrict__ row_lo,
                       const int32_t* __restrict__ band_b,
                       uint8_t* __restrict__ out, int out_h, int nby,
                       int nbx, int band_rows) {
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
  const int valid = nblk * 24;  // display bytes of this strip's rows
  const int yb0 = band * band_rows;
  const int yb1 = min(out_h, yb0 + band_rows);
  const int b_first = band_b[2 * band];
  const int b_last = band_b[2 * band + 1];
  const size_t row_bytes = static_cast<size_t>(nbx) * 24;
  const bool aligned = (row_bytes & 15) == 0;  // every row start is
  uint8_t* out_t = out + static_cast<size_t>(t) * out_h * row_bytes +
                   static_cast<size_t>(bx0) * 24;
  const size_t blk_row0 = static_cast<size_t>(t) * nby * nbx + bx0;

  const int g = threadIdx.x >> 3;  // block * 3 + channel
  const int r = threadIdx.x & 7;   // column l, then row i
  const int blk = g / 3;
  const int c = g - 3 * blk;

  fetch_block_row<kThreads>(
      coeffs, steps, blk_row0 + static_cast<size_t>(b_first) * nbx, nblk,
      smem, slot_steps);
  for (int i = threadIdx.x; i < yb1 - yb0; i += kThreads) {
    band_r0[i] = (y0[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_r1[i] = (y1[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_f[i] = fy[yb0 + i];
  }
  cp_async_wait_all();
  __syncthreads();
  if (b_first < b_last) {
    fetch_block_row<kThreads>(
        coeffs, steps, blk_row0 + static_cast<size_t>(b_first + 1) * nbx,
        nblk, smem + kSlot, slot_steps + kStrip);
  }
  column_stage(smem + g * kCoefGroup, slot_steps[blk], d, r);

  // Per block row b, two phases: (1) the rows stage of b into the ring;
  // (2) the output rows that b completes, the next block row's column
  // stage, and the copy of the one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    ring_row(smem + s * kSlot + g * kCoefGroup,
             ring + ((b * 8 + r) & (kRingRows - 1)) * kRingPitch, d, r, blk,
             c);
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_block_row<kThreads>(
          coeffs, steps, blk_row0 + static_cast<size_t>(b + 2) * nbx, nblk,
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
    column_stage(smem + (s ^ 1) * kSlot + g * kCoefGroup,
                 slot_steps[(s ^ 1) * kStrip + blk], d, r);
  }
}

}  // namespace

// coeffs: (t_count, nby, nbx, 192) float32 wire coefficients; steps:
// (t_count, nby, nbx) float32; d: HOST pointer to the (8, 8) float32
// DCT-II matrix (passed to the kernel by value); y0, y1, fy: (out_h,)
// source rows and weights; row_lo: (nby + 1,) first output row whose last
// source row lies in block row b or later; band_b: (n_bands, 2) first and
// last source block row of each band of band_rows output rows; out:
// (t_count, out_h, nbx*24) uint8.
SVC_EXPORT int svc_idct_display(const void* coeffs, const void* steps,
                                const void* d, const void* y0,
                                const void* y1, const void* fy,
                                const void* row_lo, const void* band_b,
                                void* out, int t_count, int out_h, int nby,
                                int nbx, int band_rows, int n_bands,
                                void* stream) {
  const Dct8f m = dct8_from_host(d);
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      idct8x8_display_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + kStrip - 1) / kStrip, n_bands, t_count);
  idct8x8_display_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps), m,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(band_b), static_cast<uint8_t*>(out), out_h,
      nby, nbx, band_rows);
  return static_cast<int>(cudaGetLastError());
}
