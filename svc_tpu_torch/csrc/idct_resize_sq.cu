// K6 for square transform blocks of 4 and 16 (idct4x4_resize_display,
// idct16x16_resize_display): the decoder's general display route (frame
// width excess) — dequantize, inverse B x B DCT, bilinear resample of rows
// AND columns from the padded frame to the display size, round, clip,
// interleaved BGR bytes — one kernel template instantiated at B = 4 and
// B = 16 for 3 channels.
//
// Replaces svc_tpu/ops/resize_pallas.py resize_rows_pallas (:96, the row
// stage of the bilinear resize) together with the float, non-merged mode of
// svc_tpu/ops/dct_pallas.py idct_wire_to_pitched_pallas (:692) that feeds
// it, and the XLA column gather + blend after them (svc_tpu/models/
// decoder.py:331-337), at those block shapes. Same contract as the general
// kernel (idct_resize_general.cu), which serves every other block shape and
// channel count, and the same per-element arithmetic as idct_tile.cuh
// states (__fdiv_rn dequantize with half-away rounding, fmaf over k then
// over l, in ascending order), then
//   rows     r(x) = p[y0][x] * (1 - fy) + p[y1][x] * fy   (skipped: fy = 0)
//   cols     v = r(x0) * (1 - fx) + r(x1) * fx            (skipped: fx = 0)
//   display  byte = clip(rint(v), 0, 255)
// each product and sum rounded on its own (lerp_rn), so the two kernels'
// bytes are equal.
//
// Bound: memory — 4 bytes of coefficient read per padded pixel and
// channel, about one display byte written for each (127 MB per 8-frame
// 1366x768 batch, 0.038 ms; the 4B float32 operations per coefficient take
// 0.028 ms at B = 16). The design is idct_resize.cu's (the 8x8 K6), every
// constant a function of B, with idct_display_sq.cu's slot padding:
//  - one CTA per (frame, band of output rows, strip of 64 source pixels:
//    16 block columns at B = 4, 4 at B = 16). It walks down the band's
//    block rows: the coefficients of the block row after next arrive by
//    cp.async into one of two slots while the current one is emitted and
//    the next one transformed; each block row is dequantized and
//    transformed once (column stage in place, row stage in registers) into
//    a ring of the last B + 1 pixel rows: the current block row and the
//    previous one's last row, which an output row's y0 may still be
//    (y1 <= y0 + 1);
//  - a CTA transforms the strip's block columns and one halo block column,
//    the next strip's first. An output column is emitted by the strip that
//    holds its x0; its x1 (read only where fx != 0, and then x0 + 1) lies
//    in the strip or in column 0 of the halo block. So 1/16 of the blocks
//    are transformed twice at B = 4 and 1/4 at B = 16, and no strip reads
//    another's pixels. At B = 16 the ring keeps only the halo's column 0
//    and the row stage computes only that column of a halo block: 55 KB
//    a CTA, 4 CTAs an SM (with the whole halo block: 58 KB, 3 CTAs, 14%
//    slower on an H100 SXM at 700 W); at B = 4 the whole block, 6%
//    faster there than column 0 alone. A strip
//    of 128 pixels at B = 16 would halve the halo, but its slots alone
//    take 73 KB: 2 CTAs an SM;
//  - the coefficient slot is padded per B (SqGeom: K1's square-block
//    layout) so that neither transform stage conflicts on banks; a ring
//    row's pitch leaves the row stage's stores at most two-way conflicts;
//  - output: thread k emits byte k of the strip's run in every output
//    row, so a warp's ring reads are consecutive floats and its stores one
//    coalesced run per row. Row starts are only 2-byte aligned (4,098
//    bytes a row at 1366), so the stores are single bytes, and each byte is
//    written by exactly one strip;
//  - host tables carry the geometry, copied once per geometry
//    (ops/dct.py _band_tables and _strip_tables with the block size and
//    the strip): per output row y0, y1, fy, per source block row the first
//    output row it completes, per band its first and last block row (a CTA
//    copies its band's entries to shared memory); per byte of a display
//    row the ring position of its x0 within its strip and its fx, per strip
//    its first byte (a thread keeps its byte's two in registers).
#include "idct8x8.cuh"

namespace {

constexpr int kStripPixels = 64;  // source pixels a CTA emits
// a band's per-row tables: two ring offsets and a weight per output row
constexpr int kMaxBandRows = 128;
// a strip emits at most 64 output columns (the wrapper sends a frame whose
// columns are upsampled to the general kernel), a thread per byte
constexpr int kMaxStripBytes = kStripPixels * 3;

// Per block size B: element (k, l) of pair g at g * kCoefGroup + k *
// kCoefPitch + l in a coefficient slot (floats; idct_display_sq.cu's
// layout, free of bank conflicts in both stages), the halo block's pixel
// columns the ring keeps and the ring's row pitch (floats), the threads of
// a CTA (a column of every pair of the strip and its halo block, and a
// byte of every strip row), and the CTAs an SM holds.
template <int B> struct SqGeom;
template <> struct SqGeom<4> { static constexpr int kCoefPitch = 8, kCoefGroup = 36, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 6; };
template <> struct SqGeom<16> { static constexpr int kCoefPitch = 20, kCoefGroup = 336, kHaloColumns = 1, kRingPitch = 198, kThreads = 256, kMinCtas = 4; };

template <int B>
struct Sq {
  static constexpr int kThreads = SqGeom<B>::kThreads;
  static constexpr int kStrip = kStripPixels / B;  // block columns emitted
  static constexpr int kBlocks = kStrip + 1;       // ... and the halo
  static constexpr int kGroups = kBlocks * 3;      // (block, channel) pairs
  static constexpr int kSlot = kGroups * SqGeom<B>::kCoefGroup;
  // pixel ring: source row y at row y % (B + 1), interleaved
  // (x * 3 + channel): the strip's pixels and the halo's first columns
  static constexpr int kRingRows = B + 1;
  static constexpr int kHaloColumns = SqGeom<B>::kHaloColumns;
  static constexpr int kRingPitch = SqGeom<B>::kRingPitch;
  static constexpr int kSmemBytes =
      (2 * kSlot + kRingRows * kRingPitch + 2 * kBlocks + 3 * kMaxBandRows) *
      static_cast<int>(sizeof(float));
  static_assert(kGroups * B <= kThreads, "a thread per column of a pair");
  static_assert(kMaxStripBytes <= kThreads, "a thread per byte of a strip row");
  static_assert(kHaloColumns >= 1 && kHaloColumns <= B, "x1 of the last x0");
  static_assert(kRingPitch >= (kStripPixels + kHaloColumns) * 3, "ring rows");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(SqGeom<B>::kCoefGroup >= B * SqGeom<B>::kCoefPitch,
                "slot rows fit");
  static_assert((kSlot * sizeof(float)) % 16 == 0, "16-byte slot copies");
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
  for (int ch = threadIdx.x; ch < nblk * 3 * kPairChunks;
       ch += Sq<B>::kThreads) {
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

// Rows of pair g: the first `cols` pixels of row r (B, or of a halo block
// the ring's columns), j ascending, to dst[3 * j] (the pair's pixels
// interleaved with the other two channels in a ring row).
template <int B, int cols>
__device__ __forceinline__ void sq_row_stage(const float* grp,
                                             const DctF<B>& d, int r,
                                             float* dst) {
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
  for (int j = 0; j < cols; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < B; ++l) acc = fmaf(a[l], d.m[l * B + j], acc);
    dst[3 * j] = acc;
  }
}

template <int B>
__global__ void __launch_bounds__(SqGeom<B>::kThreads, SqGeom<B>::kMinCtas)
idct_sq_resize_kernel(const float* __restrict__ coeffs,
                      const float* __restrict__ steps, const DctF<B> d,
                      const int32_t* __restrict__ y0,
                      const int32_t* __restrict__ y1,
                      const float* __restrict__ fy,
                      const int32_t* __restrict__ row_lo,
                      const int32_t* __restrict__ band_b,
                      const int32_t* __restrict__ col_e,
                      const float* __restrict__ col_f,
                      const int32_t* __restrict__ strip_lo,
                      uint8_t* __restrict__ out, int out_h, int out_w,
                      int nby, int nbx, int band_rows) {
  using S = Sq<B>;
  constexpr int kGroup = SqGeom<B>::kCoefGroup;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 2 * S::kSlot;
  float* slot_steps = ring + S::kRingRows * S::kRingPitch;
  // per output row of the band: ring offsets of y0 and y1, and fy
  int* band_r0 = reinterpret_cast<int*>(slot_steps + 2 * S::kBlocks);
  int* band_r1 = band_r0 + kMaxBandRows;
  float* band_f = reinterpret_cast<float*>(band_r1 + kMaxBandRows);

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int strip = blockIdx.x;
  const int byte0 = strip_lo[strip];
  const int nbytes = strip_lo[strip + 1] - byte0;
  if (nbytes == 0) return;  // no output column has its x0 here
  const int bx0 = strip * S::kStrip;
  const int nblk = min(S::kBlocks, nbx - bx0);
  const int yb0 = band * band_rows;
  const int yb1 = min(out_h, yb0 + band_rows);
  const int b_first = band_b[2 * band];
  const int b_last = band_b[2 * band + 1];
  const size_t row_bytes = static_cast<size_t>(out_w) * 3;
  uint8_t* out_t = out + static_cast<size_t>(t) * out_h * row_bytes + byte0;
  const size_t blk_row0 = static_cast<size_t>(t) * nby * nbx + bx0;

  // thread (pair g = block * 3 + channel, lane r); threads past the pairs
  // only copy and emit
  const bool transforms = threadIdx.x < S::kGroups * B;
  const int g = threadIdx.x / B;
  const int r = threadIdx.x & (B - 1);
  const int blk = g / 3;
  const int c = g - 3 * blk;
  // thread k < nbytes emits byte k of the strip's run: the ring position
  // of its x0 (channel included) and its fx
  const bool emits = threadIdx.x < nbytes;
  const int e = emits ? col_e[byte0 + threadIdx.x] : 0;
  const float g_x = emits ? col_f[byte0 + threadIdx.x] : 0.f;

  fetch_sq_row<B>(coeffs, steps,
                  blk_row0 + static_cast<size_t>(b_first) * nbx, nblk, smem,
                  slot_steps);
  for (int i = threadIdx.x; i < yb1 - yb0; i += S::kThreads) {
    band_r0[i] = (y0[yb0 + i] % S::kRingRows) * S::kRingPitch;
    band_r1[i] = (y1[yb0 + i] % S::kRingRows) * S::kRingPitch;
    band_f[i] = fy[yb0 + i];
  }
  cp_async_wait_all();
  __syncthreads();
  if (b_first < b_last) {
    fetch_sq_row<B>(coeffs, steps,
                    blk_row0 + static_cast<size_t>(b_first + 1) * nbx, nblk,
                    smem + S::kSlot, slot_steps + S::kBlocks);
  }
  if (transforms) {
    sq_column_stage<B>(smem + g * kGroup, slot_steps[blk], d, r);
  }

  // Per block row b, two phases: (1) the rows stage of b into the ring;
  // (2) the output rows that b completes, the next block row's column
  // stage, and the copy of the one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    if (transforms) {
      const float* grp = smem + s * S::kSlot + g * kGroup;
      float* dst = ring + ((b * B + r) % S::kRingRows) * S::kRingPitch +
                   blk * (3 * B) + c;
      // the halo block's pairs are the last 3B transform lanes, past the
      // 6 warps of the strip's: their warps hold no other pair
      if (S::kHaloColumns < B && blk == S::kStrip) {
        sq_row_stage<B, S::kHaloColumns>(grp, d, r, dst);
      } else {
        sq_row_stage<B, B>(grp, d, r, dst);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_sq_row<B>(coeffs, steps,
                      blk_row0 + static_cast<size_t>(b + 2) * nbx, nblk,
                      smem + s * S::kSlot, slot_steps + s * S::kBlocks);
    }
    if (emits) {
      uint8_t* dst = out_t + static_cast<size_t>(ya) * row_bytes + threadIdx.x;
      for (int i = ya - yb0; i < yz - yb0; ++i, dst += row_bytes) {
        const float f = band_f[i];
        const float* top = ring + band_r0[i];
        const float* bot = ring + band_r1[i];
        float v = top[e];
        if (f != 0.f) v = lerp_rn(v, bot[e], f);
        if (g_x != 0.f) {
          float w = top[e + 3];
          if (f != 0.f) w = lerp_rn(w, bot[e + 3], f);
          v = lerp_rn(v, w, g_x);
        }
        *dst = display_byte(v);
      }
    }
    if (b == b_last) break;
    if (transforms) {
      sq_column_stage<B>(smem + (s ^ 1) * S::kSlot + g * kGroup,
                         slot_steps[(s ^ 1) * S::kBlocks + blk], d, r);
    }
  }
}

template <int B>
int launch_sq_resize(const void* coeffs, const void* steps, const void* d,
                     const void* y0, const void* y1, const void* fy,
                     const void* row_lo, const void* band_b,
                     const void* col_e, const void* col_f,
                     const void* strip_lo, void* out, int t_count, int out_h,
                     int out_w, int nby, int nbx, int band_rows, int n_bands,
                     void* stream) {
  DctF<B> m;
  for (int i = 0; i < B * B; ++i) m.m[i] = static_cast<const float*>(d)[i];
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // past 48 KB at B = 16: the opt-in, set on every call (cheap, and a
  // graph capture may hold the first launch of a device)
  const cudaError_t err = cudaFuncSetAttribute(
      idct_sq_resize_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sq<B>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<B>::kStrip - 1) / Sq<B>::kStrip, n_bands,
                  t_count);
  idct_sq_resize_kernel<B><<<grid, Sq<B>::kThreads, Sq<B>::kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps), m,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(band_b),
      static_cast<const int32_t*>(col_e), static_cast<const float*>(col_f),
      static_cast<const int32_t*>(strip_lo), static_cast<uint8_t*>(out),
      out_h, out_w, nby, nbx, band_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs: (t_count, nby, nbx, 3*B*B) float32 wire coefficients, 16-byte
// aligned; steps: (t_count, nby, nbx) float32; d: HOST pointer to the
// (B, B) float32 DCT-II matrix (passed to the kernel by value); y0, y1, fy:
// (out_h,) source rows and weights; row_lo: (nby + 1,) first output row
// whose last source row lies in block row b or later; band_b: (n_bands, 2)
// first and last source block row of each band of band_rows output rows;
// col_e, col_f: (out_w * 3,) per display-row byte the ring position of its
// x0 within its strip of 64 pixels and fx; strip_lo: (ceil(nbx * B / 64) +
// 1,) the first byte of each strip (at most 192 a strip); out: (t_count,
// out_h, out_w*3) uint8.
SVC_EXPORT int svc_idct4x4_resize_display(
    const void* coeffs, const void* steps, const void* d, const void* y0,
    const void* y1, const void* fy, const void* row_lo, const void* band_b,
    const void* col_e, const void* col_f, const void* strip_lo, void* out,
    int t_count, int out_h, int out_w, int nby, int nbx, int band_rows,
    int n_bands, void* stream) {
  return launch_sq_resize<4>(coeffs, steps, d, y0, y1, fy, row_lo, band_b,
                             col_e, col_f, strip_lo, out, t_count, out_h,
                             out_w, nby, nbx, band_rows, n_bands, stream);
}

SVC_EXPORT int svc_idct16x16_resize_display(
    const void* coeffs, const void* steps, const void* d, const void* y0,
    const void* y1, const void* fy, const void* row_lo, const void* band_b,
    const void* col_e, const void* col_f, const void* strip_lo, void* out,
    int t_count, int out_h, int out_w, int nby, int nbx, int band_rows,
    int n_bands, void* stream) {
  return launch_sq_resize<16>(coeffs, steps, d, y0, y1, fy, row_lo, band_b,
                              col_e, col_f, strip_lo, out, t_count, out_h,
                              out_w, nby, nbx, band_rows, n_bands, stream);
}
