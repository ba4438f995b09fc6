// K6 idct_resize_display: the decoder's general display route (frame
// width excess) — dequantize, inverse 8x8 DCT, bilinear resample of rows
// AND columns from the padded frame to the display size, round, clip,
// interleaved BGR bytes — specialised at compile time for the codec's
// default transform block (8x8) and channel count (3).
//
// Replaces svc_tpu/ops/resize_pallas.py resize_rows_pallas (:96, the row
// stage of the bilinear resize) together with the float, non-merged mode of
// svc_tpu/ops/dct_pallas.py idct_wire_to_pitched_pallas (:692) that feeds
// it, and the XLA column gather + blend after them: the general route of
// svc_tpu/models/decoder.py (:331-337), reached by every frame width that
// is not a multiple of the MV block (854x480, 1366x768, ...). Same
// contract as the general kernel (idct_resize_general.cu), which serves
// every other block shape and channel count, and the same per-element
// arithmetic: dequantize and inverse DCT as idct8x8.cuh states, then
//   rows     r(x) = p[y0][x] * (1 - fy) + p[y1][x] * fy   (skipped: fy = 0)
//   cols     v = r(x0) * (1 - fx) + r(x1) * fx            (skipped: fx = 0)
//   display  byte = clip(rint(v), 0, 255)
// each product and sum rounded on its own (lerp_rn), so the two kernels'
// bytes are equal.
//
// Bound: memory — 4 bytes of coefficient read per padded pixel and
// channel, about one display byte written for each (127 MB per 8-frame
// 1366x768 batch). Design:
//  - one CTA of 224 threads per (frame, band of output rows, strip of 8
//    source block columns). It walks down the band's block rows as K1
//    does: the coefficients of the block row after next arrive by
//    cp.async into one of two slots while the current one is emitted and
//    the next one transformed; each block row is dequantized and
//    transformed once (column stage in place, row stage in registers)
//    into a ring of the last 16 pixel rows;
//  - the ring is 9 blocks wide: the strip's 8 and one halo block column,
//    the next strip's first. An output column is emitted by the strip that
//    holds its x0; its x1 (read only where fx != 0, and then x0 + 1) lies
//    in the strip or in column 0 of the halo block. So 12.5% of the blocks
//    are transformed twice, and no strip reads the one before it;
//  - output: thread k emits byte k of the strip's run in every output
//    row, so a warp's ring reads are consecutive floats (no bank conflicts)
//    and its stores one coalesced run per row. A display row is out_w * 3
//    bytes (4,098 at 1366), so row starts are only 2-byte aligned; byte
//    stores need no aligned head or tail, and each byte is written by
//    exactly one strip;
//  - host tables carry the geometry, copied once per geometry: per output
//    row y0, y1, fy, per source block row the first output row it
//    completes, per band its first and last block row (K1's tables; a CTA
//    copies its band's entries to shared memory); per byte of a display
//    row the ring position of its x0 within its strip (3 * (x0 - 64 *
//    strip) + channel) and its fx, per strip its first byte (a thread keeps
//    its byte's two in registers).
#include "idct8x8.cuh"

namespace {

constexpr int kStrip = 8;                   // block columns a CTA emits
constexpr int kBlocks = kStrip + 1;         // ... and the halo block column
constexpr int kGroups = kBlocks * 3;        // (block, channel) pairs
constexpr int kTransformThreads = kGroups * 8;  // a column / row of a pair
constexpr int kThreads = 224;               // 7 warps
constexpr int kSlot = kGroups * kCoefGroup;  // coefficient slot (idct8x8.cuh)
// pixel ring: source row y at row y & 15, interleaved (x * 3 + channel);
// a pitch of 28 banks mod 32 puts the 8 rows one warp's row stage writes
// 4 banks apart (two-way conflicts at most)
constexpr int kRingRows = 16;
constexpr int kRingPitch = kBlocks * 24 + 4;
// a band's per-row tables: two ring offsets and a weight per output row
constexpr int kMaxBandRows = 128;
// a strip emits at most 64 output columns (the wrapper sends a frame whose
// columns are upsampled to the general kernel), a thread per byte
constexpr int kMaxStripBytes = kStrip * 8 * 3;
constexpr int kSmemBytes =
    (2 * kSlot + kRingRows * kRingPitch + 2 * kBlocks + 3 * kMaxBandRows) *
    static_cast<int>(sizeof(float));
static_assert(kTransformThreads <= kThreads, "a thread per column of a pair");
static_assert(kMaxStripBytes <= kThreads, "a thread per byte of a strip row");
static_assert(kSmemBytes <= kSvcDefaultSmemBytes, "no shared-memory opt-in");

__global__ void __launch_bounds__(kThreads, 5)
idct8x8_resize_kernel(const float* __restrict__ coeffs,
                      const float* __restrict__ steps, const Dct8f d,
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
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 2 * kSlot;
  float* slot_steps = ring + kRingRows * kRingPitch;
  // per output row of the band: ring offsets of y0 and y1, and fy
  int* band_r0 = reinterpret_cast<int*>(slot_steps + 2 * kBlocks);
  int* band_r1 = band_r0 + kMaxBandRows;
  float* band_f = reinterpret_cast<float*>(band_r1 + kMaxBandRows);

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int strip = blockIdx.x;
  const int byte0 = strip_lo[strip];
  const int nbytes = strip_lo[strip + 1] - byte0;
  if (nbytes == 0) return;  // no output column has its x0 here
  const int bx0 = strip * kStrip;
  const int nblk = min(kBlocks, nbx - bx0);
  const int yb0 = band * band_rows;
  const int yb1 = min(out_h, yb0 + band_rows);
  const int b_first = band_b[2 * band];
  const int b_last = band_b[2 * band + 1];
  const size_t row_bytes = static_cast<size_t>(out_w) * 3;
  uint8_t* out_t = out + static_cast<size_t>(t) * out_h * row_bytes + byte0;
  const size_t blk_row0 = static_cast<size_t>(t) * nby * nbx + bx0;

  // thread (pair g = block * 3 + channel, lane r); threads past the 27
  // pairs only copy and emit
  const bool transforms = threadIdx.x < kTransformThreads;
  const int g = threadIdx.x >> 3;
  const int r = threadIdx.x & 7;
  const int blk = g / 3;
  const int c = g - 3 * blk;
  // thread k < nbytes emits byte k of the strip's run: the ring position
  // of its x0 (channel included) and its fx
  const bool emits = threadIdx.x < nbytes;
  const int e = emits ? col_e[byte0 + threadIdx.x] : 0;
  const float g_x = emits ? col_f[byte0 + threadIdx.x] : 0.f;

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
        nblk, smem + kSlot, slot_steps + kBlocks);
  }
  if (transforms) column_stage(smem + g * kCoefGroup, slot_steps[blk], d, r);

  // Per block row b, two phases: (1) the rows stage of b into the ring;
  // (2) the output rows that b completes, the next block row's column
  // stage, and the copy of the one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    if (transforms) {
      float px[8];
      row_stage(smem + s * kSlot + g * kCoefGroup, d, r, px);
      float* dst = ring + ((b * 8 + r) & (kRingRows - 1)) * kRingPitch +
                   blk * 24 + c;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j * 3] = px[j];
    }
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_block_row<kThreads>(
          coeffs, steps, blk_row0 + static_cast<size_t>(b + 2) * nbx, nblk,
          smem + s * kSlot, slot_steps + s * kBlocks);
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
      column_stage(smem + (s ^ 1) * kSlot + g * kCoefGroup,
                   slot_steps[(s ^ 1) * kBlocks + blk], d, r);
    }
  }
}

}  // namespace

// coeffs: (t_count, nby, nbx, 192) float32 wire coefficients, 16-byte
// aligned; steps: (t_count, nby, nbx) float32; d: HOST pointer to the
// (8, 8) float32 DCT-II matrix (passed to the kernel by value); y0, y1,
// fy: (out_h,) source rows and weights; row_lo: (nby + 1,) first output row
// whose last source row lies in block row b or later; band_b: (n_bands, 2)
// first and last source block row of each band of band_rows output rows;
// col_e, col_f: (out_w * 3,) per display-row byte the ring position of its
// x0 within its strip and fx; strip_lo: (ceil(nbx / 8) + 1,) the first byte
// of each strip (at most 192 a strip); out: (t_count, out_h, out_w*3)
// uint8.
SVC_EXPORT int svc_idct_resize_display(
    const void* coeffs, const void* steps, const void* d, const void* y0,
    const void* y1, const void* fy, const void* row_lo, const void* band_b,
    const void* col_e, const void* col_f, const void* strip_lo, void* out,
    int t_count, int out_h, int out_w, int nby, int nbx, int band_rows,
    int n_bands, void* stream) {
  const Dct8f m = dct8_from_host(d);
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nbx + kStrip - 1) / kStrip, n_bands, t_count);
  idct8x8_resize_kernel<<<grid, kThreads, kSmemBytes,
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
