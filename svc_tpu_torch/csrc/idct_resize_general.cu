// K6 idct_resize_display_general: the decoder's general display route
// (frame width excess) in one kernel for any transform block shape and
// channel count — dequantize, inverse blockwise DCT, bilinear resample of
// rows AND columns from the padded frame to the display size, round, clip,
// and interleaved BGR bytes. The codec's default 8x8 blocks of 3 channels
// take the specialised kernel (idct_resize.cu), which gives the same bytes;
// this one serves every other shape and is its yardstick.
//
// Replaces svc_tpu/ops/resize_pallas.py resize_rows_pallas (:96, the row
// stage of the bilinear resize) together with the float, non-merged mode of
// svc_tpu/ops/dct_pallas.py idct_wire_to_pitched_pallas (:692) that feeds
// it, and the XLA column gather + blend after them: the general route of
// svc_tpu/models/decoder.py (:331-337), reached by every frame width that
// is not a multiple of the MV block (854x480, 1366x768, ...).
//
// Per element: dequantize and inverse DCT as idct_tile.cuh states, then
//   rows     r(x) = p[y0][x] * (1 - fy) + p[y1][x] * fy   (skipped: fy = 0)
//   cols     v = r(x0) * (1 - fx) + r(x1) * fx            (skipped: fx = 0)
//   display  byte = clip(rint(v), 0, 255)   (half to even, like jnp.round)
// written to packed (T, H, W*C) rows: byte X*C + c of row Y. Each product
// and sum is rounded on its own, like the plain version's separate
// tensor operations; skipping a blend whose weight is 0 gives the same
// value as computing it, so an identity axis costs no blend.
//
// Bound: memory, like K1 (4 bytes of coefficient read per output
// byte-channel, 1 written). Design: one CTA per (frame, band of output rows,
// strip of output columns). The tile's source pixels span block rows
// [br0, br0 + nbr) and block columns [bc0, bc0 + nbc) (host tables from
// the bilinear maps); a source column x1 (or row y1) that crosses into the
// next 8-wide block makes that halo block's inverse DCT be recomputed
// inside the CTA, as K1 does for its halo block row, instead of being
// exchanged with the neighbouring tile (CTAs run in no order).
#include "idct_tile.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
idct_resize_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ steps,
                   const float* __restrict__ dh, const float* __restrict__ dw,
                   const int32_t* __restrict__ y0,
                   const int32_t* __restrict__ y1,
                   const float* __restrict__ fy,
                   const int32_t* __restrict__ band_br0,
                   const int32_t* __restrict__ x0,
                   const int32_t* __restrict__ x1,
                   const float* __restrict__ fx,
                   const int32_t* __restrict__ strip_bc0,
                   uint8_t* __restrict__ out, int out_h, int out_w, int nby,
                   int nbx, int channels, int bh, int bw, int band_rows,
                   int nbr, int strip_cols, int nbc) {
  extern __shared__ float smem[];
  const int per = nbr * nbc * channels * bh * bw;
  float* planes = smem;  // planes[c][row][col], row pitch nbc * bw

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int strip = blockIdx.x;
  const int br0 = band_br0[band];
  const int bc0 = strip_bc0[strip];
  idct_tile(coeffs, steps, dh, dw, t, nby, nbx, br0, nbr, bc0, nbc, channels,
            bh, bw, planes, smem + per);

  // resample both axes + round + clip + interleave: contiguous runs of
  // each output row
  const int pitch = nbc * bw;
  const int plane_elems = nbr * bh * pitch;
  const int src_r0 = br0 * bh;
  const int src_c0 = bc0 * bw;
  const int xo0 = strip * strip_cols;
  const int run = min(strip_cols, out_w - xo0) * channels;
  const size_t row_bytes = static_cast<size_t>(out_w) * channels;
  for (int idx = threadIdx.x; idx < band_rows * run; idx += blockDim.x) {
    const int r = idx / run;
    const int b = idx % run;
    const int yo = band * band_rows + r;
    if (yo >= out_h) continue;
    const int xo = xo0 + b / channels;
    const int c = b % channels;
    const float* pl = planes + c * plane_elems;
    const float* top = pl + (y0[yo] - src_r0) * pitch;
    const float* bot = pl + (y1[yo] - src_r0) * pitch;
    const float f = fy[yo];
    const float g = fx[xo];
    const int xa = x0[xo] - src_c0;
    float v = top[xa];
    if (f != 0.f) v = lerp_rn(v, bot[xa], f);
    if (g != 0.f) {
      const int xb = x1[xo] - src_c0;
      float w = top[xb];
      if (f != 0.f) w = lerp_rn(w, bot[xb], f);
      v = lerp_rn(v, w, g);
    }
    out[(static_cast<size_t>(t) * out_h + yo) * row_bytes +
        static_cast<size_t>(xo0) * channels + b] = display_byte(v);
  }
}

}  // namespace

// coeffs: (t_count, nby, nbx, channels*bh*bw) float32 wire coefficients;
// steps: (t_count, nby, nbx) float32 quantization steps; dh, dw: DCT-II
// matrices; y0, y1, fy: (out_h,) source rows and weights; band_br0:
// (ceil(out_h / band_rows),) first source block row of each band; x0, x1,
// fx: (out_w,) source columns and weights; strip_bc0:
// (ceil(out_w / strip_cols),) first source block column of each strip; nbr
// and nbc: the most block rows / columns any band / strip reads; out:
// (t_count, out_h, out_w*channels) uint8.
SVC_EXPORT int svc_idct_resize_display_general(
    const void* coeffs, const void* steps, const void* dh, const void* dw,
    const void* y0, const void* y1, const void* fy, const void* band_br0,
    const void* x0, const void* x1, const void* fx, const void* strip_bc0,
    void* out, int t_count, int out_h, int out_w, int nby, int nbx,
    int channels, int bh, int bw, int band_rows, int nbr, int strip_cols,
    int nbc, void* stream) {
  const int smem =
      2 * nbr * nbc * channels * bh * bw * static_cast<int>(sizeof(float));
  if (nbr < 1 || nbc < 1 || band_rows < 1 || strip_cols < 1 ||
      smem > kSvcDefaultSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_bands = (out_h + band_rows - 1) / band_rows;
  const int n_strips = (out_w + strip_cols - 1) / strip_cols;
  const dim3 grid(n_strips, n_bands, t_count);
  idct_resize_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps),
      static_cast<const float*>(dh), static_cast<const float*>(dw),
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(band_br0),
      static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const float*>(fx), static_cast<const int32_t*>(strip_bc0),
      static_cast<uint8_t*>(out), out_h, out_w, nby, nbx, channels, bh, bw,
      band_rows, nbr, strip_cols, nbc);
  return static_cast<int>(cudaGetLastError());
}
