// K1 general (idct_display_general): the decoder's whole display hot path
// in one kernel — dequantize, inverse blockwise DCT, bilinear row resample
// from the padded height to the display height, round, clip, and
// interleaved BGR bytes — for any transform block shape and channel count.
// The codec's 8x8 x 3-channel case goes to the kernel of idct_display.cu,
// whose bytes equal this one's.
//
// Replaces svc_tpu/ops/dct_pallas.py idct_wire_resample_pallas (:1077,
// pallas_call :1189) and, with identity row tables, the zero-excess
// merged-minor mode of idct_wire_to_pitched_pallas (:692, :807). Covers
// the width-aligned display routes of svc_tpu/models/decoder.py (:274-321):
// the column step is the identity there, so only rows are resampled.
//
// Per element: dequantize and inverse DCT as idct_tile.cuh states, then
//   resample v = top * (1 - f) + bot * f on source rows y0[Y], y1[Y]
//   display  byte = clip(rint(v), 0, 255)   (half to even, like jnp.round;
//            the dequant rounding is the other one — kept apart)
// written to packed (T, H, W*C) rows: byte X*C + c of row Y.
//
// Bound: memory. Reads 4 bytes of coefficient per output byte-channel
// (about 200 MB per 8-frame 1080p batch), writes 1 byte. Design: one CTA
// per (frame, band of output rows, strip of block columns). The band's
// source rows span block rows [br0, br0 + nbr); the resample's second
// source row y1 may fall in the next block row, so that halo block row's
// inverse DCT is recomputed inside the CTA instead of being exchanged with
// the neighbouring band (CTAs run in no order). Coefficients are read
// coalesced (each strip's blocks are contiguous in the wire layout),
// dequantized and transformed in shared memory, and the band's packed
// output bytes are written as contiguous row runs. Host-side tables (y0,
// y1, fy, br0 per band) carry the geometry, so one kernel serves the
// resample route and, with y0 = y1 = Y and f = 0, the zero-excess route.
#include "idct_tile.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
idct_display_general_kernel(const float* __restrict__ coeffs,
                    const float* __restrict__ steps,
                    const float* __restrict__ dh, const float* __restrict__ dw,
                    const int32_t* __restrict__ y0,
                    const int32_t* __restrict__ y1,
                    const float* __restrict__ fy,
                    const int32_t* __restrict__ band_br0,
                    uint8_t* __restrict__ out, int out_h, int nby, int nbx,
                    int channels, int bh, int bw, int band_rows, int nbr,
                    int nb) {
  extern __shared__ float smem[];
  const int per = nbr * nb * channels * bh * bw;
  float* planes = smem;  // planes[c][row][col], row pitch nb * bw

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int bx0 = blockIdx.x * nb;
  const int nblk = min(nb, nbx - bx0);
  const int br0 = band_br0[band];
  idct_tile(coeffs, steps, dh, dw, t, nby, nbx, br0, nbr, bx0, nb, channels,
            bh, bw, planes, smem + per);
  const int strip_w = nb * bw;
  const int plane_rows = nbr * bh;

  // resample + round + clip + interleave: contiguous runs of each row
  const int src0 = br0 * bh;
  const int run = nblk * bw * channels;
  const size_t row_bytes = static_cast<size_t>(nbx) * bw * channels;
  for (int idx = threadIdx.x; idx < band_rows * run; idx += blockDim.x) {
    const int r = idx / run;
    const int b = idx % run;
    const int yo = band * band_rows + r;
    if (yo >= out_h) continue;
    const int px = b / channels;
    const int c = b % channels;
    const float* pl = planes + c * plane_rows * strip_w + px;
    const float f = fy[yo];
    float v = pl[(y0[yo] - src0) * strip_w];
    if (f != 0.f) v = lerp_rn(v, pl[(y1[yo] - src0) * strip_w], f);
    out[(static_cast<size_t>(t) * out_h + yo) * row_bytes +
        static_cast<size_t>(bx0) * bw * channels + b] = display_byte(v);
  }
}

}  // namespace

// coeffs: (t_count, nby, nbx, channels*bh*bw) float32 wire coefficients;
// steps: (t_count, nby, nbx) float32 quantization steps; dh, dw: DCT-II
// matrices; y0, y1, fy: (out_h,) source rows and weights; band_br0:
// (ceil(out_h / band_rows),) first source block row of each output band;
// out: (t_count, out_h, nbx*bw*channels) uint8.
SVC_EXPORT int svc_idct_display_general(const void* coeffs,
                                        const void* steps, const void* dh,
                                        const void* dw, const void* y0,
                                        const void* y1, const void* fy,
                                        const void* band_br0, void* out,
                                        int t_count, int out_h, int nby,
                                        int nbx, int channels, int bh, int bw,
                                        int band_rows, int nbr, int nb,
                                        void* stream) {
  const int smem =
      2 * nbr * nb * channels * bh * bw * static_cast<int>(sizeof(float));
  if (nb < 1 || smem > kSvcDefaultSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_bands = (out_h + band_rows - 1) / band_rows;
  const dim3 grid((nbx + nb - 1) / nb, n_bands, t_count);
  idct_display_general_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps),
      static_cast<const float*>(dh), static_cast<const float*>(dw),
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(band_br0),
      static_cast<uint8_t*>(out), out_h, nby, nbx, channels, bh, bw,
      band_rows, nbr, nb);
  return static_cast<int>(cudaGetLastError());
}
