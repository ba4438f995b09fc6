// K2 general (dct_to_wire_general): forward blockwise 2-D DCT of packed
// frames into the bitstream's wire layout, for any transform block shape
// and channel count. The codec's 8x8 x 3-channel case goes to the kernel
// of dct_wire.cu, whose output is bit-identical to this one's.
//
// Replaces svc_tpu/ops/dct_pallas.py dct2_jsplit_to_wire_pallas (:347,
// pallas_call :416) and dct2_planes_to_wire_pallas (:282, :334). Input is
// the packed interleaved uint8 rows (N, frame_h, frame_w*C) the host ships;
// frames [frame_offset, frame_offset + T) are transformed (the encoder
// skips the overlap frame 0). Pixels past frame_h / frame_w are the zero
// pad of the codec's padded grid. Output (T, nby, nbx, C*bh*bw) float32:
// per block, channel-major coefficient rows, exactly the wire payload.
//
// Arithmetic follows the TPU kernel's two chained contractions, in order:
//   A[k][j] = sum_i dh[k][i] * x[i][j]      (i ascending)
//   Z[k][l] = sum_j dw[l][j] * A[k][j]      (j ascending)
// with the float32 DCT matrices, accumulated in double and rounded once to
// the float32 output (no TF32 anywhere; the TPU kernel's bf16 three-term
// weight split was a TPU workaround and is dropped). Float32 accumulation
// measured up to 2 ulps (2.44e-4) from the exact transform on 1080p DC
// coefficients near 2040 — at the 2.5e-4 gate; one final rounding keeps
// the kernel within half an ulp of it. Written right and simple: its
// float-to-double conversions in the inner loops and runtime index division
// keep it an order of magnitude above its bound (PERF.md).
//
// Bound: memory writes — 4 bytes of coefficient per input byte (about
// 200 MB per 8-frame 1080p batch); 16 FMAs per coefficient are negligible.
// Design: one CTA per (frame, block row, strip of up to 16 blocks). The
// strip's bh input rows are read once, coalesced, straight from the packed
// rows (no de-interleave pass) into shared memory as float; stage 1 lands
// in shared memory; stage 2 writes the strip's coefficients, which are
// contiguous in the wire layout, as one coalesced run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dct_wire_general_kernel(const uint8_t* __restrict__ packed,
                const float* __restrict__ dh, const float* __restrict__ dw,
                float* __restrict__ out, int frame_offset, int frame_h,
                int frame_w, int channels, int nby, int nbx, int bh, int bw,
                int nb) {
  extern __shared__ double smem_d[];
  const int n = bh * bw;
  const int cn = channels * n;
  const int strip_w = nb * bw;
  double* a = smem_d;  // [nb][C][k][j] stage 1 (first: 8-byte aligned)
  float* x = reinterpret_cast<float*>(smem_d + nb * cn);  // [C][bh][nb*bw]

  const int t = blockIdx.z;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * nb;
  const int nblk = min(nb, nbx - bx0);
  const uint8_t* frame = packed + static_cast<size_t>(t + frame_offset) *
                                      frame_h * frame_w * channels;

  const int row_elems = strip_w * channels;
  for (int idx = threadIdx.x; idx < bh * row_elems; idx += blockDim.x) {
    const int i = idx / row_elems;
    const int b = idx % row_elems;  // byte within the strip's packed row
    const int px = b / channels;
    const int c = b % channels;
    const int y = by * bh + i;
    const int xg = bx0 * bw + px;
    float v = 0.f;
    if (px < nblk * bw && y < frame_h && xg < frame_w) {
      v = static_cast<float>(
          frame[(static_cast<size_t>(y) * frame_w + xg) * channels + c]);
    }
    x[(c * bh + i) * strip_w + px] = v;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nb * cn; idx += blockDim.x) {
    const int blk = idx / cn;
    const int rem = idx % cn;
    const int c = rem / n;
    const int k = (rem % n) / bw;
    const int j = rem % bw;
    const float* col = x + c * bh * strip_w + blk * bw + j;
    double acc = 0.0;
    for (int i = 0; i < bh; ++i) {
      acc = fma(static_cast<double>(dh[k * bh + i]),
                static_cast<double>(col[i * strip_w]), acc);
    }
    a[idx] = acc;
  }
  __syncthreads();

  float* o = out + ((static_cast<size_t>(t) * nby + by) * nbx + bx0) * cn;
  for (int idx = threadIdx.x; idx < nblk * cn; idx += blockDim.x) {
    const int kl = idx % n;
    const int l = kl % bw;
    const double* arow = a + (idx - l);  // a[blk][c][k][0]
    double acc = 0.0;
    for (int j = 0; j < bw; ++j) {
      acc = fma(static_cast<double>(dw[l * bw + j]), arow[j], acc);
    }
    o[idx] = static_cast<float>(acc);
  }
}

}  // namespace

// packed: (N, frame_h, frame_w*channels) uint8; dh: (bh, bh), dw: (bw, bw)
// float32 DCT-II matrices; out: (t_count, nby, nbx, channels*bh*bw) float32.
SVC_EXPORT int svc_dct_to_wire_general(const void* packed, const void* dh,
                                       const void* dw, void* out, int t_count,
                                       int frame_offset, int frame_h,
                                       int frame_w, int channels, int nby,
                                       int nbx, int bh, int bw, int nb,
                                       void* stream) {
  const int smem = nb * channels * bh * bw *
                   static_cast<int>(sizeof(float) + sizeof(double));
  if (nb < 1 || smem > kSvcDefaultSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nbx + nb - 1) / nb, nby, t_count);
  dct_wire_general_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(dh),
      static_cast<const float*>(dw), static_cast<float*>(out), frame_offset,
      frame_h, frame_w, channels, nby, nbx, bh, bw, nb);
  return static_cast<int>(cudaGetLastError());
}
