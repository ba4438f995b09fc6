// K2 for square transform blocks of 4 and 16 (dct4x4_to_wire,
// dct16x16_to_wire): forward B x B DCT of packed 3-channel frames into the
// bitstream's wire layout, one kernel template instantiated at B = 4 and
// B = 16 — the transform blocks users pick beside the default 8x8 (finer
// detail, or one transform block per 16x16 MV block).
//
// Replaces svc_tpu/ops/dct_pallas.py dct2_planes_to_wire_pallas (:282,
// pallas_call :334) at those shapes. Same contract as the general kernel
// (dct_wire_general.cu), which serves every other block shape and channel
// count, and the same arithmetic in the same order, so the outputs are
// bit-identical:
//   A[k][j] = sum_i d[k][i] * x[i][j]      (i ascending)
//   Z[k][l] = sum_j d[l][j] * A[k][j]      (j ascending)
// with the float32 DCT matrix widened to double, double FMA chains, and one
// rounding to the float32 output.
//
// Bound: 1 byte read and 4 bytes of coefficient written per pixel and
// channel (250 MB per 8-frame 1080p batch, 0.075 ms at 3.35 TB/s), and
// 2 * 2B float64 operations per coefficient: at B = 16 those take 0.094 ms
// at 34 TFLOP/s, so the 16x16 kernel is bound by the FP64 pipe, the 4x4 one
// by bytes. The design is dct_wire.cu's, its CTA shape kept and every
// constant a function of B:
//  - one CTA of 384 threads per (frame, block row, strip of 128 pixels):
//    32 blocks at B = 4, 8 at B = 16; a thread per (block, channel, column)
//    in stage 1 and per (block, channel, row) in stage 2;
//  - staging: warp i copies pixel rows i, i + 12, ... of the strip (384
//    packed bytes) to shared memory with 16-byte loads where the row
//    segment is 16-byte aligned and whole (every 1080p row), 4-byte or
//    1-byte loads otherwise, zero past the frame;
//  - stage 1: a thread converts its column's B pixels to double once, keeps
//    them in registers and writes A[.][j] to shared memory; A is padded per
//    B so that neither stage's 8-byte accesses conflict on banks;
//  - stage 2: a thread reads A[k][.], forms Z[k][.] and stores it as B / 4
//    float4. A strip's blocks are contiguous in the wire layout, so the CTA
//    writes one contiguous run (6 KB at B = 4, 24 KB at B = 16);
//  - the DCT matrix is a kernel parameter (constant bank, 2 KB at B = 16),
//    widened on the host; every index is a compile-time constant or a
//    shift, and the FMA loops unroll fully.
#include "common.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kStripPixels = 128;           // pixels of a strip row
constexpr int kRowBytes = kStripPixels * 3;  // packed bytes of a strip row

// Per block size B: A[k][j] of pair g at a[g * kAGroup + k * kAPitch + j]
// (doubles), and the CTAs an SM holds (registers capped to fit them).
// B = 4: a half-warp spans 4 pairs x 4 lanes; pair strides of 20 (4 banks
// of 8 bytes apart, mod 16) and row strides of 5 keep both stages' 16
// addresses distinct. B = 16: a half-warp is one pair; a row stride of 17
// does it for stage 2, stage 1 is contiguous.
template <int B> struct SqGeom;
template <> struct SqGeom<4> { static constexpr int kAPitch = 5, kAGroup = 20, kMinCtas = 4; };
template <> struct SqGeom<16> { static constexpr int kAPitch = 17, kAGroup = 272, kMinCtas = 3; };

template <int B>
struct Sq {
  static constexpr int kStrip = kStripPixels / B;  // blocks per CTA
  static constexpr int kGroups = kStrip * 3;       // (block, channel) pairs
  static constexpr int kABytes =
      kGroups * SqGeom<B>::kAGroup * static_cast<int>(sizeof(double));
  static constexpr int kSmemBytes = kABytes + B * kRowBytes;
  static_assert(kGroups * B == kThreads, "a thread per column of a pair");
  static_assert(SqGeom<B>::kAGroup >= B * SqGeom<B>::kAPitch, "A rows fit");
};

template <int B>
struct DctD {
  double m[B * B];
};

template <int B>
__global__ void __launch_bounds__(kThreads, SqGeom<B>::kMinCtas)
dct_sq_wire_kernel(const uint8_t* __restrict__ packed, const DctD<B> d,
                   float* __restrict__ out, int frame_offset, int frame_h,
                   int frame_w, int nby, int nbx) {
  constexpr int kStrip = Sq<B>::kStrip;
  constexpr int kAPitch = SqGeom<B>::kAPitch;
  extern __shared__ __align__(16) unsigned char smem_sq[];
  double* a = reinterpret_cast<double*>(smem_sq);
  uint8_t* px = smem_sq + Sq<B>::kABytes;

  const int t = blockIdx.z;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * kStrip;
  const int nblk = min(kStrip, nbx - bx0);
  const uint8_t* frame = packed + static_cast<size_t>(t + frame_offset) *
                                      frame_h * frame_w * 3;

  // staging: warp w copies pixel rows w, w + 12, ... of the strip
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < B; i += kThreads / 32) {
    const int y = by * B + i;
    const int x0 = bx0 * B;
    const int valid =
        y < frame_h ? min(kRowBytes, max(0, (frame_w - x0) * 3)) : 0;
    const uint8_t* src =
        frame + (static_cast<size_t>(y) * frame_w + x0) * 3;
    uint8_t* dst = px + i * kRowBytes;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
    if (valid == kRowBytes && (addr & 15) == 0) {
      if (lane < kRowBytes / 16) {
        reinterpret_cast<uint4*>(dst)[lane] =
            reinterpret_cast<const uint4*>(src)[lane];
      }
    } else if (valid == kRowBytes && (addr & 3) == 0) {
      for (int w = lane; w < kRowBytes / 4; w += 32) {
        reinterpret_cast<uint32_t*>(dst)[w] =
            reinterpret_cast<const uint32_t*>(src)[w];
      }
    } else {
      for (int b = lane; b < kRowBytes; b += 32) {
        dst[b] = b < valid ? src[b] : 0;
      }
    }
  }
  __syncthreads();

  const int g = threadIdx.x / B;       // block * 3 + channel (B: a power of 2)
  const int r = threadIdx.x & (B - 1);  // column j in stage 1, row k in stage 2
  const int blk = g / 3;
  const int c = g - 3 * blk;
  double* ag = a + g * SqGeom<B>::kAGroup;

  // stage 1: column r of pair g
  {
    double x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      x[i] = static_cast<double>(px[i * kRowBytes + (blk * B + r) * 3 + c]);
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      double acc = 0.0;
#pragma unroll
      for (int i = 0; i < B; ++i) acc = fma(d.m[k * B + i], x[i], acc);
      ag[k * kAPitch + r] = acc;
    }
  }
  __syncthreads();

  // stage 2: row r of pair g, four coefficients at a time
  double arow[B];
#pragma unroll
  for (int j = 0; j < B; ++j) arow[j] = ag[r * kAPitch + j];
  // wire offset of (block, channel, row) within the strip: thread * B
  float4* o = reinterpret_cast<float4*>(
      out + ((static_cast<size_t>(t) * nby + by) * nbx + bx0) * (3 * B * B) +
      threadIdx.x * B);
#pragma unroll
  for (int q = 0; q < B / 4; ++q) {
    float z[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = 4 * q + m;
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < B; ++j) acc = fma(d.m[l * B + j], arow[j], acc);
      z[m] = static_cast<float>(acc);
    }
    if (blk < nblk) o[q] = make_float4(z[0], z[1], z[2], z[3]);
  }
}

template <int B>
int launch_sq(const void* packed, const void* d, void* out, int t_count,
              int frame_offset, int frame_h, int frame_w, int nby, int nbx,
              void* stream) {
  DctD<B> m;
  for (int i = 0; i < B * B; ++i) m.m[i] = static_cast<const float*>(d)[i];
  // set on every call: the attribute is per device, and a process may
  // launch on several
  const cudaError_t err = cudaFuncSetAttribute(
      dct_sq_wire_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sq<B>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<B>::kStrip - 1) / Sq<B>::kStrip, nby, t_count);
  dct_sq_wire_kernel<B><<<grid, kThreads, Sq<B>::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), m, static_cast<float*>(out),
      frame_offset, frame_h, frame_w, nby, nbx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: (N, frame_h, frame_w*3) uint8 on the card; d: HOST pointer to
// the (B, B) float32 DCT-II matrix (passed to the kernel by value); out:
// (t_count, nby, nbx, 3*B*B) float32 on the card.
SVC_EXPORT int svc_dct4x4_to_wire(const void* packed, const void* d,
                                  void* out, int t_count, int frame_offset,
                                  int frame_h, int frame_w, int nby, int nbx,
                                  void* stream) {
  return launch_sq<4>(packed, d, out, t_count, frame_offset, frame_h,
                      frame_w, nby, nbx, stream);
}

SVC_EXPORT int svc_dct16x16_to_wire(const void* packed, const void* d,
                                    void* out, int t_count, int frame_offset,
                                    int frame_h, int frame_w, int nby,
                                    int nbx, void* stream) {
  return launch_sq<16>(packed, d, out, t_count, frame_offset, frame_h,
                       frame_w, nby, nbx, stream);
}
