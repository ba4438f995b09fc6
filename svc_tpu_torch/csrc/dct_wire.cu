// K2 dct8x8_to_wire: forward 8x8 DCT of packed 3-channel frames into the
// bitstream's wire layout, specialised at compile time for the codec's
// default transform block (8x8) and channel count (3).
//
// Replaces svc_tpu/ops/dct_pallas.py dct2_jsplit_to_wire_pallas (:347,
// pallas_call :416) and dct2_planes_to_wire_pallas (:282, :334). Same
// contract as the general kernel (dct_wire_general.cu), which serves every
// other block shape and channel count, and the same arithmetic in the same
// order, so the two outputs are bit-identical:
//   A[k][j] = sum_i d[k][i] * x[i][j]      (i ascending)
//   Z[k][l] = sum_j d[l][j] * A[k][j]      (j ascending)
// with the float32 DCT matrix widened to double, double FMA chains, and
// one rounding to the float32 output.
//
// Bound: memory — 1 byte read and 4 bytes of coefficient written per pixel
// and channel (250 MB per 8-frame 1080p batch). The 16 double FMAs per
// coefficient (0.8 G per batch) take a fraction of that on the FP64 pipe,
// so the design keeps everything else off the inner loops:
//  - one CTA of 384 threads per (frame, block row, strip of 16 blocks);
//  - staging: one warp per pixel row copies the strip's 384 packed bytes to
//    shared memory with 16-byte loads where the row segment is 16-byte
//    aligned and whole (every 1080p row), 4-byte or 1-byte loads otherwise
//    (1366-pixel rows are only 2-byte aligned), zero past the frame;
//  - stage 1: thread (block, channel, column j) converts its 8 pixels to
//    double once, keeps them in registers and writes A[.][j] to shared
//    memory, padded so that neither stage's accesses conflict on banks;
//  - stage 2: thread (block, channel, row k) reads A[k][.] and stores
//    Z[k][.] as two float4. A strip's blocks are contiguous in the wire
//    layout, so the CTA writes one contiguous 12 KB run;
//  - the DCT matrix (the same for rows and columns at 8x8) is a kernel
//    parameter (constant bank), widened on the host; every index is a
//    compile-time constant or a shift.
#include "common.cuh"

namespace {

constexpr int kStrip = 16;                 // blocks per CTA
constexpr int kGroups = kStrip * 3;        // (block, channel) pairs
constexpr int kThreads = kGroups * 8;      // one per column / row of a pair
constexpr int kRowBytes = kStrip * 8 * 3;  // packed bytes of a strip row
// A[k][j] of pair g at a[g * kAGroup + k * kAPitch + j]: stage 1's 8-byte
// stores (lanes along j, two pairs per half-warp) and stage 2's 16-byte
// loads (lanes along k) both spread over all 32 banks.
constexpr int kAPitch = 10;
constexpr int kAGroup = 88;

struct Dct8d {
  double m[64];
};

__global__ void __launch_bounds__(kThreads, 3)
dct8x8_wire_kernel(const uint8_t* __restrict__ packed, const Dct8d d,
                   float* __restrict__ out, int frame_offset, int frame_h,
                   int frame_w, int nby, int nbx) {
  __shared__ __align__(16) uint8_t px[8 * kRowBytes];
  __shared__ __align__(16) double a[kGroups * kAGroup];

  const int t = blockIdx.z;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * kStrip;
  const int nblk = min(kStrip, nbx - bx0);
  const uint8_t* frame = packed + static_cast<size_t>(t + frame_offset) *
                                      frame_h * frame_w * 3;

  // staging: warp i copies pixel row i of the strip
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 8) {
    const int y = by * 8 + warp;
    const int x0 = bx0 * 8;
    const int valid =
        y < frame_h ? min(kRowBytes, max(0, (frame_w - x0) * 3)) : 0;
    const uint8_t* src =
        frame + (static_cast<size_t>(y) * frame_w + x0) * 3;
    uint8_t* dst = px + warp * kRowBytes;
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

  const int g = threadIdx.x >> 3;  // block * 3 + channel
  const int r = threadIdx.x & 7;   // column j in stage 1, row k in stage 2
  const int blk = g / 3;
  const int c = g - 3 * blk;
  double* ag = a + g * kAGroup;

  // stage 1: column r of pair g
  double x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = static_cast<double>(px[i * kRowBytes + (blk * 8 + r) * 3 + c]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fma(d.m[k * 8 + i], x[i], acc);
    ag[k * kAPitch + r] = acc;
  }
  __syncthreads();

  // stage 2: row r of pair g
  double arow[8];
  const double2* a2 = reinterpret_cast<const double2*>(ag + r * kAPitch);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double2 v = a2[q];
    arow[2 * q] = v.x;
    arow[2 * q + 1] = v.y;
  }
  float z[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fma(d.m[l * 8 + j], arow[j], acc);
    z[l] = static_cast<float>(acc);
  }
  if (blk < nblk) {
    // wire offset of (block, channel, row) within the strip: thread * 8
    float4* o = reinterpret_cast<float4*>(
        out + ((static_cast<size_t>(t) * nby + by) * nbx + bx0) * 192 +
        threadIdx.x * 8);
    o[0] = make_float4(z[0], z[1], z[2], z[3]);
    o[1] = make_float4(z[4], z[5], z[6], z[7]);
  }
}

}  // namespace

// packed: (N, frame_h, frame_w*3) uint8 on the card; d: HOST pointer to
// the (8, 8) float32 DCT-II matrix (passed to the kernel by value); out:
// (t_count, nby, nbx, 192) float32 on the card.
SVC_EXPORT int svc_dct8x8_to_wire(const void* packed, const void* d,
                                  void* out, int t_count, int frame_offset,
                                  int frame_h, int frame_w, int nby, int nbx,
                                  void* stream) {
  Dct8d m;
  for (int i = 0; i < 64; ++i) m.m[i] = static_cast<const float*>(d)[i];
  const dim3 grid((nbx + kStrip - 1) / kStrip, nby, t_count);
  dct8x8_wire_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), m, static_cast<float*>(out),
      frame_offset, frame_h, frame_w, nby, nbx);
  return static_cast<int>(cudaGetLastError());
}
