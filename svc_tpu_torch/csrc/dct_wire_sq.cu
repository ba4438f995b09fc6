// K2 for transform blocks of BH rows and BW columns, BH and BW in {1, 2,
// 4, 8, 16}, all but 8x8 (dct{BH}x{BW}_to_wire): forward BH x BW DCT of
// packed 3-channel frames into the bitstream's wire layout, one kernel
// template instantiated at the squares 1x1, 2x2, 4x4 and 16x16, at the
// six rectangles of sides 4, 8 and 16, at the six with a side of 2 (2x4,
// 4x2, 2x8, 8x2, 2x16, 16x2) and at the eight with a side of 1 (1x2, 2x1,
// 1x4, 4x1, 1x8, 8x1, 1x16, 16x1) — the transform blocks users pick
// beside the default 8x8 (finer detail, one transform block per 16x16 MV
// block, or sides set apart with --transform-block-h /
// --transform-block-w). Along a side of 1 the transform is a multiply-add
// by dct_matrix(1) = [[1]], kept so that the bits stay the general
// kernel's.
//
// Replaces svc_tpu/ops/dct_pallas.py dct2_planes_to_wire_pallas (:282,
// pallas_call :334) at those shapes. Same contract as the general kernel
// (dct_wire_general.cu), which serves every other block shape and channel
// count, and the same arithmetic in the same order, so the outputs are
// bit-identical:
//   A[k][j] = sum_i dh[k][i] * x[i][j]      (i ascending, dh: BH x BH)
//   Z[k][l] = sum_j dw[l][j] * A[k][j]      (j ascending, dw: BW x BW)
// with the float32 DCT matrices widened to double, double FMA chains, and
// one rounding to the float32 output.
//
// Bound: 1 byte read and 4 bytes of coefficient written per pixel and
// channel (250 MB per 8-frame 1080p batch, 0.075 ms at 3.35 TB/s), and
// 2 * (BH + BW) float64 operations per coefficient: at 16x16 those take
// 0.094 ms at 34 TFLOP/s, so the 16x16 kernel is bound by the FP64 pipe,
// the 4x4 one by bytes, a side of 16 near both. The design is
// dct_wire.cu's, its CTA shape kept and every constant a function of
// (BH, BW):
//  - one CTA of 384 threads per (frame, block row, strip of 128 pixels):
//    128 / BW blocks; a thread per (block, channel, column) in stage 1
//    and per BH coefficients of a (block, channel) pair in stage 2 — one
//    row at BH = BW, BH / BW whole rows (q, q + BW, ...) at BH > BW, a
//    BH-wide part of a row at BH < BW —, so both stages keep all 384
//    threads busy at every shape. Where a block has a side of 1 or 2, a
//    CTA takes kStep block rows (8 pixel rows; 16 at 16x2 and 16x1), and
//    stage 2 maps its threads over those rows as over the rows of one
//    block (SqGeom's comment); at a side of 2 its output goes through
//    shared memory unless kStep * BH < BW, at a side of 1 a thread's
//    coefficients of a block row are one piece of the run, stored in
//    place. At BH < BW the part is the thread's
//    warp's (threads [p * 384 / (BW / BH), ...) take columns [p * BH,
//    p * BH + BH) of every row), and a switch on it makes the columns
//    compile-time constants: the DCT matrix's entries stay immediate
//    operands from the constant bank (indexed by lane, they become
//    constant loads that diverge within a warp: 5.5x slower at 4x16 on
//    an H100);
//  - staging: warp i copies pixel rows i, i + 12, ... of the strip (384
//    packed bytes) to shared memory with 16-byte loads where the row
//    segment is 16-byte aligned and whole (every 1080p row), 4-byte or
//    1-byte loads otherwise, zero past the frame;
//  - stage 1: a thread converts its column's BH pixels to double once,
//    keeps them in registers and writes A[.][j] to shared memory; A is
//    padded per shape so that neither stage's 8-byte accesses conflict on
//    banks;
//  - stage 2: a thread reads A[k][.] and forms its coefficients of row k.
//    A strip's blocks are contiguous in the wire layout, so the CTA writes
//    one contiguous run (3 * 128 * BH floats): at a square a thread's
//    coefficients are BH consecutive floats of it, stored as float4; at
//    BH < BW a BH-wide piece of a row, stored in place; at BH > BW whole
//    rows BW floats wide and BW rows apart, which go through shared
//    memory to one coalesced pass of float4 stores (on an H100, stored in
//    place they took 0.09 ms of 0.16 at 8x4, 0.1618 ms against 0.1102
//    staged; at BH < BW staging cost more than it saved, 0.1544 ms
//    against 0.1982 at 4x16);
//  - the DCT matrices are kernel parameters (constant bank, one matrix for
//    a square, at most 2.5 KB), widened on the host; every index is a
//    compile-time constant or a shift, and the FMA loops unroll fully.
#include "common.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kStripPixels = 128;           // pixels of a strip row
constexpr int kRowBytes = kStripPixels * 3;  // packed bytes of a strip row

// Per shape: A[k][j] of pair g at a[g * kAGroup + k * kAPitch + j]
// (doubles), and the CTAs an SM holds (registers capped to fit them).
// A half-warp's 16 8-byte accesses are free of conflicts when their
// distinct addresses are distinct mod 16 (doubles). Stage 1 stores (lanes
// along j, BW to a pair) need pair strides that spread the half-warp's
// 16 / BW pairs over distinct residues; stage 2 loads (lanes along rows:
// rows q + s * BW of a pair at BH >= BW, at BH < BW lane u of a part on
// row u % BH of pair u / BH) also need odd row strides.
//  4x4: 4 pairs x 4 lanes; pair stride 20 (4 banks of 8 bytes apart, mod
//       16), row stride 5.          16x16: a half-warp is one pair; row
//       stride 17 for stage 2, stage 1 is contiguous.
//  4x16, 8x16: row stride 17, pair strides 68 and 136 (4 and 8 mod 16):
//       stage 2's 4 pairs x 4 rows and 2 x 8 fall on distinct residues.
//  4x8: stage 1's two pairs a half-warp need a pair stride of 8 mod 16,
//       which puts stage 2's pairs g and g + 2 on the same residues: row
//       stride 9, pair stride 40, 2-way conflicts on stage 2's 8 loads.
//  8x4, 16x4, 16x8: row stride BW + 1 (5, 5, 9) and pair strides 44, 84,
//       152 (12, 4, 8 mod 16) leave the 4 or 2 pairs of a half-warp on
//       distinct residues in both stages.
// kStep is the block rows a CTA takes: 1 at the shapes above, 8 / BH
// pixel rows' worth where a block has a side of 2 (at BH = 2 one block
// row is 768 packed bytes, so a CTA of one block row would spend its
// time on launch and tail). The CTA's S = kStep * BH pixel rows of a
// pair then stand in A as the rows of one S x BW block (block row m's
// row k at A row m * BH + k), and stage 2 maps its threads as it would
// for S x BW: the layouts are those of the S x BW shape.
//  2x2, 4x2, 8x2 (S = 8), 16x2 (S = 16): stage 1's 8 pairs x 2 lanes a
//       half-warp need a pair stride of 2 mod 4; stage 2's rows q + 2s
//       an odd row stride: 3 and 26 (50 at 16x2, A's 16 rows).
//  2x4, 2x8, 2x16 (S = 8): 8x4's layout, dct_wire.cu's (9, 72) and
//       8x16's.
// A side of 1 takes the same steps (S = 8 pixel rows; 16 at 16x1, one
// block row):
//  1x2, 1x4, 1x8, 1x16: 8x2's, 8x4's, dct_wire.cu's and 8x16's layouts.
//  1x1, 2x1, 4x1, 8x1 (S = 8), 16x1 (S = 16): a thread per pair (384
//       pairs a strip), its column's S doubles in both stages; row stride
//       1 and an odd pair stride (9, 17) keep a half-warp's 16 pairs on
//       distinct residues.
template <int BH, int BW> struct SqGeom;
template <> struct SqGeom<4, 4> { static constexpr int kAPitch = 5, kAGroup = 20, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<16, 16> { static constexpr int kAPitch = 17, kAGroup = 272, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<4, 8> { static constexpr int kAPitch = 9, kAGroup = 40, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<8, 4> { static constexpr int kAPitch = 5, kAGroup = 44, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<4, 16> { static constexpr int kAPitch = 17, kAGroup = 68, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<16, 4> { static constexpr int kAPitch = 5, kAGroup = 84, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<8, 16> { static constexpr int kAPitch = 17, kAGroup = 136, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<16, 8> { static constexpr int kAPitch = 9, kAGroup = 152, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<2, 2> { static constexpr int kAPitch = 3, kAGroup = 26, kMinCtas = 4, kStep = 4; };
template <> struct SqGeom<2, 4> { static constexpr int kAPitch = 5, kAGroup = 44, kMinCtas = 4, kStep = 4; };
template <> struct SqGeom<4, 2> { static constexpr int kAPitch = 3, kAGroup = 26, kMinCtas = 4, kStep = 2; };
template <> struct SqGeom<2, 8> { static constexpr int kAPitch = 9, kAGroup = 72, kMinCtas = 4, kStep = 4; };
template <> struct SqGeom<8, 2> { static constexpr int kAPitch = 3, kAGroup = 26, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<2, 16> { static constexpr int kAPitch = 17, kAGroup = 136, kMinCtas = 3, kStep = 4; };
template <> struct SqGeom<16, 2> { static constexpr int kAPitch = 3, kAGroup = 50, kMinCtas = 2, kStep = 1; };
template <> struct SqGeom<1, 1> { static constexpr int kAPitch = 1, kAGroup = 9, kMinCtas = 4, kStep = 8; };
template <> struct SqGeom<1, 2> { static constexpr int kAPitch = 3, kAGroup = 26, kMinCtas = 4, kStep = 8; };
template <> struct SqGeom<2, 1> { static constexpr int kAPitch = 1, kAGroup = 9, kMinCtas = 4, kStep = 4; };
template <> struct SqGeom<1, 4> { static constexpr int kAPitch = 5, kAGroup = 44, kMinCtas = 4, kStep = 8; };
template <> struct SqGeom<4, 1> { static constexpr int kAPitch = 1, kAGroup = 9, kMinCtas = 4, kStep = 2; };
template <> struct SqGeom<1, 8> { static constexpr int kAPitch = 9, kAGroup = 72, kMinCtas = 4, kStep = 8; };
template <> struct SqGeom<8, 1> { static constexpr int kAPitch = 1, kAGroup = 9, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<1, 16> { static constexpr int kAPitch = 17, kAGroup = 136, kMinCtas = 3, kStep = 8; };
template <> struct SqGeom<16, 1> { static constexpr int kAPitch = 1, kAGroup = 17, kMinCtas = 3, kStep = 1; };

template <int BH, int BW>
struct Sq {
  static constexpr int kStep = SqGeom<BH, BW>::kStep;  // block rows a CTA
  static constexpr int kRowsCta = kStep * BH;          // pixel rows a CTA
  static constexpr int kStrip = kStripPixels / BW;  // blocks per CTA
  static constexpr int kGroups = kStrip * 3;        // (block, channel) pairs
  static constexpr int kRun = kGroups * BH * BW;    // floats a block row
  static constexpr int kABytes =
      kGroups * SqGeom<BH, BW>::kAGroup * static_cast<int>(sizeof(double));
  static constexpr int kSmemBytes = kABytes + kRowsCta * kRowBytes;
  // stage 2: a thread's rows of its pair's kRowsCta and the coefficients
  // of each; at kRowsCta < BW a row's columns in kSplit parts of kPart
  // threads each
  static constexpr int kRows = kRowsCta > BW ? kRowsCta / BW : 1;
  static constexpr int kCols = kRowsCta < BW ? kRowsCta : BW;
  static constexpr int kSplit = BW > kRowsCta ? BW / kRowsCta : 1;
  static constexpr int kPart = kThreads / kSplit;
  static_assert(kPart % 32 == 0, "a part is whole warps");
  static_assert(kGroups * BW == kThreads, "a thread per column of a pair");
  static_assert(SqGeom<BH, BW>::kAGroup >= kRowsCta * SqGeom<BH, BW>::kAPitch,
                "A rows fit");
};

// The two DCT matrices, widened to double; a square carries one.
template <int BH, int BW>
struct DctD {
  double h[BH * BH];
  double w[BW * BW];
};
template <int B>
struct DctD<B, B> {
  double h[B * B];
};

template <int BH, int BW>
__device__ __forceinline__ double dw_at(const DctD<BH, BW>& d, int i) {
  if constexpr (BH == BW) {
    return d.h[i];
  } else {
    return d.w[i];
  }
}

// Coefficients [L0, L0 + kCols) of one row of a pair into z: arow_s
// points at A[k][0].
template <int BH, int BW, int L0>
__device__ __forceinline__ void wire_row(const double* arow_s,
                                         const DctD<BH, BW>& d, float* z) {
  double arow[BW];
#pragma unroll
  for (int j = 0; j < BW; ++j) arow[j] = arow_s[j];
#pragma unroll
  for (int m = 0; m < Sq<BH, BW>::kCols; ++m) {
    const int l = L0 + m;
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < BW; ++j) acc = fma(dw_at(d, l * BW + j), arow[j], acc);
    z[m] = static_cast<float>(acc);
  }
}

// N consecutive floats of z to dst: float4 stores, a float2 at N = 2, a
// float at N = 1.
template <int N>
__device__ __forceinline__ void store_n(float* dst, const float* z) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      *reinterpret_cast<float4*>(dst + 4 * q) =
          make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2], z[4 * q + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(z[0], z[1]);
  } else {
    static_assert(N == 1, "1, 2 or a multiple of 4 floats");
    *dst = z[0];
  }
}

// kRowsCta < BW: the part p's kCols coefficients of a row (columns p *
// kCols, a compile-time constant in each branch), stored in place at o +
// p * kCols where `store`. The coefficients stay in the branch: carried out of the
// switch, they left registers (34 registers and 0.4506 ms at 4x16 on an
// H100, against 52 and 0.1544).
template <int BH, int BW, int P = 0>
__device__ __forceinline__ void wire_part(int p, const double* arow_s,
                                          const DctD<BH, BW>& d, float* o,
                                          bool store) {
  if constexpr (P < Sq<BH, BW>::kSplit) {
    if (p == P) {
      constexpr int kCols = Sq<BH, BW>::kCols;
      float z[kCols];
      wire_row<BH, BW, P * kCols>(arow_s, d, z);
      if (store) store_n<kCols>(o + P * kCols, z);
    } else {
      wire_part<BH, BW, P + 1>(p, arow_s, d, o, store);
    }
  }
}

template <int BH, int BW>
__global__ void __launch_bounds__(kThreads, SqGeom<BH, BW>::kMinCtas)
dct_sq_wire_kernel(const uint8_t* __restrict__ packed, const DctD<BH, BW> d,
                   float* __restrict__ out, int frame_offset, int frame_h,
                   int frame_w, int nby, int nbx) {
  constexpr int kStrip = Sq<BH, BW>::kStrip;
  constexpr int kStep = Sq<BH, BW>::kStep;
  constexpr int kS = Sq<BH, BW>::kRowsCta;
  constexpr int kAPitch = SqGeom<BH, BW>::kAPitch;
  extern __shared__ __align__(16) unsigned char smem_sq[];
  double* a = reinterpret_cast<double*>(smem_sq);
  uint8_t* px = smem_sq + Sq<BH, BW>::kABytes;

  const int t = blockIdx.z;
  const int by = blockIdx.y * kStep;  // the CTA's first block row
  const int bx0 = blockIdx.x * kStrip;
  const int nblk = min(kStrip, nbx - bx0);
  const uint8_t* frame = packed + static_cast<size_t>(t + frame_offset) *
                                      frame_h * frame_w * 3;

  // staging: warp w copies pixel rows w, w + 12, ... of the strip
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < kS; i += kThreads / 32) {
    const int y = by * BH + i;
    const int x0 = bx0 * BW;
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

  const int g = threadIdx.x / BW;  // block * 3 + channel (BW: a power of 2)
  const int r = threadIdx.x & (BW - 1);  // column j in stage 1; q in stage 2
  const int blk = g / 3;
  const int c = g - 3 * blk;
  double* ag = a + g * SqGeom<BH, BW>::kAGroup;

  // stage 1: column r of pair g, in each of the CTA's block rows
#pragma unroll
  for (int m = 0; m < kStep; ++m) {
    double x[BH];
#pragma unroll
    for (int i = 0; i < BH; ++i) {
      x[i] = static_cast<double>(
          px[(m * BH + i) * kRowBytes + (blk * BW + r) * 3 + c]);
    }
#pragma unroll
    for (int k = 0; k < BH; ++k) {
      double acc = 0.0;
#pragma unroll
      for (int i = 0; i < BH; ++i) acc = fma(d.h[k * BH + i], x[i], acc);
      ag[(m * BH + k) * kAPitch + r] = acc;
    }
  }
  __syncthreads();

  // stage 2: this thread's kS coefficients, the part's columns of row u %
  // kS of pair u / kS (kS < BW), or rows r + s * BW of pair g (kS >= BW),
  // row i of a pair being row i % BH of block row i / BH; a block row's
  // strip of coefficients is one contiguous run of the wire layout. At
  // kStep = 1 the CTA's one block row lies in the frame, and the tests
  // of kStep below keep those instances free of the step's bounds
  const size_t run_stride = static_cast<size_t>(nbx) * (3 * BH * BW);
  float* os = out + ((static_cast<size_t>(t) * nby + by) * nbx + bx0) *
                        (3 * BH * BW);
  if constexpr (kS < BW) {
    // a kS-wide piece of a row, in place: a warp's pieces are kS rows of
    // its pairs, at a stride of BW floats
    const int p = threadIdx.x / Sq<BH, BW>::kPart;  // warp-uniform
    const int u = threadIdx.x - p * Sq<BH, BW>::kPart;
    const int g2 = u / kS;
    const int i = u & (kS - 1);
    const int m = kStep == 1 ? 0 : i / BH;
    wire_part<BH, BW>(p, a + g2 * SqGeom<BH, BW>::kAGroup + i * kAPitch, d,
                      os + m * run_stride + g2 * (BH * BW) + (i % BH) * BW,
                      g2 / 3 < nblk && (kStep == 1 || by + m < nby));
  } else {
    float z[kS];
#pragma unroll
    for (int s = 0; s < Sq<BH, BW>::kRows; ++s) {
      wire_row<BH, BW, 0>(ag + (r + s * BW) * kAPitch, d, z + s * BW);
    }
    if constexpr (BH == BW && kStep == 1) {
      // row r of pair g is floats [threadIdx.x * B, + B) of the run
      if (blk < nblk) store_n<BH>(os + threadIdx.x * BH, z);
    } else if constexpr (BH == 1 || BW == 1) {
      // a side of 1: pair g's coefficients of a block row are kN
      // consecutive floats of its run — at BH = 1 row r + s * BW (block
      // row r + s * BW), at BW = 1 the column's BH (block row s) —, in
      // place; a warp's pieces of one block row are contiguous
      constexpr int kN = BW == 1 ? BH : BW;
#pragma unroll
      for (int s = 0; s < kS / kN; ++s) {
        const int m = BW == 1 ? s : r + s * BW;
        if (blk < nblk && (kStep == 1 || by + m < nby)) {
          store_n<kN>(os + m * run_stride + g * (BH * BW), z + s * kN);
        }
      }
    } else {
      // rows r + s * BW are not contiguous: through shared memory (over
      // A, once every thread has read it), block row m's run at m * kRun,
      // then out as one coalesced pass of 16-byte stores
      constexpr int kRun4 = Sq<BH, BW>::kRun / 4;
      float* zs = reinterpret_cast<float*>(smem_sq);
      static_assert(kThreads * kS * static_cast<int>(sizeof(float)) <=
                    Sq<BH, BW>::kABytes, "the runs fit over A");
      __syncthreads();
#pragma unroll
      for (int s = 0; s < Sq<BH, BW>::kRows; ++s) {
        const int i = r + s * BW;
        store_n<BW>(zs + (i / BH) * Sq<BH, BW>::kRun + g * (BH * BW) +
                        (i % BH) * BW,
                    z + s * BW);
      }
      __syncthreads();
      const int n4 = nblk * (3 * BH * BW / 4);
      for (int e = threadIdx.x; e < (kStep == 1 ? n4 : kStep * kRun4);
           e += kThreads) {
        const int m = kStep == 1 ? 0 : e / kRun4;
        const int q = e - m * kRun4;
        if (kStep == 1 || (q < n4 && by + m < nby)) {
          reinterpret_cast<float4*>(os + m * run_stride)[q] =
              reinterpret_cast<const float4*>(zs)[e];
        }
      }
    }
  }
}

template <int BH, int BW>
int launch_sq(const void* packed, const void* dh, const void* dw, void* out,
              int t_count, int frame_offset, int frame_h, int frame_w,
              int nby, int nbx, void* stream) {
  DctD<BH, BW> m;
  for (int i = 0; i < BH * BH; ++i) m.h[i] = static_cast<const float*>(dh)[i];
  if constexpr (BH != BW) {
    for (int i = 0; i < BW * BW; ++i) m.w[i] = static_cast<const float*>(dw)[i];
  }
  // set on every call: the attribute is per device, and a process may
  // launch on several
  const cudaError_t err = cudaFuncSetAttribute(
      dct_sq_wire_kernel<BH, BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sq<BH, BW>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<BH, BW>::kStrip - 1) / Sq<BH, BW>::kStrip,
                  (nby + Sq<BH, BW>::kStep - 1) / Sq<BH, BW>::kStep, t_count);
  dct_sq_wire_kernel<BH, BW><<<grid, kThreads, Sq<BH, BW>::kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), m, static_cast<float*>(out),
      frame_offset, frame_h, frame_w, nby, nbx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: (N, frame_h, frame_w*3) uint8 on the card; dh, dw: HOST pointers
// to the (BH, BH) and (BW, BW) float32 DCT-II matrices (passed to the
// kernel by value; a square reads dh only); out: (t_count, nby, nbx,
// 3*BH*BW) float32 on the card.
#define SVC_DCT_SQ_ENTRY(BH, BW)                                              \
  SVC_EXPORT int svc_dct##BH##x##BW##_to_wire(                                \
      const void* packed, const void* dh, const void* dw, void* out,          \
      int t_count, int frame_offset, int frame_h, int frame_w, int nby,       \
      int nbx, void* stream) {                                                \
    return launch_sq<BH, BW>(packed, dh, dw, out, t_count, frame_offset,      \
                             frame_h, frame_w, nby, nbx, stream);             \
  }

SVC_DCT_SQ_ENTRY(4, 4)
SVC_DCT_SQ_ENTRY(16, 16)
SVC_DCT_SQ_ENTRY(4, 8)
SVC_DCT_SQ_ENTRY(8, 4)
SVC_DCT_SQ_ENTRY(4, 16)
SVC_DCT_SQ_ENTRY(16, 4)
SVC_DCT_SQ_ENTRY(8, 16)
SVC_DCT_SQ_ENTRY(16, 8)
SVC_DCT_SQ_ENTRY(2, 2)
SVC_DCT_SQ_ENTRY(2, 4)
SVC_DCT_SQ_ENTRY(4, 2)
SVC_DCT_SQ_ENTRY(2, 8)
SVC_DCT_SQ_ENTRY(8, 2)
SVC_DCT_SQ_ENTRY(2, 16)
SVC_DCT_SQ_ENTRY(16, 2)
SVC_DCT_SQ_ENTRY(1, 1)
SVC_DCT_SQ_ENTRY(1, 2)
SVC_DCT_SQ_ENTRY(2, 1)
SVC_DCT_SQ_ENTRY(1, 4)
SVC_DCT_SQ_ENTRY(4, 1)
SVC_DCT_SQ_ENTRY(1, 8)
SVC_DCT_SQ_ENTRY(8, 1)
SVC_DCT_SQ_ENTRY(1, 16)
SVC_DCT_SQ_ENTRY(16, 1)
