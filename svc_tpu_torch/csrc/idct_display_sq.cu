// K1 for transform blocks of BH rows and BW columns, BH and BW in {1, 2,
// 4, 8, 16}, all but 8x8 (idct{BH}x{BW}_display): the decoder's display
// hot path — dequantize, inverse BH x BW DCT, bilinear row resample from
// the padded height to the display height, round, clip, interleaved BGR
// bytes — one kernel template instantiated at the squares 1x1, 2x2, 4x4
// and 16x16, at the six rectangles of sides 4, 8 and 16, at the six with
// a side of 2 and at the eight with a side of 1 (1x2, 2x1, 1x4, 4x1, 1x8,
// 8x1, 1x16, 16x1), for 3 channels. Along a side of 1 the transform is a
// multiply-add by dct_matrix(1) = [[1]], kept so that the bits stay the
// general kernel's (fmaf(-0, 1, 0) is +0).
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
// (250 MB per 8-frame 1080p batch, 0.075 ms at every shape) and 4 bytes
// of step a block (67 MB at 1x1: 0.095 ms; the 2 * (BH + BW) float32
// operations per pixel and channel take 0.048 ms at 16x16). The design is
// idct_display.cu's, its CTA shape kept and every constant a function of
// (BH, BW):
//  - one CTA of 192 threads per (frame, strip of 64 pixels — 64 / BW block
//    columns —, band of output rows). It walks down the band's source
//    block rows (BH pixel rows each) one at a time; each is dequantized
//    and transformed once, plus one halo block row per band. A ring of
//    the last 2 BH pixel rows carries the previous block row, which the
//    row lerp of an output row may still need (y1 <= y0 + 1). Where a
//    block has a side of 1 or 2, a walk step takes kStep block rows (8
//    pixel rows; 16 at 16x2 and 16x1) and the ring 2 steps (SqGeom's
//    comment);
//  - the coefficients of the block row after next (one contiguous run of
//    strip * 3 * BH * BW floats, 3 KB to 12 KB) and their steps arrive by
//    cp.async into one of two shared-memory slots while the current block
//    row is emitted and the next one transformed;
//  - columns: thread (block, channel, column l) dequantizes its BH
//    coefficients and transforms them in registers, writing the result
//    back in place; rows: a thread transforms BH pixels of a pair — row q
//    of pair g (thread (g, q)) at BH = BW, rows q, q + BW, ... at BH > BW,
//    at BH < BW columns [p * BH, p * BH + BH) of row u % BH of pair u / BH
//    (thread u of part p, the threads split in BW / BH parts) — from
//    16-byte loads (8-byte at BW = 2; at BW = 1 its pair's S rows at
//    once) and stores them interleaved into the ring, so every thread
//    works in both stages. A switch on the part makes its columns
//    compile-time constants, so the DCT matrix's entries stay immediate
//    operands from the constant bank (at 4x16 a part is 48 threads: two
//    of the six warps take two parts in turn). The slot is padded per
//    shape against bank conflicts;
//  - output: a thread blends one 16-byte run of an output row and stores
//    it with one 16-byte store;
//  - host tables carry the geometry (ops/dct.py _band_tables with a
//    step's pixel rows and the strip), so one kernel serves the resample route
//    and, with y0 = y1 = Y and f = 0, the identity route. Every index in
//    the loops is a compile-time constant or a shift.
#include "idct_sq.cuh"

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

// Per shape: element (k, l) of pair g at g * kCoefGroup + k * kCoefPitch
// + l in a coefficient slot (floats), and the CTAs an SM holds. Column
// stage (lanes along l, BW to a pair, 4-byte accesses): a warp's 32 / BW
// pairs start at distinct multiples of BW banks. Row stage (16-byte loads,
// a quarter-warp's 8 rows at distinct multiples of 4 banks):
//  4x4: row stride 8, odd pair offsets (kCoefGroup / 4 odd). 16x16: row
//       stride 20, 5 groups of 4 banks.
//  4x16, 8x16: row stride 20 and pair strides 80 and 176 keep a
//       quarter-warp's 2 pairs x 4 rows and 8 rows apart, and a warp's 2
//       column groups.
//  4x8: the column stage's 4 pairs a warp need pair strides of 8 mod 32
//       floats, which puts the row stage's pairs g and g + 2 on the same
//       bank groups: row stride 8, pair stride 40, 2-way conflicts on its
//       2 float4 loads a block row.
//  8x4, 16x8: rows q + s * BW; row strides 8 and 12, pair strides 68 and
//       200 (17 and 50 groups of 4 banks).
//  16x4: row stride 4 and pair stride 68 keep the column stage (16 rows
//       of a pair) free, but a quarter-warp's two pairs meet on one bank
//       group in the row stage: 2-way conflicts on its 4 float4 loads a
//       block row. The free layout (row stride 8, pair stride 132) needs
//       83,584 bytes of shared memory, 2 CTAs an SM; this one 59,008, 3.
// kMinCtas caps the registers at 65,536 / (192 kMinCtas): 4x8 and 4x16
// fit 6 CTAs in 56 and 55 registers without spills (ptxas on sm_90a);
// 8x16 takes 4 (80 registers): at 5 (63) it ran 0.7% slower on an H100.
// kStep is the block rows a walk step takes: 1 at the shapes above, 8 /
// BH pixel rows' worth where a block has a side of 2 (at BH = 2 one block
// row is 1.5 KB of coefficients, and a 128-row band would take 64 steps
// of three barriers each). A step's S = kStep * BH rows of a pair stand
// in the slot as the rows of one S x BW block (block row m's row k at
// slot row m * BH + k); the row stage maps its threads as for S x BW and
// the ring keeps 2 S rows, so the layouts are those of the S x BW shape:
//  2x4, 2x8, 2x16 (S = 8): 8x4's, idct_display.cu's (12, 104), 8x16's.
//  2x2, 4x2, 8x2 (S = 8), 16x2 (S = 16): a 16-byte chunk is two rows, so
//       the row stride is 2 and the pair stride a multiple of 4; 20 (36
//       at 16x2, 4 mod 8) keeps the row stage's float2 loads free (a
//       half-warp's 8 pairs x 2 rows) and leaves the column stage's
//       4-byte accesses 2-way (16 pairs a warp on 8 bank offsets).
// A side of 1 takes the same steps (S = 8 pixel rows; 16 at 16x1, one
// block row). Its blocks are 1 to 16 floats, so fetch_side_1 copies a
// step's runs in one pass, 4, 8 or 16 bytes a copy, each to its slot
// place; the layouts:
//  1x2, 1x4, 1x8, 1x16: 8x2's, 8x4's, idct_display.cu's, 8x16's.
//  1x1, 2x1, 4x1, 8x1 (S = 8), 16x1 (S = 16): a thread per pair, whose
//       S floats are one slot column (row stride 1) that both stages read
//       and write at once (load_column): as float4s at a pair stride of
//       an odd multiple of 4 (12, 20: a quarter-warp's 8 on distinct bank
//       groups), at 1x1 as floats at an odd stride (9: a warp's 32 on
//       distinct banks, and 5 CTAs an SM at 12).
template <int BH, int BW> struct SqGeom;
template <> struct SqGeom<4, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 36, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<16, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 336, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<4, 8> { static constexpr int kCoefPitch = 8, kCoefGroup = 40, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<8, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kMinCtas = 5, kStep = 1; };
template <> struct SqGeom<4, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 80, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<16, 4> { static constexpr int kCoefPitch = 4, kCoefGroup = 68, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<8, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<16, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 200, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<2, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<2, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kMinCtas = 5, kStep = 4; };
template <> struct SqGeom<4, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kMinCtas = 6, kStep = 2; };
template <> struct SqGeom<2, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 104, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<8, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<2, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<16, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 36, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<1, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 9, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<1, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<2, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<1, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kMinCtas = 5, kStep = 8; };
template <> struct SqGeom<4, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kMinCtas = 6, kStep = 2; };
template <> struct SqGeom<1, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 104, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<8, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<1, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<16, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 20, kMinCtas = 3, kStep = 1; };

template <int BH, int BW>
struct Sq {
  static constexpr int kStep = SqGeom<BH, BW>::kStep;  // block rows a step
  static constexpr int kRowsStep = kStep * BH;          // pixel rows a step
  static constexpr int kStrip = kStripPixels / BW;  // block columns per CTA
  static constexpr int kGroups = kStrip * 3;        // (block, channel) pairs
  static constexpr int kSlot = kGroups * SqGeom<BH, BW>::kCoefGroup;
  static constexpr int kSteps = kStep * kStrip;  // a slot's steps
  static constexpr int kRingRows = 2 * kRowsStep;  // this step and the last
  static constexpr int kSmemBytes =
      (2 * kSlot + kRingRows * kRingPitch + 2 * kSteps + 3 * kMaxBandRows) *
      static_cast<int>(sizeof(float));
  // row stage: a thread's rows of its pair's kRowsStep and the pixels of
  // each; at kRowsStep < BW a row's columns in kSplit parts of kPart
  // threads each
  static constexpr int kRows = kRowsStep > BW ? kRowsStep / BW : 1;
  static constexpr int kCols = kRowsStep < BW ? kRowsStep : BW;
  static constexpr int kSplit = BW > kRowsStep ? BW / kRowsStep : 1;
  static constexpr int kPart = kThreads / kSplit;
  static_assert(kGroups * BW == kThreads, "a thread per column of a pair");
  static_assert(SqGeom<BH, BW>::kCoefGroup >=
                    kRowsStep * SqGeom<BH, BW>::kCoefPitch,
                "slot rows fit");
};

// Pixels [J0, J0 + kCols) of one row of pair (block blk, channel c), j
// ascending: arow points at the row in the slot, dst at its ring row.
template <int BH, int BW, int J0>
__device__ __forceinline__ void ring_row(const float* arow, float* dst,
                                         const DctF<BH, BW>& d, int blk,
                                         int c) {
  float a[BW];
  if constexpr (BW >= 4) {
#pragma unroll
    for (int q = 0; q < BW / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(arow + 4 * q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(arow);
    a[0] = v.x;
    a[1] = v.y;
  }
#pragma unroll
  for (int jj = 0; jj < Sq<BH, BW>::kCols; ++jj) {
    const int j = J0 + jj;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < BW; ++l) acc = fmaf(a[l], dw_at(d, l * BW + j), acc);
    const int e = (blk * BW + j) * 3 + c;
    dst[(e >> 4) * 20 + (e & 15)] = acc;
  }
}

// ring_row at the part p's columns (p * kCols), as a compile-time
// constant.
template <int BH, int BW, int P = 0>
__device__ __forceinline__ void ring_part(int p, const float* arow, float* dst,
                                          const DctF<BH, BW>& d, int blk,
                                          int c) {
  if constexpr (P < Sq<BH, BW>::kSplit) {
    if (p == P) {
      ring_row<BH, BW, P * Sq<BH, BW>::kCols>(arow, dst, d, blk, c);
    } else {
      ring_part<BH, BW, P + 1>(p, arow, dst, d, blk, c);
    }
  }
}

// The row stage of step b (block rows b * kStep, ...) from a slot into
// the ring: this thread's kRowsStep pixels, interleaved.
template <int BH, int BW>
__device__ __forceinline__ void sq_ring_rows(const float* slot, float* ring,
                                             const DctF<BH, BW>& d, int b) {
  constexpr int kS = Sq<BH, BW>::kRowsStep;
  constexpr int kRingRows = Sq<BH, BW>::kRingRows;
  constexpr int kPitch = SqGeom<BH, BW>::kCoefPitch;
  if constexpr (BW == 1) {
    // pair g = threadIdx.x: its S rows at once, one pixel each (pixel e
    // of the strip's row is g)
    const int g = threadIdx.x;
    float v[kS];
    load_column<kS, SqGeom<BH, BW>::kCoefGroup>(
        slot + g * SqGeom<BH, BW>::kCoefGroup, v);
    float* dst = ring + (g >> 4) * 20 + (g & 15);
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      dst[((b * kS + i) & (kRingRows - 1)) * kRingPitch] =
          fmaf(v[i], dw_at(d, 0), 0.f);
    }
  } else if constexpr (kS >= BW) {
    const int g = threadIdx.x / BW;
    const int r = threadIdx.x & (BW - 1);
    const int blk = g / 3;
#pragma unroll
    for (int s = 0; s < Sq<BH, BW>::kRows; ++s) {
      const int i = r + s * BW;
      ring_row<BH, BW, 0>(
          slot + g * SqGeom<BH, BW>::kCoefGroup + i * kPitch,
          ring + ((b * kS + i) & (kRingRows - 1)) * kRingPitch, d, blk,
          g - 3 * blk);
    }
  } else {
    const int p = threadIdx.x / Sq<BH, BW>::kPart;
    const int u = threadIdx.x - p * Sq<BH, BW>::kPart;
    const int g = u / kS;
    const int i = u & (kS - 1);
    const int blk = g / 3;
    ring_part<BH, BW>(p, slot + g * SqGeom<BH, BW>::kCoefGroup + i * kPitch,
                      ring + ((b * kS + i) & (kRingRows - 1)) * kRingPitch, d,
                      blk, g - 3 * blk);
  }
}

__device__ __forceinline__ uint32_t pack4(float4 v) {
  return static_cast<uint32_t>(display_byte(v.x)) |
         static_cast<uint32_t>(display_byte(v.y)) << 8 |
         static_cast<uint32_t>(display_byte(v.z)) << 16 |
         static_cast<uint32_t>(display_byte(v.w)) << 24;
}

template <int BH, int BW>
__global__ void __launch_bounds__(kThreads, SqGeom<BH, BW>::kMinCtas)
idct_sq_display_kernel(const float* __restrict__ coeffs,
                       const float* __restrict__ steps, const DctF<BH, BW> d,
                       const int32_t* __restrict__ y0,
                       const int32_t* __restrict__ y1,
                       const float* __restrict__ fy,
                       const int32_t* __restrict__ row_lo,
                       const int32_t* __restrict__ band_b,
                       uint8_t* __restrict__ out, int out_h, int nby,
                       int nbx, int band_rows) {
  constexpr int kStrip = Sq<BH, BW>::kStrip;
  constexpr int kSlot = Sq<BH, BW>::kSlot;
  constexpr int kSteps = Sq<BH, BW>::kSteps;
  constexpr int kRingRows = Sq<BH, BW>::kRingRows;
  constexpr int kGroup = SqGeom<BH, BW>::kCoefGroup;
  constexpr int kPitch = SqGeom<BH, BW>::kCoefPitch;
  constexpr int kStep = SqGeom<BH, BW>::kStep;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 2 * kSlot;
  float* slot_steps = ring + kRingRows * kRingPitch;
  // per output row of the band: ring offsets of y0 and y1, and fy
  int* band_r0 = reinterpret_cast<int*>(slot_steps + 2 * kSteps);
  int* band_r1 = band_r0 + kMaxBandRows;
  float* band_f = reinterpret_cast<float*>(band_r1 + kMaxBandRows);

  const int t = blockIdx.z;
  const int band = blockIdx.y;
  const int bx0 = blockIdx.x * kStrip;
  const int nblk = min(kStrip, nbx - bx0);
  const int valid = nblk * BW * 3;  // display bytes of this strip's rows
  const int yb0 = band * band_rows;
  const int yb1 = min(out_h, yb0 + band_rows);
  const int b_first = band_b[2 * band];
  const int b_last = band_b[2 * band + 1];
  const size_t row_bytes = static_cast<size_t>(nbx) * BW * 3;
  const bool aligned = (row_bytes & 15) == 0;  // every row start is
  uint8_t* out_t = out + static_cast<size_t>(t) * out_h * row_bytes +
                   static_cast<size_t>(bx0) * BW * 3;
  const size_t blk_row0 = static_cast<size_t>(t) * nby * nbx + bx0;

  // the column stage's pair (block * 3 + channel) and column
  const int g = threadIdx.x / BW;
  const int r = threadIdx.x & (BW - 1);
  const int blk = g / 3;

  fetch_step<BH, BW, kStep, kStrip, kPitch, kGroup, kThreads>(
      coeffs, steps, blk_row0, b_first, nby, nbx, nblk, smem, slot_steps);
  for (int i = threadIdx.x; i < yb1 - yb0; i += kThreads) {
    band_r0[i] = (y0[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_r1[i] = (y1[yb0 + i] & (kRingRows - 1)) * kRingPitch;
    band_f[i] = fy[yb0 + i];
  }
  cp_async_wait_all();
  __syncthreads();
  if (b_first < b_last) {
    fetch_step<BH, BW, kStep, kStrip, kPitch, kGroup, kThreads>(
        coeffs, steps, blk_row0, b_first + 1, nby, nbx, nblk, smem + kSlot,
        slot_steps + kSteps);
  }
  sq_step_columns<BH, BW, kStep, kStrip, kPitch, kGroup>(
      smem + g * kGroup, slot_steps, d, blk, r);

  // Per step b (kStep block rows; the tables count rows in steps), two
  // phases: (1) the rows stage of b into the ring; (2) the output rows
  // that b completes, the next step's column stage, and the copy of the
  // one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    sq_ring_rows<BH, BW>(smem + s * kSlot, ring, d, b);
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_step<BH, BW, kStep, kStrip, kPitch, kGroup, kThreads>(
          coeffs, steps, blk_row0, b + 2, nby, nbx, nblk, smem + s * kSlot,
          slot_steps + s * kSteps);
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
    sq_step_columns<BH, BW, kStep, kStrip, kPitch, kGroup>(
        smem + (s ^ 1) * kSlot + g * kGroup, slot_steps + (s ^ 1) * kSteps, d,
        blk, r);
  }
}

template <int BH, int BW>
int launch_sq(const void* coeffs, const void* steps, const void* dh,
              const void* dw, const void* y0, const void* y1, const void* fy,
              const void* row_lo, const void* band_b, void* out, int t_count,
              int out_h, int nby, int nbx, int band_rows, int n_bands,
              void* stream) {
  const DctF<BH, BW> m = dct_from_host<BH, BW>(dh, dw);
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      idct_sq_display_kernel<BH, BW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sq<BH, BW>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<BH, BW>::kStrip - 1) / Sq<BH, BW>::kStrip,
                  n_bands, t_count);
  idct_sq_display_kernel<BH, BW><<<grid, kThreads, Sq<BH, BW>::kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(steps), m,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(fy), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(band_b), static_cast<uint8_t*>(out), out_h,
      nby, nbx, band_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs: (t_count, nby, nbx, 3*BH*BW) float32 wire coefficients, 16-byte
// aligned; steps: (t_count, nby, nbx) float32; dh, dw: HOST pointers to the
// (BH, BH) and (BW, BW) float32 DCT-II matrices (passed to the kernel by
// value; a square reads dh only); y0, y1, fy: (out_h,) source rows and
// weights; row_lo: (n_steps + 1,) first output row whose last source row
// lies in step b or later (a step: SqGeom's kStep block rows, n_steps =
// ceil(nby / kStep)); band_b: (n_bands, 2) first and last step of each
// band of band_rows output rows; out: (t_count, out_h, nbx*BW*3) uint8.
#define SVC_IDCT_SQ_ENTRY(BH, BW)                                             \
  SVC_EXPORT int svc_idct##BH##x##BW##_display(                               \
      const void* coeffs, const void* steps, const void* dh, const void* dw,  \
      const void* y0, const void* y1, const void* fy, const void* row_lo,     \
      const void* band_b, void* out, int t_count, int out_h, int nby,         \
      int nbx, int band_rows, int n_bands, void* stream) {                    \
    return launch_sq<BH, BW>(coeffs, steps, dh, dw, y0, y1, fy, row_lo,       \
                             band_b, out, t_count, out_h, nby, nbx,           \
                             band_rows, n_bands, stream);                     \
  }

SVC_IDCT_SQ_ENTRY(4, 4)
SVC_IDCT_SQ_ENTRY(16, 16)
SVC_IDCT_SQ_ENTRY(4, 8)
SVC_IDCT_SQ_ENTRY(8, 4)
SVC_IDCT_SQ_ENTRY(4, 16)
SVC_IDCT_SQ_ENTRY(16, 4)
SVC_IDCT_SQ_ENTRY(8, 16)
SVC_IDCT_SQ_ENTRY(16, 8)
SVC_IDCT_SQ_ENTRY(2, 2)
SVC_IDCT_SQ_ENTRY(2, 4)
SVC_IDCT_SQ_ENTRY(4, 2)
SVC_IDCT_SQ_ENTRY(2, 8)
SVC_IDCT_SQ_ENTRY(8, 2)
SVC_IDCT_SQ_ENTRY(2, 16)
SVC_IDCT_SQ_ENTRY(16, 2)
SVC_IDCT_SQ_ENTRY(1, 1)
SVC_IDCT_SQ_ENTRY(1, 2)
SVC_IDCT_SQ_ENTRY(2, 1)
SVC_IDCT_SQ_ENTRY(1, 4)
SVC_IDCT_SQ_ENTRY(4, 1)
SVC_IDCT_SQ_ENTRY(1, 8)
SVC_IDCT_SQ_ENTRY(8, 1)
SVC_IDCT_SQ_ENTRY(1, 16)
SVC_IDCT_SQ_ENTRY(16, 1)
