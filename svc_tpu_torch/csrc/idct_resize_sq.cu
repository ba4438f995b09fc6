// K6 for transform blocks of BH rows and BW columns, BH and BW in {1, 2,
// 4, 8, 16}, all but 8x8 (idct{BH}x{BW}_resize_display): the decoder's
// general display route (frame width excess) — dequantize, inverse BH x BW
// DCT, bilinear resample of rows AND columns from the padded frame to the
// display size, round, clip, interleaved BGR bytes — one kernel template
// instantiated at the squares 1x1, 2x2, 4x4 and 16x16, at the six
// rectangles of sides 4, 8 and 16, at the six with a side of 2 and at the
// eight with a side of 1, for 3 channels. Along a side of 1 the transform
// is a multiply-add by dct_matrix(1) = [[1]] (fmaf(-0, 1, 0) is +0, the
// general kernel's bits).
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
// 1366x768 batch, 0.038 ms at the 4/8/16 shapes), and 4 bytes of step a
// block (1x1: 0.048 ms; the 2 (BH + BW) float32 operations per
// coefficient take 0.028 ms at 16x16). The design is
// idct_resize.cu's (the 8x8 K6), every constant a function of (BH, BW),
// with idct_display_sq.cu's slot padding:
//  - one CTA per (frame, band of output rows, strip of 64 source pixels:
//    64 / BW block columns). It walks down the band's steps of kStep block
//    rows (kRowsStep pixel rows: BH, or 8 where a side is 1 or 2, 16 at
//    16x2 and 16x1): the coefficients of the step after next arrive by
//    cp.async into one of two slots (fetch_step: at a side of 1 a step's
//    runs in one pass, each copy to its slot place) while the current one
//    is emitted and the next one transformed; each block row is
//    dequantized and transformed once (column stage in place, row stage
//    in registers) into a ring of the last kRowsStep + 1 pixel rows: the
//    current step and the previous one's last row, which an output row's
//    y0 may still be (y1 <= y0 + 1);
//  - a CTA transforms the strip's block columns and one halo block column,
//    the next strip's first. An output column is emitted by the strip that
//    holds its x0; its x1 (read only where fx != 0, and then x0 + 1) lies
//    in the strip or in column 0 of the halo block. So 1 / (64 / BW) of
//    the blocks are transformed twice, and no strip reads another's
//    pixels. At BW = 16 the ring keeps only the halo's column 0 and the
//    row stage computes only that column of a halo block (at 16x16 the
//    whole halo block took 58 KB, 3 CTAs an SM, and ran 14% slower on an
//    H100 SXM at 700 W); at BW = 1, 2, 4 and 8 the whole block (at 4x4
//    6% faster there than column 0 alone);
//  - column stage: thread (pair g = block * 3 + channel, column r)
//    dequantizes and transforms the BH coefficients of its column in
//    place, block row by block row of the step; row stage: with S =
//    kRowsStep, a thread transforms S pixels of a pair — row r of pair g
//    at S = BW, rows r, r + BW, ... at S > BW, at S < BW columns [p * S,
//    p * S + S) of row u % S of pair u / S (thread u of part p: the
//    threads split in BW / S parts of whole warps); at BW = 1 a thread
//    owns a pair, and both stages read and write its slot column at once
//    (load_column). A switch on
//    the part makes its columns compile-time constants, so the DCT
//    matrix's entries stay immediate operands from the constant bank (a
//    lane-dependent index took K2 4x16 from 0.1542 to 0.8546 ms);
//  - the coefficient slot is padded per shape (SqGeom: K1's layout in
//    idct_display_sq.cu, which K6's halo pairs leave as it is) so that
//    neither transform stage conflicts on banks (but 4x8 and 16x4: two-way
//    on the row stage's loads, and at BW = 2 on the column stage's, as in
//    K1); a ring row's pitch leaves the row stage's stores at most two-way
//    conflicts;
//  - output: thread k emits byte k of the strip's run in every output
//    row, so a warp's ring reads are consecutive floats and its stores one
//    coalesced run per row. Row starts are only 2-byte aligned (4,098
//    bytes a row at 1366), so the stores are single bytes, and each byte is
//    written by exactly one strip;
//  - host tables carry the geometry, copied once per geometry
//    (ops/dct.py _band_tables with a step's pixel rows and the strip,
//    _strip_tables with the block width and the strip): per output row y0,
//    y1, fy, per source block row the first output row it completes, per
//    band its first and last block row (a CTA copies its band's entries to
//    shared memory); per byte of a display row the ring position of its x0
//    within its strip and its fx, per strip its first byte (a thread keeps
//    its byte's two in registers).
#include "idct_sq.cuh"

namespace {

constexpr int kStripPixels = 64;  // source pixels a CTA emits
// a band's per-row tables: two ring offsets and a weight per output row
constexpr int kMaxBandRows = 128;
// a strip emits at most 64 output columns (the wrapper sends a frame whose
// columns are upsampled to the general kernel), a thread per byte
constexpr int kMaxStripBytes = kStripPixels * 3;

// Per shape: element (k, l) of pair g at g * kCoefGroup + k * kCoefPitch
// + l in a coefficient slot (floats; idct_display_sq.cu's layout, but 16x1
// packs its pairs at 16 floats: 40,344 B of shared memory, 5 CTAs an SM
// at 56 registers, where K1's 20 take 46,584 B, 4 CTAs; 3.2% and 7.0%
// faster at 1366x768 and 854x480 on an H100 despite its 4-way conflicts
// on the float4 column reads), the
// halo block's pixel columns the ring keeps and the ring's row pitch
// (floats), the threads of a CTA (a column of every pair of the strip and
// its halo block, a part of whole warps for each kRowsStep columns of a
// row at kRowsStep < BW, and a byte of every strip row), the CTAs an SM
// holds and the block rows a walk step takes (K1's: one, or 8 / BH where
// a side is 1 or 2, 16 pixel rows at 16x2 and 16x1; the step's rows stand
// as those of one kRowsStep x BW block: 1xN and 2xN take 8xN's layout
// (N in {4, 8, 16}), 1x2, 2x2 and 4x2 8x2's, 1x1, 2x1 and 4x1 8x1's, as
// in K1). Ring pitches: 206 at BW = 4, 218 at BW = 8, 198 at
// 16x16, 8x16, 1x16, 2x16 and at BW = 2, 196 at 4x16 (198 puts three
// stores on a bank there) and at BW = 1 (a warp's stores are 32
// consecutive floats). kMinCtas caps the registers at 65,536 / (kThreads
// kMinCtas): 8x4 at 6 (40 registers, no spill on sm_90a) ran 3% faster
// on an H100 than at 5 (54); one CTA more than these at 4x8, 4x16, 16x4
// and 8x16 gained nothing at 1366x768 (4x16 at 6 spilled); 1x8 at 6 (40
// registers, 20 B of spill stores) ran 1.1% and 5.1% slower at 1366x768
// and 854x480 than at 5, 2x1 at 5 4.6% and 1.8% slower than at 6 (40, 8
// B of spill stores).
template <int BH, int BW> struct SqGeom;
template <> struct SqGeom<4, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 36, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<16, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 336, kHaloColumns = 1, kRingPitch = 198, kThreads = 256, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<4, 8> { static constexpr int kCoefPitch = 8, kCoefGroup = 40, kHaloColumns = 8, kRingPitch = 218, kThreads = 256, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<8, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<4, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 80, kHaloColumns = 1, kRingPitch = 196, kThreads = 256, kMinCtas = 5, kStep = 1; };
template <> struct SqGeom<16, 4> { static constexpr int kCoefPitch = 4, kCoefGroup = 68, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<8, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kHaloColumns = 1, kRingPitch = 198, kThreads = 256, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<16, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 200, kHaloColumns = 8, kRingPitch = 218, kThreads = 224, kMinCtas = 3, kStep = 1; };
template <> struct SqGeom<2, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kHaloColumns = 2, kRingPitch = 198, kThreads = 224, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<2, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<4, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kHaloColumns = 2, kRingPitch = 198, kThreads = 224, kMinCtas = 6, kStep = 2; };
template <> struct SqGeom<2, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 104, kHaloColumns = 8, kRingPitch = 218, kThreads = 224, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<8, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kHaloColumns = 2, kRingPitch = 198, kThreads = 224, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<2, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kHaloColumns = 1, kRingPitch = 198, kThreads = 256, kMinCtas = 4, kStep = 4; };
template <> struct SqGeom<16, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 36, kHaloColumns = 2, kRingPitch = 198, kThreads = 224, kMinCtas = 4, kStep = 1; };
template <> struct SqGeom<1, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 9, kHaloColumns = 1, kRingPitch = 196, kThreads = 224, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<1, 2> { static constexpr int kCoefPitch = 2, kCoefGroup = 20, kHaloColumns = 2, kRingPitch = 198, kThreads = 224, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<2, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kHaloColumns = 1, kRingPitch = 196, kThreads = 224, kMinCtas = 6, kStep = 4; };
template <> struct SqGeom<1, 4> { static constexpr int kCoefPitch = 8, kCoefGroup = 68, kHaloColumns = 4, kRingPitch = 206, kThreads = 224, kMinCtas = 6, kStep = 8; };
template <> struct SqGeom<4, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kHaloColumns = 1, kRingPitch = 196, kThreads = 224, kMinCtas = 6, kStep = 2; };
template <> struct SqGeom<1, 8> { static constexpr int kCoefPitch = 12, kCoefGroup = 104, kHaloColumns = 8, kRingPitch = 218, kThreads = 224, kMinCtas = 5, kStep = 8; };
template <> struct SqGeom<8, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 12, kHaloColumns = 1, kRingPitch = 196, kThreads = 224, kMinCtas = 6, kStep = 1; };
template <> struct SqGeom<1, 16> { static constexpr int kCoefPitch = 20, kCoefGroup = 176, kHaloColumns = 1, kRingPitch = 198, kThreads = 256, kMinCtas = 4, kStep = 8; };
template <> struct SqGeom<16, 1> { static constexpr int kCoefPitch = 1, kCoefGroup = 16, kHaloColumns = 1, kRingPitch = 196, kThreads = 224, kMinCtas = 5, kStep = 1; };

template <int BH, int BW>
struct Sq {
  static constexpr int kThreads = SqGeom<BH, BW>::kThreads;
  static constexpr int kStep = SqGeom<BH, BW>::kStep;  // block rows a step
  static constexpr int kRowsStep = kStep * BH;          // pixel rows a step
  static constexpr int kStrip = kStripPixels / BW;  // block columns emitted
  static constexpr int kBlocks = kStrip + 1;        // ... and the halo
  static constexpr int kGroups = kBlocks * 3;       // (block, channel) pairs
  // a slot, rounded up to whole 16-byte chunks (1x1: 195 pairs of 9)
  static constexpr int kSlot =
      (kGroups * SqGeom<BH, BW>::kCoefGroup + 3) / 4 * 4;
  static constexpr int kSteps = kStep * kBlocks;  // a slot's steps
  // pixel ring: source row y at row y % (kRowsStep + 1), interleaved
  // (x * 3 + channel): the strip's pixels and the halo's first columns
  static constexpr int kRingRows = kRowsStep + 1;
  static constexpr int kHaloColumns = SqGeom<BH, BW>::kHaloColumns;
  static constexpr int kRingPitch = SqGeom<BH, BW>::kRingPitch;
  static constexpr int kSmemBytes =
      (2 * kSlot + kRingRows * kRingPitch + 2 * kSteps + 3 * kMaxBandRows) *
      static_cast<int>(sizeof(float));
  // row stage: a thread's rows of its pair's kRowsStep and the pixels of
  // each; at kRowsStep < BW a row's columns in kSplit parts of kPart
  // threads (whole warps)
  static constexpr int kRows = kRowsStep > BW ? kRowsStep / BW : 1;
  static constexpr int kCols = kRowsStep < BW ? kRowsStep : BW;
  static constexpr int kSplit = BW > kRowsStep ? BW / kRowsStep : 1;
  static constexpr int kPart =
      kSplit > 1 ? (kGroups * kRowsStep + 31) / 32 * 32 : kThreads;
  static_assert(kGroups * BW <= kThreads, "a thread per column of a pair");
  static_assert(kSplit * kPart <= kThreads, "a part per kRowsStep columns");
  static_assert(kMaxStripBytes <= kThreads, "a thread per byte of a strip row");
  static_assert(kHaloColumns >= 1 && kHaloColumns <= BW, "x1 of the last x0");
  static_assert(kRingPitch >= (kStripPixels + kHaloColumns) * 3, "ring rows");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(SqGeom<BH, BW>::kCoefGroup >=
                    kRowsStep * SqGeom<BH, BW>::kCoefPitch,
                "slot rows fit");
};

// Pixels [J0, J0 + NJ) of one row of a pair, j ascending: arow points at
// the row in the slot (16-byte loads; 8-byte at BW = 2), dst at the pair's
// first pixel in its ring row (the pair's pixels interleaved with the
// other two channels: pixel j at dst[3 * j]).
template <int BH, int BW, int J0, int NJ>
__device__ __forceinline__ void ring_row(const float* arow, float* dst,
                                         const DctF<BH, BW>& d) {
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
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = J0 + jj;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < BW; ++l) acc = fmaf(a[l], dw_at(d, l * BW + j), acc);
    dst[3 * j] = acc;
  }
}

// ring_row at the part P's columns (P * kCols), as compile-time constants;
// of a halo block only those the ring keeps.
template <int BH, int BW, int P = 0>
__device__ __forceinline__ void ring_part(int p, bool halo, const float* arow,
                                          float* dst, const DctF<BH, BW>& d) {
  using S = Sq<BH, BW>;
  if constexpr (P < S::kSplit) {
    if (p == P) {
      constexpr int J0 = P * S::kCols;
      constexpr int kKept = S::kHaloColumns - J0 < 0 ? 0
                            : S::kHaloColumns - J0 > S::kCols
                                ? S::kCols
                                : S::kHaloColumns - J0;
      if (kKept < S::kCols && halo) {
        if constexpr (kKept > 0) ring_row<BH, BW, J0, kKept>(arow, dst, d);
      } else {
        ring_row<BH, BW, J0, S::kCols>(arow, dst, d);
      }
    } else {
      ring_part<BH, BW, P + 1>(p, halo, arow, dst, d);
    }
  }
}

// The row stage of step b (block rows b * kStep, ...) from a slot into
// the ring: this thread's kRowsStep pixels (or of a halo block the kept
// ones), interleaved.
template <int BH, int BW>
__device__ __forceinline__ void sq_ring_rows(const float* slot, float* ring,
                                             const DctF<BH, BW>& d, int b) {
  using S = Sq<BH, BW>;
  constexpr int kS = S::kRowsStep;
  constexpr int kPitch = SqGeom<BH, BW>::kCoefPitch;
  constexpr int kGroup = SqGeom<BH, BW>::kCoefGroup;
  if constexpr (BW == 1) {
    // pair g = threadIdx.x: its kS rows at once, one pixel each (its
    // place in a ring row is g: block g / 3, channel g % 3)
    const int g = threadIdx.x;
    if (g >= S::kGroups) return;
    float v[kS];
    load_column<kS, kGroup>(slot + g * kGroup, v);
    // one modulo a step: its rows wrap the ring at most once (1.4-2.8%
    // faster on an H100 at 1366x768 and 854x480 than one a row)
    const int r0 = (b * kS) % S::kRingRows;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = r0 + i < S::kRingRows ? r0 + i : r0 + i - S::kRingRows;
      ring[r * S::kRingPitch + g] = fmaf(v[i], dw_at(d, 0), 0.f);
    }
    return;
  }
  int p, g, i0;
  if constexpr (kS >= BW) {
    p = 0;
    g = threadIdx.x / BW;
    i0 = threadIdx.x & (BW - 1);
  } else {
    p = threadIdx.x / S::kPart;
    const int u = threadIdx.x - p * S::kPart;
    g = u / kS;
    i0 = u & (kS - 1);
  }
  if (g >= S::kGroups || p >= S::kSplit) return;
  const int blk = g / 3;
  const int c = g - 3 * blk;
  // the halo block's pairs are the last ones: at kRowsStep >= BW their
  // warps hold no other pair; at 4x16 one warp of a part holds strip and
  // halo pairs
  const bool halo = blk == S::kStrip;
#pragma unroll
  for (int s = 0; s < S::kRows; ++s) {
    const int i = i0 + s * BW;
    ring_part<BH, BW>(
        p, halo, slot + g * kGroup + i * kPitch,
        ring + ((b * kS + i) % S::kRingRows) * S::kRingPitch +
            blk * (3 * BW) + c,
        d);
  }
}

template <int BH, int BW>
__global__ void __launch_bounds__(SqGeom<BH, BW>::kThreads,
                                  SqGeom<BH, BW>::kMinCtas)
idct_sq_resize_kernel(const float* __restrict__ coeffs,
                      const float* __restrict__ steps, const DctF<BH, BW> d,
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
  using S = Sq<BH, BW>;
  constexpr int kGroup = SqGeom<BH, BW>::kCoefGroup;
  constexpr int kPitch = SqGeom<BH, BW>::kCoefPitch;
  constexpr int kStep = S::kStep;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 2 * S::kSlot;
  float* slot_steps = ring + S::kRingRows * S::kRingPitch;
  // per output row of the band: ring offsets of y0 and y1, and fy
  int* band_r0 = reinterpret_cast<int*>(slot_steps + 2 * S::kSteps);
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

  // the column stage's thread (pair g = block * 3 + channel, column r);
  // threads past the pairs only copy, form rows and emit
  const bool transforms = threadIdx.x < S::kGroups * BW;
  const int g = threadIdx.x / BW;
  const int r = threadIdx.x & (BW - 1);
  const int blk = g / 3;
  // thread k < nbytes emits byte k of the strip's run: the ring position
  // of its x0 (channel included) and its fx
  const bool emits = threadIdx.x < nbytes;
  const int e = emits ? col_e[byte0 + threadIdx.x] : 0;
  const float g_x = emits ? col_f[byte0 + threadIdx.x] : 0.f;

  fetch_step<BH, BW, kStep, S::kBlocks, kPitch, kGroup, S::kThreads>(
      coeffs, steps, blk_row0, b_first, nby, nbx, nblk, smem, slot_steps);
  for (int i = threadIdx.x; i < yb1 - yb0; i += S::kThreads) {
    band_r0[i] = (y0[yb0 + i] % S::kRingRows) * S::kRingPitch;
    band_r1[i] = (y1[yb0 + i] % S::kRingRows) * S::kRingPitch;
    band_f[i] = fy[yb0 + i];
  }
  cp_async_wait_all();
  __syncthreads();
  if (b_first < b_last) {
    fetch_step<BH, BW, kStep, S::kBlocks, kPitch, kGroup, S::kThreads>(
        coeffs, steps, blk_row0, b_first + 1, nby, nbx, nblk, smem + S::kSlot,
        slot_steps + S::kSteps);
  }
  if (transforms) {
    sq_step_columns<BH, BW, kStep, S::kBlocks, kPitch, kGroup>(
        smem + g * kGroup, slot_steps, d, blk, r);
  }

  // Per step b (kStep block rows; the tables count rows in steps), two
  // phases: (1) the rows stage of b into the ring; (2) the output rows
  // that b completes, the next step's column stage, and the copy of the
  // one after that into the slot (1) freed.
  for (int b = b_first;; ++b) {
    const int s = (b - b_first) & 1;
    const int ya = max(yb0, row_lo[b]);
    const int yz = min(yb1, row_lo[b + 1]);
    __syncthreads();
    sq_ring_rows<BH, BW>(smem + s * S::kSlot, ring, d, b);
    cp_async_wait_all();
    __syncthreads();
    if (b + 2 <= b_last) {
      fetch_step<BH, BW, kStep, S::kBlocks, kPitch, kGroup, S::kThreads>(
          coeffs, steps, blk_row0, b + 2, nby, nbx, nblk, smem + s * S::kSlot,
          slot_steps + s * S::kSteps);
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
      sq_step_columns<BH, BW, kStep, S::kBlocks, kPitch, kGroup>(
          smem + (s ^ 1) * S::kSlot + g * kGroup,
          slot_steps + (s ^ 1) * S::kSteps, d, blk, r);
    }
  }
}

template <int BH, int BW>
int launch_sq_resize(const void* coeffs, const void* steps, const void* dh,
                     const void* dw, const void* y0, const void* y1,
                     const void* fy, const void* row_lo, const void* band_b,
                     const void* col_e, const void* col_f,
                     const void* strip_lo, void* out, int t_count, int out_h,
                     int out_w, int nby, int nbx, int band_rows, int n_bands,
                     void* stream) {
  const DctF<BH, BW> m = dct_from_host<BH, BW>(dh, dw);
  if (band_rows < 1 || band_rows > kMaxBandRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // past 48 KB at 16x16 and 16x8: the opt-in, set on every call (cheap,
  // and a graph capture may hold the first launch of a device)
  const cudaError_t err = cudaFuncSetAttribute(
      idct_sq_resize_kernel<BH, BW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sq<BH, BW>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nbx + Sq<BH, BW>::kStrip - 1) / Sq<BH, BW>::kStrip,
                  n_bands, t_count);
  idct_sq_resize_kernel<BH, BW><<<grid, Sq<BH, BW>::kThreads,
                                  Sq<BH, BW>::kSmemBytes,
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

// coeffs: (t_count, nby, nbx, 3*BH*BW) float32 wire coefficients, 16-byte
// aligned; steps: (t_count, nby, nbx) float32; dh, dw: HOST pointers to the
// (BH, BH) and (BW, BW) float32 DCT-II matrices (passed to the kernel by
// value; a square reads dh only); y0, y1, fy: (out_h,) source rows and
// weights; row_lo: (n_steps + 1,) first output row whose last source row
// lies in step b or later (a step: SqGeom's kStep block rows, n_steps =
// ceil(nby / kStep)); band_b: (n_bands, 2) first and last step of each band
// of band_rows output rows; col_e, col_f: (out_w * 3,) per
// display-row byte the ring position of its x0 within its strip of 64
// pixels and fx; strip_lo: (ceil(nbx * BW / 64) + 1,) the first byte of
// each strip (at most 192 a strip); out: (t_count, out_h, out_w*3) uint8.
#define SVC_IDCT_SQ_RESIZE_ENTRY(BH, BW)                                      \
  SVC_EXPORT int svc_idct##BH##x##BW##_resize_display(                        \
      const void* coeffs, const void* steps, const void* dh, const void* dw,  \
      const void* y0, const void* y1, const void* fy, const void* row_lo,     \
      const void* band_b, const void* col_e, const void* col_f,               \
      const void* strip_lo, void* out, int t_count, int out_h, int out_w,     \
      int nby, int nbx, int band_rows, int n_bands, void* stream) {           \
    return launch_sq_resize<BH, BW>(coeffs, steps, dh, dw, y0, y1, fy,        \
                                    row_lo, band_b, col_e, col_f, strip_lo,   \
                                    out, t_count, out_h, out_w, nby, nbx,     \
                                    band_rows, n_bands, stream);              \
  }

SVC_IDCT_SQ_RESIZE_ENTRY(4, 4)
SVC_IDCT_SQ_RESIZE_ENTRY(16, 16)
SVC_IDCT_SQ_RESIZE_ENTRY(4, 8)
SVC_IDCT_SQ_RESIZE_ENTRY(8, 4)
SVC_IDCT_SQ_RESIZE_ENTRY(4, 16)
SVC_IDCT_SQ_RESIZE_ENTRY(16, 4)
SVC_IDCT_SQ_RESIZE_ENTRY(8, 16)
SVC_IDCT_SQ_RESIZE_ENTRY(16, 8)
SVC_IDCT_SQ_RESIZE_ENTRY(2, 2)
SVC_IDCT_SQ_RESIZE_ENTRY(2, 4)
SVC_IDCT_SQ_RESIZE_ENTRY(4, 2)
SVC_IDCT_SQ_RESIZE_ENTRY(2, 8)
SVC_IDCT_SQ_RESIZE_ENTRY(8, 2)
SVC_IDCT_SQ_RESIZE_ENTRY(2, 16)
SVC_IDCT_SQ_RESIZE_ENTRY(16, 2)
SVC_IDCT_SQ_RESIZE_ENTRY(1, 1)
SVC_IDCT_SQ_RESIZE_ENTRY(1, 2)
SVC_IDCT_SQ_RESIZE_ENTRY(2, 1)
SVC_IDCT_SQ_RESIZE_ENTRY(1, 4)
SVC_IDCT_SQ_RESIZE_ENTRY(4, 1)
SVC_IDCT_SQ_RESIZE_ENTRY(1, 8)
SVC_IDCT_SQ_RESIZE_ENTRY(8, 1)
SVC_IDCT_SQ_RESIZE_ENTRY(1, 16)
SVC_IDCT_SQ_RESIZE_ENTRY(16, 1)
