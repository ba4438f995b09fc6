// K9 candidate_sads: per-block SADs of the (2R + 1)^2 candidates around
// each block's MV, for T separate (tracked, anchor) plane pairs, as
// float32, specialised for BW x BH MV blocks (BW columns, BH rows) at
// search radius R = 1 to 4 (16x16, 8x8 and 4x4 at R = 5 to 8 too, on K3's
// kernel, 2x2 on this file's thread-a-block kernel and 1x1 on its
// thread-a-pixel one): square 1, 2, 4, 8 or 16, the ratio-2
// rectangles 2x1, 1x2, 4x2, 2x4, 8x4, 4x8, 16x8, 8x16 and the ratio-4 ones
// 4x1, 1x4, 8x2, 2x8, 16x4, 4x16. These are the encoder's top-level EBMA,
// in hbma_stack and per-frame hbma alike, at 16x16 blocks and 4 pyramid
// levels (2x2), range 8 (R = 1, the default) to 39 (R = range / 8), and at
// the other block and level settings (--mv-block-w/-h, --pyr-lvl-count):
// 8x8 blocks at 4 levels or 16x16 at 5 (1x1), 16x16 at 3 levels (4x4) or 2
// (8x8), 16x8 blocks at 4, 3 or 2 levels (2x1, 4x2, 8x4) and 8x16 (1x2,
// 2x4, 4x8), 32x32, 32x16 and 16x32 blocks at 2 levels (16x16, 16x8, 8x16;
// at 3-5 levels their top blocks are among the others), 32x8 blocks at 4,
// 3 or 2 levels (4x1, 8x2, 16x4) and 8x32 (1x4, 2x8, 4x16), 16x16 MV
// blocks at one level, ranges 5-8 (16x16 at R = 5-8), at 2 levels,
// ranges 10-17 (8x8 at R = 5-8), at 3 levels, ranges 20-35 (4x4 at R =
// 5-8), at 4 levels, ranges 40-71 (2x2 at R = 5-8) and at 5 levels,
// ranges 80-143 (1x1 at R = 5-8; 8x8 MV blocks at 4 levels, ranges 40-71,
// and 4x4 at 3, ranges 20-35, too). 1x1 runs the
// thread-a-pixel kernel of this file; 2x2 and the blocks with a side of 1
// or 2, 2x1, 1x2, 4x2, 2x4, 4x1, 1x4, 8x2, 2x8, its thread-a-block kernel;
// the shapes with both sides 4 or more K3's kernel (refine_sads.cu,
// launch_refine_rows) with float32 output.
//
// Replaces svc_tpu/ops/motion_pallas.py candidate_sads (:121) at those
// shapes; every other shape runs candidate_sads_general.cu
// (window_sads.cuh), and ops/motion.py dispatches. The contract is the
// general kernel's: SAD of candidate (oy, ox) in raster order at
//   sum_{i<BH, j<BW} |trk(t, BH*by + mvy + oy - R + i, BW*bx + mvx + ox - R + j)
//                     - anc(t, BH*by + i, BW*bx + j)|
// for any int32 MVs, with tracked pixels outside the frame read as 0:
// exact integer sums, bit-equal to the general kernel and to
// candidate_sads_plain on every entry, valid or not.
//
// The thread-a-block kernel is also K3's and K7's at 2x2, 4x2, 2x4, 8x2
// and 2x8 blocks (refine_sads.cu, launch_block_sads) with int32 output (2x2
// at R = 5 to 8 too: level 2 of 8x8 MV blocks at 4 levels, level 3 of
// 16x16 and 32x32 MV blocks at 5): it
// reads frame t's tracked plane and its anchor from two bases, each frame
// a plane on (K9: the two stacks; K3: the stack and the stack plus a
// plane; K7: the pair, one frame).
//
// Bound: bytes, and mostly the output ((2R + 1)^2 SADs of 4 bytes per
// block against 2 BW BH bytes read and 8 of MVs: at 2x2, 1080p, T = 8, R =
// 1, 2.35 MB of 2.87 MB, 0.0009 ms on an H100; at 1x1, 136 x 240 pixels a
// frame, 78% of 12.0 MB at R = 1 and 99.1% of 304.5 MB at R = 8). The
// general kernel gives a warp to each
// block (4 of 32 lanes busy at 2x2, 2 at 2x1, 1 at 1x1), stages both tiles
// in shared memory, divides by runtime sizes and reduces each sum by five
// shuffles. Design:
//   - a thread per MV block (one side 1 or 2, the other at most 8) or per
//     pixel (1x1); consecutive threads take consecutive block columns of
//     one block row, so the window-row loads and the stores of each
//     candidate plane coalesce across the warp. A CTA's kThreads threads
//     span the level's block columns rounded up to a warp (kThreads at
//     most) and as many block rows as fill it: 60 block columns (1920 /
//     32, ... 240 / 4 under 32x8 MV blocks) leave 4 of 64 threads a row
//     idle, not 68 of 128 (in turns on an H100, 8x2 up to 14% faster at R
//     = 4, 22 columns up to 4%, 86 unchanged; from 97 columns on the grid
//     is one block row of 128 a CTA);
//   - the anchor rows are one load each (64-bit at BW = 8, 32-bit at 4,
//     16-bit at 2, 8-bit at 1), packed into words of 4 bytes: two words a
//     row at BW = 8, one row a word at BW = 4, two rows at BW = 2 (one at
//     2x1), two at 1x2 and four at 1x4; at 1x1 the anchor byte, copied to
//     the four bytes of a word;
//   - at 2x2 and R = 1 each of the 4 window rows, bytes x0 .. x0+3 with x0
//     = 2*bx + mvx - 1 at any alignment, is two aligned 32-bit words
//     (planes are 4-byte aligned and fh*fw is a multiple of 4) joined by
//     __funnelshift_r; otherwise each of the BH + 2R rows is BW + 2R
//     bytes, 1 to 4 words from up to 5 aligned loads; at 1x1 each of the
//     2R + 1 rows is 2R + 1 bytes, 1 to 3 words. A word is loaded only
//     where it meets the row's bytes, so no load leaves the plane; a byte
//     mask then zeroes what lies outside [0, fw) (fw need not be a multiple
//     of 4, so a word can straddle the row's edge) and a row outside [0,
//     fh) reads as 0;
//   - at 2x2 and R = 1, __vsadu4 of a window word shifted to candidate
//     column ox (low two bytes) against an anchor row (high bytes 0) adds
//     that row's two absolute differences: 18 of them make the 9 sums;
//     otherwise a candidate (oy, ox) is one __vsadu4 an anchor word: the
//     window row's word shifted to byte ox at BW = 4, one __byte_perm of
//     rows oy + i and oy + i + 1 (bytes ox, ox + 1) at BW = 2, of row oy's
//     two bytes and zeros at 2x1, of rows oy and oy + 1 (byte ox) at 1x2,
//     at 1x4 two of those pairs (rows oy, oy + 1 and oy + 2, oy + 3)
//     joined by a third, each pair shared by two candidate rows, at BW = 8
//     the row's two words shifted to byte ox; summed and stored at once
//     (no accumulators); at 1x1 one __vabsdiffu4 of a window word against
//     the anchor word gives four candidates' SADs at once, each byte of it
//     put into a float's mantissa by one __byte_perm;
//   - past R = 4 (2x2 only, kFarBlocks; K9's float32 and K3's / K7's
//     int32 alike) the BH + 2R window rows would take
//     90 registers at R = 8 (18 rows of 5 words), so a thread streams them:
//     it holds the BH rows candidate row oy needs, stores that row's 2R + 1
//     sums, then slides one row down (the next row loaded before the
//     sums, its latency behind them; in turns on an H100, 12-17% faster
//     than holding every row at R = 5-8);
//   - the SADs (< 2^23) become float32 exactly by 2^23 + x in the mantissa
//     less 2^23 (sad_as, common.cuh) past 2x2 at R = 1 (an
//     integer-to-float conversion issues at a quarter of that rate);
//   - no shared memory, no shuffles; all index math is compile-time but
//     the block's own origin.
#include "common.cuh"
#include "refine_sads.cuh"

namespace {

constexpr int kThreads = 128;  // block columns per CTA
constexpr int kCand = 9;       // (2r + 1)^2 at r = 1
// The largest radius whose instances hold all their window rows at once.
constexpr int kNearRadius = 4;

// Whether a BW x BH instance also takes R = 5 to 8, a candidate row at a
// time: 2x2, K9's (the top level of 16x16 MV blocks at 4 levels, ranges
// 40-71) and K3's / K7's (level 2 of 8x8 MV blocks at 4 levels, level 3 of
// 16x16 at 5 and 32x32 at 5).
template <int BW, int BH>
constexpr bool kFarBlocks = BW == 2 && BH == 2;

// Bytes [x0, x0 + 4) of row y of a frame as one word (byte k at bits 8k),
// bytes outside the frame 0. frame is 4-byte aligned and holds fh rows of
// fw bytes, fh * fw a multiple of 4.
__device__ __forceinline__ uint32_t window_row(const uint8_t* __restrict__ frame,
                                               int y, int x0, int fh, int fw) {
  if (y < 0 || y >= fh || x0 <= -4 || x0 >= fw) return 0u;
  const int row0 = y * fw;
  const int row1 = row0 + fw;
  const int o = row0 + x0;
  const int a = o & ~3;  // floor to a multiple of 4 (o >= -3)
  const int s = o - a;   // 0 .. 3
  const uint32_t lo = (a + 4 > row0)
      ? __ldg(reinterpret_cast<const unsigned int*>(frame + a)) : 0u;
  const uint32_t hi = (s != 0 && a + 4 < row1)
      ? __ldg(reinterpret_cast<const unsigned int*>(frame + a + 4)) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * s);
  const int first = max(0, -x0);    // first byte inside the row
  const int last = min(4, fw - x0);  // one past the last
  const uint32_t below_last = last >= 4 ? 0xffffffffu : (1u << (8 * last)) - 1u;
  return v & below_last & (0xffffffffu << (8 * first));
}

// Bytes [x0, x0 + N) of row y of a frame as (N + 3) / 4 words (byte k of
// the run at bits 8(k % 4) of word k / 4), bytes outside the frame 0. frame
// is 4-byte aligned and holds fh rows of fw bytes, fh * fw a multiple of 4.
template <int N>
__device__ __forceinline__ void window_run(const uint8_t* __restrict__ frame, int y,
                                           int x0, int fh, int fw,
                                           uint32_t (&al)[(N + 3) / 4]) {
  constexpr int kA = (N + 3) / 4;
  if (y < 0 || y >= fh || x0 <= -N || x0 >= fw) {
#pragma unroll
    for (int j = 0; j < kA; ++j) al[j] = 0u;
    return;
  }
  const int row0 = y * fw;
  const int row1 = row0 + fw;
  const int o = row0 + x0;
  const int a = o & ~3;  // floor to a multiple of 4 (o > -N)
  const int s = o - a;   // 0 .. 3
  uint32_t w[kA + 1];
#pragma unroll
  for (int m = 0; m <= kA; ++m) {
    // word m holds a byte of the run when 4m < s + N; it is loaded when it
    // also meets the row (and so lies in the frame)
    const int p = a + 4 * m;
    w[m] = (4 * m < s + N && p + 4 > row0 && p < row1)
               ? __ldg(reinterpret_cast<const unsigned int*>(frame + p)) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    const uint32_t v = __funnelshift_r(w[j], w[j + 1], 8 * s);
    const int first = min(4, max(0, -x0 - 4 * j));       // first byte in the row
    const int last = max(0, min(4, fw - x0 - 4 * j));    // one past the last
    const uint32_t below_last = last >= 4 ? 0xffffffffu : (1u << (8 * last)) - 1u;
    const uint32_t from_first = first >= 4 ? 0u : 0xffffffffu << (8 * first);
    al[j] = v & below_last & from_first;
  }
}

// The anchor bytes of a BW x BH block as kCount words, one load a row:
// BH / kStep words of kStep rows each (row q of a word at bits 8 BW q) at
// BW <= 4, kRowWords words a row at BW = 8.
template <int BW, int BH>
struct AnchorWords {
  static constexpr int kStep = BW >= 4 ? 1 : (4 / BW < BH ? 4 / BW : BH);  // rows a word
  static constexpr int kRowWords = BW >= 4 ? BW / 4 : 1;  // words a row
  static constexpr int kCount = BH / kStep * kRowWords;
};

// A block's anchor words (AnchorWords<BW, BH>), anc its first byte.
template <int BW, int BH>
__device__ __forceinline__ void load_anchor_words(const uint8_t* __restrict__ anc, int fw,
                                                  uint32_t (&a)[AnchorWords<BW, BH>::kCount]) {
  using A = AnchorWords<BW, BH>;
#pragma unroll
  for (int k = 0; k < BH / A::kStep; ++k) {
    if constexpr (BW == 8) {  // row k as words 2k, 2k + 1
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(anc + static_cast<size_t>(k) * fw));
      a[2 * k] = v.x;
      a[2 * k + 1] = v.y;
    } else {
      a[k] = 0u;
#pragma unroll
      for (int q = 0; q < A::kStep; ++q) {
        const uint8_t* p = anc + static_cast<size_t>(A::kStep * k + q) * fw;
        uint32_t v;
        if constexpr (BW == 4) {
          v = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else if constexpr (BW == 2) {
          v = __ldg(reinterpret_cast<const unsigned short*>(p));
        } else {
          v = __ldg(p);
        }
        a[k] |= v << (8 * BW * q);
      }
    }
  }
}

// The SAD of candidate column ox of a candidate row oy against the block's
// anchor words: row(q) gives window row oy + q (q < BH) as the words of
// window_run<BW + 2R>.
template <int BW, int BH, class Row>
__device__ __forceinline__ uint32_t block_sad(Row row,
                                              const uint32_t (&a)[AnchorWords<BW, BH>::kCount],
                                              int ox) {
  using A = AnchorWords<BW, BH>;
  const int j = ox / 4;
  const int d = ox % 4;
  uint32_t sad = 0u;
#pragma unroll
  for (int k = 0; k < A::kCount; ++k) {
    const uint32_t* top = row(A::kStep * (k / A::kRowWords));
    uint32_t c;
    if constexpr (BW >= 4) {
      // window row oy + k / kRowWords, bytes ox + 4w .. ox + 4w + 3 (w
      // = k % kRowWords: the anchor row's word)
      const int w = j + k % A::kRowWords;
      c = d == 0 ? top[w] : __funnelshift_r(top[w], top[w + 1], 8 * d);
    } else if constexpr (BW == 2 && A::kStep == 2) {
      // bytes ox, ox + 1 of window rows oy + 2k and oy + 2k + 1
      const uint32_t* bot = row(A::kStep * k + 1);
      if (d < 3) {
        c = __byte_perm(top[j], bot[j], d | (d + 1) << 4 | (d + 4) << 8 | (d + 5) << 12);
      } else {
        c = __byte_perm(__funnelshift_r(top[j], top[j + 1], 24),
                        __funnelshift_r(bot[j], bot[j + 1], 24), 0x5410);
      }
    } else if constexpr (BW == 2) {  // 2x1: bytes ox, ox + 1 of row oy
      c = d < 3 ? __byte_perm(top[j], 0u, d | (d + 1) << 4 | 0x4400)
                : __funnelshift_r(top[j], top[j + 1], 24) & 0xffffu;
    } else if constexpr (A::kStep == 2) {  // 1x2: byte ox of window rows oy and oy + 1
      c = __byte_perm(top[j], row(1)[j], d | (d + 4) << 4) & 0xffffu;
    } else {  // 1x4: byte ox of window rows oy .. oy + 3, two rows a pair
      const uint32_t lo = __byte_perm(top[j], row(1)[j], d | (d + 4) << 4);
      const uint32_t hi = __byte_perm(row(2)[j], row(3)[j], d | (d + 4) << 4);
      c = __byte_perm(lo, hi, 0x5410);
    }
    sad = __vsadu4(c, a[k]) + sad;
  }
  return sad;
}

template <int BW, int BH, int R, class Out>
__global__ void __launch_bounds__(kThreads)
candidate_sads_kernel(const uint8_t* __restrict__ tracked,
                      const uint8_t* __restrict__ anchor,
                      const int32_t* __restrict__ mv, Out* __restrict__ out,
                      int fh, int fw, int mfh, int mfw) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  if (bx >= mfw || by >= mfh) return;

  const size_t plane = static_cast<size_t>(fh) * fw;
  const uint8_t* trk = tracked + t * plane;
  const uint8_t* anc = anchor + t * plane + static_cast<size_t>(BH * by) * fw + BW * bx;
  const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
  const int mvx = __ldg(m);
  const int mvy = __ldg(m + 1);

  const int x0 = BW * bx + mvx - R;  // window column of ox = 0
  const int y0 = BH * by + mvy - R;  // window row of oy = 0
  if constexpr (BW == 2 && BH == 2 && R == 1) {
    const uint32_t a0 = __ldg(reinterpret_cast<const unsigned short*>(anc));
    const uint32_t a1 = __ldg(reinterpret_cast<const unsigned short*>(anc + fw));
    uint32_t acc[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) acc[c] = 0u;
    // window row wr meets anchor row 0 in candidate row oy = wr and anchor
    // row 1 in oy = wr - 1
#pragma unroll
    for (int wr = 0; wr < 4; ++wr) {
      const uint32_t w = window_row(trk, y0 + wr, x0, fh, fw);
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        const uint32_t c = (w >> (8 * ox)) & 0xffffu;
        if (wr <= 2) acc[wr * 3 + ox] = __vsadu4(c, a0) + acc[wr * 3 + ox];
        if (wr >= 1) acc[(wr - 1) * 3 + ox] = __vsadu4(c, a1) + acc[(wr - 1) * 3 + ox];
      }
    }

    const size_t plane_out = static_cast<size_t>(mfh) * mfw;
    Out* o = out + (static_cast<size_t>(t) * kCand * mfh + by) * mfw + bx;
#pragma unroll
    for (int c = 0; c < kCand; ++c) o[c * plane_out] = static_cast<Out>(acc[c]);
  } else {
    using A = AnchorWords<BW, BH>;
    constexpr int kSide = 2 * R + 1;
    constexpr int kRows = BH + 2 * R;  // window rows
    constexpr int kRun = BW + 2 * R;   // bytes a window row
    constexpr int kWords = (kRun + 3) / 4;
    uint32_t a[A::kCount];
    load_anchor_words<BW, BH>(anc, fw, a);
    const size_t plane_out = static_cast<size_t>(mfh) * mfw;
    Out* o = out + (static_cast<size_t>(t) * kSide * kSide * mfh + by) * mfw + bx;
    if constexpr (R > kNearRadius) {
      // win[q]: window row oy + q; the next one loaded before the sums
      uint32_t win[BH][kWords];
#pragma unroll
      for (int q = 0; q < BH; ++q) window_run<kRun>(trk, y0 + q, x0, fh, fw, win[q]);
#pragma unroll 1
      for (int oy = 0; oy < kSide; ++oy) {
        uint32_t next[kWords] = {};
        if (oy + 1 < kSide) window_run<kRun>(trk, y0 + oy + BH, x0, fh, fw, next);
#pragma unroll
        for (int ox = 0; ox < kSide; ++ox) {
          const uint32_t sad = block_sad<BW, BH>([&](int q) { return win[q]; }, a, ox);
          o[(oy * kSide + ox) * plane_out] = sad_as<Out>(sad);
        }
#pragma unroll
        for (int q = 0; q < BH; ++q) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) win[q][w] = q + 1 < BH ? win[q + 1][w] : next[w];
        }
      }
    } else {
      uint32_t rows[kRows][kWords];
#pragma unroll
      for (int wr = 0; wr < kRows; ++wr) window_run<kRun>(trk, y0 + wr, x0, fh, fw, rows[wr]);
#pragma unroll
      for (int oy = 0; oy < kSide; ++oy) {
#pragma unroll
        for (int ox = 0; ox < kSide; ++ox) {
          const uint32_t sad = block_sad<BW, BH>([&](int q) { return rows[oy + q]; }, a, ox);
          o[(oy * kSide + ox) * plane_out] = sad_as<Out>(sad);
        }
      }
    }
  }
}

// K9 at 1x1 blocks: a thread a pixel (x, y) of frame t. Window row oy is
// the 2R + 1 bytes from x + mvx - R on (window_run); one __vabsdiffu4
// against the anchor byte in all four bytes gives candidates 4j .. 4j + 3
// of word j at once, and one __byte_perm puts each into the mantissa of
// 2^23 (bytes 1, 2 of 0x4b000000 are 0, byte 3 is its exponent). Each
// candidate plane's store covers 32 consecutive pixels of a row a warp
// (128 bytes): past R = 4 the (2R + 1)^2 planes, 289 at R = 8, are the
// kernel's bytes. Each window row (at most 5 words) is used as soon as it
// is loaded.
template <int R>
__global__ void __launch_bounds__(kThreads)
candidate_sads_1x1_kernel(const uint8_t* __restrict__ tracked,
                          const uint8_t* __restrict__ anchor,
                          const int32_t* __restrict__ mv, float* __restrict__ out,
                          int fh, int fw) {
  constexpr int kSide = 2 * R + 1;
  constexpr int kWords = (kSide + 3) / 4;  // words a window row
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int t = blockIdx.z;
  if (x >= fw) return;

  const size_t plane = static_cast<size_t>(fh) * fw;
  const size_t at = t * plane + static_cast<size_t>(y) * fw + x;  // (t, y, x)
  const uint8_t* trk = tracked + t * plane;
  const int mvx = __ldg(mv + 2 * at);
  const int mvy = __ldg(mv + 2 * at + 1);
  const uint32_t a4 = __ldg(anchor + at) * 0x01010101u;
  float* o = out + (static_cast<size_t>(t) * kSide * kSide * fh + y) * fw + x;
#pragma unroll
  for (int oy = 0; oy < kSide; ++oy) {
    uint32_t row[kWords];
    window_run<kSide>(trk, y + mvy + oy - R, x + mvx - R, fh, fw, row);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t d = __vabsdiffu4(row[j], a4);
#pragma unroll
      for (int k = 0; k < 4 && 4 * j + k < kSide; ++k) {
        o[(oy * kSide + 4 * j + k) * plane] =
            __uint_as_float(__byte_perm(d, 0x4b000000u, k | 0x7440)) - 8388608.0f;
      }
    }
  }
}

template <int BW, int BH, int R, class Out>
int launch(const uint8_t* tracked, const uint8_t* anchor, const int32_t* mv,
           Out* out, int t_count, int fh, int fw, cudaStream_t stream) {
  const int mfh = fh / BH;
  const int mfw = fw / BW;
  // a CTA's block columns: the level's rounded up to a warp, kThreads at
  // most; block rows enough to fill kThreads
  const int cols = min(kThreads, (mfw + 31) / 32 * 32);
  const dim3 block(cols, kThreads / cols);
  const dim3 grid((mfw + cols - 1) / cols, (mfh + block.y - 1) / block.y, t_count);
  candidate_sads_kernel<BW, BH, R, Out><<<grid, block, 0, stream>>>(
      tracked, anchor, mv, out, fh, fw, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_1x1(const uint8_t* tracked, const uint8_t* anchor, const int32_t* mv,
               float* out, int t_count, int fh, int fw, cudaStream_t stream) {
  const dim3 grid((fw + kThreads - 1) / kThreads, fh, t_count);
  candidate_sads_1x1_kernel<R><<<grid, kThreads, 0, stream>>>(tracked, anchor, mv, out,
                                                              fh, fw);
  return static_cast<int>(cudaGetLastError());
}

// The 1x1 instance of radius r. tracked is 4-byte aligned and fh * fw a
// multiple of 4 (window_run's whole-word loads stay in the plane).
int launch_block1(const void* tracked, const void* anchor, const void* mv,
                  float* out, int t_count, int fh, int fw, int r,
                  cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 4 ||
      (static_cast<size_t>(fh) * fw) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* trk = static_cast<const uint8_t*>(tracked);
  const auto* anc = static_cast<const uint8_t*>(anchor);
  const auto* m = static_cast<const int32_t*>(mv);
  switch (r) {
    case 1: return launch_1x1<1>(trk, anc, m, out, t_count, fh, fw, stream);
    case 2: return launch_1x1<2>(trk, anc, m, out, t_count, fh, fw, stream);
    case 3: return launch_1x1<3>(trk, anc, m, out, t_count, fh, fw, stream);
    case 4: return launch_1x1<4>(trk, anc, m, out, t_count, fh, fw, stream);
    // past kNearRadius: the top level of 16x16 MV blocks at 5 levels and of
    // 8x8 ones at 4 (ranges 80-143 and 40-71)
    case 5: return launch_1x1<5>(trk, anc, m, out, t_count, fh, fw, stream);
    case 6: return launch_1x1<6>(trk, anc, m, out, t_count, fh, fw, stream);
    case 7: return launch_1x1<7>(trk, anc, m, out, t_count, fh, fw, stream);
    case 8: return launch_1x1<8>(trk, anc, m, out, t_count, fh, fw, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

template <int BW, int BH, class Out>
int launch_block_sads(const void* tracked, const void* anchor, const void* mv,
                      Out* out, int t_count, int fh, int fw, int r, void* stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 4 ||
      reinterpret_cast<uintptr_t>(anchor) % BW || fh % BH || fw % BW ||
      (static_cast<size_t>(fh) * fw) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* trk = static_cast<const uint8_t*>(tracked);
  const auto* anc = static_cast<const uint8_t*>(anchor);
  const auto* m = static_cast<const int32_t*>(mv);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch<BW, BH, 1>(trk, anc, m, out, t_count, fh, fw, st);
    case 2: return launch<BW, BH, 2>(trk, anc, m, out, t_count, fh, fw, st);
    case 3: return launch<BW, BH, 3>(trk, anc, m, out, t_count, fh, fw, st);
    case 4: return launch<BW, BH, 4>(trk, anc, m, out, t_count, fh, fw, st);
    default: break;
  }
  if constexpr (kFarBlocks<BW, BH>) {
    switch (r) {
      case 5: return launch<BW, BH, 5>(trk, anc, m, out, t_count, fh, fw, st);
      case 6: return launch<BW, BH, 6>(trk, anc, m, out, t_count, fh, fw, st);
      case 7: return launch<BW, BH, 7>(trk, anc, m, out, t_count, fh, fw, st);
      case 8: return launch<BW, BH, 8>(trk, anc, m, out, t_count, fh, fw, st);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9 (float32) at 2x2, 4x2, 2x4, 2x1, 1x2, 4x1, 1x4, 8x2 and 2x8 blocks;
// K3 / K7 (int32) at 2x2, 4x2, 2x4, 8x2 and 2x8
#define SVC_BLOCK_SADS(BW, BH, Out)                                                  \
  template int launch_block_sads<BW, BH, Out>(const void*, const void*, const void*, \
                                              Out*, int, int, int, int, void*);
SVC_BLOCK_SADS(2, 2, float)
SVC_BLOCK_SADS(4, 2, float)
SVC_BLOCK_SADS(2, 4, float)
SVC_BLOCK_SADS(2, 1, float)
SVC_BLOCK_SADS(1, 2, float)
SVC_BLOCK_SADS(4, 1, float)
SVC_BLOCK_SADS(1, 4, float)
SVC_BLOCK_SADS(8, 2, float)
SVC_BLOCK_SADS(2, 8, float)
SVC_BLOCK_SADS(2, 2, int32_t)
SVC_BLOCK_SADS(4, 2, int32_t)
SVC_BLOCK_SADS(2, 4, int32_t)
SVC_BLOCK_SADS(8, 2, int32_t)
SVC_BLOCK_SADS(2, 8, int32_t)
#undef SVC_BLOCK_SADS

// tracked, anchor: (t_count, fh, fw) uint8; mv: (t_count, fh/bh, fw/bw, 2)
// int32 (x, y); out: (t_count, (2r + 1)^2, fh/bh, fw/bw) float32. All
// contiguous; (bw, bh) one of 1x1, 2x2, 4x4, 8x8, 16x16, 2x1, 1x2, 4x2,
// 2x4, 8x4, 4x8, 16x8, 8x16, 4x1, 1x4, 8x2, 2x8, 16x4, 4x16, dividing fw
// and fh, 1 <= r <= 4 (also 5 <= r <= 8 at 16x16, 8x8, 4x4, 2x2 and 1x1); at 1x1
// tracked 4-byte aligned and fh * fw a
// multiple of 4; on the thread-a-block kernel (a side of 1 or 2) also the
// anchor aligned to its rows' bytes (BW); both 16-byte aligned where both
// sides are 4 or more. Refuses (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_candidate_sads(const void* tracked, const void* anchor,
                                  const void* mv, void* out, int t_count,
                                  int fh, int fw, int bw, int bh, int r,
                                  void* stream) {
  const size_t plane = static_cast<size_t>(fh) * fw;
  auto* o = static_cast<float*>(out);
  switch (shape_key(bw, bh)) {
    case shape_key(1, 1): return launch_block1(tracked, anchor, mv, o, t_count, fh, fw,
                                               r, static_cast<cudaStream_t>(stream));
    case shape_key(2, 2): return launch_block_sads<2, 2, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(2, 1): return launch_block_sads<2, 1, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(1, 2): return launch_block_sads<1, 2, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 2): return launch_block_sads<4, 2, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(2, 4): return launch_block_sads<2, 4, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 1): return launch_block_sads<4, 1, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(1, 4): return launch_block_sads<1, 4, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 2): return launch_block_sads<8, 2, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(2, 8): return launch_block_sads<2, 8, float>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 4): return launch_refine_rows<4, 4, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 8): return launch_refine_rows<8, 8, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 4): return launch_refine_rows<8, 4, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 8): return launch_refine_rows<4, 8, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 16): return launch_refine_rows<16, 16, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 8): return launch_refine_rows<16, 8, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 16): return launch_refine_rows<8, 16, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 4): return launch_refine_rows<16, 4, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 16): return launch_refine_rows<4, 16, float>(
        tracked, anchor, plane, mv, o, t_count, fh, fw, r, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
