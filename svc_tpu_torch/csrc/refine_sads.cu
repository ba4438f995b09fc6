// K3 refine_sads: candidate SADs of one hierarchical motion refinement
// level for a whole frame stack, specialised for BW x BH MV blocks (BW
// columns, BH rows) at search radius R = 1 to 4: square 4, 8, 16, 32, the
// ratio-2 rectangles 8x4, 4x8, 16x8, 8x16, 32x16, 16x32 and the ratio-4
// ones 32x8, 16x4, 8x32, 4x16 here; 2x2, 4x2, 2x4, 8x2 and 2x8 on K9's
// thread-a-block kernel (candidate_sads.cu); and 32x32, 16x16, 8x8, 4x4
// (and on the thread-a-block kernel 2x2) at R = 5 to 8 (the levels under
// the top of square MV blocks past top radius 4: 16x16 MV blocks at 2-5
// levels, ranges 10-143; 8x8 at 4 levels, ranges 40-71; 32x32 at 2-5
// levels, ranges 10-143). These are the
// refinement levels of the encoder's search at 16x16 MV blocks and 4 pyramid levels,
// range 8 (R = 1, the default) to 39 (R = range / 8), at 8x8 MV blocks or
// 2, 3 or 5 levels, at 16x8 or 8x16 MV blocks and 2, 3 or 4 levels, at
// 32x32, 32x16 or 16x32 MV blocks and 2 to 5 levels, and at 32x8 or 8x32
// MV blocks and 2, 3 or 4 levels (16x4 at 2 or 3 levels too)
// (--mv-block-w/-h, --pyr-lvl-count). The same kernel is K7's for one
// frame pair (refine_mads.cu) and K9's at 4x4, 8x8, 16x16, 8x4, 4x8, 16x8,
// 8x16, 16x4 and 4x16 blocks with float32 output (candidate_sads.cu), and
// at 16x16, 8x8 and 4x4 at R = 5 to 8 too, through the launchers of
// refine_sads.cuh: it reads frame t's tracked plane and its anchor from two
// bases a per-frame stride apart, so K3 passes (stack, stack + plane,
// plane), K7 (tracked, anchor, 0) and K9 (tracked, anchor, plane).
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pallas (:887,
// pallas_call in _refine_stack_call :1093) and, for K7, refine_mads_pallas
// (:541). Every other block shape or range runs refine_sads_general.cu /
// refine_mads_general.cu (window_sads.cuh); ops/motion.py dispatches. The
// contract is the general kernel's: frame t tracked against its anchor
// (frame t+1 of K3's stack), SAD of candidate (oy, ox) in raster order at
//   sum_{i<BH, j<BW} |trk(t, by*BH + mvy + oy - R + i, bx*BW + mvx + ox - R + j)
//                     - anc(t, by*BH + i, bx*BW + j)|
// with tracked pixels outside the frame read as 0: exact integer sums,
// bit-equal to the general kernel and to refine_sads_plain on every
// candidate, valid or not.
//
// Bound: bytes at R = 1 and 2 (each anchor and tracked pixel read once,
// each SAD written once: 0.0099 and 0.0137 ms for the three 1080p levels
// of an 8-frame batch at 16x16 MV blocks on an H100), the (2R + 1)^2 BW BH
// / 4 SIMD SADs a block at the integer rate at level 0 from R = 3. The
// general kernel gives one warp to each MV block (half its lanes idle on
// 4x4 blocks), divides by runtime sizes per pixel and works byte by byte.
// Design:
//   - a lane owns one anchor row of one block (BW / 4 words in registers);
//     the BH lanes of a block are neighbours in a warp, 256 / BH blocks of
//     one block row per CTA, so every lane is busy at every level;
//   - window rows arrive as aligned chunks of kGrain = min(BW, 16) bytes
//     (16-, 8- or 4-byte loads through the read-only path; two at BW <= 16,
//     three at BW = 32, whose window starts at a 16-byte grain so that its
//     word selects span 4 words, not 8) plus Window<BW, R>::kExtra words
//     (one at R <= 2, two at R = 3, 4) when the window reaches past them; a
//     chunk outside the frame (rows outside [0, fh), columns outside [0,
//     fw); fw is a multiple of BW) reads as 0 by one predicate per chunk.
//     The load instructions per warp, each touching up to 32 rows, set the
//     pace (L1 wavefronts), so fewer, wider ones;
//   - each lane loads only its own window rows: at R = 1 row i, the rows
//     of oy = 1, 2 come from the next lanes by shuffles and the last two
//     lanes of a block load the two rows below it; at R >= 2 lane i loads
//     rows i, i + BH, ... of the window's BH + 2R, and takes row i + oy
//     from lane (i + oy) mod BH by one shuffle a word, that lane sending
//     the row its taker wants;
//   - selects and __funnelshift_r align the words to each candidate
//     column, and __vsadu4 sums four absolute differences at once;
//   - all index math is compile-time (BW, BH and R are template
//     parameters);
//   - at R = 1 the 9 sums of an 8x8 or 4-row block reduce over its BH
//     lanes by log2(BH) xor shuffles; at R >= 2, and at R = 1 on the other
//     blocks, a lane's (2R + 1)^2 sums fit 16 bits and go two to a word,
//     and the words reduce by transposed xor steps (each halves what a lane
//     holds: 41 shuffles for R = 4 at 16 lanes, not 324; 7 for R = 1, not
//     36) while a sum covers at most 256 pixels, then as 32-bit sums
//     (reduce_store: a 32x32 block's sum reaches 255 x 1024 > 2^16); then
//     through shared memory, leaving as runs of consecutive block columns
//     of each candidate plane;
//   - at BW = 16 and R >= 2 (32 columns: R = 2, and R = 1 at 32x16), and
//     on the tall rectangles 16x32, 8x16, 4x8, 8x32 and 4x16 at every R,
//     the ALU work of the shifts, the row shuffles and the reduction
//     outweighs the SADs, so refine_sads_split_kernel gives a block BH / 4
//     lanes of 4 anchor rows each: every lane loads its 4 + 2R window rows
//     itself, a row's shifted words serve up to 4 anchor rows, and the
//     reduction spans BH / 4 lanes (kSplit; in turns on an H100: 22-27%
//     faster at 16x16 and R = 2, 3, 9% at R = 4; at 16x8 22 / 13 / 9% at R
//     = 2 / 3 / 4; at 8x16 46 / 38 / 34 / 17% at R = 1-4 and at 4x8 44 / 37
//     / 23 / 7%; at 8x32 20-25% and at 4x16 5-41%; at 32x32 and 32x16 3-5%
//     at R = 2, 15% at 32x16 and R = 1; at 8x8 no faster, 16% slower at R
//     = 4: twice the row loads; 32x8 and 16x4 run one row a lane). Its CTAs
//     hold 1024 / BH blocks, so it runs only where its grid gives every SM
//     two CTAs, does not spill just past one wave at the kernel's own CTAs
//     an SM and leaves few of its block slots idle past a block row's end
//     (split_fits: K3's stacks; a single 1080p pair, K7, keeps the
//     one-row-a-lane kernel's grid but at 8x16, R <= 3, and 8x32);
//   - past R = 4 (kNearRadius: 32x32, 16x16, 8x8 and 4x4, kFarRadii) a
//     lane's (2R + 1)^2 sums would outgrow its registers (145 words of
//     pairs at R = 8), so the kernels work one candidate row at a time: the
//     one-row kernel reduces each row's 2R + 1 sums as soon as it has them
//     (block_sads_by_row; at 32x32 on pairs over the lane offsets 16, 8, 4
//     and as 32-bit sums over 2 and 1, reduce_row: a block's sum reaches
//     261,120), the split kernel keeps the 4 candidate rows its
//     window rows can still meet in slots and reduces and stores each when
//     its last window row has passed (refine_sads_split_rows_kernel, 8x8
//     only: kSplitFar); the window rows take 3-4 extra words past R = 4, as
//     whole chunks (one word a chunk at 4 columns, one 16-byte chunk at
//     32: a 32x32 window row at R = 8 is 48 of the 64 bytes from its
//     16-byte grain on). The one-row kernel's
//     4x4 blocks, 64 a CTA, store each row's sums straight to the output
//     (kRowsToOut: their candidate planes in shared memory would pass 48 KB
//     from R = 7).
// From the window rows on, the one-row-a-lane kernel runs refine_rows.cuh,
// shared with the K8 refine (refine_sads_pitched.cu, 16x16, R = 1).
#include "refine_rows.cuh"
#include "refine_sads.cuh"

namespace {

// Anchor rows a lane owns in the split kernel.
constexpr int kSplitRows = 4;
// The largest radius whose instances hold all (2R + 1)^2 sums of a lane at
// once; past it the kernels work one candidate row at a time.
constexpr int kNearRadius = 4;

// Whether a BW x BH instance also takes R = 5 to 8 (kFarRadii's switch):
// square 4 to 32, the levels of square MV blocks past top radius 4 (K3,
// K7: 32x32 at level 0 of 32x32 MV blocks, 16x16 at level 0 of 16x16 and
// at level 1 of 32x32, 8x8 and 4x4 below them; K9: 16x16 one level of
// 16x16 MV blocks or the top of 2 of 32x32, 8x8 and 4x4 the tops of
// deeper ones). 32x32 runs the one-row kernel (8 blocks a CTA, 289 x 8
// words of sums in shared memory at R = 8): 32-column blocks' split kernel
// took 137-139 registers from R = 3.
template <int BW, int BH>
constexpr bool kFarRadii = BW == BH && BW >= 4;

// Whether an instance past kNearRadius runs refine_sads_split_rows_kernel
// (where its grid fits it, launch) rather than the one-row kernel's
// block_sads_by_row: 8-column blocks, whose 8 lanes would spend more on
// row shuffles and reductions than on their rows' 2 words of SADs (in
// turns on an H100, K9 8x8 on 8 x 544x960 at R = 5, 7, 8: 0.035 / 0.056 /
// 0.073 ms against 0.052 / 0.074 / 0.111; at R = 6 its 4 CTAs an SM put
// 544 CTAs just past one wave and split_fits keeps the one-row kernel).
// At 16x16 the one-row kernel is 3-7% faster at R = 5 and 8 and at most
// 5% slower at R = 6, 7 (K3 on 9 x 1088x1920, K9 on 8). A 4x4 block would
// get one lane and a CTA of 256 blocks of one block row, half of them idle
// on a 120-column level: 4x4 runs one row a lane.
template <int BW, int BH>
constexpr bool kSplitFar = BW == 8;

// Whether the one-row kernel past kNearRadius stores each candidate row's
// sums straight to out rather than through s_out: 4-row blocks, whose
// kCand x 64 words of sums would pass 48 KB of static shared memory from R
// = 7 (57,600 B; 73,984 at R = 8). A warp's store of one sum covers 8
// consecutive block columns of a candidate plane, 32 bytes (in turns on an
// H100, K3 on 9 x 272x480: as fast as through s_out at R = 5, 20% faster
// at R = 6).
template <int BH, int R>
constexpr bool kRowsToOut = R > kNearRadius && BH == 4;

// Whether an instance runs the split kernel (where its grid fits it,
// launch): 16-column blocks of 8 rows or more at R >= 2, the tall
// rectangles 16x32, 8x16, 4x8, 8x32 and 4x16 at every R, and 32-column
// blocks of 16 rows or more at R = 2 and 32x16 at R = 1. At R = 3, 4 the
// 32-column split kernel needs 137-139 registers, one CTA an SM, and the
// one-row kernel (75-109, two or three) is 10-19% faster; at R = 1 32x32's
// one-row kernel is 4% faster, 32x16's 15% slower; 32x8's split (2 lanes a
// block) 16% slower at R = 1, 43% at R = 2 (in turns on an H100). A 4-row
// block would get one lane and a CTA of 256 blocks (past 48 KB of sums
// from R = 3): 16x4 runs one row a lane.
template <int BW, int BH, int R>
constexpr bool kSplit = (BW == 16 && BH >= 8 && R >= 2) || (BW < BH && BH >= 8) ||
                        (BW == 32 && BH >= 16 && (R == 2 || (R == 1 && BH < BW)));

// Whether an instance's 9 sums at R = 1 reduce by plain xor steps over the
// block's BH lanes (8x8 blocks and 4-row ones) rather than two to a word
// by transposed xor steps (the R >= 2 path): on 8- and 16-row blocks that
// takes 6 or 7 shuffles where xor steps take 27 or 36 (in turns on an
// H100: 14% faster at 16x16, 11-13% at 16x8 and 8x16, 4% at 4x8; 10%
// slower at 8x4, 3% at 8x8 with K9's float output, 2% faster with K3's).
template <int BW, int BH, int R>
constexpr bool kXorSums = R == 1 && (BH == 4 || (BW == 8 && BH == 8));

// N aligned bytes (32, 16, 8 or 4; 16-byte aligned from 16 on) as N / 4
// words.
template <int N>
__device__ __forceinline__ void load_chunk(const uint8_t* p, uint32_t* w) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int k = 0; k < N / 16; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
  } else if constexpr (N == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Bytes [x0, x0 + 4 kWords) of row y of a plane as Window<BW, R>::kWords
// words, the first starting at byte x0 (the window row needs BW + 2R of
// them). It loads the kChunks aligned kGrain-byte chunks from floor(x0 /
// kGrain) * kGrain on (two BW-byte chunks at BW <= 16, three of 16 bytes
// at BW = 32), and the kExtra words after them when the window reaches
// them; a chunk outside the frame, and every chunk when the row lies
// outside it or the lane is disabled, reads as 0 (fw is a multiple of BW,
// so of kGrain, and a chunk is wholly in or out).
template <int BW, int R>
__device__ __forceinline__ void load_window_row(const uint8_t* __restrict__ plane,
                                                int y, int x0, int fh, int fw,
                                                bool enabled,
                                                uint32_t (&al)[Window<BW, R>::kWords]) {
  using W = Window<BW, R>;
  constexpr int kG = W::kGrain;
  constexpr int kW = kG / 4;  // words a chunk
  constexpr int kTail = W::kChunks * kW;  // the first extra word
  const bool row_in = enabled && y >= 0 && y < fh;
  const uint8_t* row = plane + static_cast<size_t>(row_in ? y : 0) * fw;
  const int xb = x0 & ~(kG - 1);  // floor to a multiple of kGrain
  const int s = x0 - xb;          // 0 .. kGrain-1
  uint32_t w[W::kFetch];
#pragma unroll
  for (int c = 0; c < W::kChunks; ++c) {
    const int x = xb + c * kG;
    if (row_in && x >= 0 && x < fw) {
      load_chunk<kG>(row + x, w + c * kW);
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k) w[c * kW + k] = 0u;
    }
  }
  const int x2 = xb + W::kChunks * kG;  // the window's last bytes lie here when s is large
  if constexpr (R == 1) {
    w[kTail] = (row_in && s == kG - 1 && x2 >= 0 && x2 < fw)
                   ? __ldg(reinterpret_cast<const unsigned int*>(row + x2)) : 0u;
  } else if constexpr (kG == 4) {
    // chunks of one word: word e is needed when s + 4 + 2R > 8 + 4e
#pragma unroll
    for (int e = 0; e < W::kExtra; ++e) {
      const int x = x2 + 4 * e;
      w[kTail + e] = (row_in && s > 4 * e + 4 - 2 * R && x >= 0 && x < fw)
                         ? __ldg(reinterpret_cast<const unsigned int*>(row + x)) : 0u;
    }
  } else if constexpr (W::kExtra > 2) {
    // past kNearRadius (kExtra 3, 4): the extra words fill whole chunks past
    // the kChunks, one at kGrain 16, two at 8; chunk c is read when the
    // window reaches it (s > kGrain (c + 1) - 2R) and lies in the row
    constexpr int kXChunks = (4 * W::kExtra + kG - 1) / kG;
#pragma unroll
    for (int c = 0; c < kXChunks; ++c) {
      const int x = x2 + c * kG;
      uint32_t v[kW] = {};
      if (row_in && s > kG * (c + 1) - 2 * R && x >= 0 && x < fw) load_chunk<kG>(row + x, v);
#pragma unroll
      for (int k = 0; k < kW && c * kW + k < W::kExtra; ++k) w[kTail + c * kW + k] = v[k];
    }
  } else {
    // kGrain >= 8: the kExtra (1 or 2) words lie in one chunk, 8-byte aligned
    const bool need = row_in && s > kG - 2 * R && x2 >= 0 && x2 < fw;
    if constexpr (W::kExtra == 1) {
      w[kTail] = need ? __ldg(reinterpret_cast<const unsigned int*>(row + x2)) : 0u;
    } else {
      uint2 v = make_uint2(0u, 0u);
      if (need) v = __ldg(reinterpret_cast<const uint2*>(row + x2));
      w[kTail] = v.x;
      w[kTail + 1] = v.y;
    }
  }
  align_window_row<BW, R>(w, s, al);
}

template <int BW, int BH, int R, class Out>
__global__ void __launch_bounds__(kThreads)
refine_sads_kernel(const uint8_t* __restrict__ tracked,
                   const uint8_t* __restrict__ anchor, size_t frame_stride,
                   const int32_t* __restrict__ mv, Out* __restrict__ out,
                   int fh, int fw, int mfh, int mfw) {
  constexpr int kBlocks = kThreads / BH;  // MV blocks of one block row
  using W = Window<BW, R, BH>;
  __shared__ int32_t s_out[kRowsToOut<BH, R> ? 1 : W::kCand][kBlocks];

  const unsigned i = threadIdx.x % BH;  // anchor row of this lane
  const unsigned blk = threadIdx.x / BH;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole BH-lane group is in or out

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }
  const uint8_t* trk = tracked + t * frame_stride;
  uint32_t a[BW / 4] = {};
  if (active) {
    load_chunk<BW>(anchor + t * frame_stride +
                       static_cast<size_t>(by * BH + i) * fw + bx * BW, a);
  }

  const int x0 = bx * BW + mvx - R;  // first window column (ox = 0)
  const int y0 = by * BH + mvy - R + static_cast<int>(i);  // row at oy = 0
  if constexpr (kXorSums<BW, BH, R>) {
    uint32_t r0[W::kWords], ext[W::kWords];
    load_window_row<BW, R>(trk, y0, x0, fh, fw, active, r0);
    // lanes BH-2 and BH-1 also load rows BH and BH+1 of the window
    load_window_row<BW, R>(trk, y0 + 2, x0, fh, fw, active && i >= BH - 2, ext);
    block_sads<BW, BH>(r0, ext, a, i, blk, s_out);
  } else {
    // lane i holds window rows i, i + BH, ...: those inside the window (at
    // R = 1 row i and, on lanes 0 and 1, row i + BH)
    uint32_t rows[W::kSlots][W::kWords];
#pragma unroll
    for (int k = 0; k < W::kSlots; ++k) {
      const bool inside = k == 0 || static_cast<int>(i) + k * BH < BH + 2 * R;
      load_window_row<BW, R>(trk, y0 + k * BH, x0, fh, fw, active && inside, rows[k]);
    }
    if constexpr (kRowsToOut<BH, R>) {
      const size_t plane_out = static_cast<size_t>(mfh) * mfw;
      Out* o = out + (static_cast<size_t>(t) * W::kCand * mfh + by) * mfw + bx;
      block_sads_by_row<BW, BH, R>(rows, a, i, [&](int c, uint32_t sum) {
        if (active) o[c * plane_out] = sad_as<Out>(sum);
      });
    } else if constexpr (R > kNearRadius) {
      block_sads_by_row<BW, BH, R>(rows, a, i, [&](int c, uint32_t sum) {
        s_out[c][blk] = static_cast<int32_t>(sum);
      });
    } else {
      block_sads_wide<BW, BH, R>(rows, a, i, blk, s_out);
    }
  }
  if constexpr (!kRowsToOut<BH, R>) {
    __syncthreads();
    store_sads<BH, R>(s_out, out, t, by, mfh, mfw);
  }
}

// K3 where kSplit holds: BH / 4 lanes a block, lane l owning anchor rows
// 4l .. 4l + 3 and loading its own window rows 4l .. 4l + 3 + 2R (no row
// shuffles); a window row's shifted words serve each of the lane's anchor
// rows it meets, the 16-bit sums accumulate two to a word as they come (at
// most 4 * 32 * 255 a lane), and the words reduce over the BH / 4 lanes by
// transposed xor steps (reduce_store: as 32-bit sums once a sum covers
// more than 256 pixels). 1024 / BH blocks a CTA.
template <int BW, int BH, int R, class Out>
__global__ void __launch_bounds__(kThreads)
refine_sads_split_kernel(const uint8_t* __restrict__ tracked,
                         const uint8_t* __restrict__ anchor, size_t frame_stride,
                         const int32_t* __restrict__ mv, Out* __restrict__ out,
                         int fh, int fw, int mfh, int mfw) {
  constexpr int kRows = kSplitRows;
  constexpr int kLanes = BH / kRows;
  constexpr int kBlocks = kThreads / kLanes;
  constexpr int kSide = 2 * R + 1;
  using W = Window<BW, R>;
  __shared__ int32_t s_out[W::kCand][kBlocks];

  const unsigned l = threadIdx.x % kLanes;  // this lane's anchor rows: 4l ..
  const unsigned blk = threadIdx.x / kLanes;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole group of lanes is in or out

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }
  const uint8_t* trk = tracked + t * frame_stride;
  uint32_t a[kRows][BW / 4];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < BW / 4; ++j) a[m][j] = 0u;
    if (active) {
      load_chunk<BW>(anchor + t * frame_stride +
                         static_cast<size_t>(by * BH + kRows * l + m) * fw + bx * BW, a[m]);
    }
  }
  const int x0 = bx * BW + mvx - R;  // first window column (ox = 0)
  const int y0 = by * BH + mvy - R + kRows * static_cast<int>(l);  // the lane's first row
  uint32_t packed[W::kPacked];
#pragma unroll
  for (int p = 0; p < W::kPacked; ++p) packed[p] = 0u;
#pragma unroll
  for (int k = 0; k < kRows + 2 * R; ++k) {
    uint32_t row[W::kWords];
    load_window_row<BW, R>(trk, y0 + k, x0, fh, fw, active, row);
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int oy = k - m;  // the candidate row window row k meets anchor row m in
      if (oy < 0 || oy > 2 * R) continue;
#pragma unroll
      for (int ox = 0; ox < kSide; ++ox) {
        const int wo = ox / 4;
        const int d = ox % 4;
        const int cand = oy * kSide + ox;
        uint32_t sum = cand % 2 == 0 ? packed[cand / 2] : 0u;
#pragma unroll
        for (int j = 0; j < BW / 4; ++j) {
          uint32_t c;
          if (d == 0) {
            c = row[j + wo];
          } else {
            c = __funnelshift_r(row[j + wo], row[j + wo + 1], 8 * d);
          }
          sum = __vsadu4(c, a[m][j]) + sum;
        }
        if (cand % 2 == 0) {
          packed[cand / 2] = sum;
        } else {
          packed[cand / 2] += sum << 16;
        }
      }
    }
  }
  reduce_store<W::kPacked, kLanes, kRows * BW, W::kCand>(packed, l, blk, s_out);
  __syncthreads();
  store_sads<BH, R, kBlocks>(s_out, out, t, by, mfh, mfw);
}

// The split kernel at R >= 5 (kSplitFar), one candidate row at a time: a
// lane's (2R + 1)^2 sums would outgrow its registers, but window row k
// meets its anchor rows m in candidate rows k - m only, so at most 4 rows
// of sums are open at once. Candidate row oy accumulates in slot oy % 4
// (R + 1 words of 16-bit pairs); window row k is the last to meet row k -
// 3, which then reduces over the block's BH / 4 lanes by transposed xor
// steps (reduce_row) and goes straight to out, its slot cleared for row k +
// 1. The rows of a pass of 4 window rows are unrolled (slot indices
// compile-time), the passes run at run time. A warp's stores of a sum
// cover 32 / (BH / 4) consecutive block columns of one candidate plane.
template <int BW, int BH, int R, class Out>
__global__ void __launch_bounds__(kThreads)
refine_sads_split_rows_kernel(const uint8_t* __restrict__ tracked,
                              const uint8_t* __restrict__ anchor, size_t frame_stride,
                              const int32_t* __restrict__ mv, Out* __restrict__ out,
                              int fh, int fw, int mfh, int mfw) {
  constexpr int kRows = kSplitRows;
  constexpr int kLanes = BH / kRows;
  constexpr int kBlocks = kThreads / kLanes;
  constexpr int kSide = 2 * R + 1;
  using W = Window<BW, R>;
  static_assert(kRows == 4, "a slot for each of 4 open candidate rows");

  const unsigned l = threadIdx.x % kLanes;  // this lane's anchor rows: 4l ..
  const unsigned blk = threadIdx.x / kLanes;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole group of lanes is in or out

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }
  const uint8_t* trk = tracked + t * frame_stride;
  uint32_t a[kRows][BW / 4];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < BW / 4; ++j) a[m][j] = 0u;
    if (active) {
      load_chunk<BW>(anchor + t * frame_stride +
                         static_cast<size_t>(by * BH + kRows * l + m) * fw + bx * BW, a[m]);
    }
  }
  const int x0 = bx * BW + mvx - R;  // first window column (ox = 0)
  const int y0 = by * BH + mvy - R + kRows * static_cast<int>(l);  // the lane's first row
  const size_t plane_out = static_cast<size_t>(mfh) * mfw;
  Out* o = out + (static_cast<size_t>(t) * W::kCand * mfh + by) * mfw + bx;
  uint32_t acc[kRows][R + 1];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
#pragma unroll
    for (int p = 0; p <= R; ++p) acc[s][p] = 0u;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kRows + 2 * R; k0 += kRows) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int k = k0 + u;  // the window row
      if (k >= kRows + 2 * R) break;
      uint32_t row[W::kWords];
      load_window_row<BW, R>(trk, y0 + k, x0, fh, fw, active, row);
#pragma unroll
      for (int ox = 0; ox < kSide; ++ox) {
        const int wo = ox / 4;
        const int d = ox % 4;
        uint32_t c[BW / 4];
#pragma unroll
        for (int j = 0; j < BW / 4; ++j) {
          c[j] = d == 0 ? row[j + wo] : __funnelshift_r(row[j + wo], row[j + wo + 1], 8 * d);
        }
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (k - m < 0 || k - m > 2 * R) continue;  // no candidate row oy = k - m
          uint32_t sum = 0;
#pragma unroll
          for (int j = 0; j < BW / 4; ++j) sum = __vsadu4(c[j], a[m][j]) + sum;
          // slot (k - m) % 4; a lane's sums reach 4 * BW * 255 < 2^16
          acc[(u - m) & 3][ox / 2] += ox % 2 == 0 ? sum : sum << 16;
        }
      }
      if (k >= kRows - 1) {  // candidate row k - 3 is complete
        const int oy = k - (kRows - 1);
        uint32_t(&done)[R + 1] = acc[(u + 1) & 3];
        Out* o_row = o + static_cast<size_t>(oy * kSide) * plane_out;
        reduce_row<R, kLanes, kRows * BW>(done, l, [&](int ox, uint32_t sum) {
          if (active) o_row[ox * plane_out] = sad_as<Out>(sum);
        });
#pragma unroll
        for (int p = 0; p <= R; ++p) done[p] = 0u;
      }
    }
  }
}

// Whether the split kernel takes a grid of `ctas` CTAs on `sms` SMs that
// hold `per_sm` of them at once (its own occupancy), its CTAs spanning
// `slots` block columns a block row and leaving `idle` of them past the
// row's end: every SM gets two CTAs or more; the grid does not spill past
// one full wave by fewer CTAs than there are SMs (such a remainder runs as
// a second wave of under one CTA an SM on an otherwise idle card, a whole
// CTA's time for a sliver of the work: K7's 8x16 pair at R = 4, 272 CTAs,
// 264 at once; past two waves the tail's share is a third or less); and a
// quarter of a block row's slots at most idle (K9's 16x8 on a 960-column
// level: 60 block columns in a CTA of 128; 8x32 at 1080p takes 240 in 8
// CTAs of 32, 16 of 256 idle, and the split is 20-25% faster there). Else
// the one-row kernel's four times as many, smaller CTAs spread evenly.
constexpr bool split_fits(long long ctas, long long sms, long long per_sm, int idle,
                          int slots) {
  const long long wave = per_sm * sms;
  return 4 * idle <= slots && ctas >= 2 * sms && !(ctas > wave && ctas < wave + sms);
}

// An instance's split kernel: refine_sads_split_kernel, past kNearRadius
// its by-row form.
template <int BW, int BH, int R, class Out>
auto split_kernel() {
  if constexpr (R > kNearRadius) {
    return refine_sads_split_rows_kernel<BW, BH, R, Out>;
  } else {
    return refine_sads_split_kernel<BW, BH, R, Out>;
  }
}

template <int BW, int BH, int R, class Out>
int launch(const void* tracked, const void* anchor, size_t frame_stride,
           const void* mv, Out* o, int t_count, int fh, int fw,
           void* stream) {
  const int mfh = fh / BH;
  const int mfw = fw / BW;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* trk = static_cast<const uint8_t*>(tracked);
  const auto* anc = static_cast<const uint8_t*>(anchor);
  const auto* m = static_cast<const int32_t*>(mv);
  if constexpr (R > kNearRadius ? kSplitFar<BW, BH> : kSplit<BW, BH, R>) {
    // the split kernel where its grid fits the card (a stack of 1080p
    // frames; a pair at some shapes); else the one-row kernel
    constexpr int kBlocks = kThreads / (BH / kSplitRows);
    const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
    auto* kernel = split_kernel<BW, BH, R, Out>();
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    static const int per_sm = [kernel] {  // the instance's CTAs an SM, asked once
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
      return n;
    }();
    if (split_fits(static_cast<long long>(grid.x) * grid.y * grid.z, sms, per_sm,
                   grid.x * kBlocks - mfw, grid.x * kBlocks)) {
      kernel<<<grid, kThreads, 0, st>>>(trk, anc, frame_stride, m, o, fh, fw, mfh, mfw);
      return static_cast<int>(cudaGetLastError());
    }
  }
  constexpr int kBlocks = kThreads / BH;
  const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
  refine_sads_kernel<BW, BH, R, Out><<<grid, kThreads, 0, st>>>(
      trk, anc, frame_stride, m, o, fh, fw, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instance of radius r for BW x BH blocks.
template <int BW, int BH, class Out>
int launch_refine_rows(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, Out* out,
                       int t_count, int fh, int fw, int r, void* stream) {
  if (reinterpret_cast<uintptr_t>(tracked) % 16 ||
      reinterpret_cast<uintptr_t>(anchor) % 16 || frame_stride % 16 || fh % BH ||
      fw % BW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (r) {
    case 1: return launch<BW, BH, 1>(tracked, anchor, frame_stride, mv, out,
                                     t_count, fh, fw, stream);
    case 2: return launch<BW, BH, 2>(tracked, anchor, frame_stride, mv, out,
                                     t_count, fh, fw, stream);
    case 3: return launch<BW, BH, 3>(tracked, anchor, frame_stride, mv, out,
                                     t_count, fh, fw, stream);
    case 4: return launch<BW, BH, 4>(tracked, anchor, frame_stride, mv, out,
                                     t_count, fh, fw, stream);
    default: break;
  }
  if constexpr (kFarRadii<BW, BH>) {
    switch (r) {
      case 5: return launch<BW, BH, 5>(tracked, anchor, frame_stride, mv, out,
                                       t_count, fh, fw, stream);
      case 6: return launch<BW, BH, 6>(tracked, anchor, frame_stride, mv, out,
                                       t_count, fh, fw, stream);
      case 7: return launch<BW, BH, 7>(tracked, anchor, frame_stride, mv, out,
                                       t_count, fh, fw, stream);
      case 8: return launch<BW, BH, 8>(tracked, anchor, frame_stride, mv, out,
                                       t_count, fh, fw, stream);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3 and K7 at 4x4, 8x8, 16x16, 32x32, 8x4, 4x8, 16x8, 8x16, 32x16,
// 16x32, 32x8, 16x4, 8x32 and 4x16 blocks; K9 at 4x4, 8x8, 16x16, 8x4,
// 4x8, 16x8, 8x16, 16x4 and 4x16
#define SVC_REFINE_ROWS(BW, BH, Out)                                             \
  template int launch_refine_rows<BW, BH, Out>(const void*, const void*, size_t, \
                                               const void*, Out*, int, int, int, \
                                               int, void*);
SVC_REFINE_ROWS(4, 4, int32_t)
SVC_REFINE_ROWS(8, 8, int32_t)
SVC_REFINE_ROWS(16, 16, int32_t)
SVC_REFINE_ROWS(8, 4, int32_t)
SVC_REFINE_ROWS(4, 8, int32_t)
SVC_REFINE_ROWS(16, 8, int32_t)
SVC_REFINE_ROWS(8, 16, int32_t)
SVC_REFINE_ROWS(32, 32, int32_t)
SVC_REFINE_ROWS(32, 16, int32_t)
SVC_REFINE_ROWS(16, 32, int32_t)
SVC_REFINE_ROWS(32, 8, int32_t)
SVC_REFINE_ROWS(16, 4, int32_t)
SVC_REFINE_ROWS(8, 32, int32_t)
SVC_REFINE_ROWS(4, 16, int32_t)
SVC_REFINE_ROWS(4, 4, float)
SVC_REFINE_ROWS(8, 8, float)
SVC_REFINE_ROWS(8, 4, float)
SVC_REFINE_ROWS(4, 8, float)
SVC_REFINE_ROWS(16, 16, float)
SVC_REFINE_ROWS(16, 8, float)
SVC_REFINE_ROWS(8, 16, float)
SVC_REFINE_ROWS(16, 4, float)
SVC_REFINE_ROWS(4, 16, float)
#undef SVC_REFINE_ROWS

int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int bw, int bh, int r,
                       void* stream) {
  auto* o = static_cast<int32_t*>(out);
  // K9's kernel (the blocks with a side of 2) takes a frame a plane on:
  // K3's frames lie a plane apart, K7 has one
  if ((bw == 2 || bh == 2) && t_count > 1 &&
      frame_stride != static_cast<size_t>(fh) * fw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (shape_key(bw, bh)) {
    case shape_key(2, 2): return launch_block_sads<2, 2, int32_t>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 2): return launch_block_sads<4, 2, int32_t>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(2, 4): return launch_block_sads<2, 4, int32_t>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 2): return launch_block_sads<8, 2, int32_t>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(2, 8): return launch_block_sads<2, 8, int32_t>(
        tracked, anchor, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 4): return launch_refine_rows<4, 4, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 8): return launch_refine_rows<8, 8, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 16): return launch_refine_rows<16, 16, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 4): return launch_refine_rows<8, 4, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 8): return launch_refine_rows<4, 8, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 8): return launch_refine_rows<16, 8, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 16): return launch_refine_rows<8, 16, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(32, 32): return launch_refine_rows<32, 32, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(32, 16): return launch_refine_rows<32, 16, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 32): return launch_refine_rows<16, 32, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(32, 8): return launch_refine_rows<32, 8, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(16, 4): return launch_refine_rows<16, 4, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(8, 32): return launch_refine_rows<8, 32, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    case shape_key(4, 16): return launch_refine_rows<4, 16, int32_t>(
        tracked, anchor, frame_stride, mv, o, t_count, fh, fw, r, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stack: (t_count + 1, fh, fw) uint8, 16-byte aligned; mv: (t_count,
// fh/bh, fw/bw, 2) int32 (x, y); out: (t_count, (2r + 1)^2, fh/bh, fw/bw)
// int32. All contiguous; (bw, bh) one of 2x2, 4x4, 8x8, 16x16, 32x32, 4x2,
// 2x4, 8x4, 4x8, 16x8, 8x16, 32x16, 16x32, 32x8, 16x4, 8x2, 8x32, 4x16,
// 2x8, dividing fw and fh; 1 <= r <= 4, and 5 <= r <= 8 at 32x32, 16x16,
// 8x8, 4x4 and 2x2. Refuses
// (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_refine_sads(const void* stack, const void* mv, void* out,
                               int t_count, int fh, int fw, int bw, int bh, int r,
                               void* stream) {
  const size_t plane = static_cast<size_t>(fh) * fw;
  return launch_refine_sads(stack, static_cast<const uint8_t*>(stack) + plane,
                            plane, mv, out, t_count, fh, fw, bw, bh, r, stream);
}
