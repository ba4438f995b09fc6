"""K3's, K7's and K5's dispatch (the specialised / cluster kernels and the
general ones), the cluster kernel's slice geometry, and a CPU replay of its
decomposition against ``lloyd_plain``.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing
computes. The replay runs Lloyd with the cluster kernel's order of work —
per-slice partial sums added in rank order, the repair's argmax taken per
slice and then across slices — and must give ``lloyd_plain``'s labels and
centers bit for bit.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import kmeans, motion, prng
from svc_tpu_torch.ops.pad import padded_dims
from test_torch_pyramid_ebma_dispatch import _replay_k9_1x1, _replay_k9_block


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the K3 / K7 / K5 wrappers' CUDA path to a meta device; record
    each launch as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(
        motion, "_check_sad_args",
        lambda name, planes, mv, lead, fh, fw, bw, bh, r: (fh // bh, fw // bw))
    monkeypatch.setattr(kmeans, "_check_cuda", lambda x: None)
    for mod in (motion, kmeans):
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (motion.REFINE_SADS, motion.REFINE_SADS_GENERAL,
              motion.REFINE_MADS, motion.REFINE_MADS_GENERAL,
              motion.CANDIDATE_SADS, kmeans.LLOYD, kmeans.LLOYD_GENERAL):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _meta_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


# the ratio-2 rectangles (width x height) of 16x8 and 8x16 MV blocks'
# refinement levels: K3's / K7's instances
_RECTS = [(4, 2), (8, 4), (16, 8), (2, 4), (4, 8), (8, 16)]
# the blocks with a 32-pixel side: level 0 of 32x32, 32x16 and 16x32 MV
# blocks
_WIDE = [(32, 32), (32, 16), (16, 32)]
# the ratio-4 rectangles of 32x8 and 8x32 MV blocks' refinement levels
_RATIO4 = [(32, 8), (16, 4), (8, 2), (8, 32), (4, 16), (2, 8)]


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bw,bh,r,general,kernel",
    [(4, 4, 1, False, "refine_sads"), (8, 8, 1, False, "refine_sads"),
     (16, 16, 1, False, "refine_sads"), (16, 8, 1, False, "refine_sads"),
     (16, 16, 2, False, "refine_sads"), (4, 4, 3, False, "refine_sads"),
     (8, 8, 4, False, "refine_sads"),
     *((2, 2, r, False, "refine_sads") for r in (1, 2, 3, 4)),
     # R = 5-8 at 16x16, 8x8 and 4x4 (levels 0, 1 and 2 of 2-4 levels,
     # ranges 10-71): one candidate row at a time; R = 9 and the other
     # blocks past R = 4 stay general
     (16, 16, 5, False, "refine_sads"),
     (16, 16, 8, False, "refine_sads"),
     *((16, 16, r, False, "refine_sads") for r in (6, 7)),
     (16, 16, 9, False, "refine_sads_general"),
     (16, 16, 6, True, "refine_sads_general"),
     (8, 8, 5, False, "refine_sads"), (32, 32, 8, False, "refine_sads"),
     *((b, b, r, False, "refine_sads") for b in (8, 4) for r in (5, 6, 7, 8)
       if (b, r) != (8, 5)),
     (8, 8, 9, False, "refine_sads_general"), (4, 4, 9, False, "refine_sads_general"),
     (8, 8, 7, True, "refine_sads_general"), (4, 4, 8, True, "refine_sads_general"),
     (2, 2, 5, False, "refine_sads"), (8, 4, 5, False, "refine_sads_general"),
     # R = 5-8 at 32x32 (level 0 of 32x32 MV blocks at 2-5 levels, ranges
     # 10-143) and 2x2 (level 2 of 8x8 MV blocks at 4 levels, level 3 of
     # 16x16 and 32x32 at 5); R = 9 and general=True stay general
     *((b, b, r, False, "refine_sads") for b in (32, 2) for r in (6, 7)),
     (2, 2, 8, False, "refine_sads"),
     (32, 32, 9, False, "refine_sads_general"), (2, 2, 9, False, "refine_sads_general"),
     (32, 32, 7, True, "refine_sads_general"), (2, 2, 6, True, "refine_sads_general"),
     (32, 16, 5, False, "refine_sads_general"), (16, 32, 8, False, "refine_sads_general"),
     (2, 4, 1, False, "refine_sads"),
     (1, 1, 1, False, "refine_sads_general"),
     (16, 16, 1, True, "refine_sads_general"),
     (2, 2, 1, True, "refine_sads_general"),
     # the ratio-2 rectangles (width x height) of 16x8 and 8x16 MV blocks
     *((bw, bh, r, False, "refine_sads") for bw, bh in _RECTS for r in (1, 2, 3, 4)),
     (16, 8, 2, True, "refine_sads_general"),
     (16, 8, 5, False, "refine_sads_general"),
     # the ratio-4 rectangles of 32x8 and 8x32 MV blocks (4x16, 16x4 and
     # 32x8 at r = 1 were general before them)
     (4, 16, 1, False, "refine_sads"), (16, 4, 1, False, "refine_sads"),
     (32, 8, 1, False, "refine_sads"),
     *((bw, bh, r, False, "refine_sads") for bw, bh in _RATIO4 for r in (1, 2, 3, 4)
       if (bw, bh, r) not in ((4, 16, 1), (16, 4, 1), (32, 8, 1))),
     (32, 8, 5, False, "refine_sads_general"), (2, 8, 5, False, "refine_sads_general"),
     (8, 2, 2, True, "refine_sads_general"), (8, 32, 4, True, "refine_sads_general"),
     # other ratios and sides stay general
     (6, 3, 1, False, "refine_sads_general"),
     (1, 2, 1, False, "refine_sads_general"), (64, 64, 1, False, "refine_sads_general"),
     (64, 16, 1, False, "refine_sads_general"), (16, 2, 1, False, "refine_sads_general"),
     (8, 1, 1, False, "refine_sads_general"), (1, 8, 1, False, "refine_sads_general"),
     (4, 1, 1, False, "refine_sads_general"),
     # a 32-pixel side: 32x32, 32x16, 16x32 MV blocks' level 0
     *((bw, bh, r, False, "refine_sads") for bw, bh in _WIDE for r in (1, 2, 3, 4)),
     (32, 32, 5, False, "refine_sads"),
     (32, 16, 2, True, "refine_sads_general")],
)
def test_refine_sads_dispatch(meta_launches, bw, bh, r, general, kernel):
    fh, fw = 4 * bh, 6 * bw
    stack = _meta_u8(3, fh, fw)
    mv = torch.zeros((2, 4, 6, 2), dtype=torch.int32, device="meta")
    out = motion.refine_sads(stack, mv, r, bw, bh, general=general)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (2, (2 * r + 1) ** 2, 4, 6)
    ((name, args),) = meta_launches
    assert name == kernel
    k = motion.REFINE_SADS if kernel == "refine_sads" else motion.REFINE_SADS_GENERAL
    assert len(args) == len(k.argtypes)
    assert args[3:9] == (2, fh, fw, bw, bh, r)  # t_count, fh, fw, block, r
    if kernel == "refine_sads":
        assert motion.REFINE_SADS.instance(args) == motion._instance(bw, bh, r)


@pytest.mark.parametrize("search_range,r", [(8, 1), (16, 2), (23, 2), (24, 3),
                                            (32, 4), (39, 4), (40, 5), (64, 8), (71, 8)])
def test_hbma_stack_default_levels_take_the_specialised_k3(meta_launches,
                                                           search_range, r):
    # the encoder's search at 16x16 MV blocks and 4 levels, range 8 (the
    # default) to 71: the top-level EBMA on K9, then levels 2, 1, 0 on the
    # specialised K3, all at the top radius range // 8
    pyr = [_meta_u8(9, 1088 >> lvl, 1920 >> lvl) for lvl in range(4)]
    mv, mm = motion.hbma_stack(pyr, search_range, 16, 16)
    assert tuple(mv.shape) == (8, 68, 120, 2) and tuple(mm.shape) == (8, 68, 120)
    names = [name for name, _ in meta_launches]
    assert names == ["candidate_sads"] + ["refine_sads"] * 3
    assert meta_launches[0][1][7:10] == (2, 2, r)  # K9's block and radius
    blocks = [args[6:9] for name, args in meta_launches if name == "refine_sads"]
    assert blocks == [(4, 4, r), (8, 8, r), (16, 16, r)]


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _meta_plane_at(offset, fh, fw):
    """A meta ``(fh, fw)`` uint8 plane ``offset`` bytes into its buffer (a
    meta tensor's ``data_ptr()`` is its view offset)."""
    return _meta_u8(offset + fh * fw)[offset:].view(fh, fw)


@pytest.mark.parametrize(
    "bw,bh,r,general,anchor_offset,kernel",
    [(4, 4, 1, False, 0, "refine_mads"), (8, 8, 1, False, 0, "refine_mads"),
     (16, 16, 1, False, 0, "refine_mads"),
     (16, 16, 1, False, 16, "refine_mads"),  # 16-byte aligned view
     (4, 8, 1, False, 0, "refine_mads"),
     (16, 16, 2, False, 0, "refine_mads"), (8, 8, 3, False, 16, "refine_mads"),
     (4, 4, 4, False, 0, "refine_mads"),
     *((2, 2, r, False, 0, "refine_mads") for r in (1, 2, 3, 4)),
     (2, 2, 1, False, 16, "refine_mads"),
     (2, 2, 1, False, 2, "refine_mads_general"),  # K3's 16-byte gate stays
     (2, 4, 1, False, 0, "refine_mads"),
     *((16, 16, r, False, 0, "refine_mads") for r in (5, 6, 7, 8)),
     (16, 16, 8, False, 16, "refine_mads"),
     (16, 16, 5, False, 4, "refine_mads_general"),  # K3's 16-byte gate
     (16, 16, 9, False, 0, "refine_mads_general"),
     (16, 16, 7, True, 0, "refine_mads_general"),
     (8, 8, 6, False, 0, "refine_mads"),
     *((b, b, r, False, 0, "refine_mads") for b in (8, 4) for r in (5, 6, 7, 8)
       if (b, r) != (8, 6)),
     (4, 4, 7, False, 16, "refine_mads"),
     (4, 4, 5, False, 4, "refine_mads_general"),  # K3's 16-byte gate
     (8, 8, 9, False, 0, "refine_mads_general"), (4, 4, 9, False, 0, "refine_mads_general"),
     (4, 4, 6, True, 0, "refine_mads_general"), (8, 8, 8, True, 0, "refine_mads_general"),
     (2, 2, 5, False, 0, "refine_mads"),
     # 32x32 and 2x2 at R = 5-8 (the per-frame search's level 0 of 32x32 MV
     # blocks, level 2 of 8x8 at 4 levels); R = 9 and general=True general
     *((b, b, r, False, 16, "refine_mads") for b in (32, 2) for r in (6, 7, 8)),
     (2, 2, 7, False, 2, "refine_mads_general"),  # K3's 16-byte gate
     (32, 32, 8, False, 8, "refine_mads_general"),  # K3's 16-byte gate
     (32, 32, 9, False, 0, "refine_mads_general"), (2, 2, 9, False, 0, "refine_mads_general"),
     (32, 32, 6, True, 0, "refine_mads_general"), (2, 2, 8, True, 0, "refine_mads_general"),
     (32, 8, 5, False, 0, "refine_mads_general"),
     (8, 8, 1, False, 1, "refine_mads_general"),  # unaligned anchor
     (16, 16, 1, True, 0, "refine_mads_general"),
     *((bw, bh, r, False, 16, "refine_mads") for bw, bh in _RECTS for r in (1, 2, 3, 4)),
     (16, 8, 1, False, 4, "refine_mads_general"),  # K3's 16-byte gate
     (4, 2, 3, True, 0, "refine_mads_general"),
     (16, 4, 1, False, 0, "refine_mads"),  # ratio 4: general before 32x8 MV blocks
     (6, 3, 1, False, 0, "refine_mads_general"),
     *((bw, bh, r, False, 16, "refine_mads") for bw, bh in _RATIO4 for r in (1, 2, 3, 4)),
     (8, 2, 1, False, 8, "refine_mads_general"),  # K3's 16-byte gate
     (32, 8, 2, True, 0, "refine_mads_general"),
     (2, 8, 5, False, 0, "refine_mads_general"),
     (64, 16, 1, False, 0, "refine_mads_general"),
     *((bw, bh, r, False, 16, "refine_mads") for bw, bh in _WIDE for r in (1, 2, 3, 4)),
     (32, 32, 1, False, 8, "refine_mads_general"),  # K3's 16-byte gate
     (16, 32, 4, True, 0, "refine_mads_general"),
     (32, 32, 5, False, 0, "refine_mads")],
)
def test_refine_mads_dispatch(meta_launches, bw, bh, r, general, anchor_offset,
                              kernel):
    fh, fw = 4 * bh, 6 * bw
    tracked = _meta_plane_at(0, fh, fw)
    anchor = _meta_plane_at(anchor_offset, fh, fw)
    assert anchor.data_ptr() == anchor_offset
    mv = torch.zeros((4, 6, 2), dtype=torch.int32, device="meta")
    out = motion.refine_mads(tracked, anchor, mv, r, bw, bh, general=general)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == ((2 * r + 1) ** 2, 4, 6)
    ((name, args),) = meta_launches
    assert name == kernel
    k = motion.REFINE_MADS if kernel == "refine_mads" else motion.REFINE_MADS_GENERAL
    assert len(args) == len(k.argtypes)
    assert args[1] == anchor_offset  # the anchor plane itself, not a copy
    assert args[4:9] == (fh, fw, bw, bh, r)
    if kernel == "refine_mads":
        assert motion.REFINE_MADS.instance(args) == motion._instance(bw, bh, r)


@pytest.mark.parametrize("search_range,r", [(8, 1), (16, 2), (24, 3), (32, 4), (40, 5),
                                            (64, 8)])
def test_hbma_default_levels_take_the_specialised_k7(meta_launches,
                                                     search_range, r):
    # the per-frame search (16x16 MV blocks, 4 levels, range 8 to 64) on
    # one padded 1080p pair: the top-level EBMA on K9, then levels 2, 1, 0
    # on the specialised K7
    pyr = [_meta_u8(2, 1088 >> lvl, 1920 >> lvl) for lvl in range(4)]
    mv, mm = motion.hbma([p[0] for p in pyr], [p[1] for p in pyr],
                         search_range, 16, 16)
    assert tuple(mv.shape) == (68, 120, 2) and tuple(mm.shape) == (68, 120)
    names = [name for name, _ in meta_launches]
    assert names == ["candidate_sads"] + ["refine_mads"] * 3
    blocks = [args[6:9] for name, args in meta_launches if name == "refine_mads"]
    assert blocks == [(4, 4, r), (8, 8, r), (16, 16, r)]


def test_k3_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "refine_sads.cu").read_text()
    # K3's / K7's blocks (width, height): both sides 4 or more on this
    # file's kernel, 2x2, 4x2, 2x4, 8x2 and 2x8 on K9's thread-a-block one
    entry = src[src.index("int launch_refine_sads("):]
    rows = {(int(a), int(b)) for a, b, c, d in re.findall(
        r"case shape_key\((\d+), (\d+)\): return launch_refine_rows<(\d+), (\d+), int32_t>\(",
        entry) if (a, b) == (c, d)}
    thin = {(int(a), int(b)) for a, b, c, d in re.findall(
        r"case shape_key\((\d+), (\d+)\): return launch_block_sads<(\d+), (\d+), int32_t>\(",
        entry) if (a, b) == (c, d)}
    # its frames a plane apart (K3) or one frame (K7)
    assert "if ((bw == 2 || bh == 2) && t_count > 1 &&" in entry
    assert thin == {(2, 2), (4, 2), (2, 4), (8, 2), (2, 8)}
    assert min(min(b) for b in rows) >= 4
    assert rows | thin == set(motion._K3_BLOCKS)
    assert set(_WIDE) <= rows  # level 0 of 32x32, 32x16 and 16x32 MV blocks
    assert set(_RATIO4) <= rows | thin  # the levels of 32x8 and 8x32 MV blocks
    # the instances built: int32 for K3 / K7, float32 for K9's shapes with
    # both sides 4 or more
    built = set(re.findall(r"SVC_REFINE_ROWS\((\d+), (\d+), (\w+)\)\n", src))
    assert built == ({(str(w), str(h), "int32_t") for w, h in rows}
                     | {(str(w), str(h), "float") for w, h in motion._K9_BLOCKS
                        if min(w, h) >= 4})
    # the radii of every instance, then those of kFarRadii's switch
    launcher = src[src.index("int launch_refine_rows("):src.index("if constexpr (kFarRadii<")]
    radii = {int(a) for a, b in re.findall(r"case (\d+): return launch<BW, BH, (\d+)>",
                                           launcher) if a == b}
    assert radii == set(motion._SAD_RADII)
    # the SAD arithmetic K3 shares with the K8 refine (r = 1 there) and
    # the word counts the replay above follows
    assert '#include "refine_rows.cuh"' in src
    rows = (build.CSRC_DIR / "refine_rows.cuh").read_text()
    assert "constexpr int kCand = 9;" in rows
    assert "constexpr int kThreads = 256;" in rows
    for line in ("static constexpr int kGrain = BW < 16 ? BW : 16;",
                 "static constexpr int kChunks = BW / kGrain + 1;",
                 "static constexpr int kExtra = (2 * R + 3) / 4;",
                 "static constexpr int kWords = BW / 4 + kExtra;",
                 "static constexpr int kFetch = kChunks * kGrain / 4 + kExtra;",
                 "static constexpr int kSlots = 1 + (2 * R + BH - 1) / BH;",
                 "static constexpr int kPacked = (kCand + 1) / 2;"):
        assert line in rows, line
    # the r = 1 instances keep the parent's shuffles (over BH lanes); R >= 2
    # the transposed reduction over the block's lanes, on 16-bit pairs
    # while a sum covers at most 256 pixels (_reduce_store)
    assert "reduce_store<W::kPacked, BH, BW, W::kCand>(packed, i, blk, s_out);" in rows
    assert "constexpr int Lo = L / (2 * (256 / kPixels));" in rows
    assert "reduce_transposed<N, L / 2, L, Lo>(packed, i);" in rows
    assert "reduce_transposed<2 * kHeld, Lo, L>(v, i);" in rows
    assert "__shfl_xor_sync(kFull, acc[c], off, BH);" in rows
    assert "block_sads<BW, BH>(r0, ext, a, i, blk, s_out);" in src
    assert "constexpr bool kXorSums = R == 1 && (BH == 4 || (BW == 8 && BH == 8));" in src
    assert "if constexpr (kXorSums<BW, BH, R>) {" in src
    assert "block_sads_wide<BW, BH, R>(rows, a, i, blk, s_out);" in src
    # 16-column blocks of 8 rows or more at R >= 2, the tall rectangles
    # (16x32, 8x16, 4x8, 8x32, 4x16), 32-column ones of 16 rows or more at
    # R = 2 and 32x16 at R = 1: the split kernel the replay above follows
    # (_split)
    assert f"constexpr int kSplitRows = {_SPLIT_ROWS};" in src
    assert ("constexpr bool kSplit = (BW == 16 && BH >= 8 && R >= 2) || "
            "(BW < BH && BH >= 8) ||\n"
            "                        (BW == 32 && BH >= 16 && (R == 2 || (R == 1 && BH < BW)));"
            ) in src
    assert "if constexpr (R > kNearRadius ? kSplitFar<BW, BH> : kSplit<BW, BH, R>) {" in src
    assert "constexpr int kLanes = BH / kRows;" in src
    # where its grid gives every SM two CTAs, does not spill just past one
    # wave at the kernel's own CTAs an SM and leaves a quarter of a block
    # row's slots idle at most (_split_fits); else the one-row-a-lane
    # kernel
    assert "return refine_sads_split_kernel<BW, BH, R, Out>;" in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);" in src
    assert ("if (split_fits(static_cast<long long>(grid.x) * grid.y * grid.z, sms, "
            "per_sm,\n") in src
    assert "const long long wave = per_sm * sms;" in src
    assert ("return 4 * idle <= slots && ctas >= 2 * sms && !(ctas > wave && ctas < wave + sms);"
            in src)
    assert "grid.x * kBlocks - mfw, grid.x * kBlocks)) {" in src
    assert ("reduce_store<W::kPacked, kLanes, kRows * BW, W::kCand>(packed, l, blk, s_out);"
            in src)


def test_far_radius_constants_match_the_kernel_source():
    # R = 5-8: kFarRadii's switch and blocks (16x16, 8x8 and 4x4 for K3 / K7
    # and K9, 32x32 for K3 / K7; 2x2 on the thread-a-block kernel and K9's
    # 1x1 on the thread-a-pixel one, candidate_sads.cu), the kernels that
    # work one candidate row at a time, and the word counts past
    # kNearRadius the replays follow
    src = (build.CSRC_DIR / "refine_sads.cu").read_text()
    assert "constexpr int kNearRadius = 4;" in src
    assert max(motion._SAD_RADII) == 4 < min(motion._FAR_RADII)
    far = src[src.index("if constexpr (kFarRadii<BW, BH>) {"):]
    far = far[:far.index("return static_cast<int>(cudaErrorInvalidValue);")]
    radii = {int(a) for a, b in re.findall(r"case (\d+): return launch<BW, BH, (\d+)>\(",
                                           far) if a == b}
    assert radii == set(motion._FAR_RADII)
    assert "constexpr bool kFarRadii = BW == BH && BW >= 4;" in src
    assert "if constexpr (kFarRadii<BW, BH>) {" in src
    squares = {(b, b) for b in (4, 8, 16)}
    assert motion._K3_FAR_BLOCKS == squares | {(32, 32), (2, 2)}
    assert motion._K3_FAR_BLOCKS <= motion._K3_BLOCKS
    assert motion._K9_FAR_BLOCKS == squares | {(2, 2), (1, 1)} and motion._K9_FAR_BLOCKS <= (
        motion._K9_BLOCKS)
    # the K3 / K7 / K9 instances of this file's switch: both outputs at 4x4,
    # 8x8 and 16x16, int32 at 32x32 (2x2 and K9's 1x1 are candidate_sads.cu's)
    built = set(re.findall(r"SVC_REFINE_ROWS\((\d+), (\d+), (\w+)\)\n", src))
    assert {(str(b), str(b), out) for b, _ in squares for out in ("int32_t", "float")} <= built
    assert ("32", "32", "int32_t") in built and ("32", "32", "float") not in built
    # the one-row kernel past kNearRadius, and the split by-row kernel where
    # kSplitFar holds and its grid fits (split_fits)
    assert ("} else if constexpr (R > kNearRadius) {\n"
            "      block_sads_by_row<BW, BH, R>(rows, a, i, [&](int c, uint32_t sum) {") in src
    assert "constexpr bool kSplitFar = BW == 8;" in src
    # 4x4's one-row kernel stores each candidate row straight to the output
    # (kCand x 64 words of shared memory would pass 48 KB from R = 7)
    assert "constexpr bool kRowsToOut = R > kNearRadius && BH == 4;" in src
    assert "__shared__ int32_t s_out[kRowsToOut<BH, R> ? 1 : W::kCand][kBlocks];" in src
    assert "if (active) o[c * plane_out] = sad_as<Out>(sum);" in src
    assert "s_out[c][blk] = static_cast<int32_t>(sum);" in src
    # the sums of a CTA's 64 4x4 blocks would pass 48 KB from R = 7
    assert [(2 * r + 1) ** 2 * 64 * 4 > 48 * 1024 for r in motion._FAR_RADII] == [
        False, False, True, True]
    assert "return refine_sads_split_rows_kernel<BW, BH, R, Out>;" in src
    assert "acc[(u - m) & 3][ox / 2] += ox % 2 == 0 ? sum : sum << 16;" in src
    assert "uint32_t(&done)[R + 1] = acc[(u + 1) & 3];" in src
    assert "reduce_row<R, kLanes, kRows * BW>(done, l, [&](int ox, uint32_t sum) {" in src
    rows = (build.CSRC_DIR / "refine_rows.cuh").read_text()
    # a row's sums reduce as reduce_store's do (_reduce_store): on 16-bit
    # pairs while a sum covers 256 pixels at most, then as 32-bit sums (a
    # 32x32 block's, 261,120, over the lane offsets 2 and 1)
    assert "reduce_pairs<R + 1, L, kPixels, 2 * R + 1>(packed, i, put);" in rows
    assert "reduce_pairs<N, L, kPixels, kCand>(packed, i, [&](int c, uint32_t sum) {" in rows
    assert 'static_assert(kPixels <= 256, "a lane\'s sums must fit 16 bits");' in rows
    assert "constexpr int Lo = L / (2 * (256 / kPixels));" in rows
    assert "const int send_slot = static_cast<int>(i) < rho ? q + 1 : q;" in rows
    assert ("reduce_row<R, BH, BW>(packed, i, [&](int ox, uint32_t sum) { put(oy * kSide + ox, "
            "sum); });") in rows
    # 32x32 runs the one-row kernel past R = 4 (kSplitFar: 8x8 only), its 8
    # blocks' sums in shared memory (9,248 B at R = 8), not straight to out
    assert [(2 * r + 1) ** 2 * 8 * 4 for r in motion._FAR_RADII] == [3872, 5408, 7200, 9248]
    # the extra words past R = 4: whole chunks, chunk c read when the window
    # reaches it (the replay's _k3_window_row)
    assert "constexpr int kXChunks = (4 * W::kExtra + kG - 1) / kG;" in src
    assert ("if (row_in && s > kG * (c + 1) - 2 * R && x >= 0 && x < fw) "
            "load_chunk<kG>(row + x, v);") in src
    for b in (4, 8, 16, 32):
        for r in motion._FAR_RADII:
            win = _Win(b, r)
            assert win.extra in (3, 4) and 4 * win.words >= b + 2 * r
            assert win.slots == 1 + (2 * r + b - 1) // b <= {4: 5, 8: 3, 16: 2, 32: 2}[b]
            # 32 columns: 3 chunks of 16 bytes and one more for the extra
            # words (kXChunks), 16 words at most from the grain on
            if b == 32:
                assert win.fetch == 12 + win.extra <= 16 and -(-4 * win.extra // 16) == 1


@pytest.mark.parametrize("config,blocks", [
    ((8, 4, 8), (2, 4, 8)), ((16, 3, 8), (8, 16)), ((16, 2, 8), (16,)),
    ((16, 5, 16), (2, 4, 8, 16)),
    # 16x8 and 8x16 MV blocks (width x height) at 4, 3 and 2 levels
    (((16, 8), 4, 8), ("4x2", "8x4", "16x8")), (((16, 8), 3, 8), ("8x4", "16x8")),
    (((16, 8), 2, 8), ("16x8",)), (((8, 16), 4, 16), ("2x4", "4x8", "8x16")),
    (((8, 16), 3, 8), ("4x8", "8x16")), (((8, 16), 2, 8), ("8x16",)),
    # 32x32 MV blocks at 4, 3, 2 and 5 levels (range 16), 32x16 and 16x32
    # at 4 and 2
    ((32, 4, 8), (8, 16, 32)), ((32, 3, 8), (16, 32)), ((32, 2, 8), (32,)),
    ((32, 5, 16), (4, 8, 16, 32)),
    (((32, 16), 4, 8), ("8x4", "16x8", "32x16")), (((32, 16), 2, 8), ("32x16",)),
    (((16, 32), 4, 8), ("4x8", "8x16", "16x32")), (((16, 32), 2, 8), ("16x32",)),
    # 32x8 and 8x32 MV blocks at 4, 3 and 2 levels, 16x4 at 3
    (((32, 8), 4, 8), ("8x2", "16x4", "32x8")), (((32, 8), 3, 8), ("16x4", "32x8")),
    (((32, 8), 2, 8), ("32x8",)), (((8, 32), 4, 8), ("2x8", "4x16", "8x32")),
    (((8, 32), 3, 8), ("4x16", "8x32")), (((8, 32), 2, 8), ("8x32",)),
    (((16, 4), 3, 8), ("8x2", "16x4")),
    # 16x16 MV blocks at 2 levels, ranges 10 and 16 (R = 5, 8), and at one
    # level (no refinement level); at 3 levels, ranges 20 and 32, and 4,
    # ranges 48 and 64 (R = 5, 8 and 6, 8)
    ((16, 2, 10), (16,)), ((16, 2, 16), (16,)), ((16, 1, 8), ()),
    ((16, 3, 20), (8, 16)), ((16, 3, 32), (8, 16)), ((16, 4, 48), (4, 8, 16)),
    ((16, 4, 64), (4, 8, 16)),
    # square MV blocks past top radius 4 at their other level counts: 8x8
    # at 4 levels, ranges 40 and 64 (G20), 16x16 at 5, ranges 80 and 128
    # (G21), 32x32 at 2-5 levels, ranges 10 and 128 (G22 at 4, range 64),
    # 4x4 at 3, range 32 (K9 1x1 and K7 2x2 at R = 5, 8)
    ((8, 4, 40), (2, 4, 8)), ((8, 4, 64), (2, 4, 8)),
    ((16, 5, 80), (2, 4, 8, 16)), ((16, 5, 128), (2, 4, 8, 16)),
    ((32, 2, 10), (32,)), ((32, 3, 32), (16, 32)), ((32, 4, 64), (8, 16, 32)),
    ((32, 5, 128), (4, 8, 16, 32)), ((4, 3, 32), (2, 4))])
def test_hbma_motion_configs_take_the_specialised_k7(meta_launches, config, blocks):
    # the per-frame search at 8x8 MV blocks and 4 levels, 3, 2 and 5
    # levels, at 16x8 and 8x16 MV blocks and 4, 3, 2 levels, and at 32x32,
    # 32x16 and 16x32 MV blocks, and at 32x8 and 8x32, on the 1080p frame
    # they pad to (1080 rows at 16x8 and 32x8: an odd count of block rows at
    # every level; 1088 at a 32-pixel height): the top level on K9, then
    # each level on its K7 instance
    block, levels, search_range = config
    bw, bh = (block, block) if isinstance(block, int) else block
    r = search_range >> (levels - 1)
    fh = 1088 if bw == bh else padded_dims(1920, 1080, bw, bh, levels)[1]
    pyr = [_meta_u8(2, fh >> lvl, 1920 >> lvl) for lvl in range(levels)]
    mv, mm = motion.hbma([p[0] for p in pyr], [p[1] for p in pyr], search_range,
                         bw, bh)
    assert tuple(mv.shape) == (fh // bh, 1920 // bw, 2)
    assert [name for name, _ in meta_launches] == (
        ["candidate_sads"] + ["refine_mads"] * (levels - 1))
    top = meta_launches[0][1]
    assert motion.CANDIDATE_SADS.instance(top) == motion._instance(
        bw >> (levels - 1), bh >> (levels - 1), r)
    assert [motion.REFINE_MADS.instance(args) for _, args in meta_launches[1:]] == [
        f"<{b}, {r}>" for b in blocks]


def test_k7_entry_launches_k3s_kernel():
    # one kernel body for K3 and K7: refine_mads.cu launches K3's kernel
    # through its shared launcher; the window-per-warp kernel is the general
    # entry's only
    src = (build.CSRC_DIR / "refine_mads.cu").read_text()
    assert '#include "refine_sads.cuh"' in src
    assert "launch_refine_sads(" in src
    assert '#include "window_sads.cuh"' not in src
    general = (build.CSRC_DIR / "refine_mads_general.cu").read_text()
    assert '#include "window_sads.cuh"' in general


# ---------------------------------------------------------------------------
# K3 (and K7): the lane-per-anchor-row kernel, replayed on the CPU
# ---------------------------------------------------------------------------

# csrc/refine_rows.cuh and csrc/refine_sads.cu
_M32 = 0xFFFFFFFF


def _le_words(b):
    """Little-endian 32-bit words of uint8 bytes ``(..., 4n)`` as int64
    ``(..., n)``."""
    b = np.asarray(b, np.int64).reshape(b.shape[:-1] + (-1, 4))
    return (b << (8 * np.arange(4))).sum(-1)


def _fshr(lo, hi, bits):
    """``__funnelshift_r(lo, hi, bits)`` (bits < 32)."""
    return ((hi << 32 | lo) >> bits) & _M32


def _vsadu4(a, b):
    return sum(np.abs(((a >> (8 * k)) & 0xFF) - ((b >> (8 * k)) & 0xFF)) for k in range(4))


class _Win:
    """``Window<BW, R, BH>``'s word counts (``bh`` defaults to ``bw``)."""

    def __init__(self, bw, r, bh=None):
        bh = bw if bh is None else bh
        self.grain = min(bw, 16)  # bytes of an aligned chunk
        self.chunks = bw // self.grain + 1
        self.extra = (2 * r + 3) // 4
        self.words = bw // 4 + self.extra
        self.fetch = self.chunks * self.grain // 4 + self.extra
        self.slots = 1 + (2 * r + bh - 1) // bh
        self.cand = (2 * r + 1) ** 2
        self.packed = (self.cand + 1) // 2


def _k3_window_row(plane, y, x0, enabled, b, r):
    """``load_window_row<B, R>`` for arrays of rows ``y``, first window
    columns ``x0`` and lane predicates: the aligned chunks (of ``kGrain``
    bytes: B, 16 at B = 32) and extra words with their predicates, then
    ``align_window_row``'s word selects and funnel shift. ``(..., kWords)``
    int64 words."""
    fh, fw = plane.shape
    win = _Win(b, r)
    g = win.grain
    kw = g // 4
    row_in = enabled & (y >= 0) & (y < fh)
    yy = np.where(row_in, y, 0)
    xb = x0 & ~(g - 1)
    s = x0 - xb

    def word_at(x, ok):
        assert ((x >= 0) & (x + 4 <= fw) | ~ok).all()  # inside its row
        xs = np.where(ok, x, 0)
        return np.where(ok, _le_words(np.stack([plane[yy, xs + k] for k in range(4)],
                                               -1))[..., 0], 0)

    w = []
    for c in range(win.chunks):
        x = xb + c * g
        ok = row_in & (x >= 0) & (x < fw)
        w += [word_at(x + 4 * k, ok) for k in range(kw)]
    x2 = xb + win.chunks * g
    for e in range(win.extra):
        x = x2 + 4 * e
        if r == 1:
            need, edge = s == g - 1, x2
        elif g == 4:
            need, edge = s > 4 * e + 4 - 2 * r, x
        elif win.extra > 2:  # past R = 4: chunk c of the extra words, whole
            c = 4 * e // g
            need, edge = s > g * (c + 1) - 2 * r, x2 + c * g
        else:  # both extra words in one chunk, one predicate
            need, edge = s > g - 2 * r, x2
        w.append(word_at(x, row_in & need & (edge >= 0) & (edge < fw)))
    w = np.stack(w, -1)
    assert w.shape[-1] == win.fetch
    q = s >> 2
    v = [np.take_along_axis(w, (q + j)[..., None], -1)[..., 0] for j in range(win.words + 1)]
    al = np.stack([_fshr(v[j], v[j + 1], 8 * (s & 3)) for j in range(win.words)], -1)
    # the words hold the window row's bytes from x0 on, 0 outside the frame
    want = np.zeros(al.shape[:-1] + (4 * win.words,), np.int64)
    for k in range(b + 2 * r):
        x = x0 + k
        inside = row_in & (x >= 0) & (x < fw)
        want[..., k] = np.where(inside, plane[yy, np.clip(x, 0, fw - 1)], 0)
    got = (al[..., :, None] >> (8 * np.arange(4))) & 0xFF
    np.testing.assert_array_equal(got.reshape(want.shape)[..., : b + 2 * r],
                                  want[..., : b + 2 * r])
    return al


def _reduced_count(n, h, lo=0):
    return n if h <= lo or n == 1 else _reduced_count((n + 1) // 2, h // 2, lo)


def _reduced_index(n, h, k, i, lo=0):
    """``reduced_index<N, H, Lo>(k, i)`` for an array of lanes ``i`` (``k``
    an int or an array over them, >= 0)."""
    if h <= lo:
        return np.broadcast_to(np.where(np.asarray(k) < n, k, -1), i.shape)
    if n == 1:
        return np.where(i & h, -1, _reduced_index(1, h // 2, k, i, lo))
    m = (n + 1) // 2
    inner = _reduced_index(m, h // 2, k, i, lo)
    idx = inner + np.where(i & h, m, 0)
    return np.where((inner >= 0) & (idx < n), idx, -1)


def _reduce_transposed(v, lanes, h=None, stop=0):
    """``reduce_transposed<N, H, B, Lo>`` (Lo = ``stop``) over the lane axis
    -2 of ``v`` (..., B, N), H = B / 2 unless given: the xor partner's words
    by lane index, 32-bit adds (a 16-bit pair's carry reaches its upper
    half)."""
    n = v.shape[-1]
    h = lanes.size // 2 if h is None else h
    while h > stop:
        partner = lanes ^ h
        upper = (lanes & h).astype(bool)[:, None]
        if n == 1:
            v = (v + v[..., partner, :]) & _M32
        else:
            m = (n + 1) // 2
            lo = v[..., :m]
            hi = np.concatenate([v[..., m:], np.zeros(v.shape[:-1] + (2 * m - n,),
                                                      np.int64)], -1)
            send = np.where(upper, lo, hi)
            v = (np.where(upper, hi, lo) + send[..., partner, :]) & _M32
            n = m
        h //= 2
    return v


def _reduce_store(packed, lanes, pixels, cand, packed_only=False):
    """``reduce_store<N, L, kPixels, kCand>``: each lane's words of 16-bit
    pairs (..., L, N) reduced over the L lanes, packed over the steps at
    lane offsets above Lo = L / (2 * 256 / kPixels), then unpacked into
    32-bit sums for the rest; every candidate's sum stored once, (...,
    cand). ``packed_only`` keeps every step packed (Lo = 0, the reduction
    before 32-column and 32-row blocks), whatever the sums reach."""
    n, size = packed.shape[-1], lanes.size
    lo = 0 if packed_only else size // (2 * (256 // pixels))
    held = _reduce_transposed(packed, lanes, size // 2, lo)
    count = _reduced_count(n, size // 2, lo)
    assert held.shape[-1] == count
    got = np.full(packed.shape[:-2] + (cand,), -1, np.int64)

    def store(c, lane, value):
        if c < cand:
            assert (got[..., c] == -1).all()  # each sum stored once
            got[..., c] = value[..., lane]

    if lo == 0:
        for k in range(count):
            p = _reduced_index(n, size // 2, k, lanes)
            for lane in lanes[p >= 0]:
                store(2 * p[lane], lane, held[..., k] & 0xFFFF)
                store(2 * p[lane] + 1, lane, held[..., k] >> 16)
    else:
        v = np.stack([held & 0xFFFF, held >> 16], -1).reshape(held.shape[:-1] + (2 * count,))
        v = _reduce_transposed(v, lanes, lo, 0)
        for k in range(_reduced_count(2 * count, lo)):
            q = _reduced_index(2 * count, lo, k, lanes)
            p = np.where(q >= 0, _reduced_index(n, size // 2, np.maximum(q, 0) >> 1,
                                                lanes, lo), -1)
            for lane in lanes[p >= 0]:
                store(2 * p[lane] + (q[lane] & 1), lane, v[..., k])
    assert (got >= 0).all()  # every candidate stored
    return got


def _replay_k3(stack, mv, b, r, anchor=None, bh=None, packed_only=False):
    """SADs of a ``(T+1, fh, fw)`` stack (or, with ``anchor``, of ``T``
    pairs ``stack[t]``, ``anchor[t]``: K9's two stacks) as
    ``refine_sads_kernel<BW, BH, R>`` computes them for ``b`` (BW) x ``bh``
    (BH, ``b`` unless given) blocks: per block, lane i's anchor row and its
    window rows (i and, on lanes BH-2 and BH-1, i + 2 at R = 1 on square
    and 4-row blocks; i, i + BH, ... otherwise), rows taken from other
    lanes as the shuffles take them (width BH), the funnel shifts and
    ``__vsadu4`` sums, and but on those R = 1 instances the 16-bit pairs,
    the transposed reduction (``_reduce_store``; ``packed_only``: every
    step on pairs) and each lane's stores."""
    bw, bh = b, b if bh is None else bh
    xor_sums = r == 1 and (bh == 4 or (bw == 8 and bh == 8))  # kXorSums<BW, BH, R>
    tp1, fh, fw = stack.shape
    frames = tp1 - 1 if anchor is None else tp1
    mfh, mfw = fh // bh, fw // bw
    win = _Win(bw, r, bh)
    side = 2 * r + 1
    lanes = np.arange(bh)
    out = np.full((frames, win.cand, mfh, mfw), -1, np.int64)
    for t in range(frames):
        trk, anc = (stack[t], stack[t + 1]) if anchor is None else (stack[t], anchor[t])
        for by in range(mfh):
            bx = np.arange(mfw)[:, None]
            mvx = mv[t, by, :, 0].astype(np.int64)[:, None]
            mvy = mv[t, by, :, 1].astype(np.int64)[:, None]
            x0 = np.broadcast_to(bx * bw + mvx - r, (mfw, bh))
            y0 = by * bh + mvy - r + lanes[None, :]
            # lane i's anchor row of each block: (mfw, bh lanes, bw / 4) words
            a = _le_words(anc[by * bh : by * bh + bh].reshape(bh, mfw, bw).transpose(1, 0, 2))
            on = np.ones((mfw, bh), bool)
            if xor_sums:
                r0 = _k3_window_row(trk, y0, x0, on, bw, r)
                ext = _k3_window_row(trk, y0 + 2, x0, on & (lanes >= bh - 2), bw, r)
                # shuffles within the BH-lane group; a source past it gives
                # the lane its own value
                down1 = r0[:, np.minimum(lanes + 1, bh - 1)]
                down2 = np.where((lanes + 2 < bh)[:, None],
                                 r0[:, np.minimum(lanes + 2, bh - 1)], r0)
                up1 = np.where((lanes >= 1)[:, None], ext[:, np.maximum(lanes - 1, 0)], ext)
                rows = [r0, np.where((lanes == bh - 1)[:, None], up1, down1),
                        np.where((lanes >= bh - 2)[:, None], ext, down2)]
            else:
                slots = [_k3_window_row(trk, y0 + k * bh, x0,
                                        on & ((k == 0) | (lanes + k * bh < bh + 2 * r)), bw, r)
                         for k in range(win.slots)]
                rows = []
                for oy in range(side):
                    q, rho = divmod(oy, bh)
                    if rho == 0:
                        rows.append(slots[q])
                    else:  # a lane sends the slot its taker (lane - rho) wants
                        send = np.where((lanes < rho)[:, None], slots[q + 1], slots[q])
                        rows.append(send[:, (lanes + rho) % bh])
            sums = np.zeros((mfw, bh, side, side), np.int64)
            for oy in range(side):
                row = rows[oy]
                for ox in range(side):
                    wo, d = divmod(ox, 4)
                    for j in range(bw // 4):
                        c = row[..., j + wo] if d == 0 else _fshr(
                            row[..., j + wo], row[..., j + wo + 1], 8 * d)
                        sums[:, :, oy, ox] += _vsadu4(c, a[..., j])
            sums = sums.reshape(mfw, bh, win.cand)
            if xor_sums:  # log2(BH) xor steps: every lane holds the block's sums
                out[t, :, by] = sums.sum(1).T
                continue
            assert sums.max() < 1 << 16
            flat = np.concatenate([sums, np.zeros((mfw, bh, 1), np.int64)], -1)
            packed = flat[..., 0::2][..., : win.packed] | (flat[..., 1::2][..., : win.packed] << 16)
            out[t, :, by] = _reduce_store(packed, lanes, bw, win.cand, packed_only).T
    return out


_SPLIT_ROWS = 4  # anchor rows a lane of refine_sads_split_kernel


def _split(bw, bh, r):
    """``kSplit<BW, BH, R>``: the instances that run the split kernel where
    its grid fits the card."""
    return ((bw == 16 and bh >= 8 and r >= 2) or (bw < bh and bh >= 8)
            or (bw == 32 and bh >= 16 and (r == 2 or (r == 1 and bh < bw))))


def _split_fits(ctas, sms, per_sm, idle, slots):
    """``split_fits``: whether the split kernel takes a grid of ``ctas``
    CTAs on ``sms`` SMs that hold ``per_sm`` of them at once, its CTAs
    spanning ``slots`` block columns a block row, ``idle`` of them past the
    row's end."""
    wave = per_sm * sms
    return 4 * idle <= slots and ctas >= 2 * sms and not wave < ctas < wave + sms


def _replay_k3_split(stack, mv, r, bh=16, bw=16, anchor=None, packed_only=False):
    """SADs of a ``(T+1, fh, fw)`` stack (or, with ``anchor``, of ``T``
    pairs: K9's two stacks) as ``refine_sads_split_kernel<BW, BH, R>``
    computes them: BH / 4 lanes a block, lane l with anchor rows 4l .. 4l
    + 3 loading its window rows 4l .. 4l + 3 + 2R itself, each row's
    shifted words against each anchor row it meets, sums added into 16-bit
    halves as they come, transposed xor steps over the BH / 4 lanes
    (``_reduce_store``: as 32-bit sums past 256 pixels a sum) and each
    lane's stores."""
    b, rows = bw, _SPLIT_ROWS
    tp1, fh, fw = stack.shape
    frames = tp1 - 1 if anchor is None else tp1
    mfh, mfw = fh // bh, fw // b
    win = _Win(b, r)
    side = 2 * r + 1
    lanes = np.arange(bh // rows)
    out = np.full((frames, win.cand, mfh, mfw), -1, np.int64)
    for t in range(frames):
        trk, anc = (stack[t], stack[t + 1]) if anchor is None else (stack[t], anchor[t])
        for by in range(mfh):
            bx = np.arange(mfw)[:, None]
            mvx = mv[t, by, :, 0].astype(np.int64)[:, None]
            mvy = mv[t, by, :, 1].astype(np.int64)[:, None]
            x0 = np.broadcast_to(bx * b + mvx - r, (mfw, lanes.size))
            y0 = by * bh + mvy - r + rows * lanes[None, :]
            blocks = anc[by * bh : by * bh + bh].reshape(bh, mfw, b).transpose(1, 0, 2)
            a = [_le_words(blocks[:, rows * lanes + m]) for m in range(rows)]  # (mfw, lanes, b / 4)
            packed = np.zeros((mfw, lanes.size, win.packed), np.int64)
            on = np.ones((mfw, lanes.size), bool)
            for k in range(rows + 2 * r):
                row = _k3_window_row(trk, y0 + k, x0, on, b, r)
                for m in range(rows):
                    oy = k - m
                    if not 0 <= oy <= 2 * r:
                        continue
                    for ox in range(side):
                        wo, d = divmod(ox, 4)
                        cand = oy * side + ox
                        total = packed[..., cand // 2] if cand % 2 == 0 else 0
                        for j in range(b // 4):
                            c = row[..., j + wo] if d == 0 else _fshr(
                                row[..., j + wo], row[..., j + wo + 1], 8 * d)
                            total = total + _vsadu4(c, a[m][..., j])
                        if cand % 2 == 0:
                            packed[..., cand // 2] = total & _M32
                        else:
                            packed[..., cand // 2] = (packed[..., cand // 2] + (total << 16)) & _M32
            # a lane's sums (at most 4 * BW * 255) never carry into the high half
            assert ((packed & 0xFFFF) <= rows * b * 255).all()
            out[t, :, by] = _reduce_store(packed, lanes, rows * b, win.cand, packed_only).T
    return out


def _k3_mvs(rng, kind, shape, b, r):
    if kind == "path":  # doubled propagated MVs, the refine's own inputs
        return 2 * rng.integers(-2 * r, 2 * r + 1, shape)
    if kind == "edge":  # odd MVs past every frame edge
        return 2 * rng.integers(-b, b + 1, shape) + 1
    # windows far outside the frame, and partly inside at both edges
    return rng.choice(np.array([-300, -b - r, -b, -1, 1, b, b + r, 300]), shape)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["path", "edge", "far"])
def test_k3_replay_equals_plain(b, r, kind):
    rng = np.random.default_rng(100 * b + 10 * r + len(kind))
    t, mfh, mfw = 2, 3, 5
    stack = rng.integers(0, 256, (t + 1, mfh * b, mfw * b)).astype(np.uint8)
    mv = _k3_mvs(rng, kind, (t, mfh, mfw, 2), b, r).astype(np.int32)
    # B = 16 at R >= 2 and B = 32 at R = 2 run the split kernel where its
    # grid fits the card (K3's stack) and the one-row-a-lane kernel
    # elsewhere (K7's pair): both replayed
    got = _replay_k3(stack, mv, b, r)
    ref = motion.refine_sads_plain(torch.from_numpy(stack), torch.from_numpy(mv),
                                   r, b, b)
    np.testing.assert_array_equal(got, ref.numpy())
    if _split(b, b, r):
        np.testing.assert_array_equal(_replay_k3_split(stack, mv, r, b, b), ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [4, 8, 16])
@pytest.mark.parametrize("kind", ["zero", "edge", "far"])
def test_k9_on_k3s_kernel_replay_equals_plain(b, r, kind):
    # K9 at 4x4, 8x8 and 16x16 blocks: K3's one-row-a-lane kernel (16x16 at
    # r >= 2 also the split one) on two stacks a plane apart (tracked t
    # against anchor t), its sums stored as float32 through the mantissa
    # (sad_as, csrc/common.cuh)
    rng = np.random.default_rng(1000 + 100 * b + 10 * r + len(kind))
    t, mfh, mfw = 2, 3, 5
    tracked = rng.integers(0, 256, (t, mfh * b, mfw * b)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, mfh * b, mfw * b)).astype(np.uint8)
    if kind == "zero":  # the EBMA's own MVs
        mv = np.zeros((t, mfh, mfw, 2), np.int32)
    else:
        mv = _k3_mvs(rng, kind, (t, mfh, mfw, 2), b, r).astype(np.int32)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked), torch.from_numpy(anchor),
                                      torch.from_numpy(mv), r, b, b)
    assert ref.dtype == torch.float32
    replays = [_replay_k3(tracked, mv, b, r, anchor=anchor)]
    if _split(b, b, r):
        replays.append(_replay_k3_split(tracked, mv, r, b, b, anchor=anchor))
    for sads in replays:
        assert ((sads >= 0) & (sads < 1 << 23)).all()
        got = (np.uint32(0x4B000000) | sads.astype(np.uint32)).view(np.float32) - np.float32(
            8388608.0)
        np.testing.assert_array_equal(got, ref.numpy())


# the rectangles with both sides 4 or more (width x height): K3's / K7's at
# the refinement levels of 16x8, 8x16, 32x16, 16x32, 32x8 and 8x32 MV
# blocks, K9's 8x4, 4x8, 16x8, 8x16, 16x4 and 4x16 at their top levels; 3
# block rows, as 1080-row frames give odd counts
_K3_RECTS = [(8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32), (32, 8), (16, 4),
             (8, 32), (4, 16)]


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", _K3_RECTS, ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("kind", ["path", "edge", "far"])
def test_k3_rect_replay_equals_plain(block, r, kind):
    bw, bh = block
    rng = np.random.default_rng(100 * bw + 10 * bh + r + len(kind))
    t, mfh, mfw = 2, 3, 5
    stack = rng.integers(0, 256, (t + 1, mfh * bh, mfw * bw)).astype(np.uint8)
    mv = _k3_mvs(rng, kind, (t, mfh, mfw, 2), max(bw, bh), r).astype(np.int32)
    got = _replay_k3(stack, mv, bw, r, bh=bh)
    ref = motion.refine_sads_plain(torch.from_numpy(stack), torch.from_numpy(mv), r,
                                   bw, bh)
    np.testing.assert_array_equal(got, ref.numpy())
    # 16x8 at R >= 2, 32x16 and 32x8 at R <= 2, 16x32, 8x16, 4x8, 8x32 and
    # 4x16 run the split kernel (BH / 4 lanes of 4 anchor rows) where its
    # grid fits the card
    if _split(bw, bh, r):
        np.testing.assert_array_equal(_replay_k3_split(stack, mv, r, bh, bw), ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [(8, 4), (4, 8), (16, 8), (8, 16), (16, 4), (4, 16)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("kind", ["zero", "edge", "far"])
def test_k9_rect_on_k3s_kernel_replay_equals_plain(block, r, kind):
    # K9 at 8x4, 4x8, 16x8, 8x16, 16x4 and 4x16 blocks: K3's one-row-a-lane
    # kernel on two stacks, its sums stored as float32 through the mantissa
    bw, bh = block
    rng = np.random.default_rng(2000 + 100 * bw + 10 * bh + r + len(kind))
    t, mfh, mfw = 2, 3, 5
    tracked = rng.integers(0, 256, (t, mfh * bh, mfw * bw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, mfh * bh, mfw * bw)).astype(np.uint8)
    if kind == "zero":
        mv = np.zeros((t, mfh, mfw, 2), np.int32)
    else:
        mv = _k3_mvs(rng, kind, (t, mfh, mfw, 2), max(bw, bh), r).astype(np.int32)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked), torch.from_numpy(anchor),
                                      torch.from_numpy(mv), r, bw, bh)
    # 4x8, 8x16, 4x16 and 16x8 at r >= 2 run the split kernel where its
    # grid fits the card
    replays = [_replay_k3(tracked, mv, bw, r, anchor=anchor, bh=bh)]
    if _split(bw, bh, r):
        replays.append(_replay_k3_split(tracked, mv, r, bh, bw, anchor=anchor))
    for sads in replays:
        assert ((sads >= 0) & (sads < 1 << 23)).all()
        got = (np.uint32(0x4B000000) | sads.astype(np.uint32)).view(np.float32) - np.float32(
            8388608.0)
        np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", _WIDE + [(16, 16), (32, 8), (8, 32)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_k3_saturated_blocks_need_32bit_sums(block, r):
    # anchor 255 over a checkerboard of whole blocks, tracked 0 everywhere:
    # every candidate of those blocks sums 255 BW BH (261,120 at 32x32,
    # 130,560 at 32x16 and 16x32). Both kernels (the split one where kSplit
    # holds) give it exactly; all-packed steps, the reduction before blocks
    # with a 32-pixel side, carry into the next candidate's half past 256
    # pixels, and hold at 256 pixels (65,280 at 16x16, 32x8 and 8x32: the
    # 16-bit pairs' last case)
    bw, bh = block
    rng = np.random.default_rng(3000 + bw + bh + r)
    t, mfh, mfw = 2, 3, 4
    stack = np.zeros((t + 1, mfh * bh, mfw * bw), np.uint8)
    anchor = rng.integers(0, 256, stack.shape[1:]).astype(np.uint8)
    full = (np.add.outer(np.arange(mfh), np.arange(mfw)) % 2 == 0)
    anchor[np.kron(full, np.ones((bh, bw), bool))] = 255
    stack[1:] = anchor
    mv = _k3_mvs(rng, "path", (t, mfh, mfw, 2), max(bw, bh), r).astype(np.int32)
    ref = motion.refine_sads_plain(torch.from_numpy(stack), torch.from_numpy(mv), r,
                                   bw, bh).numpy()
    assert (ref[0][:, full] == 255 * bw * bh).all()
    replays = [_replay_k3(stack, mv, bw, r, bh=bh)]
    if _split(bw, bh, r):
        replays.append(_replay_k3_split(stack, mv, r, bh, bw))
    for got in replays:
        np.testing.assert_array_equal(got, ref)
    old = [_replay_k3(stack, mv, bw, r, bh=bh, packed_only=True)]
    if _split(bw, bh, r):
        old.append(_replay_k3_split(stack, mv, r, bh, bw, packed_only=True))
    for got in old:
        if bw * bh > 256:
            assert (got[0][:, full] != ref[0][:, full]).any()
        else:
            np.testing.assert_array_equal(got, ref)


def _pairs(sums):
    """A row's 2R + 1 sums (..., 2R + 1) as R + 1 words of 16-bit pairs."""
    assert sums.max() < 1 << 16
    flat = np.concatenate([sums, np.zeros(sums.shape[:-1] + (1,), np.int64)], -1)
    return flat[..., 0::2] | (flat[..., 1::2] << 16)


def _replay_k3_by_row(stack, mv, b, r, anchor=None, packed_only=False):
    """SADs as ``refine_sads_kernel<B, B, R>`` computes them past
    kNearRadius (``block_sads_by_row``): lane i's window rows i, i + B,
    ..., and per candidate row oy the row i + oy from lane (i + oy) mod B
    (the slot that lane sends by selects), the 2R + 1 sums two to a word,
    reduced over the block's B lanes at once (``reduce_row``: on pairs
    while a sum covers 256 pixels at most, then as 32-bit sums, as
    ``_reduce_store``; ``packed_only``: every step on pairs) into
    ``s_out[oy (2R + 1) + ox]``. ``anchor``: K9's second stack."""
    tp1, fh, fw = stack.shape
    frames = tp1 - 1 if anchor is None else tp1
    mfh, mfw = fh // b, fw // b
    win = _Win(b, r)
    side = 2 * r + 1
    lanes = np.arange(b)
    out = np.full((frames, side, side, mfh, mfw), -1, np.int64)
    for t in range(frames):
        trk, anc = (stack[t], stack[t + 1]) if anchor is None else (stack[t], anchor[t])
        for by in range(mfh):
            bx = np.arange(mfw)[:, None]
            x0 = np.broadcast_to(bx * b + mv[t, by, :, 0].astype(np.int64)[:, None] - r,
                                 (mfw, b))
            y0 = by * b + mv[t, by, :, 1].astype(np.int64)[:, None] - r + lanes[None, :]
            a = _le_words(anc[by * b : by * b + b].reshape(b, mfw, b).transpose(1, 0, 2))
            on = np.ones((mfw, b), bool)
            slots = [_k3_window_row(trk, y0 + k * b, x0,
                                    on & ((k == 0) | (lanes + k * b < b + 2 * r)), b, r)
                     for k in range(win.slots)]
            for oy in range(side):
                q, rho = divmod(oy, b)
                send_slot = np.where(lanes < rho, q + 1, q)
                assert send_slot.max() < win.slots
                send = np.stack([slots[s][:, lane] for lane, s in enumerate(send_slot)], 1)
                row = send[:, (lanes + rho) % b]
                sums = np.zeros((mfw, b, side), np.int64)
                for ox in range(side):
                    wo, d = divmod(ox, 4)
                    for j in range(b // 4):
                        c = row[..., j + wo] if d == 0 else _fshr(
                            row[..., j + wo], row[..., j + wo + 1], 8 * d)
                        sums[..., ox] += _vsadu4(c, a[..., j])
                out[t, oy, :, by] = _reduce_store(_pairs(sums), lanes, b, side, packed_only).T
    return out.reshape(frames, side * side, mfh, mfw)


def _replay_k3_split_rows(stack, mv, b, r, anchor=None):
    """SADs as ``refine_sads_split_rows_kernel<B, B, R>`` computes them: B /
    4 lanes a block, lane l with anchor rows 4l .. 4l + 3 loading window
    rows 4l .. 4l + 3 + 2R itself; each row's shifted words against each
    anchor row m it meets, added into slot (k - m) % 4 of candidate row k -
    m (16-bit halves); after window row k, candidate row k - 3 reduced over
    the B / 4 lanes (``reduce_row``, all on pairs: 4 rows of B pixels a
    lane), stored, its slot cleared."""
    rows = _SPLIT_ROWS
    tp1, fh, fw = stack.shape
    frames = tp1 - 1 if anchor is None else tp1
    mfh, mfw = fh // b, fw // b
    side = 2 * r + 1
    lanes = np.arange(b // rows)
    out = np.full((frames, side, side, mfh, mfw), -1, np.int64)
    for t in range(frames):
        trk, anc = (stack[t], stack[t + 1]) if anchor is None else (stack[t], anchor[t])
        for by in range(mfh):
            bx = np.arange(mfw)[:, None]
            x0 = np.broadcast_to(bx * b + mv[t, by, :, 0].astype(np.int64)[:, None] - r,
                                 (mfw, lanes.size))
            y0 = by * b + mv[t, by, :, 1].astype(np.int64)[:, None] - r + rows * lanes[None, :]
            blocks = anc[by * b : by * b + b].reshape(b, mfw, b).transpose(1, 0, 2)
            a = [_le_words(blocks[:, rows * lanes + m]) for m in range(rows)]
            acc = np.zeros((rows, mfw, lanes.size, r + 1), np.int64)
            on = np.ones((mfw, lanes.size), bool)
            for k in range(rows + 2 * r):
                row = _k3_window_row(trk, y0 + k, x0, on, b, r)
                for ox in range(side):
                    wo, d = divmod(ox, 4)
                    c = [row[..., j + wo] if d == 0 else _fshr(row[..., j + wo],
                                                             row[..., j + wo + 1], 8 * d)
                         for j in range(b // 4)]
                    for m in range(rows):
                        if not 0 <= k - m <= 2 * r:
                            continue
                        total = sum(_vsadu4(c[j], a[m][..., j]) for j in range(b // 4))
                        slot = acc[(k - m) % rows]
                        slot[..., ox // 2] = (slot[..., ox // 2]
                                              + (total if ox % 2 == 0 else total << 16)) & _M32
                if k >= rows - 1:
                    done = acc[(k + 1) % rows]
                    # a lane's halves never carry: 4 rows of B pixels at most
                    assert ((done & 0xFFFF) <= rows * b * 255).all()
                    out[t, k - (rows - 1), :, by] = _reduce_store(done, lanes, rows * b, side).T
                    done[...] = 0
    return out.reshape(frames, side * side, mfh, mfw)


# the blocks past kNearRadius: K3's / K7's 32x32, 16x16, 8x8, 4x4 and 2x2,
# K9's 16x16, 8x8, 4x4, 2x2 and 1x1
_FAR = [(16, "refine"), (16, "candidate"), (8, "candidate"), (8, "refine"), (4, "refine"),
        (4, "candidate"), (2, "candidate"), (32, "refine"), (2, "refine"), (1, "candidate")]


@pytest.mark.parametrize("r", [5, 6, 7, 8])
@pytest.mark.parametrize("b,entry", _FAR, ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ["zero", "path", "edge", "far", "saturated"])
def test_far_radius_replays_equal_plain(b, entry, r, kind):
    # R = 5-8 at 32x32 (K3, K7), 16x16, 8x8, 4x4 (K3, K7, K9), 2x2 (K3, K7,
    # K9) and 1x1 (K9): the one-row kernel's block_sads_by_row, at 8x8
    # (kSplitFar) the split by-row kernel, at 2x2 the thread-a-block
    # kernel's streamed rows, at 1x1 the thread-a-pixel kernel, each
    # replayed, equal the plain version on every candidate; a saturated
    # block (anchor 255, tracked 0: 255 B^2 at every candidate, 65,280 at
    # 16x16, the 16-bit pairs' last case, 261,120 at 32x32, whose row sums
    # reduce on pairs only to 8 lanes) too
    rng = np.random.default_rng(4000 + 100 * b + 10 * r + len(kind) + len(entry))
    # 1x1: planes of whole words (the thread-a-pixel kernel's gate)
    t, mfh, mfw = (2, 4, 6) if b == 1 else (2, 3, 5)
    tracked = rng.integers(0, 256, (t + 1, mfh * b, mfw * b)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, mfh * b, mfw * b)).astype(np.uint8)
    if kind == "saturated":
        # K3's stack: frame 1 lit against dark frames 0 and 2; K9's anchors lit
        tracked[:] = 0
        tracked[1::2] = 255
        anchor[:] = 255
    if kind == "zero" or (kind == "saturated" and entry == "candidate"):  # the EBMA's
        mv = np.zeros((t, mfh, mfw, 2), np.int64)
    else:
        mv = _k3_mvs(rng, "path" if kind == "saturated" else kind, (t, mfh, mfw, 2), b, r)
    mv = mv.astype(np.int32)
    if entry == "refine":
        ref = motion.refine_sads_plain(torch.from_numpy(tracked), torch.from_numpy(mv), r,
                                       b, b).numpy()
        if b == 2:  # the thread-a-block kernel's int32 output, rows streamed
            replays = [_replay_k9_block(tracked[:-1], tracked[1:], mv, b, b, r, streamed=True)]
        else:
            replays = [_replay_k3_by_row(tracked, mv, b, r)]
        if b == 8:  # kSplitFar
            replays.append(_replay_k3_split_rows(tracked, mv, b, r))
        if b == 32 and kind == "saturated":
            # on pairs over all 32 lanes the saturated sums would carry
            old = _replay_k3_by_row(tracked, mv, b, r, packed_only=True)
            assert (old != ref).any()
        pair = motion.refine_mads_plain(torch.from_numpy(tracked[0]),
                                        torch.from_numpy(tracked[1]),
                                        torch.from_numpy(mv[0]), r, b, b).numpy()
        np.testing.assert_array_equal(replays[0][0], pair)  # K7: the one-row kernel
    else:
        tr = tracked[:t]
        ref = motion.candidate_sads_plain(torch.from_numpy(tr), torch.from_numpy(anchor),
                                          torch.from_numpy(mv), r, b, b).numpy()
        replays = []
        if b == 1:  # the thread-a-pixel kernel: float32 through the mantissa
            replays.append(_replay_k9_1x1(tr, anchor, mv, r))
            sads = []
        elif b == 2:  # the thread-a-block kernel, its window rows streamed
            sads = [_replay_k9_block(tr, anchor, mv, b, b, r, streamed=True)]
        else:
            sads = [_replay_k3_by_row(tr, mv, b, r, anchor=anchor)]
        if b == 8:  # kSplitFar
            sads.append(_replay_k3_split_rows(tr, mv, b, r, anchor=anchor))
        for sads in sads:
            assert ((sads >= 0) & (sads < 1 << 23)).all()
            replays.append((np.uint32(0x4B000000) | sads.astype(np.uint32)).view(np.float32)
                           - np.float32(8388608.0))
    for got in replays:
        np.testing.assert_array_equal(got, ref)
    if kind == "saturated":
        assert ref.max() == 255 * b * b


def _split_grid(bw, bh, fh, fw, t):
    """The split kernel's CTAs for ``t`` frames of ``fh`` x ``fw`` (1024 /
    BH blocks of one block row a CTA), the block columns its CTAs leave
    idle past a block row's end, and the slots its CTAs span a block row."""
    blocks, mfw = 1024 // bh, fw // bw
    across = -(-mfw // blocks)
    return across * (fh // bh) * t, across * blocks - mfw, across * blocks


@pytest.mark.parametrize("bw,bh,fh,t,per_sm,split", [
    # K7's 8x16 pair at r = 1, 2, 3, 4 (CTAs an SM by ptxas, H100): 272
    # CTAs; at r = 4 a second wave of 8
    (8, 16, 1088, 1, 6, True), (8, 16, 1088, 1, 5, True), (8, 16, 1088, 1, 3, True),
    (8, 16, 1088, 1, 2, False),
    # K3's stacks: 8x16 and 16x16 at r = 2 and 4, 16x8 (1080 rows) at r = 2,
    # 4x8 at r = 1 (1,088 CTAs, 792 at once: the second wave gives every SM
    # two)
    (8, 16, 1088, 8, 2, True), (16, 16, 1088, 8, 4, True), (16, 16, 1088, 8, 2, True),
    (16, 8, 1080, 8, 3, True), (4, 8, 544, 8, 6, True),
    # K9's 16x16 at 2 levels of 32x32 MV blocks (8 x 544x960) at r = 2 and
    # 4; its 16x8 at 2 levels of 32x16 (60 block columns in CTAs of 128)
    (16, 16, 544, 8, 4, True), (16, 16, 544, 8, 2, False), (16, 8, 544, 8, 3, False),
    # one pair at 16x16 and 4x8: under two CTAs an SM
    (16, 16, 1088, 1, 4, False), (4, 8, 544, 1, 6, False),
    # 8x32 at 1080p (240 block columns in 8 CTAs of 32: 16 of 256 slots
    # idle), K3's stack at r = 1 and 4 and K7's pair (272 CTAs, a wave of
    # 396 or more); 4x16 at 544x960 (64-block CTAs, 16 of 256 idle)
    (8, 32, 1088, 8, 5, True), (8, 32, 1088, 8, 3, True), (8, 32, 1088, 1, 3, True),
    (4, 16, 544, 8, 2, True),
])
def test_split_rule_keeps_grids_off_a_sliver_of_a_second_wave(bw, bh, fh, t, per_sm,
                                                             split):
    fw = 1920 >> {1088: 0, 1080: 0, 544: 1}[fh]
    ctas, idle, slots = _split_grid(bw, bh, fh, fw, t)
    assert _split_fits(ctas, 132, per_sm, idle, slots) == split


@pytest.mark.parametrize("b", [4, 8, 16])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_k3_transposed_reduction_stores_every_sum_once(b, r):
    # lane i's slots after reduce_transposed cover each packed word once,
    # and the words a lane holds fit the register count the kernel keeps
    win = _Win(b, r)
    lanes = np.arange(b)
    count = _reduced_count(win.packed, b // 2)
    idx = np.stack([_reduced_index(win.packed, b // 2, k, lanes) for k in range(count)])
    held = np.sort(idx[idx >= 0])
    np.testing.assert_array_equal(held, np.arange(win.packed))
    assert count <= win.packed
    # shuffles a lane makes: one per kept pair at each step
    n, h, shuffles = win.packed, b // 2, 0
    while h:
        shuffles += 1 if n == 1 else (n + 1) // 2
        n, h = (n + 1) // 2 if n > 1 else 1, h // 2
    assert shuffles < win.packed * np.log2(b)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,d,general,kernel",
    [(8160, 4, False, "lloyd"), (32400, 4, False, "lloyd"),
     (32400, 7, False, "lloyd"), (1, 4, False, "lloyd"),
     (200000, 4, False, "lloyd_general"), (8160, 4, True, "lloyd_general")],
)
def test_lloyd_dispatch(meta_launches, n, d, general, kernel):
    f, a, k = 8, 3, 10
    x = torch.zeros((f, d, n), device="meta")
    mask = torch.zeros((f, n), dtype=torch.bool, device="meta")
    init = torch.zeros((a, f, k, d), device="meta")
    labels, centers, compact = kmeans.lloyd(x, mask, init, k, 10, 1.0,
                                            general=general)
    assert tuple(labels.shape) == (a, f, n) and labels.dtype == torch.int32
    assert tuple(centers.shape) == (a, f, k, d)
    assert tuple(compact.shape) == (a, f)
    ((name, args),) = meta_launches
    assert name == kernel
    kern = kmeans.LLOYD if kernel == "lloyd" else kmeans.LLOYD_GENERAL
    assert len(args) == len(kern.argtypes)
    ints = 6 if kernel == "lloyd" else 7  # pointers before the sizes
    assert args[ints:ints + 6] == (a, f, n, d, k, 10)
    assert args[ints + 6] == kmeans._eps2(1.0)


def test_lloyd_cluster_smem_limits():
    # the 1080p and 4K fields fit, 4K at D = 7 too; 8K (129,600 MV blocks)
    # goes to the general kernel; the cut sits where the slice's bytes pass
    # what a CTA may use
    assert kmeans.cluster_smem_bytes(8160, 4) == 1024 * 22  # 22.5 KB
    assert kmeans.cluster_smem_bytes(32400, 4) == 4096 * 22  # 88 KB
    # under 48 KB alone, past it with the kernel's ~19 KB of static smem
    assert kmeans.cluster_smem_bytes(14400, 4) == 42240  # 2560x1440
    assert kmeans.cluster_smem_bytes(8160, 7) == 34816
    assert kmeans._cluster_fits(32400, 7)
    assert not kmeans._cluster_fits(129600, 4)
    assert not kmeans._cluster_fits(200000, 4)
    n = 8
    while kmeans._cluster_fits(n, 7):
        n += 8
    assert kmeans.cluster_smem_bytes(n, 7) + kmeans._K5_STATIC_SMEM > 227 * 1024
    assert kmeans.cluster_smem_bytes(n - 8, 7) + kmeans._K5_STATIC_SMEM <= 227 * 1024


def test_k5_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "lloyd.cu").read_text()
    k = {n: v for n, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(k["kCluster"]) == kmeans._K5_CLUSTER
    assert int(k["kThreads"]) // 16 == kmeans._K5_CHUNKS  # kThreads / kMaxK
    assert eval(k["kMaxSmemBytes"]) == kmeans._K5_MAX_SMEM
    # the launch takes the static part from the loaded kernel, not from a
    # second hand-kept constant, and opts in to its dynamic part every time
    launch = src[src.index("SVC_EXPORT int svc_lloyd("):]
    assert "cudaFuncGetAttributes" in launch and "sharedSizeBytes" in launch
    assert "kSvcDefaultSmemBytes" not in launch


def cluster_slices(n):
    """``(start, stop)`` of the points each CTA of a K5 cluster owns, as
    ``csrc/lloyd.cu`` cuts them: ``p0 = min(n, rank * S)``, ``len =
    min(n, p0 + S) - p0`` with ``S = ceil(n / kCluster)``."""
    s = -(-n // kmeans._K5_CLUSTER)
    out = []
    for rank in range(kmeans._K5_CLUSTER):
        p0 = min(n, rank * s)
        out.append((p0, min(n, p0 + s)))
    return out


@pytest.mark.parametrize("n", [1, 37, 8160, 32400])
def test_cluster_slices_cover_every_point_once(n):
    slices = cluster_slices(n)
    assert len(slices) == kmeans._K5_CLUSTER
    owner = np.zeros(n, np.int64)
    prev = 0
    for start, stop in slices:
        assert start == prev and stop >= start  # contiguous, in rank order
        assert stop - start <= -(-n // kmeans._K5_CLUSTER)
        owner[start:stop] += 1
        prev = stop
    assert prev == n and (owner == 1).all()
    # the padded slice the kernel allocates holds every slice: 32 chunks
    # of whole 4-label words
    per_point = 4 * 4 + 6
    pitch = kmeans.cluster_smem_bytes(n, 4) // per_point
    assert pitch % (4 * kmeans._K5_CHUNKS) == 0
    assert pitch >= max(stop - start for start, stop in slices)


# ---------------------------------------------------------------------------
# The cluster decomposition, replayed on the CPU
# ---------------------------------------------------------------------------


def _replay_lloyd(x, mask, init, k, max_iter, epsilon):
    """Lloyd for each (frame, attempt) the way K5's cluster kernel orders
    it: per-slice float64 partials added in rank order, the repair's
    argmax per slice (first of its maxima) and then across slices (the
    larger value, the lower global index on ties)."""
    f, d, n = x.shape
    a = init.shape[0]
    slices = cluster_slices(n)
    eps2 = np.float32(kmeans._eps2(epsilon))
    labels = torch.empty((a, f, n), dtype=torch.int32)
    centers = torch.empty((a, f, k, d), dtype=torch.float32)
    compact = torch.empty((a, f), dtype=torch.float32)
    for fi in range(f):
        xt, m = x[fi], mask[fi]
        for ai in range(a):
            cen = init[ai, fi].clone()
            for _ in range(max_iter):
                lab, pd = kmeans._assign(xt[None], cen[None, None], m[None])
                lab, pd = lab[0, 0], pd[0, 0]
                pd = torch.where(m, pd, torch.tensor(-1.0))
                sums = torch.zeros((k, d), dtype=torch.float64)
                counts = torch.zeros(k, dtype=torch.int64)
                for start, stop in slices:  # rank order
                    ls, ms = lab[start:stop], m[start:stop]
                    onehot = (ls[None, :] == torch.arange(k)[:, None]) & ms
                    part = onehot.to(torch.float64) @ xt[:, start:stop].T.to(torch.float64)
                    sums = sums + part
                    counts = counts + onehot.sum(dim=1)
                cand = sums.to(torch.float32) / torch.clamp(counts, min=1).to(torch.float32)[:, None]
                for j in torch.nonzero(counts == 0).flatten().tolist():
                    best_v, best_i = -np.inf, None
                    for start, stop in slices:
                        if stop == start:
                            continue
                        i = start + int(torch.argmax(pd[start:stop]))
                        if pd[i].item() > best_v:  # strictly: ties keep the lower rank
                            best_v, best_i = pd[i].item(), i
                    cand[j] = xt[:, best_i]
                    pd[best_i] = -1.0
                shift2 = kmeans._shift2(cand[None], cen[None])[0]
                cen = cand
                if shift2.item() <= eps2:
                    break
            lab, pd = kmeans._assign(xt[None], cen[None, None], m[None])
            labels[ai, fi] = lab[0, 0].to(torch.int32)
            centers[ai, fi] = cen
            total = 0.0
            for start, stop in slices:
                total += pd[0, 0, start:stop].to(torch.float64).sum().item()
            compact[ai, fi] = float(np.float32(total))
    return labels, centers, compact


def _motion_like(seed, f, n, k, attempts=3):
    """Integer motion-like features (MVs in [-8, 8], block coordinates),
    40% of the points valid (frame 0 none), k-means++ seeds."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (f, 4, n)).astype(np.float32)
    x[:, 2:] *= 16
    mask = rng.random((f, n)) < 0.4
    mask[0] = False
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    keys = prng.split(prng.fold_in(prng.key(seed), torch.arange(f)), attempts)
    init = kmeans._plus_plus_init(keys, x, mask, k).transpose(0, 1).contiguous()
    return x, mask, init


@pytest.mark.parametrize("n,k", [(37, 5), (8160, 10)])
def test_cluster_replay_equals_lloyd_plain(n, k):
    x, mask, init = _motion_like(n, 2, n, k)
    got = _replay_lloyd(x, mask, init, k, 10, 1.0)
    ref = kmeans.lloyd_plain(x, mask, init, k, 10, 1.0)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


def test_cluster_replay_repairs_across_slices():
    # fewer distinct valid points than clusters: empty clusters every
    # iteration, their repair points drawn from several slices, with ties
    # in distance between slices
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2, (2, 3, 300)).astype(np.float32) * 5)
    mask = torch.from_numpy(rng.random((2, 300)) < 0.7)
    init = x[:, :, :6].transpose(1, 2)[None].expand(2, -1, -1, -1).contiguous()
    got = _replay_lloyd(x, mask, init, 6, 10, 1.0)
    ref = kmeans.lloyd_plain(x, mask, init, 6, 10, 1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
