"""K4's fused pyramid kernel and K9's specialised kernels: their dispatch,
and CPU replays of what each CUDA kernel does, held bit for bit against the
plain versions.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing
computes. The replays follow the kernels' own index arithmetic:

* ``csrc/pyr_down_levels.cu``: a CTA per tile of the coarsest level, each
  finer level's region (with its halo) recomputed per CTA, positions
  outside a level read at their reflect-101 image clamped into the region,
  the level-0 chunk base and its halo filled from the region itself,
  level-0 positions past the halo and padded columns read from whatever
  the shared row holds (noise here), and each CTA writing its own part of
  every level;
* ``csrc/candidate_sads.cu``: per MV block, each window row as two aligned
  32-bit words joined by a funnel shift, a byte mask at the row's edges,
  and ``__vsadu4`` sums (r = 1); at r = 2 to 4 each of the 2r + 2 window
  rows as 2 or 3 words from up to 4 aligned loads, masked the same way,
  and per candidate one ``__byte_perm`` of two rows and one ``__vsadu4``
  against both anchor rows, made float32 through the mantissa; per pixel
  of a 1x1 block each of the 2r + 1 window rows as 1 to 3 words the same
  way, one ``__vabsdiffu4`` a word against the anchor byte in all four
  bytes and one ``__byte_perm`` a candidate into a float's mantissa (K9 at
  4x4 and 8x8 blocks runs K3's kernel, replayed in
  ``test_torch_motion_kmeans_dispatch.py``).
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import motion, pyramid
from svc_tpu_torch.ops.pad import padded_dims


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the K4 / K9 wrappers' CUDA path to a meta device; record each
    launch as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(
        motion, "_check_sad_args",
        lambda name, planes, mv, lead, fh, fw, bw, bh, r: (fh // bh, fw // bw))
    monkeypatch.setattr(pyramid, "_check_cuda_u8", lambda name, img: None)
    for mod in (motion, pyramid):
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (motion.CANDIDATE_SADS, motion.CANDIDATE_SADS_GENERAL,
              motion.REFINE_SADS, pyramid.PYR_DOWN, pyramid.PYR_DOWN_LEVELS):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _meta_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


# the ratio-2 rectangles (width x height) of 16x8 and 8x16 MV blocks' top
# levels: K9's instances
_RECTS = [(2, 1), (4, 2), (8, 4), (1, 2), (2, 4), (4, 8)]
# the ratio-4 rectangles of 32x8 and 8x32 MV blocks' top levels at 4, 3
# and 2 levels
_RATIO4 = [(4, 1), (8, 2), (16, 4), (1, 4), (2, 8), (4, 16)]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bw,bh,r,general,kernel",
    [(2, 2, 1, False, "candidate_sads"), (4, 4, 1, False, "candidate_sads"),
     (2, 2, 2, False, "candidate_sads"), (2, 2, 3, False, "candidate_sads"),
     (2, 2, 4, False, "candidate_sads"),
     *((s, s, r, False, "candidate_sads") for s in (1, 4, 8) for r in (1, 2, 3, 4)
       if (s, r) != (4, 1)),
     (2, 2, 5, False, "candidate_sads"),
     (1, 1, 5, False, "candidate_sads"),
     # 1x1 at R = 5-8: the top of 8x8 MV blocks at 4 levels (ranges 40-71)
     # and of 16x16 at 5 (ranges 80-143); R = 9 and general=True general
     *((1, 1, r, False, "candidate_sads") for r in (6, 7, 8)),
     (1, 1, 9, False, "candidate_sads_general"), (1, 1, 7, True, "candidate_sads_general"),
     (2, 1, 8, False, "candidate_sads_general"), (1, 4, 6, False, "candidate_sads_general"),
     # R = 5-8 at 16x16 (one level, ranges 5-8), 8x8, 4x4 and 2x2 (the top
     # of 2, 3 and 4 levels, ranges 10-17, 20-35 and 40-71): one candidate
     # row at a time; R = 9, and the other blocks past R = 4, stay general
     *((s, s, r, False, "candidate_sads") for s in (16, 8) for r in (5, 6, 7, 8)),
     *((s, s, r, False, "candidate_sads") for s in (4, 2) for r in (6, 7, 8)),
     (16, 16, 9, False, "candidate_sads_general"), (8, 8, 9, False, "candidate_sads_general"),
     (4, 4, 9, False, "candidate_sads_general"), (2, 2, 9, False, "candidate_sads_general"),
     (4, 4, 5, False, "candidate_sads"), (8, 16, 5, False, "candidate_sads_general"),
     (2, 1, 5, False, "candidate_sads_general"), (8, 2, 8, False, "candidate_sads_general"),
     (16, 16, 8, True, "candidate_sads_general"), (8, 8, 6, True, "candidate_sads_general"),
     (4, 4, 7, True, "candidate_sads_general"), (2, 2, 8, True, "candidate_sads_general"),
     (2, 4, 1, False, "candidate_sads"),
     (2, 2, 1, True, "candidate_sads_general"),
     (8, 8, 2, True, "candidate_sads_general"),
     # the top levels of 16x8 and 8x16 MV blocks (width x height)
     *((bw, bh, r, False, "candidate_sads") for bw, bh in _RECTS for r in (1, 2, 3, 4)
       if (bw, bh, r) != (2, 4, 1)),
     (4, 2, 5, False, "candidate_sads_general"),
     (8, 4, 2, True, "candidate_sads_general"),
     # the top levels of 32x32, 32x16 and 16x32 MV blocks at 2 levels
     *((bw, bh, r, False, "candidate_sads") for bw, bh in [(16, 16), (16, 8), (8, 16)]
       for r in (1, 2, 3, 4)),
     (16, 8, 5, False, "candidate_sads_general"),
     (16, 16, 2, True, "candidate_sads_general"),
     # the top levels of 32x8 and 8x32 MV blocks at 4, 3 and 2 levels (4x16
     # and 1x4 at r = 1 were general before them)
     (4, 16, 1, False, "candidate_sads"), (1, 4, 1, False, "candidate_sads"),
     *((bw, bh, r, False, "candidate_sads") for bw, bh in _RATIO4 for r in (1, 2, 3, 4)
       if (bw, bh, r) not in ((4, 16, 1), (1, 4, 1))),
     (16, 4, 5, False, "candidate_sads_general"),
     (1, 4, 5, False, "candidate_sads_general"),
     (8, 2, 3, True, "candidate_sads_general"),
     (4, 16, 2, True, "candidate_sads_general"),
     # other ratios and shapes stay general
     (6, 3, 1, False, "candidate_sads_general"),
     (32, 32, 1, False, "candidate_sads_general"),
     (32, 16, 1, False, "candidate_sads_general"),
     (16, 2, 1, False, "candidate_sads_general"), (8, 1, 1, False, "candidate_sads_general"),
     (1, 8, 1, False, "candidate_sads_general"), (32, 8, 1, False, "candidate_sads_general")],
)
def test_candidate_sads_dispatch(meta_launches, bw, bh, r, general, kernel):
    t, fh, fw = 3, 4 * bh, 6 * bw
    tr, an = _meta_u8(t, fh, fw), _meta_u8(t, fh, fw)
    mv = torch.zeros((t, 4, 6, 2), dtype=torch.int32, device="meta")
    out = motion.candidate_sads(tr, an, mv, r, bw, bh, general=general)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (t, (2 * r + 1) ** 2, 4, 6)
    ((name, args),) = meta_launches
    assert name == kernel
    k = motion.CANDIDATE_SADS if kernel == "candidate_sads" else motion.CANDIDATE_SADS_GENERAL
    assert len(args) == len(k.argtypes)
    assert args[4:10] == (t, fh, fw, bw, bh, r)
    if kernel == "candidate_sads":
        assert motion.CANDIDATE_SADS.instance(args) == motion._instance(bw, bh, r)


@pytest.mark.parametrize("levels,launches", [(1, []), (2, [1]), (3, [2]), (4, [3]),
                                             (5, [3, 1]), (7, [3, 3])])
def test_build_pyramid_dispatch(meta_launches, levels, launches):
    img = _meta_u8(9, 1088, 1920)
    pyr = pyramid.build_pyramid(img, levels)
    assert [tuple(p.shape) for p in pyr] == [
        (9, -(-1088 // 2 ** l), -(-1920 // 2 ** l)) for l in range(levels)]
    assert [name for name, _ in meta_launches] == ["pyr_down_levels"] * len(launches)
    for (_, args), halvings, src in zip(meta_launches, launches, (0, 3)):
        assert len(args) == len(pyramid.PYR_DOWN_LEVELS.argtypes)
        assert args[4:8] == (9, *pyr[src].shape[1:], halvings)
        assert args[1 + halvings:4] == (0,) * (3 - halvings)  # unused outputs


def test_build_pyramid_general_takes_the_single_level_kernel(meta_launches):
    pyramid.build_pyramid(_meta_u8(9, 1088, 1920), 4, general=True)
    assert [name for name, _ in meta_launches] == ["pyr_down_u8"] * 3


@pytest.mark.parametrize("search_range,r", [(8, 1), (16, 2), (24, 3), (32, 4), (40, 5),
                                            (64, 8), (71, 8)])
def test_hbma_stack_default_levels_take_the_new_kernels(meta_launches,
                                                        search_range, r):
    # the encoder's motion path: the fused pyramid, then the top-level
    # EBMA on the 2x2 K9 and levels 2, 1, 0 on the specialised K3, each at
    # the top radius range // 8
    pyr = pyramid.build_pyramid(_meta_u8(9, 1088, 1920), 4)
    motion.hbma_stack(pyr, search_range, 16, 16)
    assert [name for name, _ in meta_launches] == (
        ["pyr_down_levels", "candidate_sads"] + ["refine_sads"] * 3)
    assert meta_launches[1][1][7:10] == (2, 2, r)
    assert [args[8] for _, args in meta_launches[2:]] == [r] * 3


# --mv-block-w/-h and --pyr-lvl-count at 1080p: (MV block, levels, range),
# then the K9 and K3 instances the search launches, top level first; the
# MV block is (width, height) where it is not square
MOTION_CONFIGS = [
    ((8, 4, 8), ["<1, 1>", "<2, 1>", "<4, 1>", "<8, 1>"]),
    ((16, 3, 8), ["<4, 2>", "<8, 2>", "<16, 2>"]),
    ((16, 2, 8), ["<8, 4>", "<16, 4>"]),
    ((16, 5, 16), ["<1, 1>", "<2, 1>", "<4, 1>", "<8, 1>", "<16, 1>"]),
    (((16, 8), 4, 8), ["<2x1, 1>", "<4x2, 1>", "<8x4, 1>", "<16x8, 1>"]),
    (((16, 8), 3, 8), ["<4x2, 2>", "<8x4, 2>", "<16x8, 2>"]),
    (((16, 8), 2, 8), ["<8x4, 4>", "<16x8, 4>"]),
    (((8, 16), 4, 16), ["<1x2, 2>", "<2x4, 2>", "<4x8, 2>", "<8x16, 2>"]),
    (((8, 16), 3, 8), ["<2x4, 2>", "<4x8, 2>", "<8x16, 2>"]),
    (((8, 16), 2, 8), ["<4x8, 4>", "<8x16, 4>"]),
    # 32x32 MV blocks at 4, 3, 2 and 5 levels (range 16), 32x16 and 16x32 at
    # 4 and 2 (1088 rows)
    ((32, 4, 8), ["<4, 1>", "<8, 1>", "<16, 1>", "<32, 1>"]),
    ((32, 3, 8), ["<8, 2>", "<16, 2>", "<32, 2>"]),
    ((32, 2, 8), ["<16, 4>", "<32, 4>"]),
    ((32, 5, 16), ["<2, 1>", "<4, 1>", "<8, 1>", "<16, 1>", "<32, 1>"]),
    (((32, 16), 4, 8), ["<4x2, 1>", "<8x4, 1>", "<16x8, 1>", "<32x16, 1>"]),
    (((32, 16), 2, 8), ["<16x8, 4>", "<32x16, 4>"]),
    (((16, 32), 4, 8), ["<2x4, 1>", "<4x8, 1>", "<8x16, 1>", "<16x32, 1>"]),
    (((16, 32), 2, 8), ["<8x16, 4>", "<16x32, 4>"]),
    # 32x8 and 8x32 MV blocks at 4, 3 and 2 levels (1080 and 1088 rows),
    # 16x4 at 3 (4x4 transform blocks)
    (((32, 8), 4, 8), ["<4x1, 1>", "<8x2, 1>", "<16x4, 1>", "<32x8, 1>"]),
    (((32, 8), 3, 8), ["<8x2, 2>", "<16x4, 2>", "<32x8, 2>"]),
    (((32, 8), 2, 8), ["<16x4, 4>", "<32x8, 4>"]),
    (((8, 32), 4, 8), ["<1x4, 1>", "<2x8, 1>", "<4x16, 1>", "<8x32, 1>"]),
    (((8, 32), 3, 8), ["<2x8, 2>", "<4x16, 2>", "<8x32, 2>"]),
    (((8, 32), 2, 8), ["<4x16, 4>", "<8x32, 4>"]),
    (((16, 4), 3, 8), ["<4x1, 2>", "<8x2, 2>", "<16x4, 2>"]),
    # one level at ranges 5 and 8 (the whole search on K9 at 16x16), two at
    # ranges 10 and 16 (K9 8x8, K3 16x16 at R = 5 and 8); 8x8 MV blocks at
    # one level, range 8
    ((16, 1, 5), ["<16, 5>"]), ((16, 1, 8), ["<16, 8>"]),
    ((16, 2, 10), ["<8, 5>", "<16, 5>"]), ((16, 2, 16), ["<8, 8>", "<16, 8>"]),
    ((8, 1, 8), ["<8, 8>"]),
    # three levels at ranges 20 and 32 (K9 4x4, K3 8x8, 16x16 at R = 5, 8),
    # four at 40, 56 and 64 (K9 2x2, K3 4x4, 8x8, 16x16 at R = 5, 7, 8)
    ((16, 3, 20), ["<4, 5>", "<8, 5>", "<16, 5>"]),
    ((16, 3, 32), ["<4, 8>", "<8, 8>", "<16, 8>"]),
    ((16, 4, 40), ["<2, 5>", "<4, 5>", "<8, 5>", "<16, 5>"]),
    ((16, 4, 56), ["<2, 7>", "<4, 7>", "<8, 7>", "<16, 7>"]),
    ((16, 4, 64), ["<2, 8>", "<4, 8>", "<8, 8>", "<16, 8>"]),
    # square MV blocks past top radius 4 at their other level counts: 8x8
    # at 4 levels, ranges 40 and 64 (G20: K9 1x1, K3 2x2, 4x4, 8x8 at R =
    # 5, 8), 16x16 at 5, ranges 80 and 128 (G21), 32x32 at 2-5 levels (G22
    # at 4, range 64), 4x4 at 3, range 20
    ((8, 4, 40), ["<1, 5>", "<2, 5>", "<4, 5>", "<8, 5>"]),
    ((8, 4, 64), ["<1, 8>", "<2, 8>", "<4, 8>", "<8, 8>"]),
    ((16, 5, 80), ["<1, 5>", "<2, 5>", "<4, 5>", "<8, 5>", "<16, 5>"]),
    ((16, 5, 128), ["<1, 8>", "<2, 8>", "<4, 8>", "<8, 8>", "<16, 8>"]),
    ((32, 2, 10), ["<16, 5>", "<32, 5>"]), ((32, 3, 28), ["<8, 7>", "<16, 7>", "<32, 7>"]),
    ((32, 4, 64), ["<4, 8>", "<8, 8>", "<16, 8>", "<32, 8>"]),
    ((32, 5, 96), ["<2, 6>", "<4, 6>", "<8, 6>", "<16, 6>", "<32, 6>"]),
    ((4, 3, 20), ["<1, 5>", "<2, 5>", "<4, 5>"]),
]


@pytest.mark.parametrize("config,instances", MOTION_CONFIGS)
def test_hbma_stack_motion_configs_take_their_instances(meta_launches, config,
                                                         instances):
    # 8x8 MV blocks (the top level's 1x1 on K9, 2x2 on K3), 3 levels (4x4
    # on K9), 2 levels (8x8 on K9), 5 levels (1x1 and 2x2 again); 16x8 and
    # 8x16 MV blocks at 4, 3 and 2 levels, and 32x32, 32x16 and 16x32, on
    # the 1080p frame they pad to (1080 rows at 16x8: an odd count of block
    # rows at every level; 135 at every level of 32x8): each level on its
    # own specialised instance, no general kernel
    block, levels, search_range = config
    bw, bh = (block, block) if isinstance(block, int) else block
    fh = 1088 if bw == bh else padded_dims(1920, 1080, bw, bh, levels)[1]
    pyr = pyramid.build_pyramid(_meta_u8(9, fh, 1920), levels)
    meta_launches.clear()
    mv, mm = motion.hbma_stack(pyr, search_range, bw, bh)
    assert tuple(mv.shape) == (8, fh // bh, 1920 // bw, 2)
    assert [name for name, _ in meta_launches] == (
        ["candidate_sads"] + ["refine_sads"] * (levels - 1))
    kernels = [motion.CANDIDATE_SADS] + [motion.REFINE_SADS] * (levels - 1)
    assert [k.instance(args) for k, (_, args) in zip(kernels, meta_launches)] == instances


def _meta_stack_at(offset, t, fh, fw):
    """A meta ``(t, fh, fw)`` uint8 stack ``offset`` bytes into its buffer."""
    return _meta_u8(offset + t * fh * fw)[offset:].view(t, fh, fw)


@pytest.mark.parametrize(
    "block,shape,offsets,kernel",
    [(1, (2, 6, 14), (0, 0), "candidate_sads"),      # 84-byte planes
     (1, (2, 5, 7), (0, 0), "candidate_sads_general"),  # 35: not whole words
     (1, (2, 6, 14), (2, 1), "candidate_sads_general"),  # tracked off a word
     (1, (2, 6, 14), (4, 1), "candidate_sads"),      # the anchor any byte
     (2, (2, 8, 12), (4, 2), "candidate_sads"),
     (2, (2, 8, 12), (4, 1), "candidate_sads_general"),
     (4, (2, 8, 12), (16, 16), "candidate_sads"),
     (4, (2, 8, 12), (4, 16), "candidate_sads_general"),  # 16-byte chunks
     (8, (2, 16, 24), (16, 8), "candidate_sads_general"),
     # the rectangles (width, height) of 16x8 and 8x16 MV blocks' top levels
     ((2, 1), (2, 135, 240), (4, 2), "candidate_sads"),  # 1080 rows at 16x8
     ((2, 1), (2, 135, 240), (4, 1), "candidate_sads_general"),  # 16-bit anchor rows
     ((2, 1), (2, 5, 10), (0, 0), "candidate_sads_general"),  # 50: not whole words
     ((1, 2), (2, 136, 240), (4, 1), "candidate_sads"),  # the anchor any byte
     ((1, 2), (2, 136, 240), (2, 0), "candidate_sads_general"),  # tracked off a word
     ((1, 2), (2, 6, 7), (0, 0), "candidate_sads_general"),  # 42: not whole words
     ((4, 2), (2, 270, 480), (4, 4), "candidate_sads"),
     ((4, 2), (2, 270, 480), (4, 2), "candidate_sads_general"),  # 32-bit anchor rows
     ((2, 4), (2, 272, 480), (4, 2), "candidate_sads"),
     ((2, 4), (2, 272, 480), (4, 1), "candidate_sads_general"),
     ((8, 4), (2, 540, 960), (16, 16), "candidate_sads"),
     ((8, 4), (2, 540, 960), (16, 4), "candidate_sads_general"),  # 16-byte chunks
     ((4, 8), (2, 544, 960), (16, 16), "candidate_sads"),
     ((4, 8), (2, 544, 960), (8, 16), "candidate_sads_general"),
     # the top levels of 32x32, 32x16 and 16x32 MV blocks at 2 levels
     (16, (2, 544, 960), (16, 16), "candidate_sads"),
     (16, (2, 544, 960), (16, 8), "candidate_sads_general"),  # 16-byte chunks
     ((16, 8), (2, 544, 960), (16, 16), "candidate_sads"),
     ((16, 8), (2, 544, 960), (4, 16), "candidate_sads_general"),
     ((8, 16), (2, 544, 960), (16, 16), "candidate_sads"),
     ((8, 16), (2, 544, 960), (16, 2), "candidate_sads_general"),
     # the top levels of 32x8 and 8x32 MV blocks at 4, 3 and 2 levels
     ((4, 1), (2, 135, 240), (4, 4), "candidate_sads"),
     ((4, 1), (2, 135, 240), (4, 2), "candidate_sads_general"),  # 32-bit anchor rows
     ((4, 1), (2, 135, 240), (2, 4), "candidate_sads_general"),  # tracked off a word
     ((1, 4), (2, 136, 240), (4, 1), "candidate_sads"),  # the anchor any byte
     # 4-row blocks: planes of whole words at any width
     ((1, 4), (2, 4, 7), (0, 3), "candidate_sads"),
     ((1, 4), (2, 8, 5), (2, 0), "candidate_sads_general"),  # tracked off a word
     ((8, 2), (2, 270, 480), (4, 8), "candidate_sads"),
     ((8, 2), (2, 270, 480), (4, 4), "candidate_sads_general"),  # 64-bit anchor rows
     ((2, 8), (2, 272, 480), (4, 2), "candidate_sads"),
     ((2, 8), (2, 272, 480), (4, 1), "candidate_sads_general"),
     ((16, 4), (2, 540, 960), (16, 16), "candidate_sads"),
     ((16, 4), (2, 540, 960), (16, 8), "candidate_sads_general"),  # 16-byte chunks
     ((4, 16), (2, 544, 960), (16, 16), "candidate_sads"),
     ((4, 16), (2, 544, 960), (8, 16), "candidate_sads_general")],
)
def test_candidate_sads_alignment_gates(meta_launches, block, shape, offsets,
                                        kernel):
    tr = _meta_stack_at(offsets[0], *shape)
    an = _meta_stack_at(offsets[1], *shape)
    t, fh, fw = shape
    bw, bh = (block, block) if isinstance(block, int) else block
    mv = torch.zeros((t, fh // bh, fw // bw, 2), dtype=torch.int32, device="meta")
    motion.candidate_sads(tr, an, mv, 1, bw, bh)
    ((name, args),) = meta_launches
    assert name == kernel
    assert args[:2] == offsets  # the stacks themselves, not copies


def test_pyr_down_levels_rejects_bad_halvings():
    with pytest.raises(ValueError, match="halvings"):
        pyramid.pyr_down_levels(torch.zeros((1, 8, 8), dtype=torch.uint8), 4)


# ---------------------------------------------------------------------------
# K4: the fused tile walk, replayed on the CPU
# ---------------------------------------------------------------------------

_TAPS = np.array([1, 4, 6, 4, 1], np.int64)
_ROW0 = 160  # level-0 shared row (kLvRow0)
_SMEM_LIMIT = 48 * 1024  # static shared memory a CTA may declare


def _pad4(x):
    return (x + 3) & ~3


class _Geo:
    """``Geo<D>`` of csrc/pyr_down_levels.cu."""

    def __init__(self, d):
        self.d = d
        self.th, self.tw = 64 >> d, 128 >> d
        self.off0 = 18 - (2 << d)

    def r(self, l):
        return self.th if l == self.d else 2 * self.r(l + 1) + 3

    def c(self, l):
        return self.tw if l == self.d else 2 * self.c(l + 1) + 3

    def s(self, l):
        if l == 0:
            return _ROW0
        return max(_pad4(self.c(l)), 8 * (_pad4(self.c(l + 1)) // 4) + 8)

    def smem_bytes(self):
        a = max([self.r(0) * _ROW0] + [self.r(l) * self.s(l) for l in range(1, self.d)])
        b = max(self.r(l - 1) * _pad4(self.c(l)) for l in range(1, self.d + 1))
        return a + 2 * b


def _reflect101(i, n):
    """``reflect101`` of csrc/pyr_down.cuh, elementwise."""
    i = np.asarray(i, np.int64)
    if n == 1:
        return np.zeros_like(i)
    i = np.clip(i, -2, n + 1)
    while ((i < 0) | (i >= n)).any():
        i = np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))
    return i


def _region_image(q, n, q0, length):
    return np.clip(_reflect101(q, n), q0, q0 + length - 1)


def _replay_levels(img, d, rng, level0=None):
    """Levels 1..d of ``(N, H, W)`` uint8 as the fused kernel computes
    them, and how often each output byte was written. ``level0(z, y, x)``
    reads the bytes of rows ``y`` and columns ``x`` (inside the frame) of
    plane ``z`` as the kernel's level-0 loader does; by default K4's dense
    loader, which reads ``img`` itself."""
    if level0 is None:
        def level0(z, y, x):
            return img[z][y][:, x]
    g = _Geo(d)
    n, h, w = img.shape
    hs, ws = [h], [w]
    for _ in range(d):
        hs.append((hs[-1] + 1) // 2)
        ws.append((ws[-1] + 1) // 2)
    outs = [np.zeros((n, hs[l], ws[l]), np.uint8) for l in range(1, d + 1)]
    writes = [np.zeros((n, hs[l], ws[l]), np.int64) for l in range(1, d + 1)]
    for z in range(n):
        for by in range(-(-hs[d] // g.th)):
            for bx in range(-(-ws[d] // g.tw)):
                p0, q0 = [0] * (d + 1), [0] * (d + 1)
                p0[d], q0[d] = by * g.th, bx * g.tw
                for l in range(d - 1, -1, -1):
                    p0[l], q0[l] = 2 * p0[l + 1] - 2, 2 * q0[l + 1] - 2
                cb = q0[0] - g.off0
                assert cb % 16 == 0
                # the frame's own pixels, then the halo from shared memory:
                # columns -2, -1, w, w + 1 of the rows inside the frame, then
                # rows -2, -1, h, h + 1 as copies of their (clamped) images;
                # positions further out hold what no output reads (noise)
                y = p0[0] + np.arange(g.r(0))
                x = cb + np.arange(_ROW0)
                a = rng.integers(0, 256, (g.r(0), _ROW0))
                yin, xin = (y >= 0) & (y < h), (x >= 0) & (x < w)
                if yin.any() and xin.any():
                    a[np.ix_(yin, xin)] = level0(z, y[yin], x[xin])
                for col in (-2, -1, w, w + 1):
                    c = col - cb
                    if 0 <= c < _ROW0:
                        sc = int(np.clip(_reflect101(col, w) - cb, 0, _ROW0 - 1))
                        a[yin, c] = a[yin, sc]
                for r in np.nonzero(~yin & (y >= -2) & (y <= h + 1))[0]:
                    sr = int(np.clip(_reflect101(y[r], h) - p0[0], 0, g.r(0) - 1))
                    a[r] = a[sr]
                off = g.off0
                for l in range(1, d + 1):
                    hl, wl, cout = hs[l], ws[l], _pad4(g.c(l))
                    # horizontal pass: groups of four columns inside the
                    # level read straight, the others through the image
                    c = np.arange(cout)
                    grp = 4 * (c // 4) + q0[l]
                    inside = (grp >= 0) & (grp + 3 < wl)
                    src = np.where(inside, c,
                                   _region_image(q0[l] + c, wl, q0[l], g.c(l)) - q0[l])
                    idx = off + 2 * src[:, None] + np.arange(5)
                    assert idx.max() < a.shape[1]
                    hsum = (a[:, idx] * _TAPS).sum(-1)
                    assert hsum.max() < 2 ** 16
                    # vertical pass
                    p = p0[l] + np.arange(g.r(l))
                    rp = np.where((p >= 0) & (p < hl), p,
                                  _region_image(p, hl, p0[l], g.r(l)))
                    ridx = 2 * (rp - p0[l])[:, None] + np.arange(5)
                    assert ridx.max() < hsum.shape[0]
                    val = ((hsum[ridx] * _TAPS[None, :, None]).sum(1) + 128) >> 8
                    if l < d:
                        ko = (2 << (d - l)) - 2
                        own_h, own_w = g.th << (d - l), g.tw << (d - l)
                        keep = (slice(ko, ko + own_h), slice(ko, ko + own_w))
                        ys, xs = p0[l] + ko, q0[l] + ko
                    else:
                        keep = (slice(0, g.r(l)), slice(0, g.tw))
                        ys, xs = p0[l], q0[l]
                    blk = val[keep]
                    y1, x1 = min(ys + blk.shape[0], hl), min(xs + blk.shape[1], wl)
                    outs[l - 1][z, ys:y1, xs:x1] = blk[:y1 - ys, :x1 - xs]
                    writes[l - 1][z, ys:y1, xs:x1] += 1
                    if l < d:
                        # the next level reads this region from a shared row
                        # of stride S(l) whose padding holds whatever was there
                        nxt = rng.integers(0, 256, (g.r(l), g.s(l)))
                        nxt[:, :cout] = val
                        a, off = nxt, 0
    return outs, writes


@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1), (1, 1, 9), (2, 9, 1), (1, 5, 7), (3, 5, 7), (1, 2, 3),
     (1, 384, 683), (1, 1087, 1919), (2, 70, 530), (1, 130, 66)],
)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_fused_tile_walk_equals_chained_plain(shape, d):
    rng = np.random.default_rng(sum(shape) * 10 + d)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got, writes = _replay_levels(img, d, rng)
    ref = [torch.from_numpy(img)]
    for _ in range(d):
        ref.append(pyramid.pyr_down_plain(ref[-1]))
    for lvl, (g, w_) in enumerate(zip(got, writes), start=1):
        assert (w_ == 1).all(), f"level {lvl}: some output written {w_.min()}-{w_.max()} times"
        np.testing.assert_array_equal(g, ref[lvl].numpy(), err_msg=f"level {lvl}")


def test_fused_kernel_host_constants_match_the_source():
    # the kernel lives in pyr_down_levels.cuh, shared with the K8 pyramid
    assert '#include "pyr_down_levels.cuh"' in (
        build.CSRC_DIR / "pyr_down_levels.cu").read_text()
    src = (build.CSRC_DIR / "pyr_down_levels.cuh").read_text()
    assert "constexpr int kLvRow0 = 160;" in src
    assert "static constexpr int kTH = 64 >> D;" in src
    assert "static constexpr int kTW = 128 >> D;" in src
    assert "static constexpr int kOff0 = 18 - (2 << D);" in src
    cases = set(map(int, re.findall(r"case (\d+): return launch_levels<", src)))
    assert cases | {3} == set(range(1, pyramid._MAX_HALVINGS + 1))
    # both shared buffers fit the static 48 KB at every depth
    assert _Geo(3).smem_bytes() == 26520
    for d in (1, 2, 3):
        assert _Geo(d).smem_bytes() <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# K9: the 2x2 kernel's word arithmetic, replayed on the CPU
# ---------------------------------------------------------------------------


def _vsadu4(a, b):
    return sum(np.abs(((a >> (8 * k)) & 0xFF).astype(np.int64)
                      - ((b >> (8 * k)) & 0xFF).astype(np.int64)) for k in range(4))


def _word(frame, a):
    """Little-endian 32-bit words of the flat frame at byte offsets ``a``
    (multiples of 4, inside the frame)."""
    f = frame.astype(np.uint64)
    return f[a] | (f[a + 1] << 8) | (f[a + 2] << 16) | (f[a + 3] << 24)


def _window_row(frame, y, x0, fh, fw):
    """``window_row`` of csrc/candidate_sads.cu, vectorised over blocks."""
    live = (y >= 0) & (y < fh) & (x0 > -4) & (x0 < fw)
    y_, x_ = np.where(live, y, 0), np.where(live, x0, 0)
    row0 = y_ * fw
    row1 = row0 + fw
    o = row0 + x_
    a = o & ~3
    s = o - a
    lo_ok = live & (a + 4 > row0)
    hi_ok = live & (s != 0) & (a + 4 < row1)
    assert ((a >= 0) | ~lo_ok).all() and ((a + 8 <= frame.size) | ~hi_ok).all()
    lo = np.where(lo_ok, _word(frame, np.where(lo_ok, a, 0)), 0)
    hi = np.where(hi_ok, _word(frame, np.where(hi_ok, a + 4, 0)), 0)
    v = ((hi << 32) | lo) >> (8 * s).astype(np.uint64) & 0xFFFFFFFF
    first = np.maximum(0, -x_)
    last = np.minimum(4, fw - x_)
    below = np.where(last >= 4, 0xFFFFFFFF, (1 << (8 * np.clip(last, 0, 3))) - 1)
    mask = below & ((0xFFFFFFFF << (8 * np.clip(first, 0, 3))) & 0xFFFFFFFF)
    return np.where(live, v & mask.astype(np.uint64), 0)


def _replay_k9(tracked, anchor, mv):
    t, fh, fw = tracked.shape
    mfh, mfw = fh // 2, fw // 2
    out = np.zeros((t, 9, mfh, mfw), np.float32)
    by, bx = np.meshgrid(np.arange(mfh), np.arange(mfw), indexing="ij")
    for ti in range(t):
        trk = tracked[ti].reshape(-1)
        anc = anchor[ti].astype(np.uint64)
        a0 = anc[2 * by, 2 * bx] | (anc[2 * by, 2 * bx + 1] << 8)
        a1 = anc[2 * by + 1, 2 * bx] | (anc[2 * by + 1, 2 * bx + 1] << 8)
        x0 = 2 * bx + mv[ti, ..., 0].astype(np.int64) - 1
        y0 = 2 * by + mv[ti, ..., 1].astype(np.int64) - 1
        acc = np.zeros((9, mfh, mfw), np.int64)
        for wr in range(4):
            w = _window_row(trk, y0 + wr, x0, fh, fw)
            for ox in range(3):
                c = (w >> np.uint64(8 * ox)) & np.uint64(0xFFFF)
                if wr <= 2:
                    acc[wr * 3 + ox] += _vsadu4(c, a0)
                if wr >= 1:
                    acc[(wr - 1) * 3 + ox] += _vsadu4(c, a1)
        out[ti] = acc
    return out


@pytest.mark.parametrize(
    "t,fh,fw,mv_kind",
    [(2, 16, 24, "zero"), (2, 16, 24, "random"),  # fw % 4 == 0
     (3, 14, 10, "random"), (1, 6, 14, "edge"),   # fw % 4 == 2
     (2, 12, 18, "edge"), (1, 2, 2, "edge"), (2, 20, 22, "far"),
     (1, 34, 60, "random")],
)
def test_k9_word_replay_equals_plain(t, fh, fw, mv_kind):
    rng = np.random.default_rng(fh * fw + t)
    tracked = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    shape = (t, fh // 2, fw // 2, 2)
    if mv_kind == "zero":
        mv = np.zeros(shape, np.int32)
    elif mv_kind == "random":
        mv = rng.integers(-14, 15, shape).astype(np.int32)
    elif mv_kind == "edge":  # odd MVs that reach past every frame edge
        mv = (2 * rng.integers(-3, 4, shape) + 1).astype(np.int32)
    else:  # windows wholly outside the frame, and just inside
        mv = rng.choice(np.array([-40, -5, -4, -3, 3, 4, 5, 40], np.int32), shape)
    got = _replay_k9(tracked, anchor, mv)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked),
                                      torch.from_numpy(anchor),
                                      torch.from_numpy(mv), 1, 2, 2)
    np.testing.assert_array_equal(got, ref.numpy())


def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` for selectors of bytes 0-7."""
    pool = x | (y << 32)
    return sum(((pool >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def _window_run(frame, y, x0, fh, fw, n):
    """``window_run<N>`` of csrc/candidate_sads.cu, vectorised over blocks:
    (N + 3) / 4 words of row y from byte x0 on."""
    live = (y >= 0) & (y < fh) & (x0 > -n) & (x0 < fw)
    y_, x_ = np.where(live, y, 0), np.where(live, x0, 0)
    row0 = y_ * fw
    row1 = row0 + fw
    o = row0 + x_
    a = o & ~3
    s = o - a
    k_a = (n + 3) // 4
    w = []
    for m in range(k_a + 1):
        p = a + 4 * m
        ok = live & (4 * m < s + n) & (p + 4 > row0) & (p < row1)
        assert ((p >= 0) & (p + 4 <= frame.size) | ~ok).all()  # inside the plane
        w.append(np.where(ok, _word(frame, np.where(ok, p, 0)), 0).astype(np.int64))
    out = []
    for j in range(k_a):
        v = ((w[j + 1] << 32) | w[j]) >> (8 * s) & 0xFFFFFFFF
        first = np.clip(-x_ - 4 * j, 0, 4)
        last = np.clip(fw - x_ - 4 * j, 0, 4)
        below = np.where(last >= 4, 0xFFFFFFFF, (1 << (8 * np.minimum(last, 3))) - 1)
        above = np.where(first >= 4, 0, (0xFFFFFFFF << (8 * np.minimum(first, 3))) & 0xFFFFFFFF)
        out.append(np.where(live, v & below & above, 0))
    return out


def _replay_k9_wide(tracked, anchor, mv, r):
    """SADs as ``candidate_sads_kernel<R>`` (R >= 2) computes them: the
    2R + 2 window rows of each block as words, one ``__byte_perm`` of rows
    oy and oy + 1 per candidate against both anchor rows in one word, one
    ``__vsadu4``, and the float32 made by 2^23 + x less 2^23."""
    t, fh, fw = tracked.shape
    mfh, mfw = fh // 2, fw // 2
    side, run = 2 * r + 1, 2 * r + 2
    out = np.zeros((t, side * side, mfh, mfw), np.float32)
    by, bx = np.meshgrid(np.arange(mfh), np.arange(mfw), indexing="ij")
    for ti in range(t):
        trk = tracked[ti].reshape(-1)
        anc = anchor[ti].astype(np.int64)
        a01 = (anc[2 * by, 2 * bx] | (anc[2 * by, 2 * bx + 1] << 8)
               | (anc[2 * by + 1, 2 * bx] << 16) | (anc[2 * by + 1, 2 * bx + 1] << 24))
        x0 = 2 * bx + mv[ti, ..., 0].astype(np.int64) - r
        y0 = 2 * by + mv[ti, ..., 1].astype(np.int64) - r
        rows = [_window_run(trk, y0 + wr, x0, fh, fw, run) for wr in range(run)]
        for oy in range(side):
            for ox in range(side):
                j, d = divmod(ox, 4)
                top, bot = rows[oy], rows[oy + 1]
                if d < 3:
                    pair = _byte_perm(top[j], bot[j],
                                      d | (d + 1) << 4 | (d + 4) << 8 | (d + 5) << 12)
                else:
                    def shifted(rw):
                        return ((rw[j + 1] << 32) | rw[j]) >> 24 & 0xFFFFFFFF
                    pair = _byte_perm(shifted(top), shifted(bot), 0x5410)
                sad = _vsadu4(pair.astype(np.uint64), a01.astype(np.uint64)).astype(np.int64)
                assert (sad < 1 << 23).all()
                f = (np.uint32(0x4B000000) | sad.astype(np.uint32)).view(np.float32)
                out[ti, oy * side + ox] = f - np.float32(8388608.0)
    return out


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize(
    "t,fh,fw,mv_kind",
    [(2, 16, 24, "zero"), (2, 16, 24, "random"),  # fw % 4 == 0
     (3, 14, 10, "random"), (1, 6, 14, "edge"),   # fw % 4 == 2
     (2, 12, 18, "edge"), (1, 2, 2, "edge"), (2, 20, 22, "far"),
     (1, 34, 60, "random")],
)
def test_k9_wide_replay_equals_plain(r, t, fh, fw, mv_kind):
    rng = np.random.default_rng(fh * fw + t + 1000 * r)
    tracked = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    shape = (t, fh // 2, fw // 2, 2)
    if mv_kind == "zero":
        mv = np.zeros(shape, np.int32)
    elif mv_kind == "random":
        mv = rng.integers(-14, 15, shape).astype(np.int32)
    elif mv_kind == "edge":  # odd MVs that reach past every frame edge
        mv = (2 * rng.integers(-3, 4, shape) + 1).astype(np.int32)
    else:  # windows wholly outside the frame, and just inside
        mv = rng.choice(np.array([-40, -9, -5, -4, -3, 3, 4, 5, 9, 40], np.int32), shape)
    got = _replay_k9_wide(tracked, anchor, mv, r)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked),
                                      torch.from_numpy(anchor),
                                      torch.from_numpy(mv), r, 2, 2)
    np.testing.assert_array_equal(got, ref.numpy())


def test_k9_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "candidate_sads.cu").read_text()
    assert "constexpr int kCand = 9;" in src  # the r = 1 instance's count
    assert "fh % BH || fw % BW" in src
    # the blocks (width, height) of K9's entry: 1x1 on the thread-a-pixel
    # kernel, a side of 1 or 2 on the thread-a-block one, both sides 4 or
    # more on K3's kernel
    entry = src[src.index("SVC_EXPORT int svc_candidate_sads("):]
    blocks = {(int(a), int(b)) for a, b in re.findall(
        r"case shape_key\((\d+), (\d+)\): return launch_", entry)}
    assert blocks == set(motion._K9_BLOCKS)
    # the top level of 32x32, 32x16 and 16x32 MV blocks at 2 levels, and of
    # 32x8 and 8x32 at 4, 3 and 2
    assert {(16, 16), (16, 8), (8, 16)} <= blocks
    assert set(_RATIO4) <= blocks
    assert "case shape_key(1, 1): return launch_block1(" in entry
    thin = set()
    for bw, bh in blocks - {(1, 1)}:
        if min(bw, bh) >= 4:
            assert (f"case shape_key({bw}, {bh}): return launch_refine_rows<{bw}, {bh}, "
                    f"float>(") in entry
            assert motion._K9_ALIGN[bw, bh] == (16, 16)
        else:
            assert (f"case shape_key({bw}, {bh}): return launch_block_sads<{bw}, {bh}, "
                    f"float>(") in entry
            # whole tracked words; the anchor's rows one load each
            assert motion._K9_ALIGN[bw, bh] == (4, bw)
            thin.add((bw, bh))
    assert motion._K9_ALIGN[1, 1] == (4, 1)
    # the thread-a-block kernel's instances: float32 for K9, int32 for K3 /
    # K7 at their blocks with a side of 2
    built = set(re.findall(r"SVC_BLOCK_SADS\((\d+), (\d+), (\w+)\)\n", src))
    assert built == ({(str(w), str(h), "float") for w, h in thin}
                     | {(str(w), str(h), "int32_t") for w, h in motion._K3_BLOCKS
                        if min(w, h) <= 2})
    assert "reinterpret_cast<uintptr_t>(anchor) % BW" in src
    assert "(static_cast<size_t>(fh) * fw) % 4" in src
    # each launcher's radii, the thread-a-block and the 1x1 one; the
    # thread-a-block kernel's past kNearRadius (K9's 2x2: kFarBlocks)
    near = src[:src.index("if constexpr (kFarBlocks<BW, BH>) {")]
    radii = {int(a) for a, b in re.findall(r"case (\d+): return launch<BW, BH, (\d+)>\(", near)
             if a == b}
    assert radii == set(motion._SAD_RADII)
    # the 1x1 launcher: R = 1-8 (the top of 8x8 MV blocks at 4 levels and of
    # 16x16 at 5 past R = 4)
    radii = {int(a) for a, b in re.findall(r"case (\d+): return launch_1x1<(\d+)>\(", src)
             if a == b}
    assert radii == set(motion._SAD_RADII) | set(motion._FAR_RADII)
    far = src[src.index("if constexpr (kFarBlocks<BW, BH>) {"):]
    far = far[:far.index("return static_cast<int>(cudaErrorInvalidValue);")]
    assert {int(a) for a, b in re.findall(r"case (\d+): return launch<BW, BH, (\d+)>\(", far)
            if a == b} == set(motion._FAR_RADII)
    assert "constexpr int kNearRadius = 4;" in src
    # 2x2 past R = 4 for both outputs (K9's float32, K3's / K7's int32)
    assert "constexpr bool kFarBlocks = BW == 2 && BH == 2;" in src
    assert {b for b in motion._K9_FAR_BLOCKS if min(b) < 4} == {(2, 2), (1, 1)}
    assert {b for b in motion._K3_FAR_BLOCKS if min(b) < 4} == {(2, 2)}
    # past it a thread streams its window rows: the BH rows of candidate
    # row oy held, the next loaded before the row's sums, then a slide
    # (_replay_k9_block's streamed walk)
    assert "uint32_t win[BH][kWords];" in src
    assert "if (oy + 1 < kSide) window_run<kRun>(trk, y0 + oy + BH, x0, fh, fw, next);" in src
    assert ("const uint32_t sad = block_sad<BW, BH>([&](int q) { return win[q]; }, a, ox);"
            in src)
    assert ("for (int w = 0; w < kWords; ++w) win[q][w] = q + 1 < BH ? win[q + 1][w] : next[w];"
            in src)
    # past 2x2 at R = 1: BH + 2R window rows of BW + 2R bytes, anchor words
    # of 4 / BW rows (BH at most; BW / 4 words a row from BW = 4 on), one
    # __vsadu4 an anchor word a candidate, the exact float32 by the mantissa
    assert "constexpr int kRows = BH + 2 * R;" in src
    assert "constexpr int kRun = BW + 2 * R;" in src
    assert ("static constexpr int kStep = BW >= 4 ? 1 : (4 / BW < BH ? 4 / BW : BH);"
            in src)
    assert "static constexpr int kRowWords = BW >= 4 ? BW / 4 : 1;" in src
    assert "static constexpr int kCount = BH / kStep * kRowWords;" in src
    assert "const uint32_t* top = row(A::kStep * (k / A::kRowWords));" in src
    assert "const int w = j + k % A::kRowWords;" in src
    assert ("const uint32_t sad = block_sad<BW, BH>([&](int q) { return rows[oy + q]; }, "
            "a, ox);") in src
    # a CTA: the level's block columns rounded up to a warp (kThreads at
    # most), block rows to fill it (_cta_geometry)
    assert "const int cols = min(kThreads, (mfw + 31) / 32 * 32);" in src
    assert "const dim3 block(cols, kThreads / cols);" in src
    assert ("const dim3 grid((mfw + cols - 1) / cols, (mfh + block.y - 1) / block.y, "
            "t_count);") in src
    assert "const int by = blockIdx.y * blockDim.y + threadIdx.y;" in src
    assert "if (bx >= mfw || by >= mfh) return;" in src
    assert "window_run<kRun>(trk, y0 + wr, x0, fh, fw, rows[wr]);" in src
    assert "sad = __vsadu4(c, a[k]) + sad;" in src
    assert "o[(oy * kSide + ox) * plane_out] = sad_as<Out>(sad);" in src
    common = (build.CSRC_DIR / "common.cuh").read_text()
    assert "return __uint_as_float(0x4b000000u | sad) - 8388608.0f;" in common
    # 1x1: 2R + 1 window rows of 2R + 1 bytes, __vabsdiffu4 against the
    # anchor byte in every byte, a byte_perm into the mantissa a candidate
    assert "window_run<kSide>(trk, y + mvy + oy - R, x + mvx - R, fh, fw, row);" in src
    assert "__ldg(anchor + at) * 0x01010101u" in src
    assert "const uint32_t d = __vabsdiffu4(row[j], a4);" in src
    assert "__uint_as_float(__byte_perm(d, 0x4b000000u, k | 0x7440)) - 8388608.0f" in src


def _fshr(lo, hi, bits):
    """``__funnelshift_r(lo, hi, bits)`` (bits < 32)."""
    return (((hi << 32) | lo) >> bits) & 0xFFFFFFFF


def _anchor_words(anc, by, bx, bw, bh):
    """``AnchorWords<BW, BH>`` of every block of a frame's anchor plane: its
    rows packed kStep to a word (at BW = 8 two words a row), one load a
    row (``load_anchor_words``)."""
    step = 1 if bw >= 4 else (4 // bw if 4 // bw < bh else bh)
    row_words = bw // 4 if bw >= 4 else 1
    a = []
    for k in range(bh // step):
        for w in range(row_words):
            word = np.zeros(by.shape, np.int64)
            for q in range(step):
                for j in range(min(bw, 4)):
                    word |= (anc[bh * by + step * k + q, bw * bx + 4 * w + j]
                             << (8 * (bw * q + j)))
            a.append(word)
    return a, step, row_words


def _block_sad(row, a, ox, bw, step, row_words):
    """``block_sad<BW, BH>``: the SAD of candidate column ox of a candidate
    row oy, ``row(q)`` giving window row oy + q as ``window_run``'s words:
    one ``__vsadu4`` an anchor word of the window's bytes there: the row's
    word shifted to byte ox (BW = 4; at BW = 8 each of the row's two
    words), one ``__byte_perm`` of two rows (BW = 2), of a row and zeros
    (2x1), of a row's byte and the next row's (1x2) or two such pairs
    joined by a third (1x4)."""
    j, d = divmod(ox, 4)
    sad = 0
    for k, ak in enumerate(a):
        top = row(step * (k // row_words))
        if bw >= 4:
            w = j + k % row_words
            c = top[w] if d == 0 else _fshr(top[w], top[w + 1], 8 * d)
        elif bw == 2 and step == 2:
            bot = row(step * k + 1)
            if d < 3:
                c = _byte_perm(top[j], bot[j],
                               d | (d + 1) << 4 | (d + 4) << 8 | (d + 5) << 12)
            else:
                c = _byte_perm(_fshr(top[j], top[j + 1], 24),
                               _fshr(bot[j], bot[j + 1], 24), 0x5410)
        elif bw == 2:  # 2x1
            c = (_byte_perm(top[j], 0, d | (d + 1) << 4 | 0x4400) if d < 3
                 else _fshr(top[j], top[j + 1], 24) & 0xFFFF)
        elif step == 2:  # 1x2
            c = _byte_perm(top[j], row(1)[j], d | (d + 4) << 4) & 0xFFFF
        else:  # 1x4
            lo = _byte_perm(top[j], row(1)[j], d | (d + 4) << 4)
            hi = _byte_perm(row(2)[j], row(3)[j], d | (d + 4) << 4)
            c = _byte_perm(lo, hi, 0x5410)
        sad = sad + _vsadu4(c, ak)
    return sad


def _replay_k9_block(tracked, anchor, mv, bw, bh, r, streamed=False):
    """int64 SADs as ``candidate_sads_kernel<BW, BH, R>`` computes them past
    2x2 at R = 1: each block's anchor words and, per candidate, its
    ``block_sad`` over the window rows (``window_run<BW + 2R>``): at R <= 4
    all BH + 2R of them loaded first; ``streamed`` (R > kNearRadius) the BH
    rows candidate row oy needs held at once, row oy + BH loaded before
    that row's sums, then the window slid down a row."""
    t, fh, fw = tracked.shape
    mfh, mfw = fh // bh, fw // bw
    side, n_rows, run = 2 * r + 1, bh + 2 * r, bw + 2 * r
    out = np.zeros((t, side * side, mfh, mfw), np.int64)
    by, bx = np.meshgrid(np.arange(mfh), np.arange(mfw), indexing="ij")
    for ti in range(t):
        trk = tracked[ti].reshape(-1)
        a, step, row_words = _anchor_words(anchor[ti].astype(np.int64), by, bx, bw, bh)
        x0 = bw * bx + mv[ti, ..., 0].astype(np.int64) - r
        y0 = bh * by + mv[ti, ..., 1].astype(np.int64) - r

        def load(wr):
            return _window_run(trk, y0 + wr, x0, fh, fw, run)

        if streamed:
            win = [load(q) for q in range(bh)]
            for oy in range(side):
                nxt = load(oy + bh) if oy + 1 < side else None
                for ox in range(side):
                    out[ti, oy * side + ox] = _block_sad(lambda q: win[q], a, ox, bw, step,
                                                         row_words)
                win = win[1:] + [nxt]
        else:
            rows = [load(wr) for wr in range(n_rows)]
            for oy in range(side):
                for ox in range(side):
                    out[ti, oy * side + ox] = _block_sad(lambda q: rows[oy + q], a, ox, bw,
                                                         step, row_words)
    return out


# the blocks (width, height) with a side of 1 or 2 on the thread-a-block
# kernel besides 2x2: the top levels of 16x8 and 8x16 MV blocks (K9), and
# K3's / K7's 4x2 and 2x4 refinement levels; the top levels of 32x8 and
# 8x32 MV blocks (K9 4x1, 1x4, 8x2, 2x8) and K3's / K7's 8x2 and 2x8
_THIN = [(2, 1), (1, 2), (4, 2), (2, 4), (4, 1), (1, 4), (8, 2), (2, 8)]


@pytest.mark.parametrize(
    "block,r",
    # 2x2 at r = 1 runs the 4-word path (test_k9_word_replay_equals_plain);
    # 2x2 at r = 5-8 (the top of 4 levels, ranges 40-71) streams its rows
    [(b, r) for b in _THIN + [(2, 2)] for r in (1, 2, 3, 4) if (b, r) != ((2, 2), 1)]
    + [((2, 2), r) for r in motion._FAR_RADII],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("frames,mfh,mfw,mv_kind", [
    (2, 5, 12, "zero"), (2, 5, 12, "random"),  # odd block rows, fw % 4 == 0
    (3, 4, 7, "edge"), (1, 1, 1, "edge"),       # odd widths: fw % 4 != 0
    (2, 6, 11, "far")])
def test_k9_block_replay_equals_plain(block, r, frames, mfh, mfw, mv_kind):
    bw, bh = block
    rng = np.random.default_rng(1000 * bw + 100 * bh + 10 * r + mfh + mfw + len(mv_kind))
    fh, fw = mfh * bh, mfw * bw
    if fh * fw % 4:  # the kernel's gate: planes of whole words
        fh, mfh = fh * 2, mfh * 2
    tracked = rng.integers(0, 256, (frames, fh, fw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (frames, fh, fw)).astype(np.uint8)
    shape = (frames, mfh, mfw, 2)
    if mv_kind == "zero":
        mv = np.zeros(shape, np.int32)
    elif mv_kind == "random":
        mv = rng.integers(-14, 15, shape).astype(np.int32)
    elif mv_kind == "edge":  # odd MVs that reach past every frame edge
        mv = (2 * rng.integers(-4, 5, shape) + 1).astype(np.int32)
    else:  # windows wholly outside the frame, and just inside
        mv = rng.choice(np.array([-40, -9, -5, -4, -3, 3, 4, 5, 9, 40], np.int32), shape)
    sads = _replay_k9_block(tracked, anchor, mv, bw, bh, r, streamed=r > 4)
    assert ((sads >= 0) & (sads < 1 << 23)).all()
    got = (np.uint32(0x4B000000) | sads.astype(np.uint32)).view(np.float32) - np.float32(
        8388608.0)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked), torch.from_numpy(anchor),
                                      torch.from_numpy(mv), r, bw, bh)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [(4, 2), (2, 4), (8, 2), (2, 8)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("t,mfh,mfw,mv_kind", [(2, 5, 12, "path"), (3, 3, 7, "edge"),
                                               (2, 4, 6, "far")])
def test_k3_block_replay_equals_plain(r, block, t, mfh, mfw, mv_kind):
    # K3 and K7 at 4x2, 2x4, 8x2 and 2x8 blocks run K9's thread-a-block
    # kernel with two bases (the stack and the stack plus a plane; the pair)
    # and int32 output: its sums stored as they are
    bw, bh = block
    rng = np.random.default_rng(100 * bw + 10 * bh + r + mfh + len(mv_kind))
    stack = rng.integers(0, 256, (t + 1, mfh * bh, mfw * bw)).astype(np.uint8)
    shape = (t, mfh, mfw, 2)
    if mv_kind == "path":  # doubled propagated MVs, the refine's own inputs
        mv = 2 * rng.integers(-2 * r, 2 * r + 1, shape)
    elif mv_kind == "edge":
        mv = 2 * rng.integers(-5, 6, shape) + 1
    else:
        mv = rng.choice(np.array([-40, -9, -5, -1, 1, 5, 9, 40]), shape)
    mv = mv.astype(np.int32)
    got = _replay_k9_block(stack[:-1], stack[1:], mv, bw, bh, r)
    ref = motion.refine_sads_plain(torch.from_numpy(stack), torch.from_numpy(mv), r, bw, bh)
    np.testing.assert_array_equal(got, ref.numpy())
    pair = motion.refine_mads_plain(torch.from_numpy(stack[0]), torch.from_numpy(stack[1]),
                                    torch.from_numpy(mv[0]), r, bw, bh)
    np.testing.assert_array_equal(got[0], pair.numpy())


def _cta_geometry(mfh, mfw, t):
    """The thread-a-block kernel's launch: threads a CTA (block columns,
    block rows) and its grid, as ``launch`` in csrc/candidate_sads.cu sets
    them for an mfh x mfw field of t frames."""
    threads = 128  # kThreads
    cols = min(threads, -(-mfw // 32) * 32)
    block = (cols, threads // cols)
    grid = (-(-mfw // cols), -(-mfh // block[1]), t)
    return block, grid


@pytest.mark.parametrize("mfh,mfw,idle", [
    # 32x8 and 8x32 MV blocks' levels at 1080p: 60 block columns at each
    # level of 32x8 (135 block rows), 240 of 8x32 (34)
    (135, 60, 4), (34, 240, 16),
    # the default config's top level (2x2, 68 x 120), 1376x768's (48 x 86),
    # a CIF one (18 x 22), one block, a column of them
    (68, 120, 8), (48, 86, 10), (18, 22, 10), (1, 1, 31), (7, 1, 31)])
def test_thread_a_block_grid_covers_every_block_once(mfh, mfw, idle):
    # the CTAs of 128 threads: the field's block columns rounded up to a
    # warp (128 at most) and as many block rows as fill the CTA; every block
    # of every frame taken by exactly one thread, the rest past the field's
    # edge (the kernel returns there)
    t = 2
    (cols, rows), grid = _cta_geometry(mfh, mfw, t)
    assert cols * rows <= 128 and cols % 32 == 0
    hits = np.zeros((t, mfh, mfw), np.int64)
    for gz in range(grid[2]):
        for gy in range(grid[1]):
            for gx in range(grid[0]):
                ty, tx = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
                bx, by = gx * cols + tx, gy * rows + ty
                live = (bx < mfw) & (by < mfh)
                np.add.at(hits[gz], (by[live], bx[live]), 1)
    assert (hits == 1).all()
    # idle threads a row of CTAs: under a warp's worth past the last column
    assert grid[0] * cols - mfw == idle < 32


def _vabsdiffu4(a, b):
    """``__vabsdiffu4``: the four bytes' absolute differences, in place."""
    return sum(np.abs(((a >> (8 * k)) & 0xFF) - ((b >> (8 * k)) & 0xFF)) << (8 * k)
               for k in range(4))


def _replay_k9_1x1(tracked, anchor, mv, r):
    """SADs as ``candidate_sads_1x1_kernel<R>`` computes them: per pixel
    each of the 2R + 1 window rows as words (``window_run<2R + 1>``), one
    ``__vabsdiffu4`` a word against the anchor byte in all four bytes, and
    one ``__byte_perm`` a candidate into the mantissa of 2^23, less 2^23."""
    t, fh, fw = tracked.shape
    side = 2 * r + 1
    out = np.zeros((t, side * side, fh, fw), np.float32)
    y, x = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    for ti in range(t):
        trk = tracked[ti].reshape(-1)
        a4 = anchor[ti].astype(np.int64) * 0x01010101
        mvx, mvy = mv[ti, ..., 0].astype(np.int64), mv[ti, ..., 1].astype(np.int64)
        for oy in range(side):
            row = _window_run(trk, y + mvy + oy - r, x + mvx - r, fh, fw, side)
            assert len(row) == (side + 3) // 4
            for j, word in enumerate(row):
                d = _vabsdiffu4(word, a4)
                for k in range(min(4, side - 4 * j)):
                    f = _byte_perm(d, 0x4B000000, k | 0x7440).astype(np.uint32)
                    out[ti, oy * side + 4 * j + k] = f.view(np.float32) - np.float32(8388608.0)
    return out


# R = 5-8: the top of 8x8 MV blocks at 4 levels and of 16x16 at 5
@pytest.mark.parametrize("r", [1, 2, 3, 4, *motion._FAR_RADII])
@pytest.mark.parametrize(
    "t,fh,fw,mv_kind",
    # planes of whole words (the 1x1 kernel's gate); fw % 4 == 0 and not
    [(2, 8, 12, "zero"), (2, 8, 12, "random"), (3, 6, 14, "random"),
     (1, 5, 8, "edge"), (2, 10, 6, "edge"), (1, 1, 4, "edge"),
     (2, 10, 6, "far"), (1, 17, 60, "random")],
)
def test_k9_1x1_replay_equals_plain(r, t, fh, fw, mv_kind):
    rng = np.random.default_rng(fh * fw + t + 100 * r)
    tracked = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    shape = (t, fh, fw, 2)
    if mv_kind == "zero":
        mv = np.zeros(shape, np.int32)
    elif mv_kind == "random":
        mv = rng.integers(-14, 15, shape).astype(np.int32)
    elif mv_kind == "edge":  # odd MVs that reach past every frame edge
        mv = (2 * rng.integers(-3, 4, shape) + 1).astype(np.int32)
    else:  # windows wholly outside the frame, and just inside
        mv = rng.choice(np.array([-40, -9, -5, -1, 1, 5, 9, 40], np.int32), shape)
    got = _replay_k9_1x1(tracked, anchor, mv, r)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked),
                                      torch.from_numpy(anchor),
                                      torch.from_numpy(mv), r, 1, 1)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("t,fh,fw,mv_kind", [(2, 16, 24, "path"), (3, 14, 10, "edge"),
                                             (2, 20, 22, "far"), (1, 2, 2, "edge")])
def test_k3_2x2_replay_equals_plain(r, t, fh, fw, mv_kind):
    # K3 and K7 at 2x2 blocks run K9's 2x2 kernel with two bases (the stack
    # and the stack plus a plane; the pair) and int32 output: the same
    # word arithmetic, its sums stored as they are
    rng = np.random.default_rng(fh * fw + t + 10 * r)
    stack = rng.integers(0, 256, (t + 1, fh, fw)).astype(np.uint8)
    shape = (t, fh // 2, fw // 2, 2)
    if mv_kind == "path":  # doubled propagated MVs, the refine's own inputs
        mv = 2 * rng.integers(-2 * r, 2 * r + 1, shape)
    elif mv_kind == "edge":
        mv = 2 * rng.integers(-3, 4, shape) + 1
    else:
        mv = rng.choice(np.array([-40, -9, -5, -1, 1, 5, 9, 40]), shape)
    mv = mv.astype(np.int32)
    replay = _replay_k9 if r == 1 else lambda a, b, m: _replay_k9_wide(a, b, m, r)
    got = replay(stack[:-1], stack[1:], mv)
    assert (got < 1 << 23).all() and (got == np.round(got)).all()
    got = got.astype(np.int32)
    ref = motion.refine_sads_plain(torch.from_numpy(stack), torch.from_numpy(mv), r, 2, 2)
    np.testing.assert_array_equal(got, ref.numpy())
    pair = motion.refine_mads_plain(torch.from_numpy(stack[0]), torch.from_numpy(stack[1]),
                                    torch.from_numpy(mv[0]), r, 2, 2)
    np.testing.assert_array_equal(got[0], pair.numpy())
