"""Card-only tests: each CUDA kernel against its plain PyTorch version at
small and odd shapes, and the whole port on the card against the port on
the CPU. They skip where ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it runs on a card machine without it:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.kernels import build
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.ops import ccl, dct, kmeans, motion, prng, pyramid
from svc_tpu_torch.ops.resize import bilinear_axis_weights
from svc_tpu_torch.tools import ccl_cases, display_ties
from svc_tpu_torch.tools.clips import make_clip

pytestmark = pytest.mark.cuda

COEFF_GATE = 2.5e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _u8(gen, shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).cuda()


@pytest.mark.parametrize(
    "shape", [(3, 64, 128), (2, 37, 51), (1, 2, 3), (2, 1, 9), (1, 130, 66)]
)
def test_pyr_down_bit_equal(gen, shape):
    x = _u8(gen, shape)
    before = pyramid.PYR_DOWN.launches
    got = pyramid.pyr_down(x)
    assert pyramid.PYR_DOWN.launches == before + 1
    assert torch.equal(got, pyramid.pyr_down_plain(x))


@pytest.mark.parametrize("block,r,bound", [(4, 1, 2), (8, 1, 6), (16, 1, 14),
                                           (8, 2, 12), (16, 3, 30)])
def test_refine_sads_bit_equal(gen, block, r, bound):
    # MVs reach past the frame edge: windows outside read zeros on both
    # sides, so every entry (valid or not) must agree
    stack = _u8(gen, (3, 4 * block, 6 * block))
    mv = torch.randint(-bound, bound + 1, (2, 4, 6, 2), generator=gen,
                       dtype=torch.int32).cuda()
    assert torch.equal(
        motion.refine_sads(stack, mv, r, block, block),
        motion.refine_sads_plain(stack, mv, r, block, block),
    )


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "block,t,h,w,bound",
    [(4, 2, 48, 344, 2),     # level 2 of a 1376-wide padded frame
     (8, 3, 40, 688, 6),     # level 1 of it, 86 block columns
     (16, 2, 64, 1376, 14),  # level 0: a ragged last CTA (86 of 96 columns)
     (16, 1, 32, 48, 30),    # windows far past every edge
     (4, 1, 8, 12, 9),       # a 3x2 field
     (2, 2, 48, 344, 2),     # 2x2 blocks on K9's kernel: 172 block columns
     (2, 3, 34, 58, 9),      # fw % 4 == 2, windows past the edges
     (2, 1, 2, 2, 40)],      # one block, windows far outside
)
def test_refine_sads_specialised_equals_general(gen, block, t, h, w, bound, r):
    # every candidate, valid or not, bit-equal across the two kernels and
    # the plain version, at each radius's instance
    stack = _u8(gen, (t + 1, h, w))
    bound *= r
    mv = torch.randint(-bound, bound + 1, (t, h // block, w // block, 2),
                       generator=gen, dtype=torch.int32).cuda()
    before = (motion.REFINE_SADS.launches, motion.REFINE_SADS_GENERAL.launches)
    name = f"refine_sads<{block}, {r}>"
    inst = motion.REFINE_SADS.instance_launches[name]
    got = motion.refine_sads(stack, mv, r, block, block)
    gen_out = motion.refine_sads(stack, mv, r, block, block, general=True)
    assert (motion.REFINE_SADS.launches, motion.REFINE_SADS_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert motion.REFINE_SADS.instance_launches[name] == inst + 1
    assert torch.equal(got, gen_out)
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, block, block))


def test_refine_sads_unaligned_stack_takes_the_general_kernel(gen):
    # the specialised kernel loads 16-byte chunks; a stack that starts 4
    # bytes into its buffer goes to the general kernel, with the same SADs
    flat = _u8(gen, (3 * 32 * 64 + 4,))
    stack = flat[4:].view(3, 32, 64)
    assert stack.data_ptr() % 16 != 0
    mv = torch.randint(-6, 7, (2, 4, 8, 2), generator=gen, dtype=torch.int32).cuda()
    before = (motion.REFINE_SADS.launches, motion.REFINE_SADS_GENERAL.launches)
    got = motion.refine_sads(stack, mv, 1, 8, 8)
    assert (motion.REFINE_SADS.launches, motion.REFINE_SADS_GENERAL.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, 1, 8, 8))


@pytest.mark.parametrize("block,r,bound", [(4, 1, 2), (8, 1, 6), (16, 1, 14),
                                           (8, 3, 21), (16, 4, 40), (8, 5, 21),
                                           (4, 9, 21)])
def test_refine_mads_bit_equal(gen, block, r, bound):
    # one frame pair; odd MVs reaching past the frame edge; r = 1 to 8 take
    # the specialised kernel (square 4, 8, 16: r = 5 to 8 too), r = 9 the
    # general one
    tr, an = _u8(gen, (4 * block, 6 * block)), _u8(gen, (4 * block, 6 * block))
    mv = torch.randint(-bound, bound + 1, (4, 6, 2), generator=gen,
                       dtype=torch.int32).cuda()
    kernel = motion.REFINE_MADS if r <= 8 else motion.REFINE_MADS_GENERAL
    before = kernel.launches
    got = motion.refine_mads(tr, an, mv, r, block, block)
    assert kernel.launches == before + 1
    assert got.shape == ((2 * r + 1) ** 2, 4, 6)
    assert torch.equal(got, motion.refine_mads_plain(tr, an, mv, r, block, block))


def _k7_launches():
    return motion.REFINE_MADS.launches, motion.REFINE_MADS_GENERAL.launches


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("block", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["odd", "within40", "past_edges", "unaligned"])
def test_refine_mads_specialised_equals_general(gen, block, kind, r):
    # the specialised K7, the general K7, the plain version and K3 on the
    # stacked pair agree on every candidate, valid or not; an anchor one
    # byte into its buffer takes the general kernel
    h, w = 5 * block, 40 * block
    tr = _u8(gen, (h, w))
    if kind == "unaligned":
        flat = _u8(gen, (h * w + 1,))
        an = flat[1:].view(h, w)
        assert an.data_ptr() % 16 != 0
    else:
        an = _u8(gen, (h, w))
    shape = (h // block, w // block, 2)
    if kind == "odd":
        mv = 2 * torch.randint(-7, 7, shape, generator=gen, dtype=torch.int32) + 1
    elif kind == "within40":
        mv = torch.randint(-40, 41, shape, generator=gen, dtype=torch.int32)
    else:  # windows past every frame edge
        mv = torch.randint(-w - 2 * block, w + 2 * block + 1, shape, generator=gen,
                           dtype=torch.int32)
    mv = mv.cuda()
    before = _k7_launches()
    got = motion.refine_mads(tr, an, mv, r, block, block)
    want = (before[0], before[1] + 1) if kind == "unaligned" else (
        before[0] + 1, before[1])
    assert _k7_launches() == want
    gen_out = motion.refine_mads(tr, an, mv, r, block, block, general=True)
    assert _k7_launches() == (want[0], want[1] + 1)
    k3 = motion.refine_sads(torch.stack((tr, an)), mv[None], r, block, block)[0]
    assert torch.equal(got, gen_out)
    assert torch.equal(got, k3)
    assert torch.equal(got, motion.refine_mads_plain(tr, an, mv, r, block, block))


@pytest.mark.parametrize("mv_pad", [0, 14])
@pytest.mark.parametrize("t,h,w,bw,bh,r", [(3, 48, 80, 16, 16, 4),
                                           (2, 36, 52, 4, 6, 2),
                                           (1, 14, 10, 2, 2, 1)])
def test_candidate_sads_bit_equal(gen, mv_pad, t, h, w, bw, bh, r):
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    mv = torch.randint(-mv_pad, mv_pad + 1, (t, h // bh, w // bw, 2),
                       generator=gen, dtype=torch.int32).cuda()
    kernel = (motion.CANDIDATE_SADS if (bw, bh) in motion._K9_BLOCKS and r <= 4
              else motion.CANDIDATE_SADS_GENERAL)
    before = kernel.launches
    got = motion.candidate_sads(tr, an, mv, r, bw, bh, mv_pad)
    assert kernel.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, bw, bh))


@pytest.mark.parametrize(
    "t,h,w,mv_kind",
    [(8, 136, 240, "zero"),     # the encoder's top-level EBMA
     (8, 136, 240, "random"),   # MVs within +-14
     (1, 136, 240, "edge"),     # per-frame hbma's shape, odd MVs past the edges
     (2, 34, 58, "edge"),       # fw % 4 == 2: words straddle the row's end
     (3, 10, 300, "far"),       # windows wholly outside, 3 CTAs a row
     (1, 2, 2, "random")],
)
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_candidate_sads_2x2_equals_general(gen, t, h, w, mv_kind, r):
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    shape = (t, h // 2, w // 2, 2)
    if mv_kind == "zero":
        mv = torch.zeros(shape, dtype=torch.int32)
    elif mv_kind == "random":
        mv = torch.randint(-14, 15, shape, generator=gen, dtype=torch.int32)
    elif mv_kind == "edge":
        mv = 2 * torch.randint(-4, 5, shape, generator=gen, dtype=torch.int32) + 1
    else:
        mv = torch.randint(-400, 401, shape, generator=gen, dtype=torch.int32)
    mv = mv.cuda()
    before = (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches)
    inst = motion.CANDIDATE_SADS.instance_launches[f"candidate_sads<2, {r}>"]
    got = motion.candidate_sads(tr, an, mv, r, 2, 2)
    gen_out = motion.candidate_sads(tr, an, mv, r, 2, 2, general=True)
    assert (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert motion.CANDIDATE_SADS.instance_launches[f"candidate_sads<2, {r}>"] == inst + 1
    assert torch.equal(got, gen_out)  # every entry, valid or not
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, 2, 2))


@pytest.mark.parametrize(
    "block,t,h,w,mv_kind",
    [(1, 8, 136, 240, "zero"),    # the top level at 8x8 MV blocks, 4 levels
     (1, 8, 68, 120, "random"),   # and at 16x16, 5 levels
     (1, 1, 136, 240, "edge"),    # per-frame hbma's shape
     (1, 2, 10, 302, "far"),      # fw % 4 == 2, 3 CTAs a row
     (1, 1, 1, 4, "edge"),
     (4, 8, 272, 480, "zero"),    # the top level at 3 levels
     (4, 2, 40, 344, "edge"),
     (8, 8, 544, 960, "zero"),    # the top level at 2 levels
     (8, 1, 24, 48, "far")],
)
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_candidate_sads_blocks_equal_general(gen, block, t, h, w, mv_kind, r):
    # K9's 1x1 kernel and K3's kernel at 4x4 and 8x8 (float32 output)
    # against the general kernel and the plain version on every entry
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    shape = (t, h // block, w // block, 2)
    if mv_kind == "zero":
        mv = torch.zeros(shape, dtype=torch.int32)
    elif mv_kind == "random":
        mv = torch.randint(-14, 15, shape, generator=gen, dtype=torch.int32)
    elif mv_kind == "edge":
        mv = 2 * torch.randint(-2 * block, 2 * block + 1, shape, generator=gen,
                               dtype=torch.int32) + 1
    else:
        mv = torch.randint(-400, 401, shape, generator=gen, dtype=torch.int32)
    mv = mv.cuda()
    name = f"candidate_sads<{block}, {r}>"
    before = (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches)
    inst = motion.CANDIDATE_SADS.instance_launches[name]
    got = motion.candidate_sads(tr, an, mv, r, block, block)
    gen_out = motion.candidate_sads(tr, an, mv, r, block, block, general=True)
    assert (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert motion.CANDIDATE_SADS.instance_launches[name] == inst + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, gen_out)
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, block, block))


# the ratio-2 rectangles (width x height) of 16x8 and 8x16 MV blocks'
# top levels: (block, t, h, w, MVs); 135 block rows at 2x1 (the 1080-row
# frame of 16x8 MV blocks at 4 levels), fw % 4 == 2 and odd widths
RECT_K9_CASES = [
    ((2, 1), 8, 135, 240, "zero"), ((2, 1), 2, 10, 22, "edge"), ((2, 1), 1, 9, 20, "far"),
    ((1, 2), 8, 136, 240, "zero"), ((1, 2), 2, 12, 21, "edge"), ((1, 2), 1, 4, 9 * 4, "far"),
    ((4, 2), 8, 270, 480, "zero"), ((4, 2), 2, 6, 44, "edge"),
    ((2, 4), 8, 272, 480, "zero"), ((2, 4), 2, 12, 22, "edge"),
    ((8, 4), 8, 540, 960, "zero"), ((8, 4), 2, 12, 40, "far"),
    ((4, 8), 8, 544, 960, "zero"), ((4, 8), 2, 24, 20, "edge"),
]


def _rect_mvs(gen, kind, shape, bw, bh, r):
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.int32).cuda()
    if kind == "path":  # doubled propagated MVs, the refine's own inputs
        return (2 * torch.randint(-2 * r, 2 * r + 1, shape, generator=gen,
                                  dtype=torch.int32)).cuda()
    if kind == "edge":  # odd MVs past every frame edge
        reach = 2 * max(bw, bh) + r
        return (2 * torch.randint(-reach, reach + 1, shape, generator=gen,
                                  dtype=torch.int32) + 1).cuda()
    return torch.randint(-400, 401, shape, generator=gen, dtype=torch.int32).cuda()


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block,t,h,w,mv_kind", RECT_K9_CASES)
def test_candidate_sads_rect_blocks_equal_general(gen, block, t, h, w, mv_kind, r):
    # K9's thread-a-block kernel at 2x1, 1x2, 4x2, 2x4 and K3's kernel at
    # 8x4, 4x8 (float32 output) against the general kernel and the plain
    # version on every entry
    bw, bh = block
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    mv = _rect_mvs(gen, mv_kind, (t, h // bh, w // bw, 2), bw, bh, r)
    name = f"candidate_sads<{bw}x{bh}, {r}>"
    before = (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches)
    inst = motion.CANDIDATE_SADS.instance_launches[name]
    got = motion.candidate_sads(tr, an, mv, r, bw, bh)
    gen_out = motion.candidate_sads(tr, an, mv, r, bw, bh, general=True)
    assert (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert motion.CANDIDATE_SADS.instance_launches[name] == inst + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, gen_out)
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, bw, bh))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [(4, 2), (8, 4), (16, 8), (2, 4), (4, 8), (8, 16)])
@pytest.mark.parametrize("kind", ["path", "edge", "far", "large"])
def test_refine_rect_blocks_equal_general(gen, block, kind, r):
    # K3 and K7 at the ratio-2 rectangles of 16x8 and 8x16 MV blocks'
    # refinement levels (4x2, 2x4 on K9's thread-a-block kernel, the others
    # on K3's; "large": 1080p at 16x8, where the split kernel's grid fills
    # the card at r >= 2) against the general kernels, the plain versions
    # and K3 on the stacked pair, every candidate
    bw, bh = block
    t, h, w = (2, -(-1080 // bh) * bh, 1920) if kind == "large" else (2, 5 * bh, 41 * bw)
    stack = _u8(gen, (t + 1, h, w))
    mv = _rect_mvs(gen, "path" if kind == "large" else kind, (t, h // bh, w // bw, 2),
                   bw, bh, r)
    name = f"<{bw}x{bh}, {r}>"
    inst = motion.REFINE_SADS.instance_launches["refine_sads" + name]
    got = motion.refine_sads(stack, mv, r, bw, bh)
    assert motion.REFINE_SADS.instance_launches["refine_sads" + name] == inst + 1
    assert torch.equal(got, motion.refine_sads(stack, mv, r, bw, bh, general=True))
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, bw, bh))
    # K7 on frames 0 and 1, each plane 16-byte aligned (K7's gate)
    tr, an, mv0 = stack[0].clone(), stack[1].clone(), mv[0].contiguous()
    inst = motion.REFINE_MADS.instance_launches["refine_mads" + name]
    pair = motion.refine_mads(tr, an, mv0, r, bw, bh)
    assert motion.REFINE_MADS.instance_launches["refine_mads" + name] == inst + 1
    assert torch.equal(pair, got[0])
    assert torch.equal(pair, motion.refine_mads(tr, an, mv0, r, bw, bh, general=True))


def _checkerboard(h, w, bw, bh):
    """255 over every other bw x bh block of an h x w plane, 0 elsewhere."""
    by = torch.arange(h)[:, None] // bh
    bx = torch.arange(w)[None, :] // bw
    return (((by + bx) % 2 == 0).to(torch.uint8) * 255).cuda()


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [(32, 32), (32, 16), (16, 32)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("kind", ["path", "edge", "far", "large", "saturated"])
def test_refine_wide_blocks_equal_general(gen, block, kind, r):
    # K3 and K7 at level 0 of 32x32, 32x16 and 16x32 MV blocks ("large": a
    # 1088x1920 stack of 9 frames, where the split kernel's grid fits the
    # card; "saturated": anchor 255 against tracked 0 over whole blocks, a
    # block's SAD 255 BW BH, past 2^16) against the general kernels, the
    # plain versions and K3 on the stacked pair, every candidate
    bw, bh = block
    t, h, w = (8, 1088, 1920) if kind == "large" else (2, 5 * bh, 41 * bw)
    stack = _u8(gen, (t + 1, h, w))
    if kind == "saturated":
        stack.zero_()
        stack[1::2] = _checkerboard(h, w, bw, bh)
    mv = _rect_mvs(gen, kind if kind in ("edge", "far") else "path",
                   (t, h // bh, w // bw, 2), bw, bh, r)
    name = motion._instance(bw, bh, r)
    inst = motion.REFINE_SADS.instance_launches["refine_sads" + name]
    got = motion.refine_sads(stack, mv, r, bw, bh)
    assert motion.REFINE_SADS.instance_launches["refine_sads" + name] == inst + 1
    assert torch.equal(got, motion.refine_sads(stack, mv, r, bw, bh, general=True))
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, bw, bh))
    if kind == "saturated":
        assert int(got.max()) == 255 * bw * bh
    tr, an, mv0 = stack[0].clone(), stack[1].clone(), mv[0].contiguous()
    inst = motion.REFINE_MADS.instance_launches["refine_mads" + name]
    pair = motion.refine_mads(tr, an, mv0, r, bw, bh)
    assert motion.REFINE_MADS.instance_launches["refine_mads" + name] == inst + 1
    assert torch.equal(pair, got[0])
    assert torch.equal(pair, motion.refine_mads(tr, an, mv0, r, bw, bh, general=True))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [(16, 16), (16, 8), (8, 16)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("t,h,w,kind", [(8, 544, 960, "zero"), (2, 48, 80, "edge"),
                                        (1, 32, 48, "far"), (8, 544, 960, "saturated")])
def test_candidate_sads_wide_top_blocks_equal_general(gen, block, t, h, w, kind, r):
    # K9 on K3's kernel (float32 output) at the top levels of 32x32, 32x16
    # and 16x32 MV blocks at 2 levels (8 x 544x960), saturated too (65,280
    # at 16x16), against the general kernel and the plain version
    bw, bh = block
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    if kind == "saturated":
        tr.zero_()
        an[:] = _checkerboard(h, w, bw, bh)
    mv = _rect_mvs(gen, "zero" if kind == "saturated" else kind,
                   (t, h // bh, w // bw, 2), bw, bh, r)
    name = "candidate_sads" + motion._instance(bw, bh, r)
    inst = motion.CANDIDATE_SADS.instance_launches[name]
    got = motion.candidate_sads(tr, an, mv, r, bw, bh)
    assert motion.CANDIDATE_SADS.instance_launches[name] == inst + 1
    assert torch.equal(got, motion.candidate_sads(tr, an, mv, r, bw, bh, general=True))
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, bw, bh))
    if kind == "saturated":
        assert int(got.max()) == 255 * bw * bh


# the ratio-4 rectangles (width x height) of 32x8 and 8x32 MV blocks'
# refinement levels, and the 1080p level each sits on (1080 rows at 32x8:
# 135 block rows, 60 block columns; 1088 at 8x32)
RATIO4_K3 = [((32, 8), 1080, 1920), ((16, 4), 540, 960), ((8, 2), 270, 480),
             ((8, 32), 1088, 1920), ((4, 16), 544, 960), ((2, 8), 272, 480)]


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block,lh,lw", RATIO4_K3, ids=lambda b: (
    f"{b[0]}x{b[1]}" if isinstance(b, tuple) else str(b)))
@pytest.mark.parametrize("kind", ["path", "edge", "far", "large", "saturated"])
def test_refine_ratio4_blocks_equal_general(gen, block, lh, lw, kind, r):
    # K3 and K7 at the levels of 32x8 and 8x32 MV blocks (8x2, 2x8 on K9's
    # thread-a-block kernel, the others on K3's; "large": the 1080p level,
    # 9 frames; "saturated": anchor 255 against tracked 0 over whole
    # blocks, 65,280 at 32x8 and 8x32) against the general kernels, the
    # plain versions and K3 on the stacked pair, every candidate
    bw, bh = block
    t, h, w = (8, lh, lw) if kind == "large" else (2, 5 * bh, 41 * bw)
    stack = _u8(gen, (t + 1, h, w))
    if kind == "saturated":
        stack.zero_()
        stack[1::2] = _checkerboard(h, w, bw, bh)
    mv = _rect_mvs(gen, kind if kind in ("edge", "far") else "path",
                   (t, h // bh, w // bw, 2), bw, bh, r)
    name = motion._instance(bw, bh, r)
    inst = motion.REFINE_SADS.instance_launches["refine_sads" + name]
    got = motion.refine_sads(stack, mv, r, bw, bh)
    assert motion.REFINE_SADS.instance_launches["refine_sads" + name] == inst + 1
    assert torch.equal(got, motion.refine_sads(stack, mv, r, bw, bh, general=True))
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, bw, bh))
    if kind == "saturated":
        assert int(got.max()) == 255 * bw * bh
    tr, an, mv0 = stack[0].clone(), stack[1].clone(), mv[0].contiguous()
    inst = motion.REFINE_MADS.instance_launches["refine_mads" + name]
    pair = motion.refine_mads(tr, an, mv0, r, bw, bh)
    assert motion.REFINE_MADS.instance_launches["refine_mads" + name] == inst + 1
    assert torch.equal(pair, got[0])
    assert torch.equal(pair, motion.refine_mads(tr, an, mv0, r, bw, bh, general=True))


# K9 at the top levels of 32x8 and 8x32 MV blocks at 4, 3 and 2 levels: 4x1,
# 1x4, 8x2, 2x8 on the thread-a-block kernel, 16x4, 4x16 on K3's (T = 8 at
# the 1080p level; small planes with odd widths where the block allows)
RATIO4_K9 = [((4, 1), 8, 135, 240), ((1, 4), 8, 136, 240), ((8, 2), 8, 270, 480),
             ((2, 8), 8, 272, 480), ((16, 4), 8, 540, 960), ((4, 16), 8, 544, 960)]


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("block,t,h,w", RATIO4_K9, ids=lambda b: (
    f"{b[0]}x{b[1]}" if isinstance(b, tuple) else str(b)))
@pytest.mark.parametrize("kind", ["zero", "edge", "far", "small", "saturated"])
def test_candidate_sads_ratio4_top_blocks_equal_general(gen, block, t, h, w, kind, r):
    # against the general kernel and the plain version; "small": 3 frames of
    # 7 x 9 blocks (odd widths at 1x4), "saturated": 255 BW BH a block
    bw, bh = block
    if kind == "small":
        t, h, w = 3, 7 * bh, 9 * bw
        if h * w % 4:  # the thread-a-block kernel's gate: planes of whole words
            h *= 4
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    if kind == "saturated":
        tr.zero_()
        an[:] = _checkerboard(h, w, bw, bh)
    mv = _rect_mvs(gen, "zero" if kind in ("saturated", "zero") else
                   ("edge" if kind == "small" else kind), (t, h // bh, w // bw, 2), bw, bh, r)
    name = "candidate_sads" + motion._instance(bw, bh, r)
    inst = motion.CANDIDATE_SADS.instance_launches[name]
    got = motion.candidate_sads(tr, an, mv, r, bw, bh)
    assert motion.CANDIDATE_SADS.instance_launches[name] == inst + 1
    assert torch.equal(got, motion.candidate_sads(tr, an, mv, r, bw, bh, general=True))
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, bw, bh))
    if kind == "saturated":
        assert int(got.max()) == 255 * bw * bh


@pytest.mark.parametrize("r", [5, 6, 7, 8])
@pytest.mark.parametrize("kind", ["path", "edge", "far", "large", "saturated"])
@pytest.mark.parametrize("b", [16, 8, 4, 32, 2])
def test_refine_far_radii_equal_general(gen, kind, r, b):
    # K3 and K7 at 16x16, 8x8 and 4x4 blocks and R = 5-8 (levels 0, 1 and 2
    # of 16x16 MV blocks at 2-4 levels, ranges 10-71: one candidate row at a
    # time), at 32x32 (level 0 of 32x32 MV blocks at 2-5 levels) and 2x2
    # (the thread-a-block kernel, its rows streamed: level 2 of 8x8 MV
    # blocks at 4 levels); "large": the 1080p level, 9 frames, where the
    # split kernel's grid fits the card at 8x8; "saturated": 255 B^2 a
    # block, 261,120 at 32x32) against the general kernels, the plain
    # versions and K3 on the stacked pair, every candidate
    level = {32: (1088, 1920), 16: (1088, 1920), 8: (544, 960), 4: (272, 480), 2: (272, 480)}
    t, h, w = (8, *level[b]) if kind == "large" else (2, 5 * b, 41 * b)
    stack = _u8(gen, (t + 1, h, w))
    if kind == "saturated":
        stack.zero_()
        stack[1::2] = _checkerboard(h, w, b, b)
    mv = _rect_mvs(gen, kind if kind in ("edge", "far") else "path",
                   (t, h // b, w // b, 2), b, b, r)
    name = motion._instance(b, b, r)
    inst = motion.REFINE_SADS.instance_launches["refine_sads" + name]
    got = motion.refine_sads(stack, mv, r, b, b)
    assert motion.REFINE_SADS.instance_launches["refine_sads" + name] == inst + 1
    assert torch.equal(got, motion.refine_sads(stack, mv, r, b, b, general=True))
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, b, b))
    if kind == "saturated":
        assert int(got.max()) == 255 * b * b
    tr, an, mv0 = stack[0].clone(), stack[1].clone(), mv[0].contiguous()
    inst = motion.REFINE_MADS.instance_launches["refine_mads" + name]
    pair = motion.refine_mads(tr, an, mv0, r, b, b)
    assert motion.REFINE_MADS.instance_launches["refine_mads" + name] == inst + 1
    assert torch.equal(pair, got[0])
    assert torch.equal(pair, motion.refine_mads(tr, an, mv0, r, b, b, general=True))


@pytest.mark.parametrize("r", [5, 6, 7, 8])
@pytest.mark.parametrize("block,h,w", [(16, 1088, 1920), (8, 544, 960), (4, 272, 480),
                                       (2, 136, 240), (1, 136, 240), (1, 68, 120)])
@pytest.mark.parametrize("kind", ["zero", "edge", "far", "small", "saturated"])
def test_candidate_sads_far_radii_equal_general(gen, block, h, w, kind, r):
    # K9 at 16x16 (one level, ranges 5-8: 8 x 1088x1920), 8x8, 4x4 and 2x2
    # (the top of 2, 3 and 4 levels: 8 x 544x960, 272x480, 136x240) and 1x1
    # (the top of 8x8 MV blocks at 4 levels and of 16x16 at 5: 8 x 136x240,
    # 68x120) at R = 5-8 against the general kernel and the plain version;
    # "small": 3 frames of 7 x 9 blocks (8 x 12 at 1x1: whole words)
    b = block
    t = 8
    if kind == "small":
        t, h, w = (3, 8, 12) if b == 1 else (3, 7 * b, 9 * b)
    tr, an = _u8(gen, (t, h, w)), _u8(gen, (t, h, w))
    if kind == "saturated":
        tr.zero_()
        an[:] = _checkerboard(h, w, b, b)
    mv = _rect_mvs(gen, "zero" if kind in ("saturated", "zero") else
                   ("edge" if kind == "small" else kind), (t, h // b, w // b, 2), b, b, r)
    name = "candidate_sads" + motion._instance(b, b, r)
    inst = motion.CANDIDATE_SADS.instance_launches[name]
    got = motion.candidate_sads(tr, an, mv, r, b, b)
    assert motion.CANDIDATE_SADS.instance_launches[name] == inst + 1
    assert torch.equal(got, motion.candidate_sads(tr, an, mv, r, b, b, general=True))
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, r, b, b))
    if kind == "saturated":
        assert int(got.max()) == 255 * b * b


def test_candidate_sads_1x1_odd_plane_takes_the_general_kernel(gen):
    # 5x7 planes are no whole number of words: the 1x1 kernel's loads would
    # leave the last plane, so the general kernel takes them
    tr, an = _u8(gen, (2, 5, 7)), _u8(gen, (2, 5, 7))
    mv = torch.randint(-3, 4, (2, 5, 7, 2), generator=gen, dtype=torch.int32).cuda()
    before = (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches)
    got = motion.candidate_sads(tr, an, mv, 1, 1, 1)
    assert (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, 1, 1, 1))


def test_candidate_sads_unaligned_takes_the_general_kernel(gen):
    # the 2x2 kernel loads aligned words: a tracked stack 2 bytes into its
    # buffer goes to the general kernel, with the same SADs
    flat = _u8(gen, (2 * 2 * 16 * 24 + 2,))
    tr = flat[2:2 + 2 * 16 * 24].view(2, 16, 24)
    an = flat[:2 * 16 * 24].view(2, 16, 24)
    assert tr.data_ptr() % 4 != 0
    mv = torch.randint(-3, 4, (2, 8, 12, 2), generator=gen, dtype=torch.int32).cuda()
    before = (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches)
    got = motion.candidate_sads(tr, an, mv, 1, 2, 2)
    assert (motion.CANDIDATE_SADS.launches, motion.CANDIDATE_SADS_GENERAL.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, 1, 2, 2))


@pytest.mark.parametrize(
    "shape,levels",
    [((9, 1088, 1920), 4), ((2, 1087, 1919), 4), ((3, 5, 7), 4), ((1, 1, 40), 4),
     ((2, 40, 1), 3), ((1, 768, 1366), 4), ((2, 70, 530), 2), ((1, 130, 66), 5),
     ((1, 1, 1), 4), ((2, 37, 51), 3)],
)
def test_pyr_down_levels_equals_chained_plain(gen, shape, levels):
    x = _u8(gen, shape)
    launches = -(-(levels - 1) // 3)
    before = (pyramid.PYR_DOWN_LEVELS.launches, pyramid.PYR_DOWN.launches)
    pyr = pyramid.build_pyramid(x, levels)
    assert (pyramid.PYR_DOWN_LEVELS.launches, pyramid.PYR_DOWN.launches) == (
        before[0] + launches, before[1])
    ref = x
    for lvl in range(1, levels):
        ref = pyramid.pyr_down_plain(ref)
        assert torch.equal(pyr[lvl], ref), f"level {lvl}"
    assert all(torch.equal(a, b) for a, b in
               zip(pyr, pyramid.build_pyramid(x, levels, general=True)))


def test_pyr_down_levels_unaligned_input(gen):
    # a stack that starts 3 bytes into its buffer takes the byte loads
    flat = _u8(gen, (2 * 64 * 320 + 3,))
    x = flat[3:].view(2, 64, 320)
    assert x.data_ptr() % 16 != 0
    got = pyramid.pyr_down_levels(x, 3)
    ref = x
    for lvl in range(3):
        ref = pyramid.pyr_down_plain(ref)
        assert torch.equal(got[lvl], ref)


def test_refine_sads_static_and_ebma_on_card(gen):
    tr, an = _u8(gen, (2, 64, 96)), _u8(gen, (2, 64, 96))
    mv = 2 * torch.randint(-6, 7, (2, 4, 6, 2), generator=gen,
                           dtype=torch.int32).cuda()
    got = motion.refine_sads_static(tr, an, mv, 4, 16, 16, 12)
    assert torch.equal(got, motion.candidate_sads_plain(tr, an, mv, 4, 16, 16))
    mv_g, mm_g = motion.ebma(tr, an, 2, 4, 4)
    mv_c, mm_c = motion.ebma(tr.cpu(), an.cpu(), 2, 4, 4)
    assert torch.equal(mv_g.cpu(), mv_c) and torch.equal(mm_g.cpu(), mm_c)


@pytest.mark.parametrize("tbw", [4, 8])
@pytest.mark.parametrize("n,h,w", [(3, 64, 128), (2, 40, 104), (1, 8, 16)])
def test_pyr_down_pitched_bit_equal(gen, tbw, n, h, w):
    # one level on the fused kernel (D = 1) and on the general one
    x = _u8(gen, (n, h, w))
    y8 = pyramid.to_pitched(x, tbw)
    before = _k8_pyr_launches()
    got = pyramid.pyr_down_pitched(y8)
    got_g = pyramid.pyr_down_pitched(y8, general=True)
    assert _k8_pyr_launches() == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, got_g)
    assert torch.equal(got, pyramid.pyr_down_pitched_plain(y8))
    assert torch.equal(got, pyramid.pyr_down_plain(x))


def _k8_pyr_launches():
    return (pyramid.PYR_DOWN_PITCHED_LEVELS.launches,
            pyramid.PYR_DOWN_PITCHED_GENERAL.launches)


@pytest.mark.parametrize(
    "tbw,n,h,w",
    [(8, 9, 1088, 1920),  # the 1080p path
     (8, 2, 64, 1376),    # nbx 172 (% 16 == 12)
     (8, 2, 40, 536),     # nbx 67: odd, byte loads
     (4, 2, 48, 1000),    # nbx 250 (% 4 == 2): byte loads
     (4, 3, 64, 512),     # 4-byte loads
     (8, 1, 8, 16)],      # a small frame: one tile, reflect at every edge
)
@pytest.mark.parametrize("halvings", [1, 2, 3])
def test_pyr_down_pitched_levels_equals_chained(gen, tbw, n, h, w, halvings):
    # one launch, bit-equal to the fused spatial K4 on the respatialized
    # input, to the general chain (the general K8 level, then the
    # single-level K4) and to the chained plain versions
    x = _u8(gen, (n, h, w))
    y8 = pyramid.to_pitched(x, tbw)
    before = (*_k8_pyr_launches(), pyramid.PYR_DOWN.launches)
    got = pyramid.pyr_down_pitched_levels(y8, halvings)
    assert (*_k8_pyr_launches(), pyramid.PYR_DOWN.launches) == (
        before[0] + 1, before[1], before[2])
    chain = pyramid.pyr_down_pitched_levels(y8, halvings, general=True)
    assert _k8_pyr_launches()[1] == before[1] + 1
    spatial = pyramid.pyr_down_levels(x, halvings)
    ref = x
    for lvl in range(halvings):
        ref = pyramid.pyr_down_plain(ref)
        assert torch.equal(got[lvl], ref), f"level {lvl + 1}"
        assert torch.equal(got[lvl], spatial[lvl]) and torch.equal(got[lvl], chain[lvl])


def test_pyr_down_pitched_levels_unaligned_input(gen):
    # subplanes 1 byte into their buffer take the byte loads, same bytes
    flat = _u8(gen, (8 * 2 * 64 * 40 + 1,))
    y8 = flat[1:].view(8, 2, 64, 40)
    assert y8.data_ptr() % 2 != 0
    got = pyramid.pyr_down_pitched_levels(y8, 3)
    ref = pyramid.respatialize(y8)
    for lvl in range(3):
        ref = pyramid.pyr_down_plain(ref)
        assert torch.equal(got[lvl], ref)


def test_pyr_down_pitched_levels_in_a_cuda_graph(gen):
    y8 = pyramid.to_pitched(_u8(gen, (3, 64, 512)), 8)
    want = pyramid.pyr_down_pitched_levels(y8, 3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pyramid.pyr_down_pitched_levels(y8, 3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = pyramid.pyr_down_pitched_levels(y8, 3)
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, want))


def _k8_launches():
    return (motion.REFINE_SADS_PITCHED.launches,
            motion.REFINE_SADS_PITCHED_GENERAL.launches)


@pytest.mark.parametrize("tbw", [4, 8])
@pytest.mark.parametrize("block,r,bound", [(8, 1, 6), (16, 1, 14), (16, 2, 20),
                                           (16, 1, 40)])
def test_refine_sads_pitched_bit_equal(gen, tbw, block, r, bound):
    # 5 block columns: the subplane rows (nbx 10 or 5 at tbw 8) are not
    # whole 4-byte words, so every case here takes the general kernel; the
    # next test holds the specialised one
    stack = _u8(gen, (3, 4 * block, 5 * block))
    y8 = pyramid.to_pitched(stack, tbw)
    mv = torch.randint(-bound, bound + 1, (2, 4, 5, 2), generator=gen,
                       dtype=torch.int32).cuda()
    special = (tbw, block, r) == (8, 16, 1) and y8.shape[3] % 4 == 0
    before = _k8_launches()
    got = motion.refine_sads_pitched(y8, mv, r, block, block)
    assert _k8_launches() == (before[0] + special, before[1] + (not special))
    assert torch.equal(got, motion.refine_sads_pitched_plain(y8, mv, r, block, block))
    assert torch.equal(got, motion.refine_sads_plain(stack, mv, r, block, block))


@pytest.mark.parametrize(
    "t,h,w,kind",
    [(8, 64, 1920, "path"),   # the 1080p path's width, even MVs within 14
     (2, 96, 1376, "wide"),   # nbx 172 (% 16 == 12), MVs within +-40
     (2, 48, 352, "edge"),    # CIF width, odd MVs past every edge
     (1, 32, 512, "reach"),   # MVs at the band's edge and one past it
     (1, 16, 32, "wide")],    # a 1x2 field
)
def test_refine_sads_pitched_specialised_equals_general(gen, t, h, w, kind):
    # every candidate, valid or not, bit-equal across the two kernels, the
    # plain version and K3 on the spatial stack; blocks whose MV leaves the
    # staged band read global memory
    stack = _u8(gen, (t + 1, h, w))
    y8 = pyramid.to_pitched(stack, 8)
    shape = (t, h // 16, w // 16, 2)
    if kind == "path":
        mv = 2 * torch.randint(-7, 8, shape, generator=gen, dtype=torch.int32)
    elif kind == "wide":
        mv = torch.randint(-40, 41, shape, generator=gen, dtype=torch.int32)
    elif kind == "edge":
        mv = 2 * torch.randint(-8, 8, shape, generator=gen, dtype=torch.int32) + 1
    else:
        mv = torch.tensor([-16, -15, 15, 16], dtype=torch.int32)[
            torch.randint(0, 4, shape, generator=gen)]
    mv = mv.cuda()
    before = _k8_launches()
    got = motion.refine_sads_pitched(y8, mv, 1, 16, 16)
    gen_out = motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=True)
    assert _k8_launches() == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, gen_out)
    assert torch.equal(got, motion.refine_sads_pitched_plain(y8, mv, 1, 16, 16))
    assert torch.equal(got, motion.refine_sads(stack, mv, 1, 16, 16))


def test_refine_sads_pitched_unaligned_takes_the_general_kernel(gen):
    # the specialised kernel loads 4-byte words of the subplanes: a stack 2
    # bytes into its buffer, and subplane rows of 6 bytes (nbx % 4 == 2),
    # go to the general kernel, with the same SADs
    flat = _u8(gen, (8 * 3 * 32 * 64 + 2,))
    y8 = flat[2:].view(8, 3, 32, 64)
    assert y8.data_ptr() % 4 != 0
    narrow = pyramid.to_pitched(_u8(gen, (3, 32, 48)), 8)
    for x in (y8, narrow):
        mv = torch.randint(-20, 21, (2, 2, x.shape[3] // 2, 2), generator=gen,
                           dtype=torch.int32).cuda()
        before = _k8_launches()
        got = motion.refine_sads_pitched(x, mv, 1, 16, 16)
        assert _k8_launches() == (before[0], before[1] + 1)
        assert torch.equal(got, motion.refine_sads_pitched_plain(x, mv, 1, 16, 16))


@pytest.mark.parametrize("general", [False, True])
def test_refine_sads_pitched_in_a_cuda_graph(gen, general):
    # the wrapper, captured in a CUDA graph and replayed, writes the SADs of
    # a direct call
    y8 = pyramid.to_pitched(_u8(gen, (3, 64, 512)), 8)
    mv = torch.randint(-20, 21, (2, 4, 32, 2), generator=gen, dtype=torch.int32).cuda()
    want = motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=general)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=general)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=general)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_hbma_on_card_matches_cpu(gen):
    stack = _u8(gen, (2, 64, 128))
    stack[1, :, 3:] = stack[0, :, :-3]  # a 3-pixel pan
    pyr = pyramid.build_pyramid(stack, 4)
    before = motion.REFINE_MADS.launches
    mv, mm = motion.hbma([p[0] for p in pyr], [p[1] for p in pyr], 8, 16, 16)
    assert motion.REFINE_MADS.launches == before + 3
    cpu = [p.cpu() for p in pyr]
    mv_c, mm_c = motion.hbma([p[0] for p in cpu], [p[1] for p in cpu], 8, 16, 16)
    assert torch.equal(mv.cpu(), mv_c) and torch.equal(mm.cpu(), mm_c)
    gm = motion.estimate_global_motion_hierarchical(
        [p[0] for p in pyr], [p[1] for p in pyr], 8)
    gm_c = motion.estimate_global_motion_hierarchical(
        [p[0] for p in cpu], [p[1] for p in cpu], 8)
    assert torch.equal(gm.cpu(), gm_c)


def _dct_kernel(block, channels=3):
    """The K2 kernel a square block shape dispatches to."""
    if (block, channels) == (8, 3):
        return dct.DCT_WIRE
    if channels == 3 and (block, block) in dct.DCT_WIRE_SQ:
        return dct.DCT_WIRE_SQ[block, block]
    return dct.DCT_WIRE_GENERAL


def _idct_kernel(block, channels=3):
    """The K1 kernel a square block shape dispatches to."""
    if (block, channels) == (8, 3):
        return dct.IDCT_DISPLAY
    if channels == 3 and (block, block) in dct.IDCT_DISPLAY_SQ:
        return dct.IDCT_DISPLAY_SQ[block, block]
    return dct.IDCT_DISPLAY_GENERAL


def _hw(block):
    """``(block_h, block_w)`` of a test's block: ``B`` for a square, or
    ``"BHxBW"``."""
    if isinstance(block, int):
        return block, block
    return tuple(int(v) for v in block.split("x"))


# the templated K2 / K1 / K6 shapes: the squares, then the rectangles
SQ_BLOCKS = [4, 16, "4x8", "8x4", "4x16", "16x4", "8x16", "16x8"]
# the templated kernels also take the blocks with a side of 2, and those
# with a side of 1
THIN_BLOCKS = [2, "2x4", "4x2", "2x8", "8x2", "2x16", "16x2"]
SIDE_1_BLOCKS = [1, "1x2", "2x1", "1x4", "4x1", "1x8", "8x1", "1x16", "16x1"]
K12_BLOCKS = SQ_BLOCKS + THIN_BLOCKS + SIDE_1_BLOCKS
# where the exact decode puts many display bytes on halves (integer
# dequantized coefficients through a 1- or 2-point transform)
TIE_BLOCKS = ((2, 2), (1, 1))


def _held_to_plain_display(got, coeffs, steps, out_h, bh, bw):
    """K1's bytes against its plain version: within 1, and under 1e-3 of
    the bytes differing; at 2x2 and 1x1, where ~17% and ~5% of the bytes
    are exact ties of the float64 decode (tools/display_ties.py) that
    float32 summing order may round either way, under 1e-3 off the
    ties."""
    ref = dct.idct_display_plain(coeffs, steps, out_h, 3, bh, bw)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs().cpu().numpy()
    assert d.max() <= 1
    if (bh, bw) in TIE_BLOCKS:
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, out_h, 3, bh, bw)).reshape(d.shape)
        d = d[~ties]
    assert (d > 0).mean() < 1e-3


@pytest.mark.parametrize(
    "h,w,ph,pw,block",
    [(120, 128, 128, 128, 8), (16, 20, 16, 32, 8), (136, 192, 144, 192, 8),
     (30, 36, 32, 40, 4), (30, 36, 32, 40, 2), (40, 36, 48, 48, 16)],
)
def test_dct_to_wire_matches_plain(gen, h, w, ph, pw, block):
    packed = _u8(gen, (3, h, w * 3))
    kernel = _dct_kernel(block)
    before = kernel.launches
    got = dct.dct8x8_to_wire(packed, 1, 2, ph, pw, block, block)
    assert kernel.launches == before + 1
    ref = dct.dct8x8_to_wire_plain(packed, 1, 2, ph, pw, block, block)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= COEFF_GATE


@pytest.mark.parametrize(
    "nby,nbx,out_h,block",
    [(16, 16, 120, 8), (16, 16, 128, 8), (31, 32, 248, 8), (2, 3, 9, 8),
     (10, 12, 37, 4), (9, 13, 33, 4), (10, 12, 19, 2), (4, 5, 60, 16)],
)
def test_idct_display_matches_plain(gen, nby, nbx, out_h, block):
    n = block * block
    coeffs = (torch.randn((2, nby, nbx, 3 * n), generator=gen) * 90).cuda()
    steps = torch.where(
        torch.rand((2, nby, nbx), generator=gen) < 0.5, 640.0, 1.0
    ).cuda()
    kernel = _idct_kernel(block)
    before = kernel.launches
    got = dct.idct_display(coeffs, steps, out_h, 3, block, block)
    assert kernel.launches == before + 1
    ref = dct.idct_display_plain(coeffs, steps, out_h, 3, block, block)
    assert got.shape == (2, out_h, nbx * block * 3)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    assert d.max().item() <= 1
    assert (d > 0).double().mean().item() < 1e-3


@pytest.mark.parametrize(
    "t,h,w,ph,pw",
    [(8, 64, 200, 64, 208),   # 26 block columns: a ragged last strip
     (1, 40, 128, 48, 128),   # T = 1, zero-padded rows
     (2, 24, 1366, 24, 1376),  # 4098-byte rows: 2-byte aligned starts
     (3, 17, 37, 24, 40)],    # odd row bytes, ragged rows and columns
)
def test_dct8x8_specialised_equals_general(gen, t, h, w, ph, pw):
    packed = _u8(gen, (t + 1, h, w * 3))
    before = (dct.DCT_WIRE.launches, dct.DCT_WIRE_GENERAL.launches)
    got = dct.dct8x8_to_wire(packed, 1, t, ph, pw)
    gen_out = dct.dct8x8_to_wire(packed, 1, t, ph, pw, general=True)
    assert (dct.DCT_WIRE.launches, dct.DCT_WIRE_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, gen_out)  # bit for bit
    ref = dct.dct8x8_to_wire_plain(packed, 1, t, ph, pw, 8, 8)
    assert (got - ref).abs().max().item() <= COEFF_GATE


@pytest.mark.parametrize(
    "t,nby,nbx,out_h",
    [(8, 36, 26, 282),   # ragged strip, resample over several bands
     (1, 37, 17, 296),   # T = 1, identity, nby not a band multiple
     (2, 13, 3, 100),    # odd nbx: row starts not 16-byte aligned
     (3, 20, 44, 160)],  # identity, CIF width
)
def test_idct_display_specialised_equals_general(gen, t, nby, nbx, out_h):
    coeffs = (torch.randn((t, nby, nbx, 192), generator=gen) * 90).cuda()
    steps = torch.where(
        torch.rand((t, nby, nbx), generator=gen) < 0.5, 640.0, 1.0
    ).cuda()
    before = (dct.IDCT_DISPLAY.launches, dct.IDCT_DISPLAY_GENERAL.launches)
    got = dct.idct_display(coeffs, steps, out_h)
    gen_out = dct.idct_display(coeffs, steps, out_h, general=True)
    assert (dct.IDCT_DISPLAY.launches, dct.IDCT_DISPLAY_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, gen_out)  # byte for byte
    ref = dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    assert d.max().item() <= 1
    assert (d > 0).double().mean().item() < 1e-3


@pytest.mark.parametrize("block", K12_BLOCKS)
@pytest.mark.parametrize(
    "t,h,w,ph,pw",
    [(8, 64, 208, 64, 208),    # a ragged last strip at every block shape
     (1, 40, 128, 48, 128),    # T = 1, zero-padded rows
     (2, 24, 1366, 32, 1376),  # 4098-byte rows: 2-byte aligned starts
     (3, 17, 37, 32, 48)],     # odd row bytes, ragged rows and columns
)
def test_dct_sq_equals_general(gen, block, t, h, w, ph, pw):
    # the templated kernel bit-equal to the general one, both within the
    # coefficient gate of the plain version
    bh, bw = _hw(block)
    packed = _u8(gen, (t + 1, h, w * 3))
    sq = dct.DCT_WIRE_SQ[bh, bw]
    before = (sq.launches, dct.DCT_WIRE_GENERAL.launches)
    got = dct.dct8x8_to_wire(packed, 1, t, ph, pw, bh, bw)
    gen_out = dct.dct8x8_to_wire(packed, 1, t, ph, pw, bh, bw, general=True)
    assert (sq.launches, dct.DCT_WIRE_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, gen_out)  # bit for bit
    ref = dct.dct8x8_to_wire_plain(packed, 1, t, ph, pw, bh, bw)
    assert (got - ref).abs().max().item() <= COEFF_GATE


@pytest.mark.parametrize("block", K12_BLOCKS)
@pytest.mark.parametrize(
    "t,ph,pw,out_h",
    [(8, 576, 416, 564),  # ragged strip, resample over several bands
     (1, 592, 272, 592),  # T = 1, identity, nby not a band multiple
     (2, 208, 48, 200),   # a strip narrower than a CTA's
     (3, 320, 704, 320)],  # identity, CIF width
)
def test_idct_display_sq_equals_general(gen, block, t, ph, pw, out_h):
    # the templated kernel byte-equal to the general one, both within the
    # display gate of the plain version, at a gaze mix of steps 1 and 640
    # (the decoder's)
    bh, bw = _hw(block)
    nby, nbx = ph // bh, pw // bw
    coeffs = (torch.randn((t, nby, nbx, 3 * bh * bw), generator=gen)
              * 90).cuda()
    steps = torch.where(
        torch.rand((t, nby, nbx), generator=gen) < 0.5, 640.0, 1.0
    ).cuda()
    sq = dct.IDCT_DISPLAY_SQ[bh, bw]
    before = (sq.launches, dct.IDCT_DISPLAY_GENERAL.launches)
    got = dct.idct_display(coeffs, steps, out_h, 3, bh, bw)
    gen_out = dct.idct_display(coeffs, steps, out_h, 3, bh, bw, general=True)
    assert (sq.launches, dct.IDCT_DISPLAY_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, gen_out)  # byte for byte
    _held_to_plain_display(got, coeffs, steps, out_h, bh, bw)


@pytest.mark.parametrize("block", THIN_BLOCKS + SIDE_1_BLOCKS)
def test_thin_blocks_partial_last_step(gen, block):
    # a side of 1 or 2: a CTA of K2 and a walk step of K1 take several
    # block rows (8 pixel rows; one at 8x1, 16x2 and 16x1), and here the
    # frame's last step is partial (one block row more than whole steps);
    # both bit- / byte-equal to the general kernels, K1 resampled and with
    # identity rows
    bh, bw = _hw(block)
    step = dct._K2_SQ_GEOM[bh, bw][2]
    assert step == dct._K1_SQ_GEOM[bh, bw][3]
    nby = 3 * step + 1
    ph, pw = nby * bh, 208
    packed = _u8(gen, (3, ph - 1, pw * 3))
    got = dct.dct8x8_to_wire(packed, 1, 2, ph, pw, bh, bw)
    assert torch.equal(got, dct.dct8x8_to_wire(packed, 1, 2, ph, pw, bh, bw,
                                               general=True))
    coeffs = (torch.randn((2, nby, pw // bw, 3 * bh * bw), generator=gen)
              * 90).cuda()
    steps = torch.where(torch.rand(coeffs.shape[:3], generator=gen) < 0.5,
                        640.0, 1.0).cuda()
    for out_h in (ph - 2, ph):
        got = dct.idct_display(coeffs, steps, out_h, 3, bh, bw)
        assert torch.equal(got, dct.idct_display(coeffs, steps, out_h, 3, bh,
                                                 bw, general=True))
        _held_to_plain_display(got, coeffs, steps, out_h, bh, bw)


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_sq_kernels_in_a_cuda_graph(gen, block):
    # both wrappers, captured in one CUDA graph and replayed, write the
    # bytes of direct calls: their tables and matrices need no host copy
    bh, bw = _hw(block)
    packed = _u8(gen, (3, 120, 208 * 3))
    coeffs = (torch.randn((2, 128 // bh, 208 // bw, 3 * bh * bw),
                          generator=gen) * 90).cuda()
    steps = torch.where(torch.rand(coeffs.shape[:3], generator=gen) < 0.5,
                        640.0, 1.0).cuda()

    def both():
        return (dct.dct8x8_to_wire(packed, 1, 2, 128, 208, bh, bw),
                dct.idct_display(coeffs, steps, 120, 3, bh, bw))

    want = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    for o in out:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_square_blocks_on_card_match_cpu(gen, block):
    # EncoderConfig with 1x1, 2x2, 4x4 or 16x16 transform blocks, or a
    # rectangle of sides 4, 8 and 16 or with a side of 1 or 2: the
    # templated kernels of that shape on both legs and no other K1 or K2,
    # graph replays byte-equal to graph=False, the stream's coefficients
    # and the decoded bytes within the gates of the CPU port (at 2x2 and
    # 1x1 off the exact ties)
    bh, bw = _hw(block)
    w, h = 160, 112
    clip = make_clip(w, h, 6, seed=bh * 17 + bw)
    cfg = EncoderConfig(transform_block_w=bw, transform_block_h=bh)
    props = VideoProperties(w, h, len(clip))
    others = [k.name for k in (*dct.DCT_WIRE_SQ.values(),
                               *dct.IDCT_DISPLAY_SQ.values())
              if k.name not in (dct.DCT_WIRE_SQ[bh, bw].name,
                                dct.IDCT_DISPLAY_SQ[bh, bw].name)]
    build.reset_launch_counts()
    cuda_stream = list(Encoder(cfg, props, 2, device="cuda").encode_video(iter(clip)))
    counts = build.launch_counts()
    assert counts[dct.DCT_WIRE_SQ[bh, bw].name] > 0
    assert counts["dct8x8_to_wire"] == counts["dct_to_wire_general"] == 0
    assert not any(counts[k] for k in others)
    eager = list(Encoder(cfg, props, 2, device="cuda", graph=False)
                 .encode_video(iter(clip)))
    assert eager == cuda_stream
    cpu_stream = list(Encoder(cfg, props, 2, device="cpu").encode_video(iter(clip)))
    assert cuda_stream[0] == cpu_stream[0]
    header = bitstream.Header.unpack(cuda_stream[0])
    for a, b in zip(cuda_stream[1:], cpu_stream[1:]):
        ta, ca = bitstream.deserialize_frame_blocks(a, header)
        tb, cb = bitstream.deserialize_frame_blocks(b, header)
        np.testing.assert_array_equal(ta, tb)
        assert np.abs(ca - cb).max() <= COEFF_GATE
    gaze = [(w // 2, h // 2)] * (len(clip) - 1)
    frames = {}
    build.reset_launch_counts()
    for device, graph in (("cuda", True), ("cuda", False), ("cpu", True)):
        dec = Decoder(DecoderConfig(), header, batch_size=2, device=device,
                      graph=graph)
        frames[device, graph] = np.stack(
            list(dec.decode_frames(iter(cpu_stream[1:]), iter(gaze))))
    counts = build.launch_counts()
    assert counts[dct.IDCT_DISPLAY_SQ[bh, bw].name] > 0
    assert counts["idct_display"] == counts["idct_display_general"] == 0
    assert not any(counts[k] for k in others)
    np.testing.assert_array_equal(frames["cuda", True], frames["cuda", False])
    d = np.abs(frames["cuda", True].astype(np.int16)
               - frames["cpu", True].astype(np.int16))
    assert d.max() <= 1
    if (bh, bw) in TIE_BLOCKS:
        coeffs, steps = display_ties.decode_inputs(header, cpu_stream[1:], gaze)
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, h, 3, bh, bw))
        d = d.reshape(ties.shape)[~ties]
    assert (d > 0).mean() < 1e-3


def _lloyd_inputs(gen, f, n, k, attempts=3, d=4):
    """Integer motion-like features, masks (frame 0 empty), seeded centers."""
    x = torch.randint(-8, 9, (f, d, n), generator=gen).float()
    x[:, 2:] *= 16  # block coordinates
    mask = torch.rand((f, n), generator=gen) < 0.4
    mask[0] = False
    keys = prng.split(prng.fold_in(prng.key(5), torch.arange(f)), attempts)
    init = kmeans._plus_plus_init(keys, x, mask, k).transpose(0, 1)
    return x.cuda(), mask.cuda(), init.contiguous().cuda()


@pytest.mark.parametrize("f,n,k", [(3, 1, 2), (2, 37, 5), (4, 1000, 10),
                                   (2, 8160, 10), (2, 5003, 16)])
def test_lloyd_bit_equal(gen, f, n, k):
    x, mask, init = _lloyd_inputs(gen, f, n, k)
    before = kmeans.LLOYD.launches
    got = kmeans.lloyd(x, mask, init, k, 10, 1.0)
    assert kmeans.LLOYD.launches == before + 1
    ref = kmeans.lloyd_plain(x, mask, init, k, 10, 1.0)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
    again = kmeans.lloyd(x, mask, init, k, 10, 1.0)
    for a, b in zip(got, again):  # fixed reduction trees: same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "f,n,k,d,kernel",
    [(3, 1, 2, 4, "lloyd"),          # seven empty slices
     (2, 37, 5, 4, "lloyd"),
     (2, 8160, 10, 4, "lloyd"),      # 1080p
     (2, 32400, 16, 7, "lloyd"),     # 4K, the most clusters and features
     (1, 200000, 10, 4, "lloyd_general")],  # a slice past shared memory
)
def test_lloyd_cluster_equals_general(gen, f, n, k, d, kernel):
    x, mask, init = _lloyd_inputs(gen, f, n, k, d=d)
    before = (kmeans.LLOYD.launches, kmeans.LLOYD_GENERAL.launches)
    got = kmeans.lloyd(x, mask, init, k, 10, 1.0)
    gen_out = kmeans.lloyd(x, mask, init, k, 10, 1.0, general=True)
    cluster = kernel == "lloyd"
    assert (kmeans.LLOYD.launches, kmeans.LLOYD_GENERAL.launches) == (
        before[0] + cluster, before[1] + 2 - cluster)
    ref = kmeans.lloyd_plain(x, mask, init, k, 10, 1.0)
    for out in (got, gen_out):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        torch.testing.assert_close(out[2], ref[2], rtol=1e-6, atol=0)
    again = kmeans.lloyd(x, mask, init, k, 10, 1.0)
    for a, b in zip(got, again):  # fixed reduction order: same bits
        assert torch.equal(a, b)


def test_lloyd_few_distinct_points(gen):
    # fewer distinct valid points than clusters: empty clusters every
    # iteration, repaired from the farthest points
    x = torch.randint(0, 2, (2, 3, 300), generator=gen).float() * 5
    mask = torch.rand((2, 300), generator=gen) < 0.7
    init = x[:, :, :6].transpose(1, 2)[None].expand(2, -1, -1, -1).contiguous()
    x, mask, init = x.cuda(), mask.cuda(), init.cuda()
    ref = kmeans.lloyd_plain(x, mask, init, 6, 10, 1.0)
    for general in (False, True):
        got = kmeans.lloyd(x, mask, init, 6, 10, 1.0, general=general)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


_FRESH_LLOYD = """
import torch
from svc_tpu_torch.ops import kmeans, prng
f, n, k, d = 2, {n}, 10, {d}
g = torch.Generator().manual_seed(3)
x = torch.randint(-8, 9, (f, d, n), generator=g).float()
x[:, 2:] *= 16
mask = torch.rand((f, n), generator=g) < 0.4
keys = prng.split(prng.fold_in(prng.key(5), torch.arange(f)), 3)
init = kmeans._plus_plus_init(keys, x, mask, k).transpose(0, 1).contiguous()
x, mask, init = x.cuda(), mask.cuda(), init.cuda()
got = kmeans.lloyd(x, mask, init, k, 10, 1.0)
assert kmeans.LLOYD.launches == 1
ref = kmeans.lloyd_plain(x, mask, init, k, 10, 1.0)
gen_out = kmeans.lloyd(x, mask, init, k, 10, 1.0, general=True)
for out in (got, gen_out):
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    torch.testing.assert_close(out[2], ref[2], rtol=1e-6, atol=0)
"""


@pytest.mark.parametrize("n,d", [(14400, 4),   # 2560x1440: 42,240 B dynamic
                                 (8160, 7)])   # 1080p, D = 7: 34,816 B
def test_lloyd_cluster_first_launch_past_48k_with_static(gen, n, d):
    # dynamic shared memory under 48 KB that passes 48 KB with the kernel's
    # static part, launched first in a fresh process: no earlier launch
    # has raised the kernel's limit
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _FRESH_LLOYD.format(n=n, d=d)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _k6_inputs(gen, w, h, t=2, block=8):
    # the decoder's padded geometry: 16-pixel MV blocks
    bh, bw = _hw(block)
    pw, ph = -(-w // 16) * 16, -(-h // 16) * 16
    nby, nbx = ph // bh, pw // bw
    coeffs = (torch.randn((t, nby, nbx, 3 * bh * bw), generator=gen)
              * 90).cuda()
    steps = torch.where(
        torch.rand((t, nby, nbx), generator=gen) < 0.5, 640.0, 1.0
    ).cuda()
    return coeffs, steps, pw


@pytest.mark.parametrize("w,h", [(120, 64), (200, 120), (854, 480), (1366, 768)])
def test_idct_resize_display_matches_plain(gen, w, h):
    # the specialised kernel byte-equal to the general one, both within
    # the display gate of the plain version
    coeffs, steps, pw = _k6_inputs(gen, w, h)
    before = (dct.IDCT_RESIZE.launches, dct.IDCT_RESIZE_GENERAL.launches)
    got = dct.idct_resize_display(coeffs, steps, h, w)
    got_g = dct.idct_resize_display(coeffs, steps, h, w, general=True)
    assert (dct.IDCT_RESIZE.launches, dct.IDCT_RESIZE_GENERAL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, got_g)
    ref = dct.idct_resize_display_plain(coeffs, steps, h, w, 3, 8, 8)
    assert got.shape == (2, h, w * 3)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    assert d.max().item() <= 1
    assert (d > 0).double().mean().item() < 1e-3
    assert not bilinear_axis_weights(w, pw)[3]  # the columns were blended


@pytest.mark.parametrize("general", [False, True])
def test_idct_resize_display_in_a_cuda_graph(gen, general):
    # the wrapper, captured in a CUDA graph and replayed, writes the bytes
    # of a direct call: no call copies from host memory once its geometry
    # is cached
    coeffs, steps, _ = _k6_inputs(gen, 854, 480)
    want = dct.idct_resize_display(coeffs, steps, 480, 854, general=general)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dct.idct_resize_display(coeffs, steps, 480, 854, general=general)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dct.idct_resize_display(coeffs, steps, 480, 854, general=general)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _k6_launches():
    return (dct.IDCT_RESIZE.launches, dct.IDCT_RESIZE_GENERAL.launches,
            *(k.launches for k in dct.IDCT_RESIZE_SQ.values()))


@pytest.mark.parametrize("block,channels", [(2, 1), (8, 1), (4, 1), (16, 1),
                                            ("2x4", 4), ("4x2", 2), ("16x2", 1),
                                            (1, 2), ("3x3", 3), ("6x12", 3)])
def test_idct_resize_display_other_shapes_take_the_general_kernel(gen, block,
                                                                  channels):
    # K6 has no templated kernel for channels other than 3 or sides outside
    # {1, 2, 4, 8, 16}: they stay on the general one
    bh, bw = _hw(block)
    pw, ph, w, h = 208 // bw * bw, 128 // bh * bh, 200, 120
    nby, nbx = ph // bh, pw // bw
    n = channels * bh * bw
    coeffs = (torch.randn((2, nby, nbx, n), generator=gen) * 90).cuda()
    steps = torch.where(torch.rand((2, nby, nbx), generator=gen) < 0.5,
                        640.0, 1.0).cuda()
    before = _k6_launches()
    got = dct.idct_resize_display(coeffs, steps, h, w, channels, bh, bw)
    assert _k6_launches() == (before[0], before[1] + 1, *before[2:])
    ref = dct.idct_resize_display_plain(coeffs, steps, h, w, channels, bh, bw)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    assert d.max().item() <= 1
    assert (d > 0).double().mean().item() < 1e-3


def _held_to_plain_resize(got, coeffs, steps, h, w, bh, bw):
    """K6's bytes against its plain version: within 1, and under 1e-3 of
    the bytes differing; at a side of 1 or 2, where integer dequantized
    coefficients through a 1- or 2-point transform put bytes on exact
    halves of the float64 decode (tools/display_ties.py) that float32
    summing order may round either way, under 1e-3 off those ties."""
    ref = dct.idct_resize_display_plain(coeffs, steps, h, w, 3, bh, bw)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs().cpu().numpy()
    assert d.max() <= 1
    if {1, 2} & {bh, bw}:
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, h, 3, bh, bw, out_w=w)).reshape(d.shape)
        d = d[~ties]
    assert (d > 0).mean() < 1e-3


@pytest.mark.parametrize("block", K12_BLOCKS)
@pytest.mark.parametrize("w,h,t", [
    (120, 64, 2),     # width excess 8, identity rows
    (200, 120, 2),    # both axes resampled
    (854, 480, 3),    # the 854x480 class: 14 strips, several bands
    (1366, 768, 1),   # 4098-byte rows; block columns end mid-strip
    (1270, 714, 2),   # both axes resampled at 1280x720
    (61, 37, 1)])     # one ragged strip, odd row bytes
def test_idct_resize_sq_equals_general(gen, block, w, h, t):
    # the templated K6 byte-equal to the general one, both within the
    # display gate of the plain version (off the exact ties at a side of 1
    # or 2), at a gaze mix of steps 1 and 640
    bh, bw = _hw(block)
    coeffs, steps, _ = _k6_inputs(gen, w, h, t, block)
    sq = dct.IDCT_RESIZE_SQ[bh, bw]
    before = (sq.launches, dct.IDCT_RESIZE_GENERAL.launches, dct.IDCT_RESIZE.launches)
    got = dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw)
    got_g = dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw,
                                    general=True)
    assert (sq.launches, dct.IDCT_RESIZE_GENERAL.launches,
            dct.IDCT_RESIZE.launches) == (before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(got, got_g)  # byte for byte
    assert got.shape == (t, h, w * 3)
    _held_to_plain_resize(got, coeffs, steps, h, w, bh, bw)


@pytest.mark.parametrize("block", ["2x2", "4x2", "2x16", "1x1", "2x1",
                                   "1x16", "8x1"])
def test_idct_resize_sq_partial_last_step(gen, block):
    # padded heights of 2 or 4 rows past a multiple of 8 (MV blocks 2 or 4
    # rows tall): the last walk step holds fewer block rows than the others
    bh, bw = _hw(block)
    for w, h, ph in ((61, 37, 42), (100, 41, 44)):
        ph -= ph % bh
        pw = -(-w // 16) * 16
        nby, nbx = ph // bh, pw // bw
        coeffs = (torch.randn((2, nby, nbx, 3 * bh * bw), generator=gen)
                  * 90).cuda()
        steps = torch.where(torch.rand((2, nby, nbx), generator=gen) < 0.5,
                            640.0, 1.0).cuda()
        sq = dct.IDCT_RESIZE_SQ[bh, bw]
        before = sq.launches
        got = dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw)
        assert sq.launches == before + 1
        assert torch.equal(got, dct.idct_resize_display(
            coeffs, steps, h, w, 3, bh, bw, general=True))
        _held_to_plain_resize(got, coeffs, steps, h, w, bh, bw)


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_idct_resize_sq_in_a_cuda_graph(gen, block):
    # the templated wrapper, captured in a CUDA graph and replayed, writes
    # the bytes of a direct call: its tables need no host copy
    bh, bw = _hw(block)
    coeffs, steps, _ = _k6_inputs(gen, 854, 480, 2, block)
    want = dct.idct_resize_display(coeffs, steps, 480, 854, 3, bh, bw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dct.idct_resize_display(coeffs, steps, 480, 854, 3, bh, bw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dct.idct_resize_display(coeffs, steps, 480, 854, 3, bh, bw)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_wrappers_reject_bad_inputs(gen):
    with pytest.raises(TypeError):
        pyramid.pyr_down(torch.zeros((2, 8, 8), dtype=torch.int32, device="cuda"))
    stack = _u8(gen, (3, 32, 32))
    with pytest.raises(TypeError):
        motion.refine_sads(stack, torch.zeros((2, 2, 2, 2), device="cuda"), 1, 16, 16)
    zero_mv = torch.zeros((2, 2, 2, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="candidate_sads"):
        # a 116x116 window per warp needs more than the default 48 KB
        motion.candidate_sads(stack[:2], stack[1:], zero_mv, 50, 16, 16)
    with pytest.raises(ValueError, match="multiple of tbw"):
        motion.refine_sads_pitched(pyramid.to_pitched(stack, 8), zero_mv, 1, 12, 16)
    with pytest.raises(ValueError, match="H % 8"):
        pyramid.pyr_down_pitched(pyramid.to_pitched(stack[:, :30], 8))
    with pytest.raises(TypeError):
        dct.idct_display(torch.zeros((1, 2, 2, 192), device="cuda"),
                         torch.ones((1, 2, 3), device="cuda"), 16)
    with pytest.raises(TypeError):
        dct.idct_resize_display(torch.zeros((1, 2, 2, 100), device="cuda"),
                                torch.ones((1, 2, 2), device="cuda"), 16, 15)
    x = torch.zeros((1, 4, 8), device="cuda")
    with pytest.raises(ValueError):  # k above K5's 16 clusters
        kmeans.lloyd(x, torch.ones((1, 8), dtype=torch.bool, device="cuda"),
                     torch.zeros((1, 1, 17, 4), device="cuda"), 17, 10, 1.0)
    with pytest.raises(TypeError):
        kmeans.lloyd(x, torch.ones((1, 8), device="cuda"),
                     torch.zeros((1, 1, 2, 4), device="cuda"), 2, 10, 1.0)


@pytest.mark.parametrize("w,h", [(128, 120), (128, 128), (96, 72)])
def test_port_on_card_matches_port_on_cpu(gen, w, h):
    clip = make_clip(w, h, 6, seed=w + h)
    cfg = EncoderConfig(reference_compat=True)
    props = VideoProperties(w, h, len(clip))
    build.reset_launch_counts()
    cuda_stream = list(Encoder(cfg, props, 2, device="cuda").encode_video(iter(clip)))
    counts = build.launch_counts()
    assert counts["pyr_down_levels"] > 0 and counts["refine_sads"] > 0
    assert counts["candidate_sads"] > 0  # the top-level EBMA
    assert counts["dct8x8_to_wire"] > 0
    cpu_stream = list(Encoder(cfg, props, 2, device="cpu").encode_video(iter(clip)))
    assert cuda_stream[0] == cpu_stream[0]
    header = bitstream.Header.unpack(cuda_stream[0])
    for a, b in zip(cuda_stream[1:], cpu_stream[1:]):
        ta, ca = bitstream.deserialize_frame_blocks(a, header)
        tb, cb = bitstream.deserialize_frame_blocks(b, header)
        np.testing.assert_array_equal(ta, tb)
        assert np.abs(ca - cb).max() <= COEFF_GATE
    gaze = [(w // 2, h // 2)] * (len(clip) - 1)
    frames = {}
    for device in ("cuda", "cpu"):
        dec = Decoder(DecoderConfig(), header, batch_size=2, device=device)
        frames[device] = np.stack(
            list(dec.decode_frames(iter(cpu_stream[1:]), iter(gaze)))
        )
    assert build.launch_counts()["idct_display"] > 0
    d = np.abs(frames["cuda"].astype(np.int16) - frames["cpu"].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("w,h", [(128, 120), (120, 64)])
def test_default_config_on_card_matches_cpu(gen, w, h):
    # EncoderConfig(): k-means through K5; 120x64 decodes through K6
    clip = make_clip(w, h, 6, seed=w * h)
    props = VideoProperties(w, h, len(clip))
    build.reset_launch_counts()
    cuda_stream = list(Encoder(EncoderConfig(), props, 2, device="cuda")
                       .encode_video(iter(clip)))
    assert build.launch_counts()["lloyd"] > 0
    cpu_stream = list(Encoder(EncoderConfig(), props, 2, device="cpu")
                      .encode_video(iter(clip)))
    assert cuda_stream[0] == cpu_stream[0]
    header = bitstream.Header.unpack(cuda_stream[0])
    for a, b in zip(cuda_stream[1:], cpu_stream[1:]):
        ta, ca = bitstream.deserialize_frame_blocks(a, header)
        tb, cb = bitstream.deserialize_frame_blocks(b, header)
        np.testing.assert_array_equal(ta, tb)
        assert np.abs(ca - cb).max() <= COEFF_GATE
    gaze = [(w // 2, h // 2)] * (len(clip) - 1)
    frames = {}
    for device in ("cuda", "cpu"):
        dec = Decoder(DecoderConfig(), header, batch_size=2, device=device)
        frames[device] = np.stack(
            list(dec.decode_frames(iter(cpu_stream[1:]), iter(gaze)))
        )
    kernel = "idct_display" if header.frame_w == header.padded_frame_w else "idct_resize_display"
    assert build.launch_counts()[kernel] > 0
    d = np.abs(frames["cuda"].astype(np.int16) - frames["cpu"].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def _direct_stream(enc, clip):
    """Header, then direct per-batch encode + ``.cpu()`` + serialize: no
    stager, nothing in flight, pageable copies both ways."""
    out_payloads, i, n, t = [enc.header().pack()], 0, len(clip), enc.batch_size
    tbh, tbw = enc.cfg.transform_block_h, enc.cfg.transform_block_w
    while i + 1 < n:
        n_valid = min(t, n - 1 - i)
        window = clip[i:i + n_valid + 1]
        if n_valid < t:
            window = np.concatenate([window, np.repeat(window[-1:], t - n_valid, 0)])
        out = enc.encode_batch(window, i)
        c = out["coeffs"].cpu().numpy()
        c = c.reshape(c.shape[0], c.shape[1], c.shape[2], -1, tbh, tbw)
        btypes = out["block_types"].cpu().numpy().astype(np.uint32)
        for k in range(n_valid):
            out_payloads.append(bitstream.serialize_frame_blocks(
                c[k], btypes[k], enc.cfg.mv_block_w, enc.cfg.mv_block_h))
        i += n_valid
    return out_payloads


@pytest.mark.parametrize("n", [13, 15])  # 3 full batches + a remainder; 3 + 2 of 2
def test_staged_stream_equals_direct_on_card(gen, n):
    # four batches back to back through the pinned buffers and both copy
    # streams: a missing event wait shows up as a byte difference
    clip = make_clip(128, 96, n, seed=n)
    enc = Encoder(EncoderConfig(), VideoProperties(128, 96, n), 4, device="cuda")
    staged = list(enc.encode_video(iter(clip)))
    assert staged == _direct_stream(enc, clip)


def test_one_encoder_two_clips_back_to_back(gen):
    # the pinned buffers are reused across clips and calls
    a, b = make_clip(128, 96, 10, seed=1), make_clip(128, 96, 10, seed=2)
    enc = Encoder(EncoderConfig(), VideoProperties(128, 96, 10), 4, device="cuda")
    got = [list(enc.encode_video(iter(c))) for c in (a, b, a)]
    fresh = Encoder(EncoderConfig(), VideoProperties(128, 96, 10), 4, device="cuda")
    assert got[0] == got[2] == _direct_stream(fresh, a)
    assert got[1] == _direct_stream(fresh, b) and got[1] != got[0]


def test_staged_frames_wait_and_record_on_compute_stream(gen, monkeypatch):
    clip = make_clip(128, 96, 5, seed=3)
    enc = Encoder(EncoderConfig(), VideoProperties(128, 96, 5), 4, device="cuda")
    recorded = []
    original = torch.Tensor.record_stream

    def spy(self, stream):
        recorded.append((self.data_ptr(), stream))
        return original(self, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    staged = enc.stage_frames(list(clip))
    assert staged.event is not None and staged.tensor.is_cuda
    compute = torch.cuda.current_stream()
    packed = staged.take()
    assert recorded == [(packed.data_ptr(), compute)]
    out = enc.encode_packed(packed, 0)
    torch.cuda.synchronize()
    assert torch.equal(packed.cpu(), torch.as_tensor(clip).reshape(5, 96, 384))
    ref = enc.encode_batch(clip, 0)
    assert torch.equal(out["coeffs"], ref["coeffs"])


@pytest.mark.parametrize("w,h", [(128, 96), (120, 64)])  # K1; K6
def test_decode_staged_equals_unstaged_on_card(gen, w, h):
    clip = make_clip(w, h, 12, seed=w)
    stream = list(Encoder(EncoderConfig(), VideoProperties(w, h, 12), 4, device="cuda")
                  .encode_video(iter(clip)))
    header = bitstream.Header.unpack(stream[0])
    dec = Decoder(DecoderConfig(), header, batch_size=3, device="cuda")
    gaze = [(w // 2, h // 2)] * 11
    staged = list(dec.decode_frames(iter(stream[1:]), iter(gaze)))
    plain = list(dec.decode_frames(iter(stream[1:]), iter(gaze), stage_h2d=False))
    assert len(staged) == 11
    for a, b in zip(staged, plain):
        np.testing.assert_array_equal(a, b)
    # the frames handed out are not views of the reused pinned buffers:
    # another decode through the same decoder leaves them as they were
    snapshot = [f.copy() for f in staged]
    list(dec.decode_frames(iter(stream[:0:-1]), iter(gaze)))
    for a, b in zip(staged, snapshot):
        np.testing.assert_array_equal(a, b)
    cpu = Decoder(DecoderConfig(), header, batch_size=3, device="cpu")
    want = np.stack(list(cpu.decode_frames(iter(stream[1:]), iter(gaze))))
    d = np.abs(np.stack(staged).astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("n", [396, 1626, 8160])
def test_choice_on_card_equals_cpu(gen, n):
    # the without-replacement draw on the card: threefry, the stable sort
    # and the row chunks give the CPU's indices
    keys = prng.split(prng.fold_in(prng.key(7), torch.arange(3)), 40)
    want = prng.choice(keys, n, 8)
    got = prng.choice(keys.cuda(), n, 8)
    assert torch.equal(got.cpu(), want)


def test_sort_by_keys_on_card_keeps_equal_keys_in_order(gen):
    words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    bits = words[torch.randint(0, 5, (4, 3000), generator=gen)]
    values = torch.randperm(4 * 3000, generator=gen).reshape(4, 3000)
    want = prng.sort_by_keys(values, bits)
    assert torch.equal(prng.sort_by_keys(values.cuda(), bits.cuda()).cpu(), want)


@pytest.mark.parametrize("subset", [2, 3, 8])
def test_ransac_subsets_on_card_equal_cpu(gen, subset):
    from svc_tpu_torch.config import RansacParams
    from svc_tpu_torch.ops import ransac

    mv = torch.randint(-3, 4, (3, 17, 30, 2), generator=gen).float()
    mv[:, 4:12, 5:20] += 6  # a moving region
    keys = prng.fold_in(prng.key(1), torch.arange(3))
    p = RansacParams(subset_sz=subset)
    want = ransac.estimate_global_motion_ransac(mv, p, keys)
    got = ransac.estimate_global_motion_ransac(mv.cuda(), p, keys.cuda())
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-6, atol=0)
    assert torch.equal(got[2].cpu(), want[2])


def test_split_over_one_card_equals_single_device(gen):
    # the frame-parallel split over [cuda:0, cuda:0], 2 anchors a chunk:
    # the single-device stream and frames, a padded remainder batch included
    from svc_tpu_torch.parallel.sharding import ShardedEncoder, make_frame_devices

    clip = make_clip(128, 96, 8, seed=3)
    props = VideoProperties(128, 96, 8)
    devs = make_frame_devices(devices=["cuda:0", "cuda:0"])
    want = list(Encoder(EncoderConfig(), props, 4, device="cuda")
                .encode_video(iter(clip)))
    got = list(ShardedEncoder(EncoderConfig(), props, devs, batch_per_device=2)
               .encode_video(iter(clip)))
    assert got == want
    header = bitstream.Header.unpack(want[0])
    gaze = [(64, 48)] * 7
    single = Decoder(DecoderConfig(), header, batch_size=4, device="cuda")
    split = Decoder(DecoderConfig(), header, batch_size=4, devices=devs)
    a = np.stack(list(single.decode_frames(iter(want[1:]), iter(gaze))))
    b = np.stack(list(split.decode_frames(iter(want[1:]), iter(gaze))))
    np.testing.assert_array_equal(a, b)


def test_split_over_distinct_cards_equals_single_device(gen, tmp_path):
    # each chunk on its own card (up to 4): the kernels launch under that
    # card's context, the outputs gather on cuda:0; the library and the
    # CLIs give the single-device stream and frames
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    from svc_tpu_torch.apps import decoder_app, encoder_app
    from svc_tpu_torch.parallel.sharding import ShardedEncoder, make_frame_devices

    n = min(4, torch.cuda.device_count())
    devs = make_frame_devices(n, device="cuda")
    assert devs == [torch.device("cuda", i) for i in range(n)]
    clip = make_clip(128, 96, 2 * n + 4, seed=5)
    props = VideoProperties(128, 96, len(clip))
    want = list(Encoder(EncoderConfig(), props, 2 * n, device="cuda")
                .encode_video(iter(clip)))
    got = list(ShardedEncoder(EncoderConfig(), props, devs, batch_per_device=2)
               .encode_video(iter(clip)))
    assert got == want
    header = bitstream.Header.unpack(want[0])
    gaze = [(64, 48)] * (len(want) - 1)
    single = Decoder(DecoderConfig(), header, batch_size=2 * n, device="cuda")
    split = Decoder(DecoderConfig(), header, batch_size=2 * n, devices=devs)
    a = np.stack(list(single.decode_frames(iter(want[1:]), iter(gaze))))
    b = np.stack(list(split.decode_frames(iter(want[1:]), iter(gaze))))
    np.testing.assert_array_equal(a, b)
    clip_path, svc = str(tmp_path / "clip.npy"), str(tmp_path / "clip.svc")
    np.save(clip_path, clip)
    assert encoder_app.main(["enc", "--device", "cuda", "--devices", str(n),
                             "--batch-size", "2", "--verbose", "0",
                             "--output", svc, clip_path]) == 0
    assert Path(svc).read_bytes() == b"".join(want)
    out = str(tmp_path / "dec.npy")
    assert decoder_app.main(["dec", "--device", "cuda", "--devices", str(n),
                             "--gaze", "64,48", "--input", svc,
                             "--output", out]) == 0
    np.testing.assert_array_equal(np.load(out), a)


# ---------------------------------------------------------------------------
# K10, K11 and the compiled encode batch
# ---------------------------------------------------------------------------


def _snake(h, w):
    lab = -torch.ones((1, h, w), dtype=torch.int32)
    lab[0, ::2, :] = 0
    lab[0, 1::4, -1] = 0
    lab[0, 3::4, 0] = 0
    return lab


@pytest.mark.parametrize(
    "kind,b,h,w,k,connectivity,global_memory",
    [("random", 8, 68, 120, 10, 4, False),   # the 1080p path shape
     ("random", 8, 68, 120, 10, 8, False),
     ("random", 8, 68, 120, 10, 4, True),    # the general global-memory loop
     ("blobs", 8, 68, 120, 10, 4, False),
     ("blobs", 2, 135, 240, 10, 8, False),   # 4K: bands of 17 rows
     ("blobs", 1, 250, 200, 6, 4, False),    # past the general kernel's smem
     ("blobs", 1, 540, 960, 6, 8, False),    # past the cluster's capacity
     ("own", 1, 37, 53, 37 * 53, 8, False),  # every cell its own cluster
     ("snake", 1, 61, 61, 1, 4, False),
     ("snake", 1, 61, 61, 1, 4, True),
     ("snake", 1, 251, 199, 1, 8, False)],   # a snake past shared memory
)
def test_ccl_converge_bit_equal(gen, kind, b, h, w, k, connectivity, global_memory):
    if kind == "random":
        lab = torch.randint(-1, k, (b, h, w), generator=gen, dtype=torch.int32)
    elif kind == "blobs":  # a few clusters in large regions, background between
        lab = torch.randint(0, k, (b, h // 8 + 1, w // 8 + 1), generator=gen,
                            dtype=torch.int32)
        lab = lab.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w]
        lab = torch.where(torch.rand((b, h, w), generator=gen) < 0.1, -1, lab)
    elif kind == "own":
        lab = torch.randperm(h * w, generator=gen).to(torch.int32).reshape(1, h, w)
    else:
        lab = _snake(h, w)
    want = ccl.converge_labels_plain(lab, connectivity)
    # the default route (the cluster kernel where a band fits), then the
    # general kernel
    fits = not global_memory and ccl.band_cells(h, w) <= ccl.K10_BAND_CELLS
    for kernel, general in ((ccl.CCL_CONVERGE if fits else ccl.CCL_CONVERGE_GENERAL,
                             False), (ccl.CCL_CONVERGE_GENERAL, True)):
        before = kernel.launches
        got = ccl.converge_labels(lab.cuda(), connectivity, general=general,
                                  global_memory=global_memory)
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), want)
    bt, ct = ccl.block_types_from_clusters(lab.cuda(), max(k, 1), connectivity)
    bt_ref, ct_ref = ccl.block_types_from_clusters(lab, max(k, 1), connectivity)
    assert torch.equal(bt.cpu(), bt_ref) and torch.equal(ct.cpu(), ct_ref)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(ccl_cases.adversarial()))
def test_ccl_converge_adversarial(gen, name, connectivity):
    lab = ccl_cases.adversarial()[name]
    want = ccl.converge_labels_plain(lab, connectivity)
    for kernel, general in ((ccl.CCL_CONVERGE, False), (ccl.CCL_CONVERGE_GENERAL, True)):
        before = kernel.launches
        outs = [ccl.converge_labels(lab.cuda(), connectivity, general=general)
                for _ in range(20)]
        assert kernel.launches == before + 20
        for got in outs:
            assert torch.equal(got.cpu(), want)


def test_ccl_converge_in_a_cuda_graph(gen):
    lab = torch.randint(-1, 10, (8, 68, 120), generator=gen, dtype=torch.int32).cuda()
    want = ccl.converge_labels_plain(lab.cpu(), 4)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ccl.converge_labels(lab, 4)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = ccl.converge_labels(lab, 4)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize(
    "lead,shape",
    [((8, 3), (10, 8160)),  # the k-means++ seeding draw of a 1080p batch
     ((8,), (7, 1)),        # RANSAC's randint bit streams
     ((2, 2), (5,)), ((1,), (1,))],
)
def test_threefry_random_bits_bit_equal(gen, lead, shape):
    keys = prng.fold_in(prng.key(11), torch.arange(int(np.prod(lead))))
    keys = keys.reshape(lead + (2,))
    before = prng.THREEFRY.launches
    got = prng.random_bits(keys.cuda(), shape)
    assert prng.THREEFRY.launches == before + 1
    assert torch.equal(got.cpu(), prng.random_bits(keys, shape))
    want = prng.threefry_words_plain(keys.cuda(), int(np.prod(shape)), both=False)
    assert torch.equal(got.reshape(want.shape), want)


def test_threefry_split_fold_in_uniform_randint_bit_equal(gen):
    base = prng.key(2**40 + 3)
    idx = torch.arange(5, 13)
    anchors = prng.fold_in(base.cuda(), idx.cuda())
    assert torch.equal(anchors.cpu(), prng.fold_in(base, idx))
    assert torch.equal(prng.fold_in(base.cuda(), 2**32 - 1).cpu(),
                       prng.fold_in(base, 2**32 - 1))
    pair = prng.split(anchors)
    assert torch.equal(pair.cpu(), prng.split(anchors.cpu()))
    attempts = prng.split(pair[:, 1], 3)
    assert torch.equal(attempts.cpu(), prng.split(pair[:, 1].cpu(), 3))
    u = prng.uniform(attempts, (10, 8160), 1e-12, 1.0)
    assert torch.equal(u.cpu(), prng.uniform(attempts.cpu(), (10, 8160), 1e-12, 1.0))
    r = prng.randint(pair[:, 0], (7, 1), 0, 8160)
    assert torch.equal(r.cpu(), prng.randint(pair[:, 0].cpu(), (7, 1), 0, 8160))


def test_graph_stream_equals_eager_over_17_and_13_frames(gen):
    # the CUDA graph replay (two graphs by turns, a padded remainder batch
    # on the same graphs) against graph=False, byte for byte
    for n in (17, 13):
        clip = make_clip(128, 96, n, seed=n)
        props = VideoProperties(128, 96, n)
        graph = Encoder(EncoderConfig(), props, 8, device="cuda")
        eager = Encoder(EncoderConfig(), props, 8, device="cuda", graph=False)
        assert graph.graph and not eager.graph
        got = list(graph.encode_video(iter(clip)))
        assert got == list(eager.encode_video(iter(clip)))
        assert got == _direct_stream(eager, clip)
        assert list(graph._graphs) == [(9, 96, 384)]  # one shape, remainder included


def test_graph_outputs_fetched_one_batch_late(gen):
    # the output-overlap hazard: batch i's outputs are copied to the host
    # while batch i + 1 replays; the two graphs of a shape keep them intact
    from svc_tpu_torch.runtime.staging import PinnedDownload

    clip = make_clip(128, 96, 33, seed=9)
    props = VideoProperties(128, 96, 33)
    graph = Encoder(EncoderConfig(), props, 8, device="cuda")
    eager = Encoder(EncoderConfig(), props, 8, device="cuda", graph=False)
    download = PinnedDownload()
    packed = [torch.as_tensor(clip[i:i + 9]).reshape(9, 96, 384).cuda()
              for i in range(0, 32, 8)]
    pending, fetched = None, []
    for i, p in enumerate(packed):
        out = graph.encode_packed(p, 8 * i)
        fetch = download.start({"coeffs": out["coeffs"],
                                "block_types": out["block_types"]})
        if pending is not None:
            fetched.append({k: v.copy() for k, v in pending.wait().items()})
        pending = fetch
    fetched.append({k: v.copy() for k, v in pending.wait().items()})
    for i, (p, got) in enumerate(zip(packed, fetched)):
        want = eager.encode_packed(p, 8 * i)
        np.testing.assert_array_equal(got["coeffs"], want["coeffs"].cpu().numpy())
        np.testing.assert_array_equal(got["block_types"],
                                      want["block_types"].cpu().numpy())


def test_graph_replay_counts_its_launches_and_keeps_planes(gen):
    clip = make_clip(128, 96, 9, seed=4)
    props = VideoProperties(128, 96, 9)
    graph = Encoder(EncoderConfig(), props, 8, device="cuda", keep_planes=True)
    eager = Encoder(EncoderConfig(), props, 8, device="cuda", graph=False,
                    keep_planes=True)
    packed = torch.as_tensor(clip).reshape(9, 96, 384).cuda()
    graph.encode_packed(packed, 0)  # warm-up and capture
    per_replay = graph._graphs[(9, 96, 384)].launches_per_replay()
    assert per_replay["ccl_converge"] == 1 and per_replay["lloyd"] == 1
    assert "ccl_converge_general" not in per_replay
    assert per_replay["threefry2x32"] == 6  # split, RANSAC 3, seeding 2
    build.reset_launch_counts()
    out = graph.encode_packed(packed, 0)
    counts = build.launch_counts()
    for name, n in per_replay.items():
        want = n + (1 if name == "threefry2x32" else 0)  # the anchor keys
        assert counts[name] == want, name
    ref = eager.encode_packed(packed, 0)
    assert set(out) == set(ref) and "padded_planes" in out
    for key in out:
        assert torch.equal(out[key], ref[key]), key


def test_split_with_graphs_equals_eager_single_device(gen):
    from svc_tpu_torch.parallel.sharding import ShardedEncoder, make_frame_devices

    clip = make_clip(128, 96, 12, seed=6)
    props = VideoProperties(128, 96, 12)
    devs = make_frame_devices(devices=["cuda:0", "cuda:0"])
    split = ShardedEncoder(EncoderConfig(), props, devs, batch_per_device=2)
    assert all(e.graph for e in split.inners)
    want = list(Encoder(EncoderConfig(), props, 4, device="cuda", graph=False)
                .encode_video(iter(clip)))
    assert list(split.encode_video(iter(clip))) == want


def test_a_failed_capture_raises(gen):
    # a host sync inside the batch (here: int() of a device tensor in the
    # CCL step) cannot be captured; the encoder raises instead of falling
    # back to the eager path. In a child process: the failed capture must
    # not disturb the other tests' CUDA context.
    code = (
        "import torch\n"
        "from svc_tpu_torch.config import EncoderConfig, VideoProperties\n"
        "from svc_tpu_torch.models import encoder as m\n"
        "from svc_tpu_torch.tools.clips import make_clip\n"
        "orig = m.block_types_from_clusters\n"
        "def syncing(labels, k, c):\n"
        "    int(labels.sum())\n"
        "    return orig(labels, k, c)\n"
        "m.block_types_from_clusters = syncing\n"
        "clip = make_clip(64, 48, 3, seed=1)\n"
        "packed = torch.as_tensor(clip).reshape(3, 48, 192).cuda()\n"
        "eager = m.Encoder(EncoderConfig(), VideoProperties(64, 48, 3), 2,\n"
        "                  device='cuda', graph=False)\n"
        "eager.encode_packed(packed, 0)  # the eager path syncs and runs\n"
        "enc = m.Encoder(EncoderConfig(), VideoProperties(64, 48, 3), 2,\n"
        "                device='cuda')\n"
        "try:\n"
        "    enc.encode_packed(packed, 0)\n"
        "except RuntimeError:\n"
        "    print('raised')\n"
        "else:\n"
        "    print('no error')\n"
    )
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "raised"


# ---------------------------------------------------------------------------
# The compiled decode batch
# ---------------------------------------------------------------------------


_wire_payloads = display_ties.wire_payloads


# 1080p (K1), 1366x768 (K6; at 4x4, 16x16 and 2x2 blocks the templated
# K6), 854x480 at 1x1 blocks (the templated K6), 4x4-, 16x16-, 2x2- and
# 1x1-block CIF (the templated K1), 3x3-block 336x288 (the general K1)
DECODE_GRAPH_CASES = [(1920, 1080, 8, "idct_display"),
                      (1366, 768, 8, "idct_resize_display"),
                      (1366, 768, 4, "idct4x4_resize_display"),
                      (1366, 768, 16, "idct16x16_resize_display"),
                      (1366, 768, 2, "idct2x2_resize_display"),
                      (854, 480, 1, "idct1x1_resize_display"),
                      (352, 288, 4, "idct4x4_display"),
                      (352, 288, 16, "idct16x16_display"),
                      (352, 288, 2, "idct2x2_display"),
                      (336, 288, 3, "idct_display_general"),
                      (352, 288, 1, "idct1x1_display")]


@pytest.mark.parametrize("w,h,block,kernel", DECODE_GRAPH_CASES)
def test_decode_graph_equals_eager(gen, w, h, block, kernel):
    # 7 payloads at batch 4: a padded remainder batch on the same graphs;
    # staged (coefficients straight into the static input) and direct
    header, payloads, gazes = _wire_payloads(w, h, block, 7, seed=w)
    graph = Decoder(DecoderConfig(), header, batch_size=4, device="cuda")
    eager = Decoder(DecoderConfig(), header, batch_size=4, device="cuda",
                    graph=False)
    assert graph.graph and not eager.graph
    want = np.stack(list(eager.decode_frames(iter(payloads), iter(gazes))))
    for stage_h2d in (True, False):
        got = np.stack(list(graph.decode_frames(iter(payloads), iter(gazes),
                                                stage_h2d=stage_h2d)))
        np.testing.assert_array_equal(got, want)
    assert list(graph._graphs) == [(0, 4)]
    assert graph._graphs[(0, 4)].launches_per_replay() == {kernel: 1}
    build.reset_launch_counts()
    list(graph.decode_frames(iter(payloads), iter(gazes)))
    counts = {k: n for k, n in build.launch_counts().items() if n}
    assert counts == {kernel: 2}  # two replays, no warm-up, no other kernel
    cpu = Decoder(DecoderConfig(), header, batch_size=4, device="cpu")
    ref = np.stack(list(cpu.decode_frames(iter(payloads), iter(gazes))))
    d = np.abs(want.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    if block in (1, 2):
        # 2x2 blocks of integer dequantized coefficients put ~17% of the
        # bytes on exact halves, where float32 summing order picks either
        # neighbour (tools/display_ties.py), and 1x1 blocks where rows are
        # blended (none at CIF's identity rows): the gate holds the other
        # bytes
        coeffs, steps = display_ties.decode_inputs(header, payloads, gazes)
        out_w = None if coeffs.shape[2] * block == w else w
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, h, 3, block, block, out_w=out_w))
        if block == 2 and out_w is None:
            assert ties.mean() > 0.1
        d = d[~ties.reshape(d.shape)]
    assert (d > 0).mean() < 1e-3


def test_decode_graph_over_a_device_list_equals_eager(gen):
    from svc_tpu_torch.parallel.sharding import make_frame_devices

    header, payloads, gazes = _wire_payloads(1920, 1080, 8, 7, seed=3)
    devs = make_frame_devices(devices=["cuda:0", "cuda:0"])
    split = Decoder(DecoderConfig(), header, batch_size=4, devices=devs)
    eager = Decoder(DecoderConfig(), header, batch_size=4, device="cuda",
                    graph=False)
    want = np.stack(list(eager.decode_frames(iter(payloads), iter(gazes))))
    for stage_h2d in (True, False):
        got = np.stack(list(split.decode_frames(iter(payloads), iter(gazes),
                                                stage_h2d=stage_h2d)))
        np.testing.assert_array_equal(got, want)
    # one pair per entry, though both entries are cuda:0
    assert sorted(split._graphs) == [(0, 2), (1, 2)]
    assert split._graphs[(0, 2)] is not split._graphs[(1, 2)]


def test_decode_graph_second_stream_keeps_the_first(gen):
    # the frames handed out are copies: a second stream through the same
    # graphs leaves the first stream's frames as they were
    header, payloads, gazes = _wire_payloads(128, 96, 8, 11, seed=4)
    dec = Decoder(DecoderConfig(), header, batch_size=3, device="cuda")
    first = list(dec.decode_frames(iter(payloads), iter(gazes)))
    snapshot = [f.copy() for f in first]
    second = list(dec.decode_frames(iter(payloads[::-1]), iter(gazes[::-1])))
    for a, b in zip(first, snapshot):
        np.testing.assert_array_equal(a, b)
    eager = Decoder(DecoderConfig(), header, batch_size=3, device="cuda",
                    graph=False)
    want = list(eager.decode_frames(iter(payloads[::-1]), iter(gazes[::-1])))
    for a, b in zip(second, want):
        np.testing.assert_array_equal(a, b)


def test_decode_batch_graph_output_valid_until_two_calls_on(gen):
    header, payloads, gazes = _wire_payloads(128, 96, 8, 6, seed=5)
    dec = Decoder(DecoderConfig(), header, batch_size=3, device="cuda")
    eager = Decoder(DecoderConfig(), header, batch_size=3, device="cuda",
                    graph=False)
    batches = []
    for s in (0, 3):
        types, coeffs = zip(*[bitstream.deserialize_frame_blocks(p, header)
                              for p in payloads[s:s + 3]])
        coeffs = np.stack([c.reshape(c.shape[0], c.shape[1], -1) for c in coeffs])
        rects = [dec.padded_gaze_rect(g) for g in gazes[s:s + 3]]
        batches.append((coeffs, np.stack(types), rects))
    a = dec.decode_batch(*batches[0])
    b = dec.decode_batch(*batches[1])
    # call 0's output is the first graph's own, intact after call 1
    assert torch.equal(a, eager.decode_batch(*batches[0]))
    assert torch.equal(b, eager.decode_batch(*batches[1]))
    want = a.clone()
    # call 2 (the first graph again) staged straight into its static input
    staged = dec.stage_coeffs(batches[0][0])
    assert staged.tensor is dec._graphs[(0, 3)]._slots[0].inputs[0]
    assert torch.equal(dec.decode_batch(staged, *batches[0][1:]), want)


def test_a_failed_decode_capture_raises(gen):
    # a host sync inside the decode batch cannot be captured; the decoder
    # raises instead of running eagerly. In a child process, as for the
    # encoder.
    code = (
        "import numpy as np, torch\n"
        "from svc_tpu_torch.config import DecoderConfig\n"
        "from svc_tpu_torch.io import bitstream\n"
        "from svc_tpu_torch.models import decoder as m\n"
        "orig = m.block_quant_steps\n"
        "def syncing(types, gazed, fg, bg):\n"
        "    int(types.sum())\n"
        "    return orig(types, gazed, fg, bg)\n"
        "m.block_quant_steps = syncing\n"
        "hdr = bitstream.Header(2, 64, 48, 0, 0, 8, 8, 3)\n"
        "args = (np.zeros((2, 6, 8, 192), np.float32),\n"
        "        np.zeros((2, 6, 8), np.uint32), np.zeros((2, 4), np.int32))\n"
        "m.Decoder(DecoderConfig(), hdr, 2, device='cuda', graph=False)"
        ".decode_batch(*args)\n"
        "try:\n"
        "    m.Decoder(DecoderConfig(), hdr, 2, device='cuda').decode_batch(*args)\n"
        "except RuntimeError:\n"
        "    print('raised')\n"
        "else:\n"
        "    print('no error')\n"
    )
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "raised"
