"""Port vs svc_tpu: the motion search at square MV blocks past top radius 4
on the level counts the earlier far-radius files leave out: 8x8 MV blocks
at 4 levels (ranges 40-71: K9 1x1 at the top, K3 / K7 2x2, 4x4 and 8x8
below it), 16x16 at 5 levels (ranges 80-143: K9 1x1, K3 / K7 2x2 to 16x16)
and 32x32 at 2 and 5 levels (ranges 10-17 and 80-143: K3 / K7 32x32 at
level 0), R = 5-8. ``hbma_stack``, the per-frame ``hbma`` and one
``Encoder`` batch at 8x8 MV blocks and 4 levels (G20's setting at range
40), bit-equal: MV fields, min-MADs and block types.

The frames are one block row high. At every setting the port's ``hbma``
and its ``hbma_stack`` on the frame pair are held to svc_tpu's ``hbma``
(svc_tpu's own tests hold its ``hbma_stack`` to ``vmap(hbma)``); svc_tpu's
``hbma_stack`` itself, whose eager vmapped refine costs the CPU 15-30 s a
search here, at two settings. Where a refinement level keeps 8 block
columns svc_tpu takes its Pallas refine (``refine_mads_stack_pallas``,
``refine_mads_pallas``, in interpret mode, whose cost grows with its
static MV bound), so one case of each new refinement block runs there at
its smallest radius: ``hbma_stack`` at 8x8 MV blocks and 4 levels, range
40 (K3 2x2), and ``hbma`` at 32x32 and 2 levels, range 10 (K7 32x32). The
others run on 7 block columns, where svc_tpu takes its XLA refine. The
content pans by 5 pixels of the top level, so the top search finds |mv| >
4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.clips import make_clip
from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.models import encoder as j_enc
from svc_tpu.ops import motion as j_motion
from svc_tpu.ops import motion_pallas as j_mp
from svc_tpu.ops import pyramid as j_pyr
from svc_tpu.runtime import layouts as j_layouts
from svc_tpu_torch import config
from svc_tpu_torch.models import encoder as t_enc
from svc_tpu_torch.ops import motion, pyramid

COEFF_GATE = 2.5e-4
# (MV block, levels, search range, columns): top radius range >> (levels -
# 1) = 5 or 8; 8 block columns take svc_tpu's Pallas refine, 7 its XLA one
STACK_CASES = [(8, 4, 40, 64), (32, 2, 10, 224)]
FRAME_CASES = [(8, 4, 40, 56), (8, 4, 64, 56), (16, 5, 80, 112), (16, 5, 128, 112),
               (32, 2, 10, 256), (32, 5, 128, 224)]


def _panned_pair(block, levels, w, seed):
    """Two ``block`` x ``w`` frames of a texture of 4 x 4 pixel cells, the
    anchor (frame 1) the tracked frame (frame 0) moved 5 top-level pixels
    left, and 1 up where the top level has more than one row."""
    rng = np.random.default_rng(seed)
    dx = 5 << (levels - 1)
    dy = 1 << (levels - 1) if block >> (levels - 1) > 1 else 0
    cells = rng.integers(0, 256, ((block + dy) // 4 + 1, (w + dx) // 4 + 1), dtype=np.uint8)
    base = np.kron(cells, np.ones((4, 4), np.uint8))
    return np.stack([base[dy:dy + block, dx:dx + w], base[:block, :w]])


def _counted(monkeypatch, name):
    """Count the calls of svc_tpu's Pallas refine ``name``."""
    calls = []
    kernel = getattr(j_mp, name)

    def counted(*a, **k):
        calls.append(1)
        return kernel(*a, **k)

    monkeypatch.setattr(j_mp, name, counted)
    return calls


def _top_found_far(mv, levels):
    # the top level found motion past the near radii (an MV past 4 top-level
    # pixels, doubled at each level below)
    assert np.abs(mv).max() > 4 << (levels - 1)


@pytest.mark.parametrize("block,levels,search_range,w", STACK_CASES)
def test_hbma_stack_square_far_radii_bit_equal(block, levels, search_range, w,
                                               monkeypatch):
    x = _panned_pair(block, levels, w, seed=search_range + block)
    calls = _counted(monkeypatch, "refine_mads_stack_pallas")
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, block, block)
    # every refinement level took the kernel on 8 block columns, none on 7
    assert len(calls) == (levels - 1 if w == 8 * block else 0)
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, block, block)
    assert mv_t.shape == (1, 1, w // block, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    _top_found_far(mv_t.numpy(), levels)


@pytest.mark.parametrize("block,levels,search_range,w", FRAME_CASES)
def test_hbma_square_far_radii_bit_equal(block, levels, search_range, w, monkeypatch):
    x = _panned_pair(block, levels, w, seed=search_range + block + 1)
    calls = _counted(monkeypatch, "refine_mads_pallas")
    jp = j_pyr.build_pyramid(jnp.asarray(x), levels)
    tp = pyramid.build_pyramid(torch.from_numpy(x), levels)
    mv_j, mm_j = j_motion.hbma([p[0] for p in jp], [p[1] for p in jp], search_range,
                               block, block)
    assert len(calls) == (levels - 1 if w == 8 * block else 0)
    mv_t, mm_t = motion.hbma([p[0] for p in tp], [p[1] for p in tp], search_range,
                             block, block)
    assert mv_t.shape == (1, w // block, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    _top_found_far(mv_t.numpy(), levels)
    # the port's hbma_stack on the pair: the same field
    mv_s, mm_s = motion.hbma_stack(tp, search_range, block, block)
    np.testing.assert_array_equal(mv_s[0].numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_s[0].numpy(), np.asarray(mm_j))


def test_square_far_radius_encode_bit_equal(monkeypatch):
    # one batch of 2 anchors at 8x8 MV blocks and 4 levels (G20's setting)
    # through both packages: the same header, MV fields and block types,
    # coefficients within the gate. svc_tpu's encoder runs its ops eagerly
    # (compiling its program at these ranges takes the CPU many minutes),
    # at range 40 (r = 5; at G20's range 64 it takes the CPU twice as long)
    w, h, n, batch = 56, 8, 3, 2
    clip = make_clip(w, h, n, seed=11)
    cfg = EncoderConfig(mv_block_w=8, mv_block_h=8, mv_search_range=40)
    props = VideoProperties(w, h, n)
    tenc = t_enc.Encoder(*[config.from_dict(getattr(config, type(c).__name__),
                                            dataclasses.asdict(c)) for c in (cfg, props)],
                         batch_size=batch, device="cpu")
    tb = tenc.encode_batch(clip, 0)
    jenc = j_enc.Encoder(cfg, props, batch_size=batch)
    monkeypatch.setattr(j_layouts.PinnedDispatch, "_ensure_compiled", lambda self, args: False)
    with jax.disable_jit():
        jb = jenc.encode_batch(clip, 0)
    assert tb["mv_field"].shape == (batch, h // 8, w // 8, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert tb["coeffs"].shape == np.array(jb["coeffs"]).shape
    assert np.abs(tb["coeffs"].numpy() - np.array(jb["coeffs"])).max() <= COEFF_GATE
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found
    assert tenc.header().pack() == jenc.header().pack()
