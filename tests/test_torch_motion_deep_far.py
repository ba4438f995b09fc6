"""Port vs svc_tpu: the motion search at 16x16 MV blocks past top radius 4
with 3 and 4 pyramid levels (search ranges 20-35 and 40-71: K9 at 4x4 and
2x2, K3 / K7 at 8x8 and 4x4 below them, R = 5-8). ``hbma_stack``, the
per-frame ``hbma`` and one ``Encoder`` batch at 4 levels, range 64,
bit-equal: MV fields, min-MADs and block types.

On 128-column frames every level keeps 8 block columns, so svc_tpu's
search takes its Pallas refine (``refine_mads_stack_pallas``,
``refine_mads_pallas``, in interpret mode) at each refinement level:
``hbma_stack`` at 3 levels, range 20, and ``hbma`` at 4 levels, range 40.
That interpret mode costs the CPU half a minute to minutes a search (its
static MV bound grows with the levels and the radius: 112 pixels at level
0 of 4 at range 64), so the other cases run on 112 columns (7 block
columns), where svc_tpu takes its XLA refine. The content pans by 5
pixels of the top level, so the top search finds |mv| > 4.
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
H = 16  # one block row at every level (2x2 blocks at the top of 4)
# (levels, search range, columns): top radius range >> (levels - 1) = 5
# and 8 at 3 levels (K9 4x4; K3 / K7 8x8, 16x16) and at 4 levels (K9 2x2;
# K3 / K7 4x4, 8x8, 16x16); 128 columns take svc_tpu's Pallas refine
STACK_CASES = [(3, 20, 128), (3, 32, 112), (4, 40, 112), (4, 64, 112)]
FRAME_CASES = [(3, 20, 112), (3, 32, 112), (4, 40, 128), (4, 64, 112)]


def _panned_pair(levels, w, seed):
    """Two ``H`` x ``w`` frames of a texture of 4 x 4 pixel cells, the
    anchor (frame 1) the tracked frame (frame 0) moved 5 top-level pixels
    left and 1 up."""
    rng = np.random.default_rng(seed)
    dx, dy = 5 << (levels - 1), 1 << (levels - 1)
    cells = rng.integers(0, 256, ((H + dy) // 4 + 1, (w + dx) // 4 + 1), dtype=np.uint8)
    base = np.kron(cells, np.ones((4, 4), np.uint8))
    return np.stack([base[dy:dy + H, dx:dx + w], base[:H, :w]])


def _counted(monkeypatch, name):
    """Count the calls of svc_tpu's Pallas refine ``name``."""
    calls = []
    kernel = getattr(j_mp, name)

    def counted(*a, **k):
        calls.append(1)
        return kernel(*a, **k)

    monkeypatch.setattr(j_mp, name, counted)
    return calls


@pytest.mark.parametrize("levels,search_range,w", STACK_CASES)
def test_hbma_stack_deep_far_radii_bit_equal(levels, search_range, w, monkeypatch):
    x = _panned_pair(levels, w, seed=search_range)
    calls = _counted(monkeypatch, "refine_mads_stack_pallas")
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, 16, 16)
    # every refinement level took the kernel on 128 columns, none on 112
    assert len(calls) == (levels - 1 if w == 128 else 0)
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, 16, 16)
    assert mv_t.shape == (1, H // 16, w // 16, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    # the top level found motion past the near radii
    assert np.abs(mv_t.numpy()).max() > 4 << (levels - 1)


@pytest.mark.parametrize("levels,search_range,w", FRAME_CASES)
def test_hbma_deep_far_radii_bit_equal(levels, search_range, w, monkeypatch):
    x = _panned_pair(levels, w, seed=search_range + 1)
    calls = _counted(monkeypatch, "refine_mads_pallas")
    jp = j_pyr.build_pyramid(jnp.asarray(x), levels)
    tp = pyramid.build_pyramid(torch.from_numpy(x), levels)
    mv_j, mm_j = j_motion.hbma([p[0] for p in jp], [p[1] for p in jp], search_range, 16, 16)
    assert len(calls) == (levels - 1 if w == 128 else 0)
    mv_t, mm_t = motion.hbma([p[0] for p in tp], [p[1] for p in tp], search_range, 16, 16)
    assert mv_t.shape == (H // 16, w // 16, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 4 << (levels - 1)


def test_deep_far_radius_encode_bit_equal(monkeypatch):
    # one batch of 2 anchors at 4 levels and range 64 (the reference's SSE2
    # build at --mv-search-range 64) through both packages: the same
    # header, MV fields and block types, coefficients within the gate.
    # svc_tpu's encoder runs its ops eagerly: compiling its program at
    # range 64 (four 289-candidate selections) takes the CPU many minutes
    w, h, n, batch = 112, H, 3, 2
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(mv_search_range=64)
    props = VideoProperties(w, h, n)
    tenc = t_enc.Encoder(*[config.from_dict(getattr(config, type(c).__name__),
                                            dataclasses.asdict(c)) for c in (cfg, props)],
                         batch_size=batch, device="cpu")
    tb = tenc.encode_batch(clip, 0)
    jenc = j_enc.Encoder(cfg, props, batch_size=batch)
    monkeypatch.setattr(j_layouts.PinnedDispatch, "_ensure_compiled", lambda self, args: False)
    with jax.disable_jit():
        jb = jenc.encode_batch(clip, 0)
    assert tb["mv_field"].shape == (batch, h // 16, w // 16, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert tb["coeffs"].shape == np.array(jb["coeffs"]).shape
    assert np.abs(tb["coeffs"].numpy() - np.array(jb["coeffs"])).max() <= COEFF_GATE
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found
    assert tenc.header().pack() == jenc.header().pack()
