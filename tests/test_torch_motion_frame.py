"""Port vs svc_tpu: the per-frame motion API — ``refine`` (table and gather
paths), ``hbma`` (which reaches svc_tpu's ``refine_mads_pallas``, kernel
K7's TPU original, in interpret mode), the global-motion estimators — and
the plain versions of K7, K8 and K9 against svc_tpu's Pallas kernels in
interpret mode. All bit-equal (SADs on the entries svc_tpu defines)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.ops import motion as j_motion
from svc_tpu.ops import motion_pallas as j_mp
from svc_tpu.ops import pyramid as j_pyr
from svc_tpu.ops import pyramid_pallas as j_pp
from svc_tpu_torch.ops import motion, pyramid


def _moving_stack(n, h, w, seed=0):
    """Textured frames under a global pan plus one moving patch."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4 * n, w + 4 * n), dtype=np.uint8)
    frames = np.stack([base[2 * i : 2 * i + h, 3 * i : 3 * i + w] for i in range(n)])
    patch = rng.integers(0, 256, (h // 4, w // 4), dtype=np.uint8)
    for i in range(n):
        y, x = h // 3 + i, w // 3 - 2 * i
        frames[i, y : y + h // 4, x : x + w // 4] = patch
    return frames


def _pyramids(frames, levels):
    j = j_pyr.build_pyramid(jnp.asarray(frames), levels)
    t = pyramid.build_pyramid(torch.from_numpy(frames), levels)
    return j, t


def _valid(mv, r, bw, bh, fh, fw):
    """(ncand, ..., mfh, mfw) mask of candidates whose window lies inside
    the frame, for (..., mfh, mfw, 2) int MVs."""
    mfh, mfw = mv.shape[-3:-1]
    by = np.arange(mfh)[:, None] * bh
    bx = np.arange(mfw)[None, :] * bw
    out = []
    for ey, ex in motion.candidate_offsets(r):
        py = by + mv[..., 1] + ey
        px = bx + mv[..., 0] + ex
        out.append((py >= 0) & (py <= fh - bh) & (px >= 0) & (px <= fw - bw))
    return np.stack(out)


# (h, w, levels, block_w, block_h, search range): the default 4-level
# 16x16 search, a rectangular block, a 3-level pyramid; every level has
# mfw >= 8, so svc_tpu's hbma takes refine_mads_pallas
HBMA_CASES = [
    (128, 256, 4, 16, 16, 8),
    (64, 256, 3, 16, 8, 4),
    (64, 128, 3, 8, 8, 4),
]


@pytest.mark.parametrize("h,w,levels,bw,bh,r", HBMA_CASES)
def test_hbma_bit_equal(h, w, levels, bw, bh, r, monkeypatch):
    frames = _moving_stack(2, h, w, seed=h + w + bh)
    jp, tp = _pyramids(frames, levels)
    calls = []
    pallas = j_mp.refine_mads_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_pallas", counted)
    mv_j, mm_j = j_motion.hbma([p[0] for p in jp], [p[1] for p in jp], r, bw, bh)
    assert len(calls) == levels - 1  # every refinement level took the kernel
    mv_t, mm_t = motion.hbma([p[0] for p in tp], [p[1] for p in tp], r, bw, bh)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


def test_hbma_validation_errors_match():
    pyr = pyramid.build_pyramid(torch.from_numpy(_moving_stack(2, 32, 64)), 4)
    tr, an = [p[0] for p in pyr], [p[1] for p in pyr]
    with pytest.raises(ValueError, match="search range must be >="):
        motion.hbma(tr, an, 4, 16, 16)
    with pytest.raises(ValueError, match="block dims must be divisible"):
        motion.hbma(tr, an, 8, 12, 16)


@pytest.mark.parametrize("mv_bound", [0, 9])
def test_refine_bit_equal(mv_bound):
    # mv_bound > 0 takes svc_tpu's dense-table path, 0 its gather path;
    # MVs within the bound for the table, up to 20 (past the frame) for
    # the gather; odd MVs and a carried-in min-MAD that blocks some updates
    rng = np.random.default_rng(mv_bound)
    h, w, bw, bh, r = 48, 96, 8, 8, 3
    frames = _moving_stack(2, h, w, seed=3)
    lim = mv_bound - r if mv_bound else 20
    mv = rng.integers(-lim, lim + 1, (h // bh, w // bw, 2)).astype(np.float32)
    mm = rng.uniform(0, 120, (h // bh, w // bw)).astype(np.float32)
    args = (r, bw, bh)
    mv_j, mm_j = j_motion.refine(
        jnp.asarray(frames[0]), jnp.asarray(frames[1]), *args,
        jnp.asarray(mv), jnp.asarray(mm), mv_bound=mv_bound,
    )
    mv_t, mm_t = motion.refine(
        torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), *args,
        torch.from_numpy(mv), torch.from_numpy(mm), mv_bound=mv_bound,
    )
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert (mv_t.numpy() != mv).any()  # some blocks moved


@pytest.mark.parametrize("bound_in,bw,bh", [(14, 16, 16), (6, 8, 8)])
def test_refine_mads_plain_matches_pallas(bound_in, bw, bh):
    h, w, r = 64, 256, 1
    frames = _moving_stack(2, h, w, seed=bound_in)
    mfh, mfw = h // bh, w // bw
    rng = np.random.default_rng(bound_in)
    mv = 2 * rng.integers(-bound_in // 2, bound_in // 2 + 1, (mfh, mfw, 2))
    mv = mv.astype(np.int32)
    mv_yx = np.stack([mv[..., 1], mv[..., 0]], axis=1)[:, :, None, :]
    want = np.asarray(j_mp.refine_mads_pallas(
        jnp.asarray(frames[0]), jnp.asarray(frames[1]), jnp.asarray(mv_yx),
        r, bound_in, bw, bh,
    ))  # (mfh, rows_out, mfw)
    ncand = (2 * r + 1) ** 2
    want = want[:, :ncand].transpose(1, 0, 2)
    got = motion.refine_mads(
        torch.from_numpy(frames[0]), torch.from_numpy(frames[1]),
        torch.from_numpy(mv), r, bw, bh,
    ).numpy()
    assert got.shape == (ncand, mfh, mfw) and got.dtype == np.int32
    valid = _valid(mv, r, bw, bh, h, w)
    np.testing.assert_array_equal(got[valid], want[valid])
    assert valid.sum() > ncand * mfh * mfw // 2


def test_candidate_sads_plain_matches_pallas():
    # as tests/test_pallas_kernels.py: mv_pad 3, unbounded odd MVs
    rng = np.random.default_rng(0)
    t, h, w, bw, bh, r, bound = 2, 32, 256, 16, 16, 1, 3
    tracked = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    mv = rng.integers(-bound, bound + 1, (t, h // bh, w // bw, 2)).astype(np.int32)
    want = np.asarray(j_mp.candidate_sads(
        jnp.asarray(tracked), jnp.asarray(anchor), jnp.asarray(mv), r, bw, bh, bound
    ))
    got = motion.candidate_sads(
        torch.from_numpy(tracked), torch.from_numpy(anchor),
        torch.from_numpy(mv), r, bw, bh, bound,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    valid = _valid(mv, r, bw, bh, h, w).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(got[valid], want[valid])


def test_refine_sads_static_plain_matches_pallas():
    rng = np.random.default_rng(3)
    t, h, w, bw, bh, r, bound = 2, 64, 256, 16, 16, 1, 14
    tracked = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    mv = (rng.integers(-7, 8, (t, h // bh, w // bw, 2)) * 2).astype(np.int32)
    args = (r, bw, bh, bound)
    want = np.asarray(j_mp.refine_sads_static(
        jnp.asarray(tracked), jnp.asarray(anchor), jnp.asarray(mv), *args
    ))
    tt, ta, tm = map(torch.from_numpy, (tracked, anchor, mv))
    got = motion.refine_sads_static(tt, ta, tm, *args).numpy()
    valid = _valid(mv, r, bw, bh, h, w).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(got[valid], want[valid])
    with pytest.raises(ValueError, match="even"):
        motion.refine_sads_static(tt, ta, tm + 1, *args)
    with pytest.raises(ValueError, match="block_h"):
        motion.refine_sads_static(tt, ta, tm, 3, bw, bh, bound)


def _pitched(spatial, tbw=8):
    return np.stack([spatial[..., j::tbw] for j in range(tbw)])


def test_pyr_down_pitched_plain_matches_pallas():
    # shapes as tests/test_pitched_frontend.py
    rng = np.random.default_rng(0)
    tbw, t, h, nbx = 8, 3, 64, 32
    spatial = rng.integers(0, 256, (t, h, nbx * tbw)).astype(np.uint8)
    y8 = _pitched(spatial, tbw)
    want = np.asarray(j_pp.pyr_down_mxu_pitched_pallas(jnp.asarray(y8)))
    got = pyramid.pyr_down_pitched(torch.from_numpy(y8)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pyramid.to_pitched(torch.from_numpy(spatial), tbw).numpy(), y8
    )
    with pytest.raises(ValueError, match="H % 8"):
        pyramid.pyr_down_pitched(torch.from_numpy(y8[:, :, :60]))


@pytest.mark.parametrize("tbw,t,h,w", [(8, 3, 64, 256), (4, 2, 32, 128)])
def test_pyr_down_pitched_levels_matches_pallas(tbw, t, h, w):
    # svc_tpu's pitched encoder path: level 1 from the subplanes, levels
    # 2-3 from the spatial level 1 (models/encoder.py:402-420)
    rng = np.random.default_rng(h + w)
    spatial = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    y8 = _pitched(spatial, tbw)
    want = [j_pp.pyr_down_mxu_pitched_pallas(jnp.asarray(y8))]
    for _ in range(2):
        want.append(j_pp.pyr_down_mxu_pallas(want[-1]))
    got = pyramid.pyr_down_pitched_levels(torch.from_numpy(y8), 3)
    assert len(got) == 3
    for lvl, (g, w_) in enumerate(zip(got, want), start=1):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=f"level {lvl}")


def test_refine_sads_pitched_plain_matches_pallas():
    rng = np.random.default_rng(2)
    tbw, tp1, fh, fw = 8, 3, 64, 128
    bw = bh = 16
    r, bound_in = 1, 14
    mfh, mfw = fh // bh, fw // bw
    spatial = rng.integers(0, 256, (tp1, fh, fw)).astype(np.uint8)
    mv = (rng.integers(-7, 8, (tp1 - 1, mfh, mfw, 2)) * 2).astype(np.int32)
    mv_yx = np.stack([mv[..., 1], mv[..., 0]], axis=2)[:, :, :, None, :]
    want = np.asarray(j_mp.refine_mads_stack_pitched_pallas(
        jnp.asarray(_pitched(spatial, tbw)), jnp.asarray(mv_yx), r, bound_in, bw, bh
    ))  # (T, mfh, rows_out, mfw)
    ncand = (2 * r + 1) ** 2
    want = want[:, :, :ncand].transpose(0, 2, 1, 3)
    y8 = torch.from_numpy(_pitched(spatial, tbw))
    got = motion.refine_sads_pitched(y8, torch.from_numpy(mv), r, bw, bh).numpy()
    valid = _valid(mv, r, bw, bh, fh, fw).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(got[valid], want[valid])
    with pytest.raises(ValueError, match="multiple of tbw"):
        motion.refine_sads_pitched(y8, torch.from_numpy(mv), r, 12, bh)


@pytest.mark.parametrize("t,h,w", [(2, 64, 128), (3, 48, 256)])
def test_hbma_stack_pitched_base_bit_equal(t, h, w, monkeypatch):
    # the pitched frontend's search (16x16 MV blocks, range 8, 4 levels)
    # where svc_tpu's pitched refine gate holds: its level 0 runs
    # refine_mads_stack_pitched_pallas (interpret mode), the port's the K8
    # refine's plain version (the specialised kernel on a card)
    frames = _moving_stack(t + 1, h, w, seed=t + h)
    jp, tp = _pyramids(frames, 4)
    assert j_mp.pitched_refine_supported(8, h // 16, w // 16, 16, 16, 1, 14)
    calls = []
    pallas = j_mp.refine_mads_stack_pitched_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_stack_pitched_pallas", counted)
    y8 = _pitched(frames, 8)
    mv_j, mm_j = j_motion.hbma_stack(jp, 8, 16, 16, base_pitched=jnp.asarray(y8))
    assert len(calls) == 1
    y8_t = torch.from_numpy(y8)
    mv_t, mm_t = motion.hbma_stack([y8_t] + tp[1:], 8, 16, 16, base_pitched=y8_t)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


def test_global_motion_avg_bit_equal():
    rng = np.random.default_rng(5)
    field = rng.integers(-9, 10, (7, 13, 2)).astype(np.float32)
    want = np.asarray(j_motion.estimate_global_motion_avg(jnp.asarray(field)))
    got = motion.estimate_global_motion_avg(torch.from_numpy(field)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 3])
def test_global_motion_exhaustive_bit_equal(r):
    frames = _moving_stack(2, 24, 40, seed=r)
    gm_j, mm_j = j_motion.estimate_global_motion_exhaustive(
        jnp.asarray(frames[0]), jnp.asarray(frames[1]), r
    )
    gm_t, mm_t = motion.estimate_global_motion_exhaustive(
        torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), r
    )
    np.testing.assert_array_equal(gm_t.numpy(), np.asarray(gm_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))


def test_global_motion_hierarchical_bit_equal():
    frames = _moving_stack(2, 32, 48, seed=4)
    jp, tp = _pyramids(frames, 3)
    want = j_motion.estimate_global_motion_hierarchical(
        [p[0] for p in jp], [p[1] for p in jp], 8
    )
    got = motion.estimate_global_motion_hierarchical(
        [p[0] for p in tp], [p[1] for p in tp], 8
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy()).max() > 0


def test_hbma_stack_equals_stacked_hbma():
    frames = _moving_stack(4, 64, 128, seed=9)
    pyr = pyramid.build_pyramid(torch.from_numpy(frames), 4)
    mv_s, mm_s = motion.hbma_stack(pyr, 8, 16, 16)
    pairs = [
        motion.hbma([p[t] for p in pyr], [p[t + 1] for p in pyr], 8, 16, 16)
        for t in range(3)
    ]
    np.testing.assert_array_equal(mv_s.numpy(), torch.stack([p[0] for p in pairs]).numpy())
    np.testing.assert_array_equal(mm_s.numpy(), torch.stack([p[1] for p in pairs]).numpy())
    # the pitched base level (K8's refine on a card) gives the same field
    y8 = pyramid.to_pitched(pyr[0], 8)
    mv_p, mm_p = motion.hbma_stack([y8] + pyr[1:], 8, 16, 16, base_pitched=y8)
    np.testing.assert_array_equal(mv_p.numpy(), mv_s.numpy())
    np.testing.assert_array_equal(mm_p.numpy(), mm_s.numpy())
