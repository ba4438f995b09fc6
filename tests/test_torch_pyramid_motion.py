"""Port vs svc_tpu: padding, luma, pyramid (K4) and hierarchical motion
search (ebma + K3 refine SADs + selection) — all bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.ops import color as j_color
from svc_tpu.ops import motion as j_motion
from svc_tpu.ops import pad as j_pad
from svc_tpu.ops import pyramid as j_pyr
from svc_tpu_torch.ops import color, motion, pad, pyramid


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


def test_luma_bit_equal():
    rng = np.random.default_rng(1)
    b, g, r = rng.integers(0, 256, (3, 4, 33, 47), dtype=np.uint8)
    want = np.asarray(j_color.bgr_planes_to_y(*map(jnp.asarray, (b, g, r))))
    got = color.bgr_planes_to_y(*map(torch.from_numpy, (b, g, r)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h", [(128, 120), (1920, 1080), (100, 37)])
def test_padded_dims_and_pad(w, h):
    assert pad.padded_dims(w, h, 16, 16, 4) == j_pad.padded_dims(w, h, 16, 16, 4)
    pw, ph = pad.padded_dims(w, h, 16, 16, 4)
    x = np.random.default_rng(2).integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        pad.pad_frame(torch.from_numpy(x), 16, 8 + ph - h).numpy(),
        np.asarray(j_pad.pad_frame(jnp.asarray(x), 16, 8 + ph - h)),
    )


@pytest.mark.parametrize(
    "shape", [(3, 64, 128), (2, 37, 51), (1, 2, 3), (2, 1, 9)]
)
def test_pyr_down_bit_equal(shape):
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(j_pyr.pyr_down(jnp.asarray(x)))
    np.testing.assert_array_equal(pyramid.pyr_down(torch.from_numpy(x)).numpy(), want)


def test_pyr_down_matches_pallas_kernel():
    from svc_tpu.ops.pyramid_pallas import pyr_down_mxu_pallas

    x = np.random.default_rng(4).integers(0, 256, (2, 64, 128), dtype=np.uint8)
    want = np.asarray(pyr_down_mxu_pallas(jnp.asarray(x)))  # interpret mode
    np.testing.assert_array_equal(pyramid.pyr_down(torch.from_numpy(x)).numpy(), want)


def test_build_pyramid_bit_equal():
    x = _moving_stack(3, 64, 128)
    for a, b in zip(
        j_pyr.build_pyramid(jnp.asarray(x), 4),
        pyramid.build_pyramid(torch.from_numpy(x), 4),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("r", [1, 2])
def test_ebma_bit_equal(r):
    x = _moving_stack(3, 16, 32, seed=5)
    x[1, 4:8, 8:16] = 7  # a flat patch exercises the flat-region reset
    import jax

    mv_j, mm_j = jax.vmap(lambda a, b: j_motion.ebma(a, b, r, 2, 2))(
        jnp.asarray(x[:-1]), jnp.asarray(x[1:])
    )
    mv_t, mm_t = motion.ebma(torch.from_numpy(x[:-1]), torch.from_numpy(x[1:]), r, 2, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))


def test_refine_sads_match_pallas_on_valid_candidates():
    from svc_tpu.ops.motion_pallas import refine_mads_stack_pallas

    x = _moving_stack(3, 64, 128, seed=6)
    bw = bh = 16
    r, bound_in = 1, 14
    t, mfh, mfw = 2, 64 // bh, 128 // bw
    rng = np.random.default_rng(7)
    mv = 2 * rng.integers(-bound_in // 2, bound_in // 2 + 1, (t, mfh, mfw, 2))
    mv = mv.astype(np.int32)  # (x, y)
    # the TPU kernel's (T, mfh, 2, 1, mfw) layout: y row, then x row
    mv_yx = np.stack([mv[..., 1], mv[..., 0]], axis=2)[:, :, :, None, :]
    want = np.asarray(
        refine_mads_stack_pallas(jnp.asarray(x), jnp.asarray(mv_yx), r, bound_in, bw, bh)
    )  # (T, mfh, rows_out, mfw)
    got = motion.refine_sads(torch.from_numpy(x), torch.from_numpy(mv), r, bw, bh).numpy()
    by = np.arange(mfh)[:, None] * bh
    bx = np.arange(mfw)[None, :] * bw
    n_valid = 0
    for i, (ey, ex) in enumerate(motion.candidate_offsets(r)):
        py = by + mv[..., 1] + ey
        px = bx + mv[..., 0] + ex
        valid = (py >= 0) & (py <= 64 - bh) & (px >= 0) & (px <= 128 - bw)
        np.testing.assert_array_equal(got[:, i][valid], want[:, :, i][valid])
        n_valid += int(valid.sum())
    assert n_valid > 0


@pytest.mark.parametrize(
    "search_range,h,w",
    # ranges 8 (the default), 16, 24 and 32 at 16x16 MV blocks and 4
    # levels: top radii 1 to 4; at 32 a top level of 16x32 pixels (8x16
    # 2x2 blocks) holds a radius-4 window inside the frame
    [(8, 64, 128), (16, 64, 128), (24, 64, 128), (32, 128, 256)],
)
def test_hbma_stack_bit_equal(search_range, h, w):
    x = _moving_stack(3, h, w, seed=8)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), 4),
                                     search_range, 16, 16)
    mv_t, mm_t = motion.hbma_stack(
        pyramid.build_pyramid(torch.from_numpy(x), 4), search_range, 16, 16
    )
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found



# --mv-block-w/-h and --pyr-lvl-count, (MV block, levels, range): 8x8 MV
# blocks at 4 levels (1x1 blocks at the top, 2x2 below it), 3 levels (4x4
# at the top, r = 2), 2 levels (8x8, r = 4) and 5 levels at range 16 (1x1
# and 2x2 again); 64x128 frames keep 8 block columns or more a level
MOTION_CONFIGS = [(8, 4, 8), (16, 3, 8), (16, 2, 8), (16, 5, 16)]


@pytest.mark.parametrize("block,levels,search_range", MOTION_CONFIGS)
def test_hbma_stack_motion_configs_bit_equal(block, levels, search_range):
    x = _moving_stack(3, 64, 128, seed=10)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, block, block)
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, block, block)
    assert mv_t.shape == (2, 64 // block, 128 // block, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


@pytest.mark.parametrize("block,levels,search_range", MOTION_CONFIGS)
def test_hbma_motion_configs_bit_equal(block, levels, search_range, monkeypatch):
    # the per-frame search; svc_tpu's refinement levels on its
    # refine_mads_pallas (K7's TPU original, in interpret mode)
    from svc_tpu.ops import motion_pallas as j_mp

    frames = _moving_stack(2, 64, 128, seed=11)
    jp = j_pyr.build_pyramid(jnp.asarray(frames), levels)
    tp = pyramid.build_pyramid(torch.from_numpy(frames), levels)
    calls = []
    pallas = j_mp.refine_mads_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_pallas", counted)
    mv_j, mm_j = j_motion.hbma([p[0] for p in jp], [p[1] for p in jp], search_range,
                               block, block)
    assert len(calls) == levels - 1
    mv_t, mm_t = motion.hbma([p[0] for p in tp], [p[1] for p in tp], search_range,
                             block, block)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0


# 16x8 and 8x16 MV blocks (width x height) at 4, 3 and 2 levels: (block_w,
# block_h, levels, range, rows); 72 rows give 9 block rows at every level
# of 16x8 (odd, as the 1080 rows of 1080p do)
RECT_CONFIGS = [(16, 8, 4, 8, 72), (16, 8, 3, 8, 72), (16, 8, 2, 8, 72),
                (8, 16, 4, 16, 64), (8, 16, 3, 8, 64), (8, 16, 2, 8, 64)]


@pytest.mark.parametrize("bw,bh,levels,search_range,h", RECT_CONFIGS)
def test_hbma_stack_rect_configs_bit_equal(bw, bh, levels, search_range, h):
    x = _moving_stack(3, h, 128, seed=12)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, bw, bh)
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, bw, bh)
    assert mv_t.shape == (2, h // bh, 128 // bw, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


# MV blocks with a 32-pixel side (width, height, levels, range): 32x32 at
# 2, 3, 4 and 5 levels (range 16 at 5), 32x16 and 16x32 at 2 and 4; 64x256
# frames keep 8 block columns or more at every level, so svc_tpu's search
# takes refine_mads_stack_pallas (in interpret mode) at each refinement level
WIDE_CONFIGS = [(32, 32, 2, 8), (32, 32, 3, 8), (32, 32, 4, 8), (32, 32, 5, 16),
                (32, 16, 2, 8), (32, 16, 4, 8), (16, 32, 2, 8), (16, 32, 4, 8)]


@pytest.mark.parametrize("bw,bh,levels,search_range", WIDE_CONFIGS)
def test_hbma_stack_wide_configs_bit_equal(bw, bh, levels, search_range, monkeypatch):
    from svc_tpu.ops import motion_pallas as j_mp

    x = _moving_stack(2, 64, 256, seed=13)
    calls = []
    pallas = j_mp.refine_mads_stack_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_stack_pallas", counted)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, bw, bh)
    assert len(calls) == levels - 1  # every refinement level took the kernel
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, bw, bh)
    assert mv_t.shape == (1, 64 // bh, 256 // bw, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


# ratio-4 MV blocks (width, height, levels, rows, columns): 32x8 and 8x32
# at 4, 3 and 2 levels, 16x4 at 3 (the shapes of 32x8's lower levels); 5
# block rows at every level of 32x8 and 16x4 (odd, as the 135 of 1080p),
# 3 at 8x32, and 8 block columns at every level, so svc_tpu's search takes
# refine_mads_stack_pallas (in interpret mode) at each refinement level
RATIO4_CONFIGS = [(32, 8, 4, 40, 256), (32, 8, 3, 40, 256), (32, 8, 2, 40, 256),
                  (8, 32, 4, 96, 64), (8, 32, 3, 96, 64), (8, 32, 2, 96, 64),
                  (16, 4, 3, 20, 128)]


@pytest.mark.parametrize("bw,bh,levels,h,w", RATIO4_CONFIGS)
def test_hbma_stack_ratio4_configs_bit_equal(bw, bh, levels, h, w, monkeypatch):
    from svc_tpu.ops import motion_pallas as j_mp

    x = _moving_stack(2, h, w, seed=14)
    calls = []
    pallas = j_mp.refine_mads_stack_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_stack_pallas", counted)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels), 8,
                                     bw, bh)
    assert len(calls) == levels - 1  # every refinement level took the kernel
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   8, bw, bh)
    assert mv_t.shape == (1, h // bh, w // bw, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found


# 16x16 MV blocks past r = 4 (levels, range, rows): one level at ranges 5
# and 8 (the whole search an EBMA at r = 5, 8), two levels at ranges 10 and
# 16 (r = 5, 8 at the top and at level 0); 128 columns give 8 block columns
# at level 0, so svc_tpu's search takes refine_mads_stack_pallas (in
# interpret mode) there; 48 rows keep its interpret-mode run to seconds
FAR_CONFIGS = [(1, 5, 64), (1, 8, 64), (2, 10, 48), (2, 16, 48)]


@pytest.mark.parametrize("levels,search_range,h", FAR_CONFIGS)
def test_hbma_stack_far_radii_bit_equal(levels, search_range, h, monkeypatch):
    from svc_tpu.ops import motion_pallas as j_mp

    x = _moving_stack(2, h, 128, seed=16)
    calls = []
    pallas = j_mp.refine_mads_stack_pallas

    def counted(*a, **k):
        calls.append(1)
        return pallas(*a, **k)

    monkeypatch.setattr(j_mp, "refine_mads_stack_pallas", counted)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), levels),
                                     search_range, 16, 16)
    assert len(calls) == levels - 1  # every refinement level took the kernel
    mv_t, mm_t = motion.hbma_stack(pyramid.build_pyramid(torch.from_numpy(x), levels),
                                   search_range, 16, 16)
    assert mv_t.shape == (1, h // 16, 8, 2)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 4  # motion found past the near radii
