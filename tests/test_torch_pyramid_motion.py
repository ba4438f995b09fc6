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


def test_hbma_stack_bit_equal():
    x = _moving_stack(3, 64, 128, seed=8)
    mv_j, mm_j = j_motion.hbma_stack(j_pyr.build_pyramid(jnp.asarray(x), 4), 8, 16, 16)
    mv_t, mm_t = motion.hbma_stack(
        pyramid.build_pyramid(torch.from_numpy(x), 4), 8, 16, 16
    )
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
    assert np.abs(mv_t.numpy()).max() > 0  # the pan was found

