"""Port vs svc_tpu: RANSAC, morphology, k-means (opencv_split) and
per-cluster connected components — all bit-equal on shared keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.config import EncoderConfig, RansacParams
from svc_tpu.ops import ccl as j_ccl
from svc_tpu.ops import kmeans as j_kmeans
from svc_tpu.ops import morphology as j_morph
from svc_tpu.ops import ransac as j_ransac
from svc_tpu_torch.ops import ccl, kmeans, morphology, prng, ransac

F, MFH, MFW = 4, 8, 16


def _motion_fields(seed=1):
    """Integer MV fields: a global pan, moving blobs, sparse noise."""
    rng = np.random.default_rng(seed)
    mv = np.zeros((F, MFH, MFW, 2), np.float32)
    mv[..., 0], mv[..., 1] = 2, -1
    for f in range(F):
        for _ in range(3):
            y, x = rng.integers(0, MFH - 3), rng.integers(0, MFW - 4)
            mv[f, y : y + 3, x : x + 4] = rng.integers(-8, 9, 2)
        noise = rng.random((MFH, MFW, 1)) < 0.05
        mv[f] += noise * rng.integers(-3, 4, (MFH, MFW, 2))
    return mv


def _keys(seed):
    """The encoder's (ransac, kmeans) key pairs for F anchors, both packages."""
    kj = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(F)
    )
    kj = jax.vmap(jax.random.split)(kj)
    kt = prng.split(prng.fold_in(prng.key(seed), torch.arange(F)))
    return kj, kt


@pytest.fixture(scope="module")
def segmentation():
    """One JAX run of the segmentation chain, shared by the tests below."""
    cfg = EncoderConfig(reference_compat=True)
    mv = _motion_fields()
    kj, kt = _keys(cfg.seed)
    gm, rmse, inl = jax.vmap(
        lambda m, k: j_ransac.estimate_global_motion_ransac(m, cfg.ransac, k)
    )(jnp.asarray(mv), kj[:, 0])
    fg = j_morph.close_then_open(~inl, 3, 3)
    ys = np.broadcast_to(np.arange(MFH, dtype=np.float32)[:, None] * 16, (MFH, MFW))
    xs = np.broadcast_to(np.arange(MFW, dtype=np.float32)[None, :] * 16, (MFH, MFW))
    feats = np.stack(
        [np.stack([np.zeros_like(xs), m[..., 0], xs, ys]).reshape(4, -1) for m in mv]
    )
    mask = np.array(fg).reshape(F, -1)
    labels, centers, compact = j_kmeans.kmeans_t_frames(
        jnp.asarray(feats), jnp.asarray(mask), 10, kj[:, 1],
        attempts=3, max_iter=10, epsilon=1.0, repair="opencv_split",
    )
    btypes, counts = j_ccl.block_types_from_clusters(
        labels.reshape(F, MFH, MFW), 10, 4
    )
    return dict(
        cfg=cfg, mv=mv, kt=kt, gm=np.array(gm), rmse=np.array(rmse),
        inliers=np.array(inl), fg=np.array(fg), feats=feats, mask=mask,
        labels=np.array(labels), centers=np.array(centers),
        compact=np.array(compact), btypes=np.array(btypes),
        counts=np.array(counts),
    )


def test_ransac_matches(segmentation):
    s = segmentation
    gm, rmse, inl = ransac.estimate_global_motion_ransac(
        torch.from_numpy(s["mv"]), s["cfg"].ransac, s["kt"][:, 0]
    )
    np.testing.assert_array_equal(inl.numpy(), s["inliers"])
    np.testing.assert_array_equal(gm.numpy(), s["gm"])
    np.testing.assert_allclose(rmse.numpy(), s["rmse"], rtol=1e-6, atol=1e-6)


def test_morphology_matches(segmentation):
    s = segmentation
    fg = morphology.close_then_open(~torch.from_numpy(s["inliers"]), 3, 3)
    np.testing.assert_array_equal(fg.numpy(), s["fg"])
    assert s["fg"].any() and not s["fg"].all()


@pytest.mark.parametrize("kw,kh", [(3, 3), (4, 2), (1, 5)])
def test_morphology_rect_shapes(kw, kh):
    m = np.random.default_rng(kw * 10 + kh).random((2, 9, 13)) < 0.4
    want = np.asarray(j_morph.close_then_open(jnp.asarray(m), kw, kh))
    got = morphology.close_then_open(torch.from_numpy(m), kw, kh).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_matches(segmentation):
    s = segmentation
    labels, centers, compact = kmeans.kmeans_t_frames(
        torch.from_numpy(s["feats"]), torch.from_numpy(s["mask"]), 10,
        s["kt"][:, 1], attempts=3, max_iter=10, epsilon=1.0,
    )
    np.testing.assert_array_equal(labels.numpy(), s["labels"])
    np.testing.assert_array_equal(centers.numpy(), s["centers"])
    np.testing.assert_array_equal(compact.numpy(), s["compact"])


def test_block_types_match(segmentation):
    s = segmentation
    btypes, counts = ccl.block_types_from_clusters(
        torch.from_numpy(s["labels"].reshape(F, MFH, MFW)), 10, 4
    )
    np.testing.assert_array_equal(btypes.numpy(), s["btypes"])
    np.testing.assert_array_equal(counts.numpy(), s["counts"])
    assert s["btypes"].max() > 0


@pytest.mark.parametrize("connectivity", [4, 8])
def test_block_types_random_clusters(connectivity):
    lab = np.random.default_rng(connectivity).integers(-1, 3, (3, 11, 14))
    lab = lab.astype(np.int32)
    bj, cj = j_ccl.block_types_from_clusters(jnp.asarray(lab), 3, connectivity)
    bt, ct = ccl.block_types_from_clusters(torch.from_numpy(lab), 3, connectivity)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_block_types_snaking_component():
    # one long serpentine component: propagation needs many sweeps
    lab = -np.ones((1, 9, 9), np.int32)
    lab[0, ::2, :] = 0
    lab[0, 1::4, -1] = 0
    lab[0, 3::4, 0] = 0
    bj, _ = j_ccl.block_types_from_clusters(jnp.asarray(lab), 1, 4)
    bt, _ = ccl.block_types_from_clusters(torch.from_numpy(lab), 1, 4)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert bt.max().item() == 1


def test_ransac_iteration_math_matches():
    for p in [
        RansacParams(),
        RansacParams(success_prob=0.999, inlier_ratio=0.2),
        RansacParams(inlier_ratio=0.0),
        RansacParams(success_prob=0.0),
    ]:
        assert ransac.iter_count(p) == j_ransac.iter_count(p)
    for n in (1, 100, 8160, 10**6):
        assert ransac.hypothesis_cap(n) == j_ransac.hypothesis_cap(n)


def test_ransac_zero_hypotheses():
    mv = torch.zeros((2, 3, 4, 2))
    gm, rmse, inl = ransac.estimate_global_motion_ransac(
        mv, RansacParams(success_prob=0.0), prng.split(prng.key(0), 2)
    )
    assert not inl.any() and gm.abs().sum() == 0 and rmse.abs().sum() == 0


def test_ransac_degenerate_keeps_hypothesis():
    # every vector far from every other: one inlier each (the hypothesis
    # itself), so the refit equals the drawn vector and the inlier count
    # never drops below the 1-subset
    mv = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2) * 100
    kj, kt = _keys(3)
    p = RansacParams()
    want = jax.vmap(
        lambda m, k: j_ransac.estimate_global_motion_ransac(m, p, k)
    )(jnp.asarray(mv), kj[:2, 0])
    got = ransac.estimate_global_motion_ransac(torch.from_numpy(mv), p, kt[:2, 0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="K5"):
        kmeans.kmeans_t_frames(
            torch.zeros((1, 4, 8)), torch.ones((1, 8), dtype=torch.bool), 2,
            prng.split(prng.key(0), 1), repair="global_farthest",
        )
    with pytest.raises(NotImplementedError, match="subset_sz"):
        ransac.estimate_global_motion_ransac(
            torch.zeros((1, 2, 2, 2)), RansacParams(subset_sz=2),
            prng.split(prng.key(0), 1),
        )
