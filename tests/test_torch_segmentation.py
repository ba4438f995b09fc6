"""Port vs svc_tpu: RANSAC, morphology, k-means (both repair rules, and
the Lloyd kernel K5's plain version against the Pallas kernel in interpret
mode) and per-cluster connected components — all bit-equal on shared keys
(compactness, a float sum in another order, within rtol 1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.config import EncoderConfig, RansacParams
from svc_tpu.ops import ccl as j_ccl
from svc_tpu.ops import kmeans as j_kmeans
from svc_tpu.ops import kmeans_pallas as j_kmeans_pallas
from svc_tpu.ops import morphology as j_morph
from svc_tpu.ops import ransac as j_ransac
from svc_tpu_torch import config
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


def _port(params):
    """A svc_tpu config carried across to the port's."""
    return config.from_dict(getattr(config, type(params).__name__),
                            dataclasses.asdict(params))


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
        torch.from_numpy(s["mv"]), _port(s["cfg"].ransac), s["kt"][:, 0]
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
        repair="opencv_split",
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


@pytest.mark.parametrize(
    "connectivity,kind",
    [pytest.param(4, "random", id="4"), pytest.param(8, "random", id="8"),
     # every cell its own cluster: H*W single-cell components, k = H*W
     pytest.param(4, "own", id="own-4"), pytest.param(8, "own", id="own-8"),
     # 3x3 tiles of 9 clusters: no two 8-neighbours share a cluster
     pytest.param(8, "tiles", id="tiles-8")],
)
def test_block_types_random_clusters(connectivity, kind):
    if kind == "random":
        lab = np.random.default_rng(connectivity).integers(-1, 3, (3, 11, 14))
    elif kind == "own":
        lab = np.random.default_rng(5).permutation(7 * 9).reshape(1, 7, 9)
    else:
        yy, xx = np.mgrid[0:12, 0:15]
        lab = ((yy % 3) * 3 + xx % 3)[None]
    lab = lab.astype(np.int32)
    k = int(lab.max()) + 1
    bj, cj = j_ccl.block_types_from_clusters(jnp.asarray(lab), k, connectivity)
    bt, ct = ccl.block_types_from_clusters(torch.from_numpy(lab), k, connectivity)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if kind != "random":  # one component, and one block type, per cell
        assert len(np.unique(bt.numpy())) == lab.size


def _snake(n: int) -> np.ndarray:
    """One serpentine component over an ``n x n`` grid (n odd)."""
    lab = -np.ones((1, n, n), np.int32)
    lab[0, ::2, :] = 0
    lab[0, 1::4, -1] = 0
    lab[0, 3::4, 0] = 0
    return lab


def _spiral(n: int) -> np.ndarray:
    """One square spiral of cluster 1 winding into an ``n x n`` grid, the
    gaps between its arms cluster 0 (a second, interleaved spiral)."""
    lab = np.zeros((n, n), np.int32)
    y, x, dy, dx = 0, 0, 0, 1
    seen = np.zeros((n, n), bool)
    for _ in range(n * n):
        lab[y, x] = 1
        seen[y, x] = True
        ny, nx = y + 2 * dy, x + 2 * dx
        if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
            dy, dx = dx, -dy  # turn right
            ny, nx = y + 2 * dy, x + 2 * dx
            if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
                break
        lab[y + dy, x + dx] = 1
        seen[y + dy, x + dx] = True
        y, x = ny, nx
    return lab[None]


@pytest.mark.parametrize(
    "kind,n,connectivity",
    [pytest.param("snake", 9, 4, id="snake9-4"),
     # svc_tpu's first loop stops after (h + w) // 10 blocks of 12 sweeps
     # (72 at 31x31); these components are ~500 cells long, so its second
     # loop (pointer jumping) must finish them
     pytest.param("snake", 31, 4, id="snake31-4"),
     pytest.param("snake", 31, 8, id="snake31-8"),
     pytest.param("spiral", 33, 4, id="spiral33-4"),
     pytest.param("spiral", 33, 8, id="spiral33-8")],
)
def test_block_types_snaking_component(kind, n, connectivity):
    # one long serpentine component: propagation needs many sweeps
    lab = _snake(n) if kind == "snake" else _spiral(n)
    k = int(lab.max()) + 1
    bj, cj = j_ccl.block_types_from_clusters(jnp.asarray(lab), k, connectivity)
    bt, ct = ccl.block_types_from_clusters(torch.from_numpy(lab), k, connectivity)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if kind == "snake":
        assert bt.max().item() == 1
    elif connectivity == 4:  # the spiral and the gaps between its arms
        assert ct.numpy().tolist() == [[2, 2]]


def test_ransac_iteration_math_matches():
    for p in [
        RansacParams(),
        RansacParams(success_prob=0.999, inlier_ratio=0.2),
        RansacParams(inlier_ratio=0.0),
        RansacParams(success_prob=0.0),
    ]:
        assert ransac.iter_count(_port(p)) == j_ransac.iter_count(p)
    for n in (1, 100, 8160, 10**6):
        assert ransac.hypothesis_cap(n) == j_ransac.hypothesis_cap(n)


def test_ransac_zero_hypotheses():
    mv = torch.zeros((2, 3, 4, 2))
    gm, rmse, inl = ransac.estimate_global_motion_ransac(
        mv, config.RansacParams(success_prob=0.0), prng.split(prng.key(0), 2)
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
    got = ransac.estimate_global_motion_ransac(torch.from_numpy(mv), _port(p), kt[:2, 0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _lloyd_case(case):
    """Integer features ``(F, D, N)``, mask, k for one Lloyd parity case."""
    rng = np.random.default_rng(len(case))
    f, n, k = (1, 200, 5) if case == "one_frame" else (3, 256, 6)
    feats = rng.integers(-8, 9, (f, 4, n)).astype(np.float32)
    mask = rng.random((f, n)) < 0.5
    if case == "empty_mask":
        mask[1] = False  # every cluster empty, every iteration
    if case == "few_distinct":
        # 4 distinct points for k = 6: empty clusters every iteration
        feats[2] = np.where(rng.random((4, n)) < 0.5, 2.0, -3.0)
        feats[2, 2:] = 7.0
    return feats, mask, k


def _jax_lloyd_inputs(feats, mask, k, attempts, seed):
    """svc_tpu's seeded Lloyd-kernel inputs, as kmeans_t_frames builds them."""
    f, d, n = feats.shape
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(seed), jnp.arange(f)
    )
    keys_a = jax.vmap(lambda kk: jax.random.split(kk, attempts))(keys)
    centers0 = jax.vmap(
        lambda ft, mk, ks: jax.vmap(
            lambda kk: j_kmeans._plus_plus_init(kk, ft, mk, k)
        )(ks)
    )(jnp.asarray(feats), jnp.asarray(mask), keys_a)  # (F, A, k, d)
    init = (
        jnp.zeros((attempts, f, 16, 128), jnp.float32)
        .at[:, :, :k, :d]
        .set(jnp.swapaxes(centers0, 0, 1))
    )
    x_aug = jnp.zeros((f, 8, n), jnp.float32).at[:, :d].set(feats).at[:, d].set(1.0)
    return x_aug, jnp.asarray(mask, jnp.float32)[:, None, :], init, keys


@pytest.mark.parametrize("case", ["integer", "empty_mask", "few_distinct", "one_frame"])
def test_lloyd_plain_matches_pallas_kernel(case):
    # K5's plain version against svc_tpu's fused Lloyd kernel itself, run
    # in interpret mode from the same seeded start
    feats, mask, k = _lloyd_case(case)
    d = feats.shape[1]
    x_aug, mask_f, init, _ = _jax_lloyd_inputs(feats, mask, k, 3, seed=7)
    want = j_kmeans_pallas.lloyd_pallas_batched(
        x_aug, mask_f, init, k, d, 10, 1.0, interpret=True
    )
    x, m, c0 = kmeans.lloyd_inputs_from_jax(
        np.asarray(x_aug), np.asarray(mask_f), np.asarray(init), k, d
    )
    labels, centers, compact = kmeans.lloyd_plain(x, m, c0, k, 10, 1.0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(
        centers.numpy(), np.asarray(want[1])[:, :, :k, :d]
    )
    np.testing.assert_allclose(compact.numpy(), np.asarray(want[2]), rtol=1e-6)


def test_lloyd_plain_matches_per_frame_pallas_kernel():
    # a single frame runs svc_tpu's per-frame twin (lloyd_pallas)
    feats, mask, k = _lloyd_case("one_frame")
    x_aug, mask_f, init, _ = _jax_lloyd_inputs(feats, mask, k, 1, seed=8)
    want = j_kmeans_pallas.lloyd_pallas(
        x_aug[0], mask_f[0], init[:, 0], k, 4, 10, 1.0, interpret=True
    )
    x, m, c0 = kmeans.lloyd_inputs_from_jax(
        np.asarray(x_aug), np.asarray(mask_f), np.asarray(init), k, 4
    )
    labels, centers, compact = kmeans.lloyd_plain(x, m, c0, k, 10, 1.0)
    np.testing.assert_array_equal(labels.numpy()[:, 0], np.asarray(want[0]))
    np.testing.assert_array_equal(
        centers.numpy()[:, 0], np.asarray(want[1])[:, :k, :4]
    )
    np.testing.assert_allclose(
        compact.numpy()[:, 0], np.asarray(want[2]), rtol=1e-6
    )


@pytest.mark.parametrize("case", ["motion", "empty_mask", "few_distinct"])
def test_kmeans_global_farthest_matches(case, segmentation):
    # the default config's k-means end to end: Gumbel seeding, Lloyd with
    # the global_farthest repair, best attempt
    s = segmentation
    if case == "motion":
        # the default config's features (mv.x, mv.y, x, y) of the fixture
        feats = np.concatenate(
            [np.moveaxis(s["mv"], -1, 1).reshape(F, 2, -1), s["feats"][:, 2:]],
            axis=1,
        )
        mask, k, keys_j, keys_t = s["mask"], 10, None, s["kt"][:, 1]
    else:
        feats, mask, k = _lloyd_case(case)
        _, _, _, keys_j = _jax_lloyd_inputs(feats, mask, k, 3, seed=5)
        keys_t = prng.key_from_jax_data(np.asarray(jax.random.key_data(keys_j)))
    if keys_j is None:
        kj, _ = _keys(s["cfg"].seed)
        keys_j = kj[:, 1]
    want = j_kmeans.kmeans_t_frames(
        jnp.asarray(feats), jnp.asarray(mask), k, keys_j,
        attempts=3, max_iter=10, epsilon=1.0, repair="global_farthest",
    )
    got = kmeans.kmeans_t_frames(
        torch.from_numpy(feats), torch.from_numpy(mask), k, keys_t,
        attempts=3, max_iter=10, epsilon=1.0, repair="global_farthest",
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)


def test_unported_options_raise(segmentation):
    # RANSAC subset_sz = 2 was refused until the port drew subsets without
    # replacement; it now runs and matches svc_tpu on the fixture's fields
    s = segmentation
    p = RansacParams(subset_sz=2)
    kj, _ = _keys(s["cfg"].seed)
    want = jax.vmap(
        lambda m, k: j_ransac.estimate_global_motion_ransac(m, p, k)
    )(jnp.asarray(s["mv"]), kj[:, 0])
    gm, rmse, inl = ransac.estimate_global_motion_ransac(
        torch.from_numpy(s["mv"]), _port(p), s["kt"][:, 0]
    )
    np.testing.assert_array_equal(gm.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(rmse.numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(want[2]))
