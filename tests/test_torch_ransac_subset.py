"""RANSAC with subsets larger than one vector, port vs svc_tpu: the
without-replacement draw (``prng.permutation`` / ``prng.choice`` against
``jax.random.permutation`` / ``choice(replace=False)``, bit for bit, across
the shuffle's round-count boundary and with equal sort keys), then
``estimate_global_motion_ransac`` at subsets 2, 3 and 8 (indices, global
motion and inlier masks bit-equal, RMSE within rtol 1e-6), and one encoder
batch at subset 3 (headers and block types byte-equal, coefficients within
the DCT gate)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.config import EncoderConfig, RansacParams, VideoProperties
from svc_tpu.models import encoder as j_enc
from svc_tpu.ops import ransac as j_ransac
from svc_tpu_torch import config
from svc_tpu_torch.models import encoder as t_enc
from svc_tpu_torch.ops import prng, ransac
from svc_tpu_torch.tools.clips import make_clip

COEFF_GATE = 2.5e-4


def _port(params):
    """A svc_tpu config carried across to the port's."""
    return config.from_dict(getattr(config, type(params).__name__),
                            dataclasses.asdict(params))


def _keys(seed, n):
    """``fold_in(key(seed), i)`` for ``i < n``, both packages."""
    kj = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n)
    )
    return kj, prng.fold_in(prng.key(seed), torch.arange(n))


@pytest.mark.parametrize("n", [1, 2, 396, 1625, 1626, 8160])
def test_permutation_and_choice_match_jax(n):
    # 1625 is the last size of one shuffle round, 1626 the first of two;
    # 8160 is the 1080p MV field
    kj, kt = _keys(11, 6)
    kj = kj.reshape(2, 3)
    kt = kt.reshape(2, 3, 2)
    pj = jax.vmap(jax.vmap(lambda k: jax.random.permutation(k, n)))(kj)
    pt = prng.permutation(kt, n)
    assert pt.shape == (2, 3, n) and pt.dtype == torch.int64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for m in sorted({min(n, 3), min(n, 8)}):
        cj = jax.vmap(jax.vmap(
            lambda k: jax.random.choice(k, n, (m,), replace=False)))(kj)
        np.testing.assert_array_equal(
            prng.choice(kt, n, m).numpy(), np.asarray(cj)
        )


def test_shuffle_rounds_boundary():
    assert [prng.shuffle_rounds(n) for n in (1, 2, 1625, 1626, 8160, 32400)] == [
        0, 1, 1, 2, 2, 2
    ]


def test_sort_by_keys_keeps_equal_keys_in_order():
    # constructed sort keys: few distinct words, some past 2**31 (uint32
    # order, not int32 order), many equal ones
    rng = np.random.default_rng(3)
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    bits = words[rng.integers(0, len(words), (4, 257))]
    values = rng.permutation(4 * 257).reshape(4, 257).astype(np.int32)
    _, want = jax.vmap(jax.lax.sort_key_val)(jnp.asarray(bits), jnp.asarray(values))
    got = prng.sort_by_keys(
        torch.from_numpy(values.astype(np.int64)),
        torch.from_numpy(bits.astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_permutation_with_colliding_sort_keys():
    # at n = 200000 a round's 32-bit sort keys collide (birthday bound),
    # so only the stable order of equal keys gives jax's permutation
    n = 200000
    kj, kt = _keys(2, 1)
    carried, first = prng.split(kt[0])
    second = prng.split(carried)[1]
    bits = [prng.random_bits(sub, (n,)) for sub in (first, second)]
    assert all(len(torch.unique(b)) < n for b in bits)
    np.testing.assert_array_equal(
        prng.permutation(kt[0], n).numpy(),
        np.asarray(jax.random.permutation(kj[0], n)),
    )


def _integer_fields(f, h, w, seed):
    """Integer MV fields as the encoder gives them: a global pan, moving
    blobs, sparse noise."""
    rng = np.random.default_rng(seed)
    mv = np.zeros((f, h, w, 2), np.float32)
    mv[..., 0], mv[..., 1] = 2, -1
    for i in range(f):
        for _ in range(3):
            y, x = rng.integers(0, h - 3), rng.integers(0, w - 4)
            mv[i, y:y + 3, x:x + 4] = rng.integers(-8, 9, 2)
        noise = rng.random((h, w, 1)) < 0.3
        mv[i] += noise * rng.integers(-3, 4, (h, w, 2))
    return mv


def _ransac_both(mv, params, seed=5):
    kj, kt = _keys(seed, mv.shape[0])
    want = jax.vmap(
        lambda m, k: j_ransac.estimate_global_motion_ransac(m, params, k)
    )(jnp.asarray(mv), kj)
    got = ransac.estimate_global_motion_ransac(
        torch.from_numpy(mv), _port(params), kt
    )
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_ransac_equal(want, got):
    np.testing.assert_array_equal(got[0], want[0])  # global motion
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)  # RMSE
    np.testing.assert_array_equal(got[2], want[2])  # inlier mask


@pytest.mark.parametrize("subset", [2, 3, 8])
@pytest.mark.parametrize("field", ["encoder", "1080p"])
def test_ransac_subset_matches(subset, field):
    # "encoder": 4 frames of a 16x8 field; "1080p": one 120x68 field (8160
    # vectors, two shuffle rounds)
    f, h, w = (4, 8, 16) if field == "encoder" else (1, 68, 120)
    mv = _integer_fields(f, h, w, seed=subset)
    want, got = _ransac_both(mv, RansacParams(subset_sz=subset))
    _assert_ransac_equal(want, got)
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("subset", [2, 3, 8])
def test_ransac_subset_indices_match(subset):
    # the hypotheses' index sets: split(key, k), then choice per key
    n, k = 128, ransac.iter_count(config.RansacParams(subset_sz=subset))
    kj, kt = _keys(9, 2)
    want = jax.vmap(lambda key: jax.vmap(
        lambda kk: jax.random.choice(kk, n, (subset,), replace=False)
    )(jax.random.split(key, k)))(kj)
    got = prng.choice(prng.split(kt, k), n, subset)
    assert got.shape == (2, k, subset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(len(set(row)) == subset for row in got.reshape(-1, subset).tolist())


@pytest.mark.parametrize("subset", [2, 3])
def test_ransac_subset_degenerate(subset):
    # every vector far from every other: each hypothesis (a subset mean)
    # has at most one inlier, fewer than the subset, so the best hypothesis
    # and its subset RMSE are kept
    mv = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2) * 100
    want, got = _ransac_both(mv, RansacParams(subset_sz=subset), seed=3)
    _assert_ransac_equal(want, got)
    assert got[2].sum(axis=(1, 2)).max() < subset


def test_ransac_subset_hypotheses_capped():
    # inlier ratio 0.05 at subset 2 asks for 1840 hypotheses, past the cap
    # of 1644 for the 1080p field
    p = RansacParams(subset_sz=2, inlier_ratio=0.05)
    assert j_ransac.iter_count(p) > j_ransac.hypothesis_cap(68 * 120)
    want, got = _ransac_both(_integer_fields(1, 68, 120, seed=4), p)
    _assert_ransac_equal(want, got)


def test_ransac_subset_larger_than_field_raises():
    with pytest.raises(ValueError, match="smaller than RANSAC subset"):
        ransac.estimate_global_motion_ransac(
            torch.zeros((1, 1, 2, 2)), config.RansacParams(subset_sz=3),
            prng.split(prng.key(0), 1)[:, 0],
        )


@pytest.fixture(scope="module")
def subset3_batch():
    """One 128x120 encoder batch at subset 3, both packages."""
    w, h, n = 128, 120, 5
    clip = make_clip(w, h, n, seed=7)
    cfg = EncoderConfig(ransac=RansacParams(subset_sz=3))
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=4)
    tenc = t_enc.Encoder(_port(cfg), _port(props), batch_size=4, device="cpu")
    jb = {k: np.array(v) for k, v in jenc.encode_batch(clip, 0).items()}
    tb = {k: v.numpy() for k, v in tenc.encode_batch(clip, 0).items()}
    return dict(jenc=jenc, tenc=tenc, jb=jb, tb=tb)


def test_encoder_subset3_matches(subset3_batch):
    s = subset3_batch
    jb, tb = s["jb"], s["tb"]
    assert s["tenc"].header().pack() == s["jenc"].header().pack()
    for key in ("mv_field", "global_motion", "foreground_mask_raw",
                "foreground_mask", "cluster_labels", "block_types"):
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    np.testing.assert_allclose(tb["ransac_rmse"], jb["ransac_rmse"], rtol=1e-6)
    assert np.abs(tb["coeffs"] - jb["coeffs"]).max() <= COEFF_GATE
    assert (tb["block_types"] > 0).any()
