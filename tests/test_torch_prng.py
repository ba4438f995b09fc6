"""ops.prng reproduces the jax.random derivations the encoder uses, bit for
bit (jax_threefry_partitionable=True)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu_torch.ops import prng

SEEDS = [0, 7, 12345, 2**31 - 1]


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    kj = jax.random.key(seed)
    kt = prng.key(seed)
    np.testing.assert_array_equal(_data(kj), kt.numpy())
    fj = jax.vmap(lambda i: jax.random.fold_in(kj, i))(jnp.arange(5, 21))
    ft = prng.fold_in(kt, torch.arange(5, 21))
    np.testing.assert_array_equal(_data(fj), ft.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split(seed, num):
    kj = jax.random.fold_in(jax.random.key(seed), 3)
    kt = prng.fold_in(prng.key(seed), 3)
    np.testing.assert_array_equal(
        _data(jax.random.split(kj, num)), prng.split(kt, num).numpy()
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_points", [1, 8, 8160, 70000])
def test_randint_matches(seed, n_points):
    keys_j = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(4)
    )
    keys_t = prng.fold_in(prng.key(seed), torch.arange(4))
    rj = jax.vmap(lambda k: jax.random.randint(k, (7, 1), 0, n_points))(keys_j)
    rt = prng.randint(keys_t, (7, 1), 0, n_points)
    assert rt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_match(seed):
    # the k-means++ gumbel draw: uniform(minval=1e-12, maxval=1.0), (k, N)
    kj = jax.random.split(jax.random.key(seed), 3)
    kt = prng.split(prng.key(seed), 3)
    uj = jax.vmap(
        lambda k: jax.random.uniform(
            k, (10, 53), dtype=jnp.float32, minval=1e-12, maxval=1.0
        )
    )(kj)
    ut = prng.uniform(kt, (10, 53), 1e-12, 1.0)
    assert ut.dtype == torch.float32
    np.testing.assert_array_equal(
        np.asarray(uj).view(np.uint32), ut.numpy().view(np.uint32)
    )
    assert float(ut.min()) >= 1e-12 and float(ut.max()) < 1.0


def test_key_from_jax_data_round_trips():
    kj = jax.random.fold_in(jax.random.key(99), 123)
    kt = prng.key_from_jax_data(np.asarray(jax.random.key_data(kj)))
    np.testing.assert_array_equal(
        _data(jax.random.split(kj)), prng.split(kt).numpy()
    )


def test_threefry_known_answer():
    # Random123 known-answer vector for threefry2x32 (20 rounds), the
    # same vector jax's own tests check
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    o0, o1 = prng.threefry2x32(t(0x13198A2E), t(0x03707344),
                               t(0x243F6A88), t(0x85A308D3))
    assert (int(o0), int(o1)) == (0xC4923A9C, 0x483DF7A0)
