"""The compiled encode batch on the CPU: the draws K11 takes over, held to
jax.random at the exact shapes of the encode path; the K10 and K11
wrappers' dispatch on a meta device; the launch accounting of a captured
CUDA graph; and the CPU encoder, which never captures, byte-equal to
svc_tpu's stream.

K10 (``csrc/ccl_converge.cu``) and K11 (``csrc/threefry.cu``) have no CPU
mode; ``tests/test_torch_cuda.py`` holds them to these plain versions on
the card. The plain CCL loop's adversarial inputs are cases of
``tests/test_torch_segmentation.py``'s block-type tests.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.config import EncoderConfig as JEncoderConfig
from svc_tpu.config import VideoProperties as JVideoProperties
from svc_tpu.models.encoder import Encoder as JEncoder
from svc_tpu_torch.config import EncoderConfig, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.kernels import build
from svc_tpu_torch.models import encoder as encoder_mod
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.ops import ccl, prng
from svc_tpu_torch.tools.clips import make_clip

T, F, A, K, N = 8, 8, 3, 10, 8160  # 1080p batch: 8 anchors, 68 x 120 blocks
COEFF_GATE = 2.5e-4


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.fixture(scope="module")
def path_keys():
    """The encode path's keys for anchors 0..7 of seed 0 in both packages:
    anchor keys, their (ransac, kmeans) split, the kmeans attempt keys."""
    anchors_j = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(T))
    pair_j = jax.vmap(jax.random.split)(anchors_j)
    attempts_j = jax.vmap(lambda k: jax.random.split(k, A))(pair_j[:, 1])
    anchors_t = prng.fold_in(prng.key(0), torch.arange(T))
    pair_t = prng.split(anchors_t)
    attempts_t = prng.split(pair_t[:, 1], A)
    return dict(anchors=(anchors_j, anchors_t), pair=(pair_j, pair_t),
                attempts=(attempts_j, attempts_t))


def test_anchor_keys_and_split_at_the_path_shapes(path_keys):
    for name in ("anchors", "pair", "attempts"):
        kj, kt = path_keys[name]
        np.testing.assert_array_equal(_data(kj), kt.numpy(), err_msg=name)
    assert path_keys["attempts"][1].shape == (F, A, 2)


def test_seeding_uniform_at_the_path_shape(path_keys):
    # the k-means++ gumbel draw of a 1080p batch: F x A keys x (k, N)
    kj, kt = path_keys["attempts"]
    uj = jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, (K, N), dtype=jnp.float32, minval=1e-12, maxval=1.0)))(kj)
    ut = prng.uniform(kt, (K, N), 1e-12, 1.0)
    assert ut.shape == (F, A, K, N) and ut.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(uj).view(np.uint32),
                                  ut.numpy().view(np.uint32))


def test_random_bits_and_randint_at_the_path_shape(path_keys):
    # RANSAC at subset 1: randint((7, 1), 0, N) per frame, its two bit
    # streams drawn from a split of the frame's key
    kj, kt = path_keys["pair"]
    rj = jax.vmap(lambda k: jax.random.randint(k, (7, 1), 0, N))(kj[:, 0])
    rt = prng.randint(kt[:, 0], (7, 1), 0, N)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    bj = jax.vmap(lambda k: jax.random.bits(k, (7, 1)))(kj[:, 0])
    bt = prng.random_bits(kt[:, 0], (7, 1))
    np.testing.assert_array_equal(np.asarray(bj).astype(np.int64), bt.numpy())


def test_fold_in_scalar_and_broadcast_data():
    kj = jax.random.key(1234)
    kt = prng.key(1234)
    np.testing.assert_array_equal(_data(jax.random.fold_in(kj, 2**32 - 1)),
                                  prng.fold_in(kt, 2**32 - 1).numpy())
    keys_j = jax.random.split(kj, 4)
    keys_t = prng.split(kt, 4)
    want = jax.vmap(lambda k: jax.random.fold_in(k, 9))(keys_j)
    np.testing.assert_array_equal(_data(want), prng.fold_in(keys_t, 9).numpy())
    want = jax.vmap(jax.random.fold_in)(keys_j, jnp.arange(4))
    np.testing.assert_array_equal(_data(want),
                                  prng.fold_in(keys_t, torch.arange(4)).numpy())


@pytest.mark.parametrize("n_counts,both", [(1, True), (5, True), (7, False)])
def test_threefry_words_equals_the_cipher(n_counts, both):
    keys = prng.split(prng.key(77), 6).reshape(2, 3, 2)
    data = torch.arange(6 * n_counts, dtype=torch.int64).reshape(2, 3, n_counts)
    data = data * 0x9E3779B1 + (1 << 33)  # high bits are not read
    for d in (None, data):
        got = prng.threefry_words(keys, n_counts, d, both=both)
        x1 = torch.arange(n_counts) if d is None else d & 0xFFFFFFFF
        o0, o1 = prng.threefry2x32(keys[..., 0:1], keys[..., 1:2],
                                   torch.zeros((), dtype=torch.int64), x1)
        want = torch.stack([o0, o1], -1) if both else o0 ^ o1
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K10 / K11 dispatch on a meta device (shapes and arguments, no compute)
# ---------------------------------------------------------------------------


@pytest.fixture
def meta_launches(monkeypatch):
    launched = []
    for mod in (ccl, prng):
        monkeypatch.setattr(mod, "_check_cuda", lambda x: None)
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (ccl.CCL_CONVERGE, prng.THREEFRY):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


@pytest.mark.parametrize(
    "b,h,w,global_memory,want_global",
    [(8, 68, 120, False, 0),     # 1080p: 40,800 B of shared memory
     (8, 135, 240, False, 0),    # 4K: 162,000 B
     (2, 270, 480, False, 1),    # 8K: past shared memory
     (8, 68, 120, True, 1)],
)
def test_ccl_converge_dispatch(meta_launches, b, h, w, global_memory, want_global):
    lab = torch.zeros((b, h, w), dtype=torch.int32, device="meta")
    out = ccl.converge_labels(lab, 8, global_memory=global_memory)
    assert out.dtype == torch.int64 and tuple(out.shape) == (b, h, w)
    ((name, args),) = meta_launches
    assert name == "ccl_converge" and len(args) == len(ccl.CCL_CONVERGE.argtypes)
    assert args[3:8] == (b, h, w, 8, want_global)
    assert (args[2] is None) == (not want_global)  # scratch only for global
    assert (h * w <= ccl.K10_SHARED_CELLS) == (5 * h * w <= 227 * 1024)


def test_ccl_converge_rejects_bad_connectivity(meta_launches):
    lab = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="connectivity"):
        ccl.converge_labels(lab, 6)
    assert not meta_launches


def test_threefry_dispatch_of_the_path_draws(meta_launches):
    keys = torch.zeros((F, 2), dtype=torch.int64, device="meta")
    assert tuple(prng.split(keys).shape) == (F, 2, 2)
    attempts = prng.split(keys, A)
    assert tuple(attempts.shape) == (F, A, 2)
    u = prng.uniform(attempts, (K, N), 1e-12, 1.0)
    assert tuple(u.shape) == (F, A, K, N) and u.dtype == torch.float32
    r = prng.randint(keys, (7, 1), 0, N)
    assert tuple(r.shape) == (F, 7, 1) and r.dtype == torch.int32
    f = prng.fold_in(torch.zeros((2,), dtype=torch.int64, device="meta"),
                     torch.zeros((T,), dtype=torch.int64, device="meta"))
    assert tuple(f.shape) == (T, 2)
    # (n_keys, n_counts, both, data given): split, split(3), uniform's bits,
    # randint's split and two bit streams, fold_in
    got = [(a[3], a[4], a[5], a[1] is not None) for _, a in meta_launches]
    assert got == [(F, 2, 1, False), (F, A, 1, False), (F * A, K * N, 0, False),
                   (F, 2, 1, False), (F, 7, 0, False), (F, 7, 0, False),
                   (T, 1, 1, True)]


def test_threefry_rejects_bad_keys(meta_launches):
    with pytest.raises(TypeError, match="int64"):
        prng.split(torch.zeros((3, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError, match="data"):
        prng.threefry_words(torch.zeros((3, 2), dtype=torch.int64, device="meta"),
                            4, torch.zeros((3, 5), dtype=torch.int64, device="meta"))
    assert not meta_launches


# ---------------------------------------------------------------------------
# Launch accounting of a capture
# ---------------------------------------------------------------------------


def test_captured_launches_count_per_replay(monkeypatch):
    # a launch inside a capture is recorded for the graph, not counted;
    # each replay adds the recorded launches
    monkeypatch.setattr(prng.THREEFRY, "_fn", lambda *a: 0)
    monkeypatch.setattr(prng.THREEFRY, "launches", 0)
    prng.THREEFRY.launch()
    with build.captured_launches() as counts:
        prng.THREEFRY.launch()
        prng.THREEFRY.launch()
    assert prng.THREEFRY.launches == 1 and counts == {"threefry2x32": 2}
    build.add_launches(counts)
    build.add_launches(counts)
    assert prng.THREEFRY.launches == 5
    prng.THREEFRY.launch()  # outside again: counted
    assert prng.THREEFRY.launches == 6


def test_captured_launches_nest_and_restore(monkeypatch):
    monkeypatch.setattr(prng.THREEFRY, "_fn", lambda *a: 0)
    monkeypatch.setattr(prng.THREEFRY, "launches", 0)
    with build.captured_launches() as outer:
        with build.captured_launches() as inner:
            prng.THREEFRY.launch()
        prng.THREEFRY.launch()
    assert inner == {"threefry2x32": 1} and outer == {"threefry2x32": 1}
    assert prng.THREEFRY.launches == 0


# ---------------------------------------------------------------------------
# The CPU encoder runs eagerly and stays byte-equal to svc_tpu
# ---------------------------------------------------------------------------


class _NoGraph:
    def __init__(self, *a, **k):
        raise AssertionError("a CPU encoder touched torch.cuda.CUDAGraph")


@pytest.mark.parametrize("reference_compat", [False, True])
def test_cpu_encoder_never_captures_and_matches_svc_tpu(monkeypatch,
                                                         reference_compat):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(encoder_mod, "GraphPair", _NoGraph)
    w, h, n = 64, 48, 6
    clip = make_clip(w, h, n, seed=5)
    enc = Encoder(EncoderConfig(reference_compat=reference_compat),
                  VideoProperties(w, h, n), batch_size=2, device="cpu")
    assert enc.graph is False and not enc._graphs
    got = list(enc.encode_video(iter(clip)))
    jenc = JEncoder(JEncoderConfig(reference_compat=reference_compat),
                    JVideoProperties(w, h, n), batch_size=2)
    want = list(jenc.encode_video(iter(clip)))
    # the repo's stream equality: header and block types byte for byte,
    # coefficients within the DCT gate (tests/test_torch_roundtrip.py)
    assert got[0] == want[0] and len(got) == len(want) == n
    header = bitstream.Header.unpack(got[0])
    for a, b in zip(got[1:], want[1:]):
        ta, ca = bitstream.deserialize_frame_blocks(a, header)
        tb, cb = bitstream.deserialize_frame_blocks(b, header)
        np.testing.assert_array_equal(ta, tb)
        assert np.abs(ca.astype(np.float64) - cb).max() <= COEFF_GATE
    assert not enc._graphs


def test_graph_flag_is_ignored_on_the_cpu():
    enc = Encoder(EncoderConfig(), VideoProperties(32, 32, 3), batch_size=2,
                  device="cpu", graph=True)
    assert enc.graph is False
    buf = io.BytesIO()
    for chunk in enc.encode_video(iter(make_clip(32, 32, 3, seed=1))):
        buf.write(chunk)
    assert len(buf.getvalue()) > 0 and not enc._graphs
