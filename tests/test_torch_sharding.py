"""The port's frame-parallel split (``svc_tpu_torch.parallel.sharding``)
on CPU device lists: held to svc_tpu's ``ShardedEncoder`` and mesh
``Decoder`` on the conftest's virtual CPU devices (the cases of
tests/test_sharding.py: every output, the stream statistics, several
anchors per device, the wrong-batch errors), and to the port's own
single-device encoder and decoder (the stream byte for byte, staged and
direct, with a padded remainder batch; the decoded frames; the padded
planes in the single-device layout and the visualizer's dumps)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from svc_tpu.config import (
    DecoderConfig as JDecoderConfig,
    EncoderConfig as JEncoderConfig,
    KMeansParams as JKMeansParams,
    VideoProperties as JVideoProperties,
)
from svc_tpu.io import bitstream as j_bitstream
from svc_tpu.models.decoder import Decoder as JDecoder
from svc_tpu.models.encoder import Encoder as JEncoder
from svc_tpu.parallel.sharding import ShardedEncoder as JShardedEncoder
from svc_tpu.parallel.sharding import make_frame_mesh
from svc_tpu_torch import visualize as tvis
from svc_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    KMeansParams,
    VideoProperties,
)
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder, stream_encode
from svc_tpu_torch.parallel.sharding import ShardedEncoder, make_frame_devices

COEFF_GATE = 2.5e-4
H, W = 48, 64
# (devices, anchors per device): meshes of 2 and 4, 1 and 2 anchors each
SPLITS = [(2, 1), (2, 2), (4, 1), (4, 2)]


def _cfgs():
    """tests/test_sharding.py's config, in both packages."""
    kw = dict(mv_block_w=8, mv_block_h=8, mv_search_range=4, pyr_lvl_count=2)
    return (JEncoderConfig(kmeans=JKMeansParams(cluster_count=3), **kw),
            EncoderConfig(kmeans=KMeansParams(cluster_count=3), **kw))


def _frames(t, h=H, w=W, seed=0):
    """tests/test_sharding.py's clip: a textured pan, a fading square."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(30, 220, (24, 28)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    out = []
    for i in range(t):
        f = bg[i:i + h, i:i + w].copy()
        f[10:20, 30:40] = 240 - 5 * i
        out.append(np.repeat(f[..., None], 3, -1).astype(np.uint8))
    return np.stack(out)


def _cpu(n):
    return make_frame_devices(n, device="cpu")


@pytest.fixture(scope="module", params=SPLITS, ids=lambda s: f"{s[0]}dev-bpd{s[1]}")
def split_batch(request):
    """One split batch through svc_tpu's ShardedEncoder and the port's."""
    n_dev, bpd = request.param
    jcfg, tcfg = _cfgs()
    t = n_dev * bpd
    frames = _frames(t + 1)
    jenc = JShardedEncoder(jcfg, JVideoProperties(W, H, t + 1),
                           make_frame_mesh(n_dev), batch_per_device=bpd)
    tenc = ShardedEncoder(tcfg, VideoProperties(W, H, t + 1), _cpu(n_dev),
                          batch_per_device=bpd)
    jout = {k: np.asarray(v) for k, v in jenc.encode_batch(frames, 3).items()}
    tout = {k: v.numpy() for k, v in tenc.encode_batch(frames, 3).items()}
    return dict(n_dev=n_dev, bpd=bpd, frames=frames, jenc=jenc, tenc=tenc,
                jout=jout, tout=tout)


def test_outputs_equal_svc_tpu(split_batch):
    jout, tout = split_batch["jout"], split_batch["tout"]
    assert set(tout) == set(jout)
    for key in ("block_types", "mv_field", "foreground_mask_raw",
                "foreground_mask", "cluster_labels", "global_motion"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_allclose(tout["ransac_rmse"], jout["ransac_rmse"], rtol=1e-6)
    assert tout["coeffs"].shape == jout["coeffs"].shape
    assert np.abs(tout["coeffs"] - jout["coeffs"]).max() <= COEFF_GATE


def test_stream_statistics_equal_svc_tpu(split_batch):
    jout, tout = split_batch["jout"], split_batch["tout"]
    assert tout["total_foreground_blocks"].dtype == np.int32
    assert int(tout["total_foreground_blocks"]) == int(jout["total_foreground_blocks"])
    assert int(tout["total_foreground_blocks"]) == int(tout["foreground_mask"].sum())
    np.testing.assert_allclose(tout["mean_ransac_rmse"], jout["mean_ransac_rmse"],
                               rtol=1e-6)


def test_split_equals_single_device(split_batch):
    # svc_tpu's test_matches_single_chip_bitwise, on the port alone: every
    # output of the split batch equals one single-device batch of T anchors
    _, tcfg = _cfgs()
    t = split_batch["n_dev"] * split_batch["bpd"]
    single = Encoder(tcfg, VideoProperties(W, H, t + 1), batch_size=t, device="cpu")
    want = single.encode_batch(split_batch["frames"], 3)
    tout = split_batch["tout"]
    for key, v in want.items():
        np.testing.assert_array_equal(tout[key], v.numpy(), err_msg=key)


def test_chunk_keys_equal_svc_tpu(split_batch):
    # chunk d's anchor keys: the slice d of svc_tpu's _sharded_keys
    n_dev, bpd, tenc = split_batch["n_dev"], split_batch["bpd"], split_batch["tenc"]
    want = np.asarray(jax.random.key_data(
        split_batch["jenc"]._sharded_keys(3))).astype(np.int64)
    for d, inner in enumerate(tenc.inners):
        np.testing.assert_array_equal(inner._keys(3 + d * bpd, bpd).numpy(), want[d])


def test_halo_chunks_equal_svc_tpu(split_batch):
    frames, tenc = split_batch["frames"], split_batch["tenc"]
    chunks = tenc.chunk_frames(frames)
    assert chunks.shape == (split_batch["n_dev"], split_batch["bpd"] + 1, H, W * 3)
    np.testing.assert_array_equal(chunks, split_batch["jenc"].chunk_frames(frames))
    for d in range(1, len(chunks)):
        np.testing.assert_array_equal(chunks[d, 0], chunks[d - 1, -1])


@pytest.mark.parametrize("n_frames", [5, 7])
def test_wrong_batch_size_raises(n_frames):
    # svc_tpu's test_wrong_batch_size_raises: 4 anchors split 2 x 2
    _, tcfg = _cfgs()
    enc = ShardedEncoder(tcfg, VideoProperties(W, H, 9), _cpu(2), batch_per_device=2)
    with pytest.raises(ValueError, match="sharded batch"):
        enc.encode_batch(_frames(n_frames + 1), 0)
    with pytest.raises(ValueError, match="sharded batch"):
        enc.stage_frames(list(_frames(n_frames + 1)))


@pytest.fixture(scope="module")
def streams():
    """A 10-frame clip (9 payloads: two batches of 4 and a padded one of
    1) through the single-device encoder and the 2 x 2 split."""
    _, tcfg = _cfgs()
    clip = _frames(10)
    props = VideoProperties(W, H, len(clip))
    single = Encoder(tcfg, props, batch_size=4, device="cpu")
    split = ShardedEncoder(tcfg, props, _cpu(2), batch_per_device=2)
    return dict(clip=clip, single=single, split=split,
                want=list(single.encode_video(iter(clip))),
                got=list(split.encode_video(iter(clip))))


def test_split_stream_byte_equal(streams):
    assert len(streams["got"]) == 10
    assert streams["got"] == streams["want"]


def test_split_stream_direct_byte_equal(streams):
    # the direct protocol (no stage_frames): encode_batch per batch
    class Direct:
        def __init__(self, enc):
            self.cfg, self.batch_size = enc.cfg, enc.batch_size
            self.header, self.encode_batch = enc.header, enc.encode_batch

    got = list(stream_encode(Direct(streams["split"]), iter(streams["clip"])))
    assert got == streams["want"]


def test_split_stream_resumes(streams):
    tail = list(stream_encode(streams["split"], iter(streams["clip"][3:]),
                              emit_header=False, first_anchor_index=3))
    assert tail == streams["want"][4:]


@pytest.mark.parametrize("stage_h2d", [True, False])
def test_split_decode_equals_single_device(streams, stage_h2d):
    want = streams["want"]
    header = bitstream.Header.unpack(want[0])
    gazes = [(20 + 3 * i, 16) for i in range(len(want) - 1)]
    single = Decoder(DecoderConfig(), header, batch_size=4, device="cpu")
    split = Decoder(DecoderConfig(), header, batch_size=4, devices=_cpu(2))
    a = np.stack(list(single.decode_frames(iter(want[1:]), iter(gazes))))
    b = np.stack(list(split.decode_frames(iter(want[1:]), iter(gazes),
                                          stage_h2d=stage_h2d)))
    assert b.shape == (9, H, W, 3)
    np.testing.assert_array_equal(b, a)


def _decode_inputs(t=8, seed=5):
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=(t, H // 8, W // 8, 192)).astype(np.float32) * 30
    btypes = rng.integers(0, 4, (t, H // 8, W // 8), np.uint32)
    rects = np.tile(np.array([[8, 8, 16, 16]], np.int32), (t, 1))
    return coeffs, btypes, rects


@pytest.mark.parametrize("n_dev", [2, 4])
def test_split_decode_batch_equals_svc_tpu_mesh(n_dev):
    # svc_tpu's test_sharded_decode_bitwise: one batch of 8 on a mesh
    coeffs, btypes, rects = _decode_inputs()
    jh = j_bitstream.Header(8, W, H, 0, 0, 8, 8, 3)
    want = JDecoder(JDecoderConfig(), jh, batch_size=8,
                    mesh=make_frame_mesh(n_dev))._decode_batch(coeffs, btypes, rects)
    hd = bitstream.Header(8, W, H, 0, 0, 8, 8, 3)
    dec = Decoder(DecoderConfig(), hd, batch_size=8, devices=_cpu(n_dev))
    got = dec.decode_batch(coeffs, btypes, rects).numpy()
    np.testing.assert_array_equal(got, JDecoder.packed_bytes(want))
    staged = dec.stage_coeffs(list(coeffs))
    assert len(staged) == n_dev
    np.testing.assert_array_equal(dec.decode_batch(staged, btypes, rects).numpy(), got)


def test_split_decoder_batch_mismatch_raises():
    # svc_tpu's test_sharded_decoder_batch_mismatch_raises
    hd = bitstream.Header(4, W, H, 0, 0, 8, 8, 3)
    with pytest.raises(ValueError, match="must divide across 4 devices"):
        Decoder(DecoderConfig(), hd, batch_size=9, devices=_cpu(4))


def _vis_frames():
    rng = np.random.default_rng(7)
    coarse = rng.integers(20, 235, (20, 24)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    return np.stack([
        np.repeat(bg[8 + t:56 + t, 4 + t:68 + t, None], 3, -1).astype(np.uint8)
        for t in range(5)])


def test_padded_planes_single_device_layout():
    # svc_tpu's split keeps each chunk's halo frame in its stack (6 frames
    # for 4 anchors over 2 chunks); the port's equals the single-device
    # (3, T+1, PH, PW) stack, frame 0 the overlap frame
    _, tcfg = _cfgs()
    frames = _vis_frames()
    props = VideoProperties(W, H, 5)
    split = ShardedEncoder(tcfg, props, _cpu(2), batch_per_device=2, keep_planes=True)
    single = Encoder(tcfg, props, batch_size=4, device="cpu", keep_planes=True)
    got = split.encode_batch(frames, 0)["padded_planes"]
    assert tuple(got.shape) == (3, 5, H, W)
    np.testing.assert_array_equal(
        got.numpy(), single.encode_batch(frames, 0)["padded_planes"].numpy())
    assert "padded_planes" not in ShardedEncoder(
        tcfg, props, _cpu(2), batch_per_device=2).encode_batch(frames, 0)


def test_visualizer_dumps_equal_unsplit(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # .npy dumps, no titles
    _, tcfg = _cfgs()
    frames = _vis_frames()
    props = VideoProperties(W, H, 5)
    sdir, udir = str(tmp_path / "split"), str(tmp_path / "single")
    split = ShardedEncoder(tcfg, props, _cpu(2), batch_per_device=2, keep_planes=True)
    single = Encoder(tcfg, props, batch_size=4, device="cpu", keep_planes=True)
    a = list(tvis.VisualizingEncoder(split, sdir).encode_video(iter(frames)))
    b = list(tvis.VisualizingEncoder(single, udir).encode_video(iter(frames)))
    assert a == b and len(a) == 5
    names = sorted(os.listdir(sdir))
    assert names == sorted(os.listdir(udir)) == [f"frame_{i:05d}.npy" for i in range(4)]
    for name in names:
        np.testing.assert_array_equal(np.load(os.path.join(sdir, name)),
                                      np.load(os.path.join(udir, name)))


def test_visualizer_requires_planes_when_split(tmp_path):
    _, tcfg = _cfgs()
    split = ShardedEncoder(tcfg, VideoProperties(W, H, 5), _cpu(2), batch_per_device=2)
    with pytest.raises(ValueError, match="keep_planes"):
        tvis.VisualizingEncoder(split, str(tmp_path))


def test_make_frame_devices_cpu_and_lists():
    assert make_frame_devices(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_frame_devices(device="cpu") == [torch.device("cpu")]
    assert make_frame_devices(devices=["cpu", "cpu", "cpu"], n_devices=2) == [
        torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="unsupported device type"):
        make_frame_devices(2, device="meta")


def test_make_frame_devices_cuda_counts(monkeypatch):
    # no card: cuda raises, nothing runs on the CPU in its place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_frame_devices(2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_frame_devices(devices=["cuda:0", "cuda:0"])
    # one card: cuda:0 alone, and svc_tpu's message for more
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_frame_devices(1, device="cuda:0") == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_frame_devices(2, device="cuda")
    assert make_frame_devices(devices=["cuda:0", "cuda:0"]) == [
        torch.device("cuda", 0)] * 2
