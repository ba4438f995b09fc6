"""The port's own host layer against svc_tpu's: the wire format (header,
frame and block bytes, on the native and the NumPy path), config
validation, carrying a config across, the CLI parser, video files and PSNR
give the same bytes, codes and values."""

import dataclasses
import io

import numpy as np
import pytest

from svc_tpu import config as j_config
from svc_tpu import metrics as j_metrics
from svc_tpu.io import bitstream as j_bs
from svc_tpu.io import video as j_video
from svc_tpu.runtime import native as j_native
from svc_tpu.utils import cli as j_cli
from svc_tpu_torch import config, metrics
from svc_tpu_torch.apps import decoder_app, encoder_app
from svc_tpu_torch.io import bitstream, video
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.runtime import native
from svc_tpu_torch.tools.clips import make_clip
from svc_tpu_torch.utils import cli


@pytest.fixture(params=["native", "numpy"])
def wire_path(request, monkeypatch):
    """Both serializers on the native library, or both on NumPy."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(j_native, "load", lambda: None)
    elif not (native.available() and j_native.available()):
        pytest.skip("the native host library does not build here")
    return request.param


def _header_fields(rng):
    return [int(v) for v in rng.integers(0, 2**32, 8, dtype=np.uint64)]


def test_header_bytes_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        fields = _header_fields(rng)
        raw = bitstream.Header(*fields).pack()
        assert raw == j_bs.Header(*fields).pack()
        assert bitstream.Header.unpack(raw) == bitstream.Header(*fields)
    assert bitstream.HEADER_SIZE == j_bs.HEADER_SIZE == 32
    assert bitstream.BLOCK_TYPE_BACKGROUND == j_bs.BLOCK_TYPE_BACKGROUND


@pytest.mark.parametrize("c,ph,pw,tb,mvb", [(3, 32, 48, 8, 16), (1, 24, 40, 4, 8)])
def test_frame_and_block_bytes_equal(wire_path, c, ph, pw, tb, mvb):
    rng = np.random.default_rng(ph * pw)
    coeffs = rng.normal(size=(c, ph, pw)).astype(np.float32) * 100
    types = rng.integers(0, 5, (-(-ph // mvb), -(-pw // mvb))).astype(np.uint32)
    raw = bitstream.serialize_frame(coeffs, types, tb, tb, mvb, mvb)
    assert raw == j_bs.serialize_frame(coeffs, types, tb, tb, mvb, mvb)
    blocks = np.ascontiguousarray(
        coeffs.reshape(c, ph // tb, tb, pw // tb, tb).transpose(1, 3, 0, 2, 4)
    )
    raw_b = bitstream.serialize_frame_blocks(blocks, types, mvb, mvb)
    assert raw_b == j_bs.serialize_frame_blocks(blocks, types, mvb, mvb) == raw
    hdr = bitstream.Header(2, pw, ph, 0, 0, tb, tb, c)
    j_hdr = j_bs.Header(*dataclasses.astuple(hdr))
    for got, want in zip(bitstream.deserialize_frame(raw, hdr),
                         j_bs.deserialize_frame(raw, j_hdr)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(bitstream.deserialize_frame_blocks(raw, hdr),
                         j_bs.deserialize_frame_blocks(raw, j_hdr)):
        np.testing.assert_array_equal(got, want)
    stream = raw + raw[::-1]
    assert list(bitstream.read_frames(io.BytesIO(stream), hdr)) == list(
        j_bs.read_frames(io.BytesIO(stream), j_hdr)
    )
    with pytest.raises(ValueError, match="failed to read block"):
        list(bitstream.read_frames(io.BytesIO(stream[:-1]), hdr))


def test_encoder_stream_bytes_equal_svc_tpu_serializer(wire_path):
    # the port's stream is svc_tpu's serializer applied to the port's own
    # coefficients and block types, byte for byte
    clip = make_clip(64, 48, 3, seed=2)
    cfg = config.EncoderConfig(reference_compat=True)
    enc = Encoder(cfg, config.VideoProperties(64, 48, 3), batch_size=2,
                  device="cpu")
    stream = list(enc.encode_video(iter(clip)))
    out = enc.encode_batch(clip, 0)
    c = out["coeffs"].numpy()
    t, nby, nbx, _ = c.shape
    blocks = c.reshape(t, nby, nbx, 3, 8, 8)
    types = out["block_types"].numpy().astype(np.uint32)
    assert stream[0] == j_bs.Header(*dataclasses.astuple(enc.header())).pack()
    for i in range(t):
        assert stream[1 + i] == j_bs.serialize_frame_blocks(blocks[i], types[i], 16, 16)


# bad configs: one field off per case, nested params included
ENCODER_CASES = [
    {}, {"mv_block_w": 0}, {"mv_block_h": 0}, {"pyr_lvl_count": 0},
    {"mv_search_range": 4}, {"ransac": {"inlier_thresh": -1.0}},
    {"ransac": {"success_prob": -0.5}}, {"ransac": {"inlier_ratio": -0.1}},
    {"kmeans": {"cluster_count": 0}}, {"kmeans": {"attempt_count": 0}},
    {"kmeans": {"max_iter_count": 0}}, {"kmeans": {"epsilon": 0.0}},
    {"connected_components_connectivity": 6}, {"transform_block_w": 0},
    {"transform_block_h": 0}, {"transform_block_w": 32},
    {"transform_block_h": 32}, {"transform_block_w": 6},
    {"transform_block_h": 6},
]


def _with(cls, overrides):
    d = dataclasses.asdict(cls())
    for k, v in overrides.items():
        d[k] = {**d[k], **v} if isinstance(v, dict) else v
    return d


@pytest.mark.parametrize("overrides", ENCODER_CASES)
def test_validate_encoder_config_equal(overrides):
    d = _with(j_config.EncoderConfig, overrides)
    j_cfg = j_config.EncoderConfig(**{
        **d, "ransac": j_config.RansacParams(**d["ransac"]),
        "kmeans": j_config.KMeansParams(**d["kmeans"]),
    })
    cfg = config.from_dict(config.EncoderConfig, dataclasses.asdict(j_cfg))
    assert isinstance(cfg.ransac, config.RansacParams)
    assert isinstance(cfg.kmeans, config.KMeansParams)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    got = config.validate_encoder_config(cfg)
    want = j_config.validate_encoder_config(j_cfg)
    assert (got.code.name, got.code.value, got.message) == (
        want.code.name, want.code.value, want.message)
    assert got.ok == (overrides == {})


@pytest.mark.parametrize("overrides", [{}, {"foreground_quant_step": 0},
                                       {"background_quant_step": 0}])
def test_validate_decoder_config_equal(overrides):
    j_cfg = j_config.DecoderConfig(**_with(j_config.DecoderConfig, overrides))
    cfg = config.from_dict(config.DecoderConfig, dataclasses.asdict(j_cfg))
    got = config.validate_decoder_config(cfg)
    want = j_config.validate_decoder_config(j_cfg)
    assert (got.code.value, got.message) == (want.code.value, want.message)


def test_from_dict_carries_every_config():
    props = config.from_dict(config.VideoProperties,
                             dataclasses.asdict(j_config.VideoProperties(1920, 1080, 17)))
    assert props == config.VideoProperties(1920, 1080, 17)
    cfg = config.from_dict(config.EncoderConfig, {"kmeans": {"cluster_count": 4}})
    assert cfg.kmeans.cluster_count == 4 and cfg.mv_block_w == 16
    with pytest.raises(ValueError, match="unknown fields"):
        config.from_dict(config.DecoderConfig, {"quant_step": 1})


APP_ARGVS = [
    ["app", "--mv-block-w", "8", "--ransac-inlier-thresh", "2.5e1", "clip.npy"],
    ["app", "--kmeans-cluster-count", "-3", "--seed", "12abc", "--", "x"],
    ["app", "--verbose", "x1"],
    ["app", "--bogus", "1"],
    ["app", "--device", " cuda  cpu", "--output", "a b.svc", "f"],
    ["app", "--transform-block-w"],
    ["app", "--gaze", "3,4", "--foreground-quant-step", "7", "--input", "s"],
    ["app", "--max-gaze-rect-w", "+9", "--background-quant-step", "1e3"],
]


@pytest.mark.parametrize("argv", APP_ARGVS)
@pytest.mark.parametrize("app", [encoder_app, decoder_app])
def test_cli_parsing_equal_on_app_flags(app, argv):
    # the apps' option tables through both parsers: same status, same
    # stop index, same values set
    def run(parser, to_opt):
        c = app._AppConfig()
        opts = [to_opt(o) for o in app._opts(c)]
        status, argi = parser.parse_opts(argv, opts)
        return status.name, argi, dataclasses.asdict(
            c.encoder if app is encoder_app else c.decoder), vars(c).copy()

    got = run(cli, lambda o: o)
    want = run(j_cli, lambda o: j_cli.Opt(
        o.name, j_cli.OptArgType[o.arg_type.name], o.setter))
    assert got[:3] == want[:3]
    keep = {k: v for k, v in got[3].items() if k not in ("encoder", "decoder")}
    assert keep == {k: v for k, v in want[3].items() if k not in ("encoder", "decoder")}
    assert cli.status_message(cli.Status[got[0]]) == j_cli.status_message(
        j_cli.Status[want[0]])


@pytest.mark.parametrize("ext", ["y4m", "npy", "avi"])
def test_video_files_equal(tmp_path, ext):
    frames = make_clip(32, 16, 3, seed=4)
    writers = {
        "y4m": (video.write_y4m_video, j_video.write_y4m_video),
        "npy": (video.write_npy_video, j_video.write_npy_video),
        "avi": (video.write_raw_avi, j_video.write_raw_avi),
    }[ext]
    paths = [str(tmp_path / f"{who}.{ext}") for who in ("port", "ref")]
    writers[0](paths[0], frames)
    writers[1](paths[1], frames)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    r_port, r_ref = video.VideoReader(paths[0]), j_video.VideoReader(paths[1])
    try:
        assert dataclasses.asdict(r_port.props) == dataclasses.asdict(r_ref.props)
        got, want = np.stack(list(r_port)), np.stack(list(r_ref))
    finally:
        r_port.close()
        r_ref.close()
    np.testing.assert_array_equal(got, want)
    if ext != "y4m":  # y4m goes through YUV and is lossy
        np.testing.assert_array_equal(got, frames)


def test_psnr_equal():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-3, 4, a.shape), 0, 255)
    assert metrics.psnr(a, b) == j_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == j_metrics.psnr(a, a) == float("inf")
    assert metrics.bitrate_bits_per_pixel(1000, 8, 8, 2) == (
        j_metrics.bitrate_bits_per_pixel(1000, 8, 8, 2))


def test_make_clip_copy_equal():
    from benchmarks.clips import make_clip as j_make_clip

    np.testing.assert_array_equal(make_clip(48, 32, 3, seed=5),
                                  j_make_clip(48, 32, 3, seed=5))
