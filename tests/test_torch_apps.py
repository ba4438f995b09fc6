"""The port's CLIs, in-process through ``main(argv)`` with ``--device cpu``
on a tiny .npy clip: same flags and outputs as the library, unsupported
flags refused with status 1, and no silent CPU fallback for ``cuda``."""

import numpy as np
import pytest
import torch

from benchmarks.clips import make_clip
from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu.metrics import psnr
from svc_tpu_torch.apps import decoder_app, encoder_app
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder

ENC_FLAGS = [
    "--reference-compat", "1", "--device", "cpu", "--batch-size", "2",
    "--verbose", "0",
]


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("clips") / "clip.npy"
    np.save(path, make_clip(64, 48, 5, seed=5))
    return str(path)


@pytest.fixture(scope="module")
def stream_path(clip_path, tmp_path_factory):
    svc = str(tmp_path_factory.mktemp("streams") / "clip.svc")
    assert encoder_app.main(["enc", *ENC_FLAGS, "--output", svc, clip_path]) == 0
    return svc


def test_encoder_cli_matches_library(clip_path, stream_path):
    clip = np.load(clip_path)
    enc = Encoder(EncoderConfig(reference_compat=True),
                  VideoProperties(64, 48, len(clip)), batch_size=2, device="cpu")
    with open(stream_path, "rb") as f:
        assert f.read() == b"".join(enc.encode_video(iter(clip)))


def _library_decode(stream_path, gazes):
    with open(stream_path, "rb") as f:
        data = f.read()
    header = bitstream.Header.unpack(data)
    payloads = [
        data[bitstream.frame_offset(header, i):bitstream.frame_offset(header, i + 1)]
        for i in range(header.frame_count)
    ]
    dec = Decoder(DecoderConfig(), header, batch_size=8, device="cpu")
    return np.stack(list(dec.decode_frames(iter(payloads), iter(gazes))))


def test_decoder_cli_matches_library(clip_path, stream_path, tmp_path):
    out = str(tmp_path / "dec.npy")
    rc = decoder_app.main(["dec", "--device", "cpu", "--gaze", "32,24",
                           "--input", stream_path, "--output", out])
    assert rc == 0
    frames = np.load(out)
    np.testing.assert_array_equal(frames, _library_decode(stream_path, [(32, 24)] * 4))
    assert frames.shape == (4, 48, 64, 3)


def test_lossless_steps_round_trip(clip_path, stream_path, tmp_path):
    out = str(tmp_path / "dec.npy")
    rc = decoder_app.main(["dec", "--device", "cpu", "--background-quant-step",
                           "1", "--input", stream_path, "--output", out,
                           "--max-frames", "3"])
    assert rc == 0
    frames = np.load(out)
    assert frames.shape[0] == 3
    assert psnr(np.load(clip_path)[1:4], frames) > 40


@pytest.mark.parametrize(
    "flag", ["--devices", "--visualize", "--show", "--trace", "--profile",
             "--start-frame"],
)
def test_encoder_refuses_unsupported_flags(flag, clip_path, capsys):
    rc = encoder_app.main(["enc", *ENC_FLAGS, flag, "1", clip_path])
    assert rc == 1
    assert "not yet supported by svc_tpu_torch" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--devices", "--show", "--trace", "--start-frame"])
def test_decoder_refuses_unsupported_flags(flag, stream_path, capsys):
    rc = decoder_app.main(["dec", "--device", "cpu", flag, "1",
                           "--input", stream_path])
    assert rc == 1
    assert "not yet supported by svc_tpu_torch" in capsys.readouterr().err


def test_cli_cuda_without_card_fails(monkeypatch, clip_path, stream_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [f for f in ENC_FLAGS if f != "cpu" and f != "--device"]
    assert encoder_app.main(["enc", *flags, "--device", "cuda", clip_path]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert decoder_app.main(["dec", "--input", stream_path]) == 1  # default cuda
    assert "no CUDA device" in capsys.readouterr().err


def test_encoder_default_config_refused(clip_path, capsys):
    rc = encoder_app.main(["enc", "--device", "cpu", "--verbose", "0", clip_path])
    assert rc == 1
    assert "K5" in capsys.readouterr().err


def test_cli_errors(capsys, stream_path):
    assert encoder_app.main(["enc", "--bogus", "1", "x.npy"]) == 1
    assert "unexpected option name" in capsys.readouterr().err
    assert encoder_app.main(["enc", *ENC_FLAGS]) == 1
    assert "missing video path" in capsys.readouterr().err
    assert decoder_app.main(["dec", "--device", "cpu", "--gaze", "x",
                             "--input", stream_path]) == 1
    assert "bad --gaze value" in capsys.readouterr().err


def test_decoder_gaze_trajectory(stream_path, tmp_path):
    traj = tmp_path / "gaze.txt"
    traj.write_text("0 10 10\n2 50 30\n")
    out = str(tmp_path / "dec.npy")
    rc = decoder_app.main(["dec", "--device", "cpu", "--gaze-trajectory",
                           str(traj), "--input", stream_path, "--output", out])
    assert rc == 0
    want = _library_decode(stream_path, [(10, 10), (10, 10), (50, 30), (50, 30)])
    np.testing.assert_array_equal(np.load(out), want)


def test_encoder_max_frames(clip_path, stream_path, tmp_path):
    svc = str(tmp_path / "head.svc")
    rc = encoder_app.main(["enc", *ENC_FLAGS, "--max-frames", "2",
                           "--output", svc, clip_path])
    assert rc == 0
    with open(svc, "rb") as f:
        head = f.read()
    with open(stream_path, "rb") as f:
        full = f.read()
    header = bitstream.Header.unpack(head)
    assert header.frame_count == 2
    assert head[bitstream.HEADER_SIZE:] == full[
        bitstream.HEADER_SIZE:bitstream.frame_offset(header, 2)]
