"""The port's CLIs, in-process through ``main(argv)`` with ``--device cpu``
on a tiny .npy clip: same flags and outputs as the library, unsupported
flags refused with status 1, and no silent CPU fallback for ``cuda``; the
encoder runs the default config unless ``--reference-compat 1``."""

import numpy as np
import pytest
import torch

from svc_tpu_torch.apps import decoder_app, encoder_app
from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.metrics import psnr
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.tools.clips import make_clip

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
    "flag", ["--devices", "--visualize", "--show", "--trace", "--profile"],
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


def test_resume_produces_identical_stream(clip_path, stream_path, tmp_path):
    # svc_tpu's test of the same name (tests/test_apps.py): the full stream
    # up to payload 2, then the tail that --start-frame 2 --no-header 1
    # writes, is the full stream byte for byte
    tail = str(tmp_path / "tail.svc")
    rc = encoder_app.main(["enc", *ENC_FLAGS, "--start-frame", "2",
                           "--no-header", "1", "--output", tail, clip_path])
    assert rc == 0
    with open(stream_path, "rb") as f:
        full = f.read()
    with open(tail, "rb") as f:
        tail_bytes = f.read()
    header = bitstream.Header.unpack(full)
    assert len(tail_bytes) == len(full) - bitstream.frame_offset(header, 2) > 0
    assert full[:bitstream.frame_offset(header, 2)] + tail_bytes == full


def test_start_frame_with_header_and_max_frames(clip_path, stream_path, tmp_path):
    # a resumed stream with its own header: 1 payload from payload 1 on
    svc = str(tmp_path / "mid.svc")
    rc = encoder_app.main(["enc", *ENC_FLAGS, "--start-frame", "1",
                           "--max-frames", "1", "--output", svc, clip_path])
    assert rc == 0
    with open(svc, "rb") as f:
        mid = f.read()
    with open(stream_path, "rb") as f:
        full = f.read()
    header = bitstream.Header.unpack(full)
    assert bitstream.Header.unpack(mid).frame_count == 1
    assert mid[bitstream.HEADER_SIZE:] == full[
        bitstream.frame_offset(header, 1):bitstream.frame_offset(header, 2)]


def test_full_stream_header_equals_svc_tpu(clip_path, stream_path, tmp_path):
    # the same clip and flags through svc_tpu's encoder app: the header
    # bytes are equal (the payloads differ within the coefficient gate)
    from svc_tpu.apps import encoder_app as ref_app

    ref = str(tmp_path / "ref.svc")
    flags = list(ENC_FLAGS)
    i = flags.index("--device")
    del flags[i:i + 2]
    assert ref_app.main(["enc", *flags, "--output", ref, clip_path]) == 0
    with open(ref, "rb") as f:
        ref_bytes = f.read()
    with open(stream_path, "rb") as f:
        full = f.read()
    assert full[:bitstream.HEADER_SIZE] == ref_bytes[:bitstream.HEADER_SIZE]
    assert len(full) == len(ref_bytes)


def test_cli_cuda_without_card_fails(monkeypatch, clip_path, stream_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [f for f in ENC_FLAGS if f != "cpu" and f != "--device"]
    assert encoder_app.main(["enc", *flags, "--device", "cuda", clip_path]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert decoder_app.main(["dec", "--input", stream_path]) == 1  # default cuda
    assert "no CUDA device" in capsys.readouterr().err


def test_encoder_default_config_cli_matches_library(clip_path, tmp_path):
    # no --reference-compat: the default config (k-means repair
    # global_farthest, kernel K5 on a card)
    svc = str(tmp_path / "default.svc")
    rc = encoder_app.main(["enc", "--device", "cpu", "--batch-size", "2",
                           "--verbose", "0", "--output", svc, clip_path])
    assert rc == 0
    clip = np.load(clip_path)
    enc = Encoder(EncoderConfig(), VideoProperties(64, 48, len(clip)),
                  batch_size=2, device="cpu")
    with open(svc, "rb") as f:
        assert f.read() == b"".join(enc.encode_video(iter(clip)))


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
