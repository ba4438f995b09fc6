"""The port's CLIs, in-process through ``main(argv)`` with ``--device cpu``
on a tiny .npy clip: same flags and outputs as the library (through the
native writer and the Python writer thread alike), ``--trace``,
``--profile``, ``--visualize``, the decoder's ``--start-frame``,
``--devices N`` (byte-equal to the single-device stream and frames; more
cards than exist exit 1), ``--ransac-subset-sz 3``, the decoder's GUI
``--show`` on a stub OpenCV (``--show`` without OpenCV exits 1), a failing
reader failing the run, and no silent CPU fallback for ``cuda``; the
encoder runs the default config unless ``--reference-compat 1``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from svc_tpu_torch.apps import decoder_app, encoder_app
from svc_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    RansacParams,
    VideoProperties,
)
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.metrics import psnr
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.runtime import native
from svc_tpu_torch.runtime.tracing import TRACE_FILE
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


def _one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


TOO_MANY = "requested 2 devices but only 1 available"


@pytest.mark.parametrize("flag", ["--devices", "--show"])
def test_encoder_refuses_unsupported_flags(flag, clip_path, capsys, monkeypatch):
    # --devices 2 on one card exits 1 with svc_tpu's message; --show is
    # gated on OpenCV, as in svc_tpu; cv2 is made unimportable so that no
    # test opens a window
    monkeypatch.setitem(sys.modules, "cv2", None)
    if flag == "--devices":
        _one_card(monkeypatch)
        args = [*ENC_FLAGS, "--device", "cuda", "--devices", "2"]
    else:
        args = [*ENC_FLAGS, "--show", "1"]
    assert encoder_app.main(["enc", *args, clip_path]) == 1
    want = {"--show": "--show requires OpenCV (cv2)"}.get(flag, TOO_MANY)
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--devices", "--show"])
def test_decoder_refuses_unsupported_flags(flag, stream_path, capsys, monkeypatch):
    # the decoder's counterparts: --devices 2 on one card, --show without
    # OpenCV
    monkeypatch.setitem(sys.modules, "cv2", None)
    if flag == "--devices":
        _one_card(monkeypatch)
        args = ["--device", "cuda", "--devices", "2"]
    else:
        args = ["--device", "cpu", "--show", "1"]
    assert decoder_app.main(["dec", *args, "--input", stream_path]) == 1
    want = {"--show": "--show requires OpenCV (cv2)"}.get(flag, TOO_MANY)
    assert want in capsys.readouterr().err


def test_cli_devices_cuda_without_card_fails(monkeypatch, clip_path, stream_path,
                                             capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [f for f in ENC_FLAGS if f not in ("--device", "cpu")]
    assert encoder_app.main(["enc", *flags, "--devices", "2", clip_path]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert decoder_app.main(["dec", "--devices", "2", "--input", stream_path]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("per_device", [1, 3])
def test_encoder_cli_devices_matches_library(per_device, clip_path, stream_path,
                                             tmp_path, capsys):
    # svc_tpu's tests/test_sharding.py:157 on CPU chunks: 2 devices x 1
    # anchor (two batches) and x 3 (one padded batch) write the
    # single-device stream byte for byte
    out = str(tmp_path / "split.svc")
    flags = [f for f in ENC_FLAGS if f not in ("--verbose", "0")]
    rc = encoder_app.main(["enc", *flags, "--batch-size", str(per_device),
                           "--devices", "2", "--output", out, clip_path])
    assert rc == 0
    batch = 2 * per_device
    assert (f"sharding {batch}-frame batches across 2 devices"
            in capsys.readouterr().err)
    assert _read(out) == _read(stream_path)


def test_decoder_cli_devices_matches_library(stream_path, tmp_path):
    # svc_tpu's tests/test_sharding.py:241: batch 3 over 2 devices decodes
    # batches of 4 (2 a device), the library's frames
    out = str(tmp_path / "split.npy")
    rc = decoder_app.main(["dec", "--device", "cpu", "--gaze", "32,24",
                           "--batch-size", "3", "--devices", "2",
                           "--input", stream_path, "--output", out])
    assert rc == 0
    np.testing.assert_array_equal(
        np.load(out), _library_decode(stream_path, [(32, 24)] * 4))


def test_encoder_cli_ransac_subset_matches_library(clip_path, tmp_path):
    out = str(tmp_path / "subset3.svc")
    rc = encoder_app.main(["enc", *ENC_FLAGS, "--ransac-subset-sz", "3",
                           "--output", out, clip_path])
    assert rc == 0
    clip = np.load(clip_path)
    cfg = EncoderConfig(reference_compat=True, ransac=RansacParams(subset_sz=3))
    enc = Encoder(cfg, VideoProperties(64, 48, len(clip)), batch_size=2,
                  device="cpu")
    assert _read(out) == b"".join(enc.encode_video(iter(clip)))


class _StubCv2:
    """Enough of OpenCV for the decoder's GUI: each ``imshow`` records the
    frame, then fires a click (ignored) and a mouse move; ``waitKey``
    reports a key once ``stop_after`` frames have been shown."""

    EVENT_MOUSEMOVE, EVENT_LBUTTONDOWN = 0, 1

    def __init__(self, stop_after):
        self.stop_after = stop_after
        self.windows, self.shown, self.moves = [], [], []
        self.callback = None
        self.destroyed = False

    def namedWindow(self, name, *flags):
        self.windows.append(name)

    def setMouseCallback(self, name, callback):
        assert name in self.windows
        self.callback = callback

    def imshow(self, name, frame):
        assert name == "Decoded Video"
        self.shown.append(np.array(frame))
        i = len(self.shown)
        self.callback(self.EVENT_LBUTTONDOWN, 63, 47, 0, None)
        self.moves.append((6 * i, 4 * i))
        self.callback(self.EVENT_MOUSEMOVE, *self.moves[-1], 0, None)

    def waitKey(self, delay):
        return 27 if len(self.shown) == self.stop_after else -1

    def destroyAllWindows(self):
        self.destroyed = True


def test_decoder_show_follows_the_mouse(tmp_path, monkeypatch):
    # svc_tpu's GUI (apps/decoder_app.py:258-290): batch 1, each frame's
    # gaze where the mouse last moved when its payload was read, a key stops
    # the run; the shown frames are a batch-1 library decode at those gazes
    clip = make_clip(64, 48, 9, seed=9)
    enc = Encoder(EncoderConfig(reference_compat=True),
                  VideoProperties(64, 48, len(clip)), batch_size=4, device="cpu")
    svc = tmp_path / "clip.svc"
    svc.write_bytes(b"".join(enc.encode_video(iter(clip))))
    cv2 = _StubCv2(stop_after=6)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    gazes = []
    decode_frames = Decoder.decode_frames

    def recording(self, payloads, gaze_iter=None, **kwargs):
        assert self.batch_size == 1 and len(self.devices) == 1

        def record():
            for g in gaze_iter:
                gazes.append(g)
                yield g

        return decode_frames(self, payloads, record(), **kwargs)

    monkeypatch.setattr(Decoder, "decode_frames", recording)
    rc = decoder_app.main(["dec", "--device", "cpu", "--show", "1",
                           "--batch-size", "4", "--devices", "2",
                           "--input", str(svc)])
    assert rc == 0
    assert len(cv2.shown) == 6 and cv2.destroyed
    assert (0, 0) == gazes[0] and set(gazes[1:]) - {(0, 0)} <= set(cv2.moves)
    assert len(set(gazes)) > 2  # the gaze followed the mouse
    monkeypatch.setattr(Decoder, "decode_frames", decode_frames)
    payloads = [svc.read_bytes()[bitstream.frame_offset(enc.header(), i):
                                 bitstream.frame_offset(enc.header(), i + 1)]
                for i in range(len(gazes))]
    want = list(Decoder(DecoderConfig(), enc.header(), batch_size=1,
                        device="cpu").decode_frames(iter(payloads), iter(gazes)))
    for got, ref in zip(cv2.shown, want):
        np.testing.assert_array_equal(got, ref)


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


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_encoder_native_and_python_writers_agree(clip_path, stream_path, tmp_path,
                                                 monkeypatch):
    # the native C++ writer thread and the Python writer thread write the
    # library's bytes
    assert native.available()
    py = str(tmp_path / "py.svc")
    monkeypatch.setattr(native, "available", lambda: False)
    assert encoder_app.main(["enc", *ENC_FLAGS, "--output", py, clip_path]) == 0
    assert _read(py) == _read(stream_path)


class _FailingReader(encoder_app.VideoReader):
    """Yields two frames, then fails like a corrupt file would."""

    def __iter__(self):
        for i, frame in enumerate(super().__iter__()):
            if i == 2:
                raise OSError("read error mid-clip")
            yield frame


@pytest.mark.parametrize("writer", ["native", "python"])
def test_reader_failure_fails_the_app(writer, clip_path, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(encoder_app, "VideoReader", _FailingReader)
    if writer == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    out = str(tmp_path / "short.svc")
    rc = encoder_app.main(["enc", *ENC_FLAGS, "--output", out, clip_path])
    assert rc == 1
    assert "read error mid-clip" in capsys.readouterr().err


def test_encoder_trace_has_svc_tpu_stat_keys(clip_path, stream_path, tmp_path):
    from svc_tpu.apps import encoder_app as ref_app

    ours, ref = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    out = str(tmp_path / "t.svc")
    assert encoder_app.main(["enc", *ENC_FLAGS, "--trace", ours, "--output", out,
                             clip_path]) == 0
    assert _read(out) == _read(stream_path)
    flags = [f for f in ENC_FLAGS if f not in ("--device", "cpu")]
    assert ref_app.main(["enc", *flags, "--trace", ref, "--output",
                         str(tmp_path / "j.svc"), clip_path]) == 0
    with open(ours) as f:
        got = json.load(f)
    with open(ref) as f:
        want = json.load(f)
    assert set(got) == set(want) == {"events", "stats"}
    assert set(got["stats"]) == set(want["stats"]) == {
        "device_dispatch", "device_fetch", "serialize"}
    for name, stat in got["stats"].items():
        assert set(stat) == set(want["stats"][name])
        assert stat["count"] == want["stats"][name]["count"]


def test_encoder_profile_writes_a_trace(clip_path, tmp_path):
    prof = tmp_path / "prof"
    assert encoder_app.main(["enc", *ENC_FLAGS, "--profile", str(prof), "--output",
                             str(tmp_path / "p.svc"), clip_path]) == 0
    with open(prof / TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]


def test_encoder_visualize_dumps_each_payload(clip_path, stream_path, tmp_path):
    views = tmp_path / "views"
    out = str(tmp_path / "v.svc")
    assert encoder_app.main(["enc", *ENC_FLAGS, "--visualize", str(views),
                             "--output", out, clip_path]) == 0
    names = sorted(os.listdir(views))
    assert len(names) == 4 and names[0].startswith("frame_00000")
    assert _read(out) == _read(stream_path)  # the planes change no byte


def test_decoder_start_frame_is_the_tail(stream_path, tmp_path):
    full, tail = str(tmp_path / "full.npy"), str(tmp_path / "tail.npy")
    flags = ["dec", "--device", "cpu", "--gaze", "32,24", "--batch-size", "3",
             "--input", stream_path]
    assert decoder_app.main([*flags, "--output", full]) == 0
    assert decoder_app.main([*flags, "--start-frame", "2", "--output", tail]) == 0
    np.testing.assert_array_equal(np.load(tail), np.load(full)[2:])
    assert np.load(tail).shape[0] == 2


def test_decoder_trace(stream_path, tmp_path, capsys):
    trace = str(tmp_path / "d.json")
    assert decoder_app.main(["dec", "--device", "cpu", "--batch-size", "3",
                             "--trace", trace, "--input", stream_path,
                             "--output", str(tmp_path / "d.npy")]) == 0
    with open(trace) as f:
        stats = json.load(f)["stats"]
    assert stats["parse"]["count"] == 4
    assert stats["device_dispatch"]["count"] == stats["device_fetch"]["count"] == 2
    assert "device_fetch" in capsys.readouterr().err
