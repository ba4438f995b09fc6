"""Video file access for the encoder/decoder apps (the port's own copy of
``svc_tpu/io/video.py``).

Replaces the reference's ``cv::VideoCapture`` input (apps/encoder.cpp:192-204)
and its GUI display output (libs/decoder.cpp:151-218, which has no file
output path) with dependency-gated readers/writers:

* any container/codec via OpenCV's ``VideoCapture`` when ``cv2`` is
  importable (optional — the framework never uses OpenCV for compute),
  or via an ``ffmpeg`` rawvideo pipe when the binary is on PATH (so
  arbitrary containers need NO OpenCV at all; the last optional cv2
  dependency is display GUI only),
* ``.npy`` — a ``(frames, height, width, 3)`` uint8 BGR array,
* ``.y4m`` — YUV4MPEG2 with C444 or Cmono colorspace (pure-Python parser),
* ``.avi`` — uncompressed BI_RGB (rawvideo BGR24) AVI, read and written
  natively. This is the **lossless interchange format** with the reference
  binary: FFmpeg/OpenCV decode BI_RGB without any colorspace conversion, so
  the reference's ``cv::VideoCapture`` (apps/encoder.cpp:192) sees
  bit-identical BGR pixels to our reader — unlike y4m, whose YUV round trip
  is range/matrix dependent. Golden end-to-end parity tests rely on this.

All readers yield uint8 BGR ``(H, W, 3)`` frames, the same pixel layout the
reference consumes from OpenCV.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

from svc_tpu_torch.config import VideoProperties

try:  # optional, used only for container decode, never for compute
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def _yuv444_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 full-range YUV->BGR (inverse of the encoder's BGR2YUV)."""
    yf = y.astype(np.float32)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + 1.403 * vf
    g = yf - 0.344 * uf - 0.714 * vf
    b = yf + 1.773 * uf
    bgr = np.stack([b, g, r], axis=-1)
    return np.clip(np.rint(bgr), 0, 255).astype(np.uint8)


class VideoReader:
    """Iterate uint8 BGR frames from a file path."""

    def __init__(self, path: str):
        self.path = path
        self._frames: Optional[np.ndarray] = None
        self._cap = None
        self._y4m = None

        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.ndim == 3:
                arr = np.repeat(arr[..., None], 3, axis=-1)
            if arr.ndim != 4 or arr.shape[-1] != 3:
                raise ValueError(
                    f"expected (T, H, W, 3) uint8 array in {path}, got "
                    f"{arr.shape}"
                )
            self._frames = np.ascontiguousarray(arr.astype(np.uint8))
            t, h, w, _ = self._frames.shape
            self.props = VideoProperties(frame_w=w, frame_h=h, frame_count=t)
        elif path.endswith(".y4m"):
            self._y4m = _Y4MReader(path)
            self.props = self._y4m.props
        elif path.endswith(".avi") and _is_raw_avi(path):
            self._y4m = _RawAviReader(path)  # same iterator contract
            self.props = self._y4m.props
        elif not _HAS_CV2:
            if ffmpeg_available():
                self._y4m = _FfmpegReader(path)  # same iterator contract
                self.props = self._y4m.props
            else:
                raise RuntimeError(
                    "failed to initialize video capturing: neither OpenCV "
                    "(cv2) nor an ffmpeg binary is available; use a .npy, "
                    ".y4m, or raw-BGR .avi input instead"
                )
        else:
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise RuntimeError("failed to initialize video capturing")
            self.props = VideoProperties(
                frame_w=int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                frame_h=int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            )

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._frames is not None:
            yield from self._frames
        elif self._y4m is not None:
            yield from self._y4m
        else:
            while True:
                ok, frame = self._cap.read()
                if not ok:
                    return
                yield frame

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
        if self._y4m is not None:
            self._y4m.close()


def ffmpeg_available() -> bool:
    """True when both ``ffmpeg`` and ``ffprobe`` are on PATH."""
    return (
        shutil.which("ffmpeg") is not None
        and shutil.which("ffprobe") is not None
    )


class _FfmpegReader:
    """Arbitrary-container reader over an ``ffmpeg`` rawvideo pipe.

    The OpenCV-free path to every codec ffmpeg can decode: geometry and
    frame count come from ``ffprobe`` (packet count — container frame
    metadata lies, exactly the case the encoder's header reconciliation
    handles, models/encoder.py), pixels stream through
    ``ffmpeg -i .. -f rawvideo -pix_fmt bgr24 -`` as the same uint8 BGR
    rows ``cv::VideoCapture`` would produce (apps/encoder.cpp:192).
    """

    def __init__(self, path: str):
        probe = subprocess.run(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-count_packets", "-show_entries",
                "stream=width,height,nb_read_packets", "-of", "json",
                path,
            ],
            capture_output=True,
        )
        if probe.returncode != 0:
            raise RuntimeError(
                "failed to initialize video capturing: "
                + probe.stderr.decode(errors="replace").strip()
            )
        streams = json.loads(probe.stdout).get("streams") or []
        if not streams:
            raise RuntimeError(
                "failed to initialize video capturing: no video stream"
            )
        info = streams[0]
        w, h = int(info["width"]), int(info["height"])
        n = int(info.get("nb_read_packets") or 0)
        self.props = VideoProperties(frame_w=w, frame_h=h, frame_count=n)
        self._shape = (h, w, 3)
        self._frame_bytes = w * h * 3
        # stderr is piped (not discarded) so a mid-stream decode failure
        # is distinguishable from normal EOS; `-v error` keeps the
        # stream far below pipe-buffer size, so no drain thread needed
        self._proc = subprocess.Popen(
            [
                "ffmpeg", "-v", "error", "-i", path,
                "-f", "rawvideo", "-pix_fmt", "bgr24", "-",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        assert self._proc.stdout is not None
        delivered = 0
        while True:
            chunks = []
            need = self._frame_bytes
            while need:
                buf = self._proc.stdout.read(need)
                if not buf:
                    break
                chunks.append(buf)
                need -= len(buf)
            if need:  # pipe ended: clean EOS or a decode failure?
                self._check_eos(delivered, short_frame=bool(chunks))
                return
            delivered += 1
            yield np.frombuffer(b"".join(chunks), np.uint8).reshape(
                self._shape
            )

    def _check_eos(self, delivered: int, short_frame: bool) -> None:
        """Raise when ffmpeg exited nonzero (corrupt/truncated container)
        or the pipe died mid-frame — a silent short stream would
        otherwise encode fewer frames than the container advertises with
        no diagnostic at all."""
        rc = self._proc.wait()
        err = b""
        if self._proc.stderr is not None:
            err = self._proc.stderr.read() or b""
        if rc != 0 or short_frame:
            detail = err.decode(errors="replace").strip()
            raise RuntimeError(
                f"ffmpeg decode failed after {delivered}/"
                f"{self.props.frame_count} frames (exit code {rc}"
                + (", truncated frame" if short_frame else "")
                + (f"): {detail}" if detail else ")")
            )
        if delivered < self.props.frame_count:
            warnings.warn(
                f"ffmpeg delivered {delivered} frames but the container "
                f"advertised {self.props.frame_count}; encoding the "
                "shorter stream",
                RuntimeWarning,
                stacklevel=2,
            )

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait()
        if self._proc.stdout is not None:
            self._proc.stdout.close()


@dataclasses.dataclass
class _Y4MHeader:
    width: int
    height: int
    colorspace: str


class _Y4MReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        line = self._f.readline().decode("ascii", "replace").strip()
        if not line.startswith("YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {path}")
        w = h = 0
        cs = "420"
        for tok in line.split()[1:]:
            if tok.startswith("W"):
                w = int(tok[1:])
            elif tok.startswith("H"):
                h = int(tok[1:])
            elif tok.startswith("C"):
                cs = tok[1:]
        if cs not in ("444", "mono"):
            raise ValueError(
                f"unsupported y4m colorspace C{cs}; use C444 or Cmono"
            )
        self.hdr = _Y4MHeader(w, h, cs)
        # frame count requires a scan; do it once (files are seekable)
        plane = w * h
        self._frame_bytes = plane * (3 if cs == "444" else 1)
        start = self._f.tell()
        count = 0
        while True:
            fl = self._f.readline()
            if not fl:
                break
            if not fl.startswith(b"FRAME"):
                break
            self._f.seek(self._frame_bytes, 1)
            count += 1
        self._f.seek(start)
        self.props = VideoProperties(frame_w=w, frame_h=h, frame_count=count)

    def __iter__(self) -> Iterator[np.ndarray]:
        w, h = self.hdr.width, self.hdr.height
        while True:
            fl = self._f.readline()
            if not fl or not fl.startswith(b"FRAME"):
                return
            raw = self._f.read(self._frame_bytes)
            if len(raw) < self._frame_bytes:
                return
            if self.hdr.colorspace == "mono":
                y = np.frombuffer(raw, np.uint8).reshape(h, w)
                yield np.repeat(y[..., None], 3, axis=-1)
            else:
                planes = np.frombuffer(raw, np.uint8).reshape(3, h, w)
                yield _yuv444_to_bgr(planes[0], planes[1], planes[2])

    def close(self) -> None:
        self._f.close()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + len(payload).to_bytes(4, "little") + payload + pad


def _is_raw_avi(path: str) -> bool:
    """True when the .avi is an uncompressed BI_RGB file we parse natively."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                return False
            data = f.read(4096)
        i = data.find(b"strf")
        if i < 0 or i + 8 + 40 > len(data):
            return False
        bih = data[i + 8 : i + 8 + 40]
        compression = int.from_bytes(bih[16:20], "little")
        bit_count = int.from_bytes(bih[14:16], "little")
        return compression == 0 and bit_count == 24
    except OSError:
        return False


class _RawAviReader:
    """Minimal reader for BI_RGB AVIs (both row orders, padded-stride rows).

    Handles ``write_raw_avi``'s top-down files and standard bottom-up ones;
    the same files decode bit-identically through ``cv::VideoCapture``.
    """

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = None
        # index via a memory map: a raw 1080p AVI is ~6 MB/frame, so
        # slurping the file would pin the whole clip resident for the
        # reader's lifetime; mmap pages in only what each frame touches
        import mmap
        import os

        try:
            if os.fstat(self._f.fileno()).st_size == 0:
                raise ValueError(f"not an AVI file: {path}")
            self._mm = mmap.mmap(
                self._f.fileno(), 0, access=mmap.ACCESS_READ
            )
            self._parse(path)
        except Exception:
            self.close()
            raise

    def _parse(self, path: str) -> None:
        data = self._mm
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise ValueError(f"not an AVI file: {path}")
        i = data.find(b"strf")
        if i < 0 or i + 8 + 40 > len(data):
            raise ValueError(f"truncated AVI stream format chunk: {path}")
        bih = data[i + 8 : i + 8 + 40]
        w = int.from_bytes(bih[4:8], "little", signed=True)
        h = int.from_bytes(bih[8:12], "little", signed=True)
        self._top_down = h < 0
        h = abs(h)
        self._w, self._h = w, h
        self._stride = (w * 3 + 3) & ~3
        # collect '00db'/'00dc' chunk offsets inside the movi list
        self._offsets = []
        j = data.find(b"LIST", i)
        while j >= 0:
            if data[j + 8 : j + 12] == b"movi":
                end = j + 8 + int.from_bytes(data[j + 4 : j + 8], "little")
                k = j + 12
                while k + 8 <= min(end, len(data)):
                    cc = data[k : k + 4]
                    sz = int.from_bytes(data[k + 4 : k + 8], "little")
                    if cc in (b"00db", b"00dc"):
                        self._offsets.append((k + 8, sz))
                    k += 8 + sz + (sz & 1)
                break
            j = data.find(b"LIST", j + 4)
        self.props = VideoProperties(
            frame_w=w, frame_h=h, frame_count=len(self._offsets)
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        for off, sz in self._offsets:
            rows = np.frombuffer(
                self._mm[off : off + sz], np.uint8
            ).reshape(self._h, self._stride)[:, : self._w * 3]
            frame = rows.reshape(self._h, self._w, 3)
            yield frame if self._top_down else frame[::-1].copy()

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()


def write_raw_avi(path: str, frames_bgr: np.ndarray, fps: int = 30) -> None:
    """Write uint8 BGR frames as an uncompressed BI_RGB AVI (lossless).

    Rows are stored top-down (negative biHeight): some FFmpeg builds
    (e.g. the one bundled with OpenCV 5 Python wheels) crash on bottom-up
    BI_RGB AVIs, while top-down decodes bit-exactly everywhere tested.
    """
    frames_bgr = np.asarray(frames_bgr, dtype=np.uint8)
    t, h, w, _ = frames_bgr.shape
    stride = (w * 3 + 3) & ~3
    frame_sz = stride * h

    bih = b"".join(
        [
            (40).to_bytes(4, "little"),
            w.to_bytes(4, "little"),
            (-h).to_bytes(4, "little", signed=True),  # negative: top-down
            (1).to_bytes(2, "little"),
            (24).to_bytes(2, "little"),
            (0).to_bytes(4, "little"),  # BI_RGB
            frame_sz.to_bytes(4, "little"),
            bytes(16),
        ]
    )
    strh = b"".join(
        [
            b"vids",
            b"DIB ",
            bytes(12),  # flags, priority/language, initial frames
            (1).to_bytes(4, "little"),  # scale
            int(fps).to_bytes(4, "little"),  # rate
            (0).to_bytes(4, "little"),  # start
            t.to_bytes(4, "little"),  # length
            frame_sz.to_bytes(4, "little"),
            (0xFFFFFFFF).to_bytes(4, "little"),  # quality
            (0).to_bytes(4, "little"),  # sample size
            (0).to_bytes(2, "little"),
            (0).to_bytes(2, "little"),
            w.to_bytes(2, "little"),
            h.to_bytes(2, "little"),
        ]
    )
    avih = b"".join(
        [
            int(1e6 // fps).to_bytes(4, "little"),
            (frame_sz * fps).to_bytes(4, "little"),
            (0).to_bytes(4, "little"),
            (0x10).to_bytes(4, "little"),  # AVIF_HASINDEX
            t.to_bytes(4, "little"),
            (0).to_bytes(4, "little"),
            (1).to_bytes(4, "little"),  # one stream
            frame_sz.to_bytes(4, "little"),
            w.to_bytes(4, "little"),
            h.to_bytes(4, "little"),
            bytes(16),
        ]
    )
    strl = _chunk(b"LIST", b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", bih))
    hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + strl)

    movi_payload = bytearray(b"movi")
    index = bytearray()
    for frame in frames_bgr:
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : w * 3] = frame.reshape(h, w * 3)
        index += (
            b"00db"
            + (0x10).to_bytes(4, "little")  # AVIIF_KEYFRAME
            + len(movi_payload).to_bytes(4, "little")
            + frame_sz.to_bytes(4, "little")
        )
        movi_payload += _chunk(b"00db", rows.tobytes())
    movi = _chunk(b"LIST", bytes(movi_payload))
    idx1 = _chunk(b"idx1", bytes(index))

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + len(body).to_bytes(4, "little") + body)


def write_npy_video(path: str, frames: np.ndarray) -> None:
    """Write decoded frames as a ``(T, H, W, 3)`` uint8 BGR array."""
    np.save(path, np.asarray(frames, dtype=np.uint8))


def write_y4m_video(path: str, frames_bgr: np.ndarray) -> None:
    """Write uint8 BGR frames as C444 y4m (full-range BT.601)."""
    frames_bgr = np.asarray(frames_bgr, dtype=np.uint8)
    t, h, w, _ = frames_bgr.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C444\n".encode())
        for frame in frames_bgr:
            b = frame[..., 0].astype(np.float32)
            g = frame[..., 1].astype(np.float32)
            r = frame[..., 2].astype(np.float32)
            y = 0.299 * r + 0.587 * g + 0.114 * b
            # full-range BT.601 YCbCr chroma scale (the exact inverse of
            # _yuv444_to_bgr's 1.773/1.403 reconstruction and what every
            # standard consumer expects). The analog-YUV 0.492/0.877
            # scale used here previously read back with systematic color
            # shifts (+32 on saturated red through a round trip).
            u = 0.564 * (b - y) + 128.0
            v = 0.713 * (r - y) + 128.0
            planes = np.stack([y, u, v])
            f.write(b"FRAME\n")
            f.write(
                np.clip(np.rint(planes), 0, 255).astype(np.uint8).tobytes()
            )
