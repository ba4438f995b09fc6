"""Decoder CLI of the port (``svc_tpu/apps/decoder_app.py``).

Same flag names and meanings as ``svc_tpu``'s decoder app (the reference
decoder's flags, apps/decoder.cpp:34-40, plus the framework extensions).
Reads the bitstream from stdin (or ``--input``) and writes decoded uint8
BGR frames to ``--output`` (``.npy`` or ``.y4m``, default ``out.npy``):

  python -m svc_tpu_torch.apps.decoder_app --device cuda --gaze 960,540 \\
      --input clip.svc --output out.npy

Port-specific: ``--device cuda|cpu`` (default ``cuda``).

  --start-frame N   decode from payload N (the stream is random access)
  --trace PATH      dump the host spans (parse, device_dispatch,
                    device_fetch) as JSON and print a summary to stderr
  --devices N       split each batch across N devices (``--device cuda``:
                    cards 0..N-1; ``cpu``: N CPU chunks) of
                    ``ceil(batch / N)`` frames; identical frames
  --show 1          display the frames in an OpenCV window whose gaze
                    follows the mouse, the reference's GUI (needs cv2;
                    batch 1, one device)

The decode runs svc_tpu's thread layout (svc_tpu/apps/decoder_app.py:
220-241, the reference's apps/decoder.cpp:55-88): a reader thread streams
payloads through a bounded queue (capacity 100) while the main thread
decodes, staging each batch's coefficients one batch ahead and keeping one
batch in flight.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from svc_tpu_torch.config import DecoderConfig, validate_decoder_config
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.io.video import write_npy_video, write_y4m_video
from svc_tpu_torch.runtime.pipeline import BoundedQueue, pipeline_threads
from svc_tpu_torch.runtime.tracing import Tracer
from svc_tpu_torch.utils import cli


class _AppConfig:
    def __init__(self):
        self.decoder = DecoderConfig()
        self.input: Optional[str] = None
        self.output = "out.npy"
        self.gaze: Optional[str] = None
        self.gaze_trajectory: Optional[str] = None
        self.batch_size = 8
        self.start_frame = 0
        self.max_frames = 0  # 0 = all
        self.trace: Optional[str] = None
        self.device = "cuda"
        self.devices = 0  # 0 = single device
        self.show = 0


def _opts(c: _AppConfig) -> List[cli.Opt]:
    d = c.decoder
    U, I, S = cli.OptArgType.UINT, cli.OptArgType.INT, cli.OptArgType.STRING
    P = cli.OptArgType.PATH
    fs = cli.field_setter
    return [
        cli.Opt("foreground-quant-step", U, fs(d, "foreground_quant_step")),
        cli.Opt("background-quant-step", U, fs(d, "background_quant_step")),
        cli.Opt("max-gaze-rect-w", U, fs(d, "max_gaze_rect_w")),
        cli.Opt("max-gaze-rect-h", U, fs(d, "max_gaze_rect_h")),
        # framework extensions
        cli.Opt("input", P, fs(c, "input")),
        cli.Opt("output", P, fs(c, "output")),
        cli.Opt("gaze", S, fs(c, "gaze")),
        cli.Opt("gaze-trajectory", P, fs(c, "gaze_trajectory")),
        cli.Opt("batch-size", U, fs(c, "batch_size")),
        # random access: every block has the same wire size
        cli.Opt("start-frame", U, fs(c, "start_frame")),
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        cli.Opt("trace", P, fs(c, "trace")),
        cli.Opt("devices", U, fs(c, "devices")),
        cli.Opt("show", I, fs(c, "show")),
        cli.Opt("device", S, fs(c, "device")),
    ]


def _parse_gazes(
    cfg: _AppConfig, frame_count: int
) -> List[Optional[Tuple[int, int]]]:
    """Per-frame gaze positions from ``--gaze`` / ``--gaze-trajectory``
    (one ``frame_index x y`` row per line; a position holds until the next
    row). Malformed values raise ``ValueError``."""
    gazes: List[Optional[Tuple[int, int]]] = [None] * frame_count
    if cfg.gaze:
        parts = cfg.gaze.replace(",", " ").split()
        try:
            pos = (int(parts[0]), int(parts[1]))
        except (IndexError, ValueError):
            raise ValueError(
                f"bad --gaze value {cfg.gaze!r}: expected X,Y integers"
            ) from None
        gazes = [pos] * frame_count
    if cfg.gaze_trajectory:
        table: Dict[int, Tuple[int, int]] = {}
        try:
            f = open(cfg.gaze_trajectory)
        except OSError as e:
            raise ValueError(f"failed to open gaze trajectory: {e}") from None
        with f:
            for lineno, line in enumerate(f, 1):
                fields = line.replace(",", " ").split()
                if len(fields) < 3:
                    continue
                try:
                    table[int(fields[0])] = (int(fields[1]), int(fields[2]))
                except ValueError:
                    raise ValueError(
                        f"bad gaze trajectory line {lineno}: {line.rstrip()!r}"
                    ) from None
        last: Optional[Tuple[int, int]] = None
        for i in range(frame_count):
            last = table.get(i, last)
            gazes[i] = last
    return gazes


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    cfg = _AppConfig()

    status, _ = cli.parse_opts(argv, _opts(cfg))
    if status != cli.Status.OK:
        print(
            f"parsing config: parsing options: {cli.status_message(status)}",
            file=sys.stderr,
        )
        return 1
    err = validate_decoder_config(cfg.decoder)
    if not err.ok:
        print(f"validating config: {err.message}", file=sys.stderr)
        return 1

    try:
        stream = open(cfg.input, "rb") if cfg.input else sys.stdin.buffer
    except OSError as e:
        print(f"failed to open input: {e}", file=sys.stderr)
        return 1
    try:
        raw_header = stream.read(bitstream.HEADER_SIZE)
        if len(raw_header) < bitstream.HEADER_SIZE:
            print("failed to read header", file=sys.stderr)
            return 1
        header = bitstream.Header.unpack(raw_header)
        try:
            header.validate()
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1

        from svc_tpu_torch.models.decoder import Decoder

        if cfg.show:
            # latency over throughput in the GUI: one frame a batch, one
            # device
            cfg.batch_size = 1
            cfg.devices = 0
        try:
            if cfg.devices > 1:
                from svc_tpu_torch.parallel.sharding import make_frame_devices

                per_dev = -(-cfg.batch_size // cfg.devices)
                decoder = Decoder(
                    cfg.decoder, header, batch_size=per_dev * cfg.devices,
                    devices=make_frame_devices(cfg.devices, device=cfg.device),
                )
            else:
                decoder = Decoder(
                    cfg.decoder, header, batch_size=cfg.batch_size,
                    device=cfg.device,
                )
        except (RuntimeError, ValueError) as e:
            print(f"creating decoder: {e}", file=sys.stderr)
            return 1

        start = min(cfg.start_frame, header.frame_count)
        count = header.frame_count - start
        if cfg.max_frames:
            count = min(count, cfg.max_frames)
        try:
            bitstream.seek_to_frame(stream, header, start)
            if cfg.show:
                return _run_gui(decoder, stream, header, count)
            gazes = _parse_gazes(cfg, header.frame_count)[start:start + count]
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1

        tracer = Tracer(enabled=bool(cfg.trace))
        frames: List[np.ndarray] = []

        # 2-stage pipeline: reader thread -> decode (main)
        def produce(q: BoundedQueue) -> None:
            for payload in bitstream.read_frames(stream, header, count):
                q.push(payload)

        def consume(q: BoundedQueue) -> None:
            frames.extend(decoder.decode_frames(
                iter(q), iter(gazes), tracer=tracer if cfg.trace else None))

        try:
            pipeline_threads(produce, consume, capacity=100)
        except ValueError as e:  # truncated stream
            print(str(e), file=sys.stderr)
            return 1
    finally:
        if cfg.input:
            stream.close()

    video = (
        np.stack(frames)
        if frames
        else np.zeros((0, header.frame_h, header.frame_w, 3), np.uint8)
    )
    if cfg.output.endswith(".y4m"):
        write_y4m_video(cfg.output, video)
    else:
        write_npy_video(cfg.output, video)
    print(f"decoded {len(frames)} frames -> {cfg.output}", file=sys.stderr)
    if cfg.trace:
        tracer.dump(cfg.trace)
        print(tracer.report(), file=sys.stderr)
    return 0


def _run_gui(decoder, stream, header, count: int) -> int:
    """The reference's GUI (libs/decoder.cpp:151-216): each decoded frame
    in a window, the gaze of each next frame where the mouse last moved,
    until a key is pressed. The stream is already at ``--start-frame``;
    ``count`` honours ``--max-frames``."""
    try:
        import cv2
    except ImportError:
        print("--show requires OpenCV (cv2)", file=sys.stderr)
        return 1

    window = "Decoded Video"
    cv2.namedWindow(window)
    mouse = {"x": 0, "y": 0}

    def on_mouse(event, x, y, _flags, _param):
        if event == cv2.EVENT_MOUSEMOVE:
            mouse["x"], mouse["y"] = x, y

    cv2.setMouseCallback(window, on_mouse)

    def gaze_stream():
        for _ in range(count):
            yield (mouse["x"], mouse["y"])

    for frame in decoder.decode_frames(
        bitstream.read_frames(stream, header, count), gaze_stream()
    ):
        cv2.imshow(window, frame)
        if cv2.waitKey(1) >= 0:
            break
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
