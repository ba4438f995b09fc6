"""Decoder CLI of the port (``svc_tpu/apps/decoder_app.py``).

Same flag names and meanings as ``svc_tpu``'s decoder app (the reference
decoder's flags, apps/decoder.cpp:34-40, plus the framework extensions).
Reads the bitstream from stdin (or ``--input``) and writes decoded uint8
BGR frames to ``--output`` (``.npy`` or ``.y4m``, default ``out.npy``):

  python -m svc_tpu_torch.apps.decoder_app --device cuda --gaze 960,540 \\
      --input clip.svc --output out.npy

Port-specific: ``--device cuda|cpu`` (default ``cuda``). ``--devices``,
``--show``, ``--trace`` and ``--start-frame`` are accepted by name but exit
with status 1.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from svc_tpu.config import DecoderConfig, validate_decoder_config
from svc_tpu.io import bitstream
from svc_tpu.io.video import write_npy_video, write_y4m_video
from svc_tpu.utils import cli
from svc_tpu_torch.apps import UNSUPPORTED

_UNSUPPORTED_FLAGS = ("devices", "show", "trace", "start-frame")


class _AppConfig:
    def __init__(self):
        self.decoder = DecoderConfig()
        self.input: Optional[str] = None
        self.output = "out.npy"
        self.gaze: Optional[str] = None
        self.gaze_trajectory: Optional[str] = None
        self.batch_size = 8
        self.max_frames = 0  # 0 = all
        self.device = "cuda"
        self.unsupported: List[str] = []


def _opts(c: _AppConfig) -> List[cli.Opt]:
    d = c.decoder
    U, S = cli.OptArgType.UINT, cli.OptArgType.STRING
    P = cli.OptArgType.PATH
    fs = cli.field_setter
    opts = [
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
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        cli.Opt("device", S, fs(c, "device")),
    ]
    for name in _UNSUPPORTED_FLAGS:
        opts.append(cli.Opt(name, P, lambda _v, n=name: c.unsupported.append(n)))
    return opts


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
    if cfg.unsupported:
        print(f"--{cfg.unsupported[0]}: {UNSUPPORTED}", file=sys.stderr)
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

        try:
            decoder = Decoder(
                cfg.decoder, header, batch_size=cfg.batch_size,
                device=cfg.device,
            )
        except (NotImplementedError, RuntimeError, ValueError) as e:
            print(f"creating decoder: {e}", file=sys.stderr)
            return 1

        count = header.frame_count
        if cfg.max_frames:
            count = min(count, cfg.max_frames)
        try:
            gazes = _parse_gazes(cfg, header.frame_count)[:count]
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        try:
            frames = list(
                decoder.decode_frames(
                    bitstream.read_frames(stream, header, count), iter(gazes)
                )
            )
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
