"""Encoder CLI of the port (``svc_tpu/apps/encoder_app.py``).

Same flag names and meanings as ``svc_tpu``'s encoder app (the reference
encoder's flags, apps/encoder.cpp:75-104, plus the framework extensions);
the bitstream goes to stdout or ``--output``, diagnostics to stderr:

  python -m svc_tpu_torch.apps.encoder_app --device cuda \\
      --output clip.svc clip.npy

Port-specific: ``--device cuda|cpu`` (default ``cuda``; ``cuda`` without a
card is an error). ``--reference-compat`` defaults to 0 (the default
config, k-means kernel K5); 1 selects the reference-compat config.
``--devices``, ``--visualize``, ``--show``, ``--trace``, ``--profile`` and
``--start-frame`` are accepted by name but exit with status 1.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from svc_tpu_torch.config import EncoderConfig, VideoProperties, validate_encoder_config
from svc_tpu_torch.io.video import VideoReader
from svc_tpu_torch.utils import cli
from svc_tpu_torch.apps import UNSUPPORTED

_UNSUPPORTED_FLAGS = (
    "devices", "visualize", "show", "trace", "profile", "start-frame",
)


class _AppConfig:
    def __init__(self):
        self.encoder = EncoderConfig()
        self.verbose = 1
        self.video_path: Optional[str] = None
        self.output: Optional[str] = None
        self.batch_size = 8
        self.max_frames = 0  # 0 = all
        self.device = "cuda"
        self.unsupported: List[str] = []


def _opts(c: _AppConfig) -> List[cli.Opt]:
    e = c.encoder
    U, F, I, S = (
        cli.OptArgType.UINT,
        cli.OptArgType.FLOAT,
        cli.OptArgType.INT,
        cli.OptArgType.STRING,
    )
    P = cli.OptArgType.PATH
    fs = cli.field_setter
    opts = [
        cli.Opt("mv-block-w", U, fs(e, "mv_block_w")),
        cli.Opt("mv-block-h", U, fs(e, "mv_block_h")),
        cli.Opt("pyr-lvl-count", U, fs(e, "pyr_lvl_count")),
        cli.Opt("mv-search-range", U, fs(e, "mv_search_range")),
        cli.Opt("ransac-subset-sz", U, fs(e.ransac, "subset_sz")),
        cli.Opt("ransac-inlier-thresh", F, fs(e.ransac, "inlier_thresh")),
        cli.Opt("ransac-success-prob", F, fs(e.ransac, "success_prob")),
        cli.Opt("ransac-inlier-ratio", F, fs(e.ransac, "inlier_ratio")),
        cli.Opt("morph-rect-w", U, fs(e, "morph_rect_w")),
        cli.Opt("morph-rect-h", U, fs(e, "morph_rect_h")),
        cli.Opt("kmeans-cluster-count", U, fs(e.kmeans, "cluster_count")),
        cli.Opt("kmeans-attempt-count", U, fs(e.kmeans, "attempt_count")),
        cli.Opt("kmeans-max-iter-count", U, fs(e.kmeans, "max_iter_count")),
        cli.Opt("kmeans-epsilon", F, fs(e.kmeans, "epsilon")),
        cli.Opt(
            "connected-components-connectivity",
            U,
            fs(e, "connected_components_connectivity"),
        ),
        cli.Opt("transform-block-w", U, fs(e, "transform_block_w")),
        cli.Opt("transform-block-h", U, fs(e, "transform_block_h")),
        cli.Opt("verbose", I, fs(c, "verbose")),
        # framework extensions
        cli.Opt("seed", U, fs(e, "seed")),
        cli.Opt(
            "reference-compat",
            I,
            lambda v: setattr(e, "reference_compat", bool(v)),
        ),
        cli.Opt("output", P, fs(c, "output")),
        cli.Opt("batch-size", U, fs(c, "batch_size")),
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        cli.Opt("device", S, fs(c, "device")),
    ]
    for name in _UNSUPPORTED_FLAGS:
        opts.append(cli.Opt(name, P, lambda _v, n=name: c.unsupported.append(n)))
    return opts


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    cfg = _AppConfig()

    status, argi = cli.parse_opts(argv, _opts(cfg))
    if status != cli.Status.OK:
        print(
            f"parsing configuration: parsing options: "
            f"{cli.status_message(status)}",
            file=sys.stderr,
        )
        return 1
    if cfg.unsupported:
        print(f"--{cfg.unsupported[0]}: {UNSUPPORTED}", file=sys.stderr)
        return 1
    if len(argv) < argi + 1:
        print(
            "parsing configuration: missing video path argument",
            file=sys.stderr,
        )
        return 1
    cfg.video_path = argv[argi]

    err = validate_encoder_config(cfg.encoder)
    if not err.ok:
        print(f"validating configuration: {err.message}.", file=sys.stderr)
        return 1

    from svc_tpu_torch.models.encoder import Encoder

    try:
        reader = VideoReader(cfg.video_path)
    except (RuntimeError, ValueError, FileNotFoundError) as e:
        print(str(e) or "failed to initialize video capturing",
              file=sys.stderr)
        return 1
    try:
        props: VideoProperties = reader.props
        if cfg.verbose:
            print("Video properties:", file=sys.stderr)
            print(f"  Width: {props.frame_w}", file=sys.stderr)
            print(f"  Height: {props.frame_h}", file=sys.stderr)
            print(f"  Frame count: {props.frame_count}", file=sys.stderr)
        try:
            encoder = Encoder(
                cfg.encoder, props, batch_size=cfg.batch_size,
                device=cfg.device,
            )
        except (NotImplementedError, RuntimeError, ValueError) as e:
            print(f"creating encoder: {e}", file=sys.stderr)
            return 1

        n_payloads = max(props.frame_count - 1, 0)
        if cfg.max_frames:
            n_payloads = min(n_payloads, cfg.max_frames)

        def frames():
            for i, frame in enumerate(reader):
                if i > n_payloads:  # overlap frame + payload frames
                    break
                yield frame

        payloads = 0
        out = open(cfg.output, "wb") if cfg.output else sys.stdout.buffer
        try:
            for i, chunk in enumerate(
                encoder.encode_video(frames(), header_frame_count=n_payloads)
            ):
                out.write(chunk)
                if i:  # chunk 0 is the header
                    payloads += 1
        finally:
            if cfg.output:
                out.close()
    finally:
        reader.close()

    # the container's frame count can be wrong; a header promising more
    # payloads than the body holds makes the stream undecodable
    if payloads != n_payloads:
        if cfg.output:
            with open(cfg.output, "r+b") as f:
                f.write(encoder.header(payloads).pack())
            print(f"note: source yielded {payloads} payload frames "
                  f"(metadata promised {n_payloads}); header updated",
                  file=sys.stderr)
        else:
            print(f"warning: wrote {payloads} payload frames but the header "
                  f"(already on the pipe) promises {n_payloads}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
