"""Encoder CLI of the port (``svc_tpu/apps/encoder_app.py``).

Same flag names and meanings as ``svc_tpu``'s encoder app (the reference
encoder's flags, apps/encoder.cpp:75-104, plus the framework extensions);
the bitstream goes to stdout or ``--output``, diagnostics to stderr:

  python -m svc_tpu_torch.apps.encoder_app --device cuda \\
      --output clip.svc clip.npy

Port-specific: ``--device cuda|cpu`` (default ``cuda``; ``cuda`` without a
card is an error). ``--reference-compat`` defaults to 0 (the default
config, k-means kernel K5); 1 selects the reference-compat config.
``--start-frame N`` resumes at payload ``N`` (source frame ``N`` is the
overlap frame) and ``--no-header 1`` leaves the header out, so a tail
written with both, appended to the first ``N`` payloads of the full
stream, gives the full stream byte for byte.

The encode runs svc_tpu's thread layout (svc_tpu/apps/encoder_app.py:
253-292, the reference's apps/encoder.cpp:223-228): a reader thread feeds
frames through a bounded queue to the encoder on the main thread, whose
staged, one-batch-in-flight stream goes to a writer — the native C++
queue and thread when ``runtime.native`` is available, otherwise a Python
writer thread. A reader failure fails the run (no short stream with status
0); Ctrl-C exits with status 130.

  --trace PATH      dump the host spans (device_dispatch, device_fetch,
                    serialize) as JSON and print a summary to stderr
  --profile DIR     torch.profiler Chrome trace of the run in DIR/trace.json
  --visualize DIR   dump the seven-view composite of every payload frame
  --show 1          show it live in a window (needs OpenCV)
  --devices N       split each batch across N devices (``--device cuda``:
                    cards 0..N-1; ``cpu``: N CPU chunks), ``--batch-size``
                    anchors each (``parallel.sharding.ShardedEncoder``);
                    the stream is byte-identical to the single-device one
"""

from __future__ import annotations

import sys
from typing import List, Optional

from svc_tpu_torch.config import EncoderConfig, VideoProperties, validate_encoder_config
from svc_tpu_torch.io.video import VideoReader
from svc_tpu_torch.runtime import native
from svc_tpu_torch.runtime.pipeline import BoundedQueue, CancelToken, pipeline_threads
from svc_tpu_torch.runtime.tracing import Tracer, device_profile
from svc_tpu_torch.utils import cli


class _AppConfig:
    def __init__(self):
        self.encoder = EncoderConfig()
        self.verbose = 1
        self.video_path: Optional[str] = None
        self.output: Optional[str] = None
        self.batch_size = 8
        self.start_frame = 0
        self.max_frames = 0  # 0 = all
        self.no_header = 0
        self.visualize: Optional[str] = None
        self.show = 0
        self.trace: Optional[str] = None
        self.profile: Optional[str] = None
        self.device = "cuda"
        self.devices = 0  # 0 = single device


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
    return [
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
        # resume: payload index to start from (the bitstream is random
        # access; the encoder's state is only the previous frame)
        cli.Opt("start-frame", U, fs(c, "start_frame")),
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        cli.Opt("no-header", I, fs(c, "no_header")),
        cli.Opt("visualize", P, fs(c, "visualize")),
        cli.Opt("show", I, fs(c, "show")),
        # observability
        cli.Opt("trace", P, fs(c, "trace")),
        cli.Opt("profile", P, fs(c, "profile")),
        cli.Opt("device", S, fs(c, "device")),
        cli.Opt("devices", U, fs(c, "devices")),
    ]


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
        # the visualizers are the only consumers of the padded planes
        keep_planes = bool(cfg.visualize or cfg.show)
        try:
            if cfg.devices > 1:
                from svc_tpu_torch.parallel.sharding import (
                    ShardedEncoder,
                    make_frame_devices,
                )

                encoder = ShardedEncoder(
                    cfg.encoder, props,
                    make_frame_devices(cfg.devices, device=cfg.device),
                    batch_per_device=cfg.batch_size, keep_planes=keep_planes,
                )
                if cfg.verbose:
                    print(f"sharding {encoder.batch_size}-frame batches "
                          f"across {cfg.devices} devices", file=sys.stderr)
            else:
                encoder = Encoder(
                    cfg.encoder, props, batch_size=cfg.batch_size,
                    device=cfg.device, keep_planes=keep_planes,
                )
        except (RuntimeError, ValueError) as e:
            print(f"creating encoder: {e}", file=sys.stderr)
            return 1
        device = encoder.device
        if cfg.visualize:
            from svc_tpu_torch.visualize import VisualizingEncoder

            encoder = VisualizingEncoder(encoder, cfg.visualize)
        if cfg.show:
            from svc_tpu_torch.visualize import LiveEncoderView

            try:
                encoder = LiveEncoderView(encoder)
            except ImportError:
                print("--show requires OpenCV (cv2)", file=sys.stderr)
                return 1
        tracer = Tracer(enabled=bool(cfg.trace))

        # resume accounting: payload k encodes source frame k+1
        total_payloads = max(props.frame_count - 1, 0)
        start = min(cfg.start_frame, total_payloads)
        n_payloads = total_payloads - start
        if cfg.max_frames:
            n_payloads = min(n_payloads, cfg.max_frames)

        def frames_from(q: BoundedQueue):
            it = iter(q)
            for _ in range(start):  # skip up to the overlap frame
                next(it, None)
            for i, frame in enumerate(it):
                if i > n_payloads:  # overlap frame + payload frames
                    break
                yield frame

        payloads = 0

        def encode_stream(q: BoundedQueue):
            nonlocal payloads
            chunks = encoder.encode_video(
                frames_from(q),
                emit_header=not cfg.no_header,
                header_frame_count=n_payloads,
                first_anchor_index=start,
                tracer=tracer if cfg.trace else None,
            )
            for i, chunk in enumerate(chunks):
                if i or cfg.no_header:  # chunk 0 is the header, if any
                    payloads += 1
                yield chunk

        cancel = CancelToken()

        def produce(q: BoundedQueue) -> None:
            for frame in reader:
                cancel.check()
                q.push(frame)

        def consume(q: BoundedQueue) -> None:
            if native.available():
                with native.NativeWriter(cfg.output, capacity=10) as w:
                    for chunk in encode_stream(q):
                        w.push(chunk)
                return
            out = open(cfg.output, "wb") if cfg.output else sys.stdout.buffer

            def write_all(wq: BoundedQueue) -> None:
                for chunk in encode_stream(q):
                    wq.push(chunk)

            def drain(wq: BoundedQueue) -> None:
                for chunk in wq:
                    out.write(chunk)

            try:
                pipeline_threads(write_all, drain, capacity=10, cancel=cancel)
            finally:
                if cfg.output:
                    out.close()

        try:
            # 3-stage pipeline: reader thread -> encode -> writer
            with device_profile(cfg.profile, device):
                pipeline_threads(produce, consume, capacity=10, cancel=cancel)
        except KeyboardInterrupt:
            cancel.cancel()
            print("interrupted", file=sys.stderr)
            return 130
        except Exception as e:  # noqa: BLE001 — the CLI's boundary
            print(f"encoding failed: {e!r}", file=sys.stderr)
            return 1
    finally:
        reader.close()

    # the container's frame count can be wrong; a header promising more
    # payloads than the body holds makes the stream undecodable
    if not cfg.no_header and payloads != n_payloads:
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
    if cfg.trace:
        tracer.dump(cfg.trace)
        print(tracer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
