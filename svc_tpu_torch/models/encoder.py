"""The encoder pipeline on torch tensors (``svc_tpu/models/encoder.py``).

Per batch of ``T + 1`` frames (frame ``t`` tracked against anchor
``t + 1``; frame 0 is the overlap frame, never emitted):

    BGR -> luma -> pad -> pyramid (K4) -> HBMA (top-level EBMA, then K3 per
    refinement level) -> RANSAC global motion -> foreground = outliers ->
    close/open -> k-means of foreground motion features -> per-cluster
    connected components -> block types; forward DCT of frames 1..T (K2)

Randomness: anchor ``i`` draws from ``fold_in(key(cfg.seed), i)``, split
into the RANSAC and k-means keys — the same derivation as ``svc_tpu``, so
both packages emit the same bitstream for the same input and config.

K-means features and repair follow the config, as in ``svc_tpu``: the
default config clusters ``(mv.x, mv.y, x, y)`` with the ``global_farthest``
repair (kernel K5 on CUDA); ``reference_compat=True`` clusters the
reference's effective ``(0, mv.x, x, y)`` layout (quirk Q1) with cv::kmeans'
split-the-biggest-cluster repair.

On ``cuda`` a batch runs as one CUDA graph per input shape
(``runtime/graphs.py``), svc_tpu's one compiled program per batch shape
(``jax.jit(self.encode_batch_fn)``): captured on first use, then replayed
with the frames and anchor keys copied into its static inputs. The path
has no host sync and no host copy for it to trip on: the CCL converges in
kernel K10, the threefry draws run in K11, and every scalar constant is
filled on the device. ``Encoder(..., graph=False)`` keeps the eager path
on the card, to hold the graph against; CPU tensors always run eagerly.

Streaming (``stream_encode``) overlaps the stages the way ``svc_tpu`` does:
each batch's frames are staged one batch ahead on a worker thread
(``stage_frames``: pinned buffer, copy stream, event), and one batch stays
in flight, so batch ``i`` is fetched (pinned D2H on a second copy stream)
and serialized only after batch ``i + 1`` has been dispatched.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from svc_tpu_torch.config import EncoderConfig, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.ops import prng
from svc_tpu_torch.ops.ccl import block_types_from_clusters
from svc_tpu_torch.ops.color import bgr_planes_to_y
from svc_tpu_torch.ops.dct import dct8x8_to_wire
from svc_tpu_torch.ops.kmeans import kmeans_t_frames
from svc_tpu_torch.ops.morphology import close_then_open
from svc_tpu_torch.ops.motion import hbma_stack
from svc_tpu_torch.ops.pad import pad_frame, padded_dims
from svc_tpu_torch.ops.pyramid import build_pyramid
from svc_tpu_torch.ops.ransac import estimate_global_motion_ransac, iter_count
from svc_tpu_torch.runtime.device import DeviceLike, resolve_device
from svc_tpu_torch.runtime.graphs import GraphPair
from svc_tpu_torch.runtime.staging import (
    DoubleBufferedStager,
    PinnedDownload,
    PinnedUpload,
    Staged,
)
from svc_tpu_torch.runtime.tracing import span


class Encoder:
    """Batched video encoder.

    Args:
      cfg: validated ``EncoderConfig``.
      vidprops: source video properties.
      batch_size: anchor frames encoded per batch.
      device: ``"cuda"`` (kernels) or ``"cpu"`` (plain PyTorch versions).
      keep_planes: include the padded channel planes in the outputs
        (``padded_planes``, the full ``(3, T+1, PH, PW)`` stack; frame 0 is
        the overlap frame). Only the visualizer consumes them.
      graph: on ``cuda``, run each batch as a CUDA graph replay (the
        default); ``False`` runs it eagerly, kernel by kernel. Ignored on
        the CPU, which always runs eagerly.

    On ``cuda`` with ``graph=True`` the tensors a batch returns are the
    graph's own: they stay valid until the second call after it (two
    graphs per shape, taken by turns); copy what must live longer.
    """

    def __init__(
        self,
        cfg: EncoderConfig,
        vidprops: VideoProperties,
        batch_size: int = 8,
        device: DeviceLike = "cuda",
        keep_planes: bool = False,
        graph: bool = True,
    ):
        if iter_count(cfg.ransac) == 0:
            raise ValueError(
                "RANSAC parameters yield zero hypotheses; nothing to fit"
            )
        self.cfg = cfg
        self.vidprops = vidprops
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.keep_planes = keep_planes
        self.graph = graph and self.device.type == "cuda"
        self._graphs: Dict[tuple, GraphPair] = {}  # by (T+1, H, W*3)
        self._seed_key: Optional[torch.Tensor] = None  # copied on first use
        self._upload = PinnedUpload(self.device)
        self.padded_w, self.padded_h = padded_dims(
            vidprops.frame_w,
            vidprops.frame_h,
            cfg.mv_block_w,
            cfg.mv_block_h,
            cfg.pyr_lvl_count,
        )
        self.excess_w = self.padded_w - vidprops.frame_w
        self.excess_h = self.padded_h - vidprops.frame_h
        self.mv_field_w = self.padded_w // cfg.mv_block_w
        self.mv_field_h = self.padded_h // cfg.mv_block_h

    def header(self, frame_count: Optional[int] = None) -> bitstream.Header:
        """Bitstream header; the first frame is reference-only, so the
        stream carries ``frame_count - 1`` payloads unless overridden."""
        if frame_count is None:
            frame_count = self.vidprops.frame_count
            if frame_count > 0:
                frame_count -= 1
        return bitstream.Header(
            frame_count=frame_count,
            frame_w=self.vidprops.frame_w,
            frame_h=self.vidprops.frame_h,
            frame_excess_w=self.excess_w,
            frame_excess_h=self.excess_h,
            transform_block_w=self.cfg.transform_block_w,
            transform_block_h=self.cfg.transform_block_h,
            channel_count=3,
        )

    def _keys(self, start_index: int, count: int) -> torch.Tensor:
        """``(count, 2)`` anchor keys ``fold_in(key(seed), i)``."""
        if self._seed_key is None:
            self._seed_key = prng.key(self.cfg.seed, self.device)
        idx = torch.arange(start_index, start_index + count, device=self.device)
        return prng.fold_in(self._seed_key, idx)

    def stage_frames(self, packed) -> Staged:
        """Ship host frames to the device for :meth:`encode_batch_staged`.

        ``packed`` is ``(N, H, W*3)`` uint8 rows, or a sequence of N
        ``(H, W, 3)`` frames; either is stacked straight into one of two
        reused pinned buffers and copied on the copy stream (``cuda``).
        Safe to call from the stager's worker thread.
        """
        first = packed if isinstance(packed, np.ndarray) else packed[0]
        n = len(packed)
        h = first.shape[1] if isinstance(packed, np.ndarray) else first.shape[0]
        shape = (n, h, self.vidprops.frame_w * 3)
        return self._upload(packed, shape, torch.uint8)

    def encode_batch_staged(
        self, staged: Staged, first_anchor_index: int
    ) -> Dict[str, torch.Tensor]:
        """Dispatch on frames shipped by :meth:`stage_frames`: the current
        stream waits on the copy's event before the batch's first kernel."""
        return self.encode_packed(staged.take(), first_anchor_index)

    def encode_batch(
        self, frames_bgr, first_anchor_index: int
    ) -> Dict[str, torch.Tensor]:
        """Encode ``(T+1, H, W, 3)`` uint8 BGR frames (numpy or tensor);
        anchor ``t`` of the batch has stream index ``first_anchor_index + t``.
        The direct, synchronous path: the frames are copied as they are,
        from pageable memory.
        """
        frames = torch.as_tensor(np.ascontiguousarray(frames_bgr))
        n, h, w, c = frames.shape
        packed = frames.reshape(n, h, w * c).to(self.device)
        return self.encode_packed(packed, first_anchor_index)

    def encode_packed(
        self, packed: torch.Tensor, first_anchor_index: int
    ) -> Dict[str, torch.Tensor]:
        """Encode ``(T+1, H, W*3)`` uint8 packed rows already on the device.

        The anchor keys are drawn outside the graph (K11); on ``cuda`` with
        ``graph=True`` the batch is then one replay of the graph of its
        shape, captured on first use (a capture that fails raises)."""
        keys = self._keys(first_anchor_index, packed.shape[0] - 1)
        if not self.graph:
            return self._encode(packed, keys)
        shape = tuple(packed.shape)
        graphs = self._graphs.get(shape)
        if graphs is None:
            graphs = self._graphs[shape] = GraphPair(
                self._encode, (packed, keys), self.device)
        return graphs(packed, keys)

    def _encode(
        self, packed: torch.Tensor, anchor_keys: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """The batch, eagerly: packed rows and ``(T, 2)`` anchor keys in."""
        cfg = self.cfg
        n, h, w3 = packed.shape
        t = n - 1
        mfh, mfw = self.mv_field_h, self.mv_field_w
        k = cfg.kmeans.cluster_count

        px = packed.reshape(n, h, w3 // 3, 3)
        y = bgr_planes_to_y(px[..., 0], px[..., 1], px[..., 2])
        y = pad_frame(y, self.padded_w, self.padded_h)
        pyr = build_pyramid(y, cfg.pyr_lvl_count)
        mv, _ = hbma_stack(pyr, cfg.mv_search_range, cfg.mv_block_w, cfg.mv_block_h)

        keys = prng.split(anchor_keys)  # (T, 2, 2)
        gm, rmse, inliers = estimate_global_motion_ransac(
            mv, cfg.ransac, keys[:, 0]
        )
        # foreground = RANSAC outliers, then morphological cleanup
        fg_raw = ~inliers
        fg = close_then_open(fg_raw, cfg.morph_rect_w, cfg.morph_rect_h)

        # k-means features per block (libs/encoder.cpp:296-321)
        dev = packed.device
        ys = (torch.arange(mfh, dtype=torch.float32, device=dev)[:, None]
              * cfg.mv_block_h).expand(t, mfh, mfw)
        xs = (torch.arange(mfw, dtype=torch.float32, device=dev)[None, :]
              * cfg.mv_block_w).expand(t, mfh, mfw)
        if cfg.reference_compat:
            # quirk Q1: the reference's effective layout (0, mv.x, x, y)
            rows = [torch.zeros_like(mv[..., 0]), mv[..., 0], xs, ys]
        else:
            rows = [mv[..., 0], mv[..., 1], xs, ys]
        feats = torch.stack(rows, dim=1).reshape(t, 4, mfh * mfw)
        labels, _, _ = kmeans_t_frames(
            feats,
            fg.reshape(t, -1),
            k,
            keys[:, 1],
            attempts=cfg.kmeans.attempt_count,
            max_iter=cfg.kmeans.max_iter_count,
            epsilon=cfg.kmeans.epsilon,
            repair="opencv_split" if cfg.reference_compat else "global_farthest",
        )
        labels = labels.reshape(t, mfh, mfw)
        btypes, _ = block_types_from_clusters(
            labels, k, cfg.connected_components_connectivity
        )
        coeffs = dct8x8_to_wire(
            packed, 1, t, self.padded_h, self.padded_w,
            cfg.transform_block_h, cfg.transform_block_w, 3,
        )
        out = {
            "coeffs": coeffs,
            "block_types": btypes,
            "mv_field": mv,
            "foreground_mask_raw": fg_raw,
            "foreground_mask": fg,
            "cluster_labels": labels,
            "global_motion": gm,
            "ransac_rmse": rmse,
        }
        if self.keep_planes:
            out["padded_planes"] = pad_frame(
                px.permute(3, 0, 1, 2), self.padded_w, self.padded_h
            ).contiguous()
        return out

    def encode_video(
        self,
        frames: Iterator[np.ndarray],
        on_batch=None,
        emit_header: bool = True,
        header_frame_count: Optional[int] = None,
        first_anchor_index: int = 0,
        tracer=None,
    ) -> Iterator[bytes]:
        """Stream encode: the header, then one payload per anchor frame
        (see :func:`stream_encode`)."""
        return stream_encode(
            self,
            frames,
            on_batch=on_batch,
            emit_header=emit_header,
            header_frame_count=header_frame_count,
            first_anchor_index=first_anchor_index,
            tracer=tracer,
        )


def stream_encode(
    enc,
    frames: Iterator[np.ndarray],
    on_batch=None,
    emit_header: bool = True,
    header_frame_count: Optional[int] = None,
    first_anchor_index: int = 0,
    tracer=None,
) -> Iterator[bytes]:
    """Yield the header, then one wire payload per anchor frame, through
    any encoder exposing the batch protocol (``header()``, ``batch_size``,
    ``cfg``, ``encode_batch``).

    Frames are consumed ``batch_size + 1`` at a time; the last frame of a
    batch is the overlap (tracked-only) frame of the next. The final partial
    batch is padded with copies of its last frame and the surplus payloads
    are dropped.

    The structure is ``svc_tpu``'s (svc_tpu/models/encoder.py:544-705):

    * when the encoder exposes ``stage_frames`` and ``encode_batch_staged``,
      each batch's frames are staged on a worker thread
      (``DoubleBufferedStager``) while the previous batch computes;
    * one batch is in flight: right after a batch is dispatched its outputs
      start copying to pinned host memory on a copy stream, and they are
      read and serialized only after the NEXT batch has been dispatched.

    On ``cuda`` the dispatch returns once the batch's graph replay is
    queued (the eager path, ``graph=False``, has no host sync either, but
    its host launches take longer than the device work). Fetch and
    serialization stay on this thread: a serializer thread beside the
    dispatching one measured no faster on an H100 host, contention slowing
    dispatch by about what it overlapped (PERF.md). The two graphs per
    shape keep batch ``i``'s outputs intact while its copy runs beside
    batch ``i + 1``.

    ``on_batch(first_anchor_index, outputs, n_valid)`` is an observability
    hook (the visualizer); ``tracer`` records the ``device_dispatch``,
    ``device_fetch`` and ``serialize`` spans (``runtime.tracing.Tracer``).
    ``emit_header=False`` plus ``first_anchor_index`` resume a partially
    written stream: the caller feeds frames from one before the resume
    point.
    """
    if emit_header:
        yield enc.header(header_frame_count).pack()

    cfg = enc.cfg
    window: List[np.ndarray] = []
    anchor_index = first_anchor_index
    batch = enc.batch_size
    download = PinnedDownload()
    pending = None  # one batch in flight: fetch i while i+1 computes

    def serialize(done):
        out, fetch, first_index, n_valid = done
        with span(tracer, "device_fetch", frames=n_valid):
            host = fetch.wait()
            c = host["coeffs"]
            t_, nby, nbx, _ = c.shape
            coeffs = c.reshape(
                t_, nby, nbx, -1, cfg.transform_block_h, cfg.transform_block_w
            )
            btypes = host["block_types"].astype(np.uint32)
        if on_batch is not None:
            on_batch(first_index, out, n_valid)
        for i in range(n_valid):
            with span(tracer, "serialize"):
                payload = bitstream.serialize_frame_blocks(
                    coeffs[i], btypes[i], cfg.mv_block_w, cfg.mv_block_h
                )
            yield payload

    use_staging = hasattr(enc, "stage_frames") and hasattr(enc, "encode_batch_staged")
    stager = None
    staged_meta = None  # (first_anchor_index, n_valid) of the staged batch

    def dispatch(frames_or_staged, first_index: int, n_valid: int, staged: bool):
        nonlocal pending
        with span(tracer, "device_dispatch", frames=n_valid):
            if staged:
                out = enc.encode_batch_staged(frames_or_staged, first_index)
            else:
                out = enc.encode_batch(frames_or_staged, first_index)
            fetch = download.start(
                {"coeffs": out["coeffs"], "block_types": out["block_types"]}
            )
        prev, pending = pending, (out, fetch, first_index, n_valid)
        if prev is not None:
            yield from serialize(prev)

    def run(window_frames: List[np.ndarray], n_valid: int):
        nonlocal anchor_index, staged_meta
        if stager is None:
            fi = anchor_index
            anchor_index += n_valid
            yield from dispatch(np.stack(window_frames), fi, n_valid, staged=False)
            return
        if staged_meta is not None:
            staged = stager.collect()  # batch i-1's transfer
            fi, nv = staged_meta
            stager.submit(window_frames)  # batch i streams H2D...
            staged_meta = (anchor_index, n_valid)
            anchor_index += n_valid
            yield from dispatch(staged, fi, nv, staged=True)  # ...while i-1 computes
        else:
            stager.submit(window_frames)
            staged_meta = (anchor_index, n_valid)
            anchor_index += n_valid

    try:
        if use_staging:
            stager = DoubleBufferedStager(enc.stage_frames)
        for frame in frames:
            window.append(np.asarray(frame, dtype=np.uint8))
            if len(window) == batch + 1:
                yield from run(window, batch)
                window = window[-1:]  # overlap frame
        remainder = len(window) - 1
        if remainder > 0:
            # pad to the batch shape; the surplus outputs are dropped
            pad = [window[-1]] * (batch - remainder)
            yield from run(window + pad, remainder)
        if staged_meta is not None:
            staged = stager.collect()
            fi, nv = staged_meta
            yield from dispatch(staged, fi, nv, staged=True)
        if pending is not None:
            yield from serialize(pending)
    finally:
        if stager is not None:
            stager.close()
