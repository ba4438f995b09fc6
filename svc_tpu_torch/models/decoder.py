"""The decoder pipeline on torch tensors (``svc_tpu/models/decoder.py``).

Per frame: per-block quantization step (gaze rect / block type) ->
dequantize -> inverse DCT -> bilinear resize of the PADDED reconstruction
to the display size (the reference's display-path squeeze, replicated) ->
round/clip -> packed ``(H, W*C)`` BGR bytes.

Routes, by geometry:

* width-aligned (``frame_w`` equals the padded width — every MV-block
  divisible width, 1080p included): only rows are resampled, and the whole
  path is kernel K1 (``ops.dct.idct_display``); zero excess is its
  identity-row mode;
* general (width excess — 854x480, 1366x768, ...): both axes are
  resampled, and the whole path is kernel K6 (``ops.dct.idct_resize_display``).

On the CPU both routes run the kernels' plain PyTorch versions.

With a device list (``devices=``, ``parallel.sharding.make_frame_devices``)
a batch splits into one chunk of frames per entry, each decoded by the
same single-device program on its own device and gathered back in order
onto the first: frames are data-parallel in decode (each depends only on
its own payload and gaze rect), so no collective is needed and the frames
equal the single-device ones.

Every route returns uint8 packed ``(T, H, W*C)`` rows.

On ``cuda`` a batch runs as one CUDA graph replay per (device entry,
batch shape) (``runtime/graphs.py``), svc_tpu's one compiled program per
batch shape (``jax.jit`` of its ``decode_batch``, and the same under
``shard_map`` for a mesh): the steps, then K1 or K6, captured after a
warm-up that fills the display kernels' table caches. The captured
program has no host sync and no host copy: its constants are scalars, its
tables already on the device, its static inputs 16-byte aligned.
``Decoder(..., graph=False)`` keeps the eager path on the card, to hold
the graph against; CPU tensors always run eagerly.

``decode_frames`` streams the way ``svc_tpu`` does: wire coefficients are
staged one batch ahead on a worker thread (``stage_coeffs``: pinned
buffer, copy stream, event), and one batch stays in flight, so batch ``i``
is read back (pinned D2H on a second copy stream) only after batch
``i + 1`` has been dispatched. With graphs the stager copies each batch's
coefficients straight into the static input of the graph that will
replay it (``GraphPair.claim``), svc_tpu's one H2D copy into its
program's own input (``stage_coeffs``). The block types and gaze rects,
1% of the bytes, are staged beside them on the same worker thread, into
new tensors the replay copies in: on the dispatching thread their pinned
copy waited while the worker stacked its batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svc_tpu_torch.config import DecoderConfig
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.utils.mathx import round_half_away_from_zero
from svc_tpu_torch.ops.dct import idct_display, idct_resize_display
from svc_tpu_torch.ops.quant import block_quant_steps
from svc_tpu_torch.runtime.device import DeviceLike, device_scope, resolve_device
from svc_tpu_torch.runtime.graphs import GraphPair
from svc_tpu_torch.runtime.staging import (
    DoubleBufferedStager,
    PinnedDownload,
    PinnedUpload,
    Staged,
    to_device,
)
from svc_tpu_torch.runtime.tracing import span


def gaze_rect_from_center(
    cx: int, cy: int, max_w: int, max_h: int, frame_w: int, frame_h: int
) -> Tuple[int, int, int, int]:
    """Clamp a gaze rectangle centered at (cx, cy) inside the frame
    (``CalcWithinFrameRectFromCenter``, libs/decoder.cpp:65-100): the half
    extents shrink so the rect stays within bounds. Returns ``(x, y, w, h)``.
    """
    cx = min(max(cx, 0), frame_w - 1)
    cy = min(max(cy, 0), frame_h - 1)
    half_w = (max_w + 1) // 2
    if cx + half_w >= frame_w:
        half_w = frame_w - cx - 1
    if cx < half_w:
        half_w = cx
    half_h = (max_h + 1) // 2
    if cy + half_h >= frame_h:
        half_h = frame_h - cy - 1
    if cy < half_h:
        half_h = cy
    return cx - half_w, cy - half_h, 2 * half_w, 2 * half_h


class Decoder:
    """Batched bitstream decoder.

    Args:
      cfg: validated ``DecoderConfig``.
      header: bitstream header.
      batch_size: frames decoded per batch.
      device: ``"cuda"`` (kernels K1 / K6) or ``"cpu"`` (plain PyTorch).
      devices: optional device list (an entry may repeat); each batch
        splits into ``len(devices)`` equal chunks of frames, one per
        entry, and ``device`` is ignored. ``batch_size`` must divide.
      graph: on ``cuda``, run each batch (each entry's chunk) as a CUDA
        graph replay (the default); ``False`` runs it eagerly, kernel by
        kernel. Ignored on the CPU, which always runs eagerly.

    On ``cuda`` with ``graph=True`` and one device, the tensor
    :meth:`decode_batch` returns is the graph's own: it stays valid until
    the second call after it (two graphs per shape, taken by turns); copy
    what must live longer. ``decode_frames`` reads batch ``k`` back before
    it dispatches batch ``k + 2``.
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        header: bitstream.Header,
        batch_size: int = 8,
        device: DeviceLike = "cuda",
        devices: Optional[Sequence[DeviceLike]] = None,
        graph: bool = True,
    ):
        self.cfg = cfg
        self.header = header
        self.batch_size = batch_size
        if devices:
            self.devices = [resolve_device(d) for d in devices]
            if batch_size % len(self.devices):
                raise ValueError(
                    f"batch size {batch_size} must divide across "
                    f"{len(self.devices)} devices"
                )
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]  # where the frames are gathered
        self.width_aligned = header.frame_w == header.padded_frame_w
        self.graph = graph and self.device.type == "cuda"
        self._graphs: Dict[Tuple[int, int], GraphPair] = {}  # by (entry, frames)
        self._uploads = [PinnedUpload(d) for d in self.devices]
        # block types and gaze rects, staged beside the coefficients
        self._small_uploads = [(PinnedUpload(d), PinnedUpload(d))
                               for d in self.devices]
        h = header
        # (nby, nbx, C*bh*bw): a frame's wire coefficients
        self._wire_shape = (
            h.padded_frame_h // h.transform_block_h,
            h.padded_frame_w // h.transform_block_w,
            h.channel_count * h.transform_block_h * h.transform_block_w,
        )

    def padded_gaze_rect(
        self, gaze: Optional[Tuple[int, int]]
    ) -> Tuple[int, int, int, int]:
        """Gaze rect in padded space (libs/decoder.cpp:174-183), or an
        empty rect when no gaze position is given."""
        h = self.header
        if gaze is None:
            return (0, 0, 0, 0)
        rect = gaze_rect_from_center(
            gaze[0], gaze[1], self.cfg.max_gaze_rect_w,
            self.cfg.max_gaze_rect_h, h.frame_w, h.frame_h,
        )
        w_ratio = h.padded_frame_w / h.frame_w
        h_ratio = h.padded_frame_h / h.frame_h
        return (
            round_half_away_from_zero(rect[0] * w_ratio),
            round_half_away_from_zero(rect[1] * h_ratio),
            round_half_away_from_zero(rect[2] * w_ratio),
            round_half_away_from_zero(rect[3] * h_ratio),
        )

    def _steps(self, block_types: torch.Tensor, rects: torch.Tensor):
        h = self.header
        nby, nbx, _ = self._wire_shape
        dev = block_types.device
        bys = torch.arange(nby, device=dev)[:, None] * h.transform_block_h
        bxs = torch.arange(nbx, device=dev)[None, :] * h.transform_block_w
        r = rects.to(torch.int64)[:, :, None, None]
        # cv::Rect::contains: x <= px < x + w
        gazed = (
            (bxs >= r[:, 0]) & (bxs < r[:, 0] + r[:, 2])
            & (bys >= r[:, 1]) & (bys < r[:, 1] + r[:, 3])
        )
        return block_quant_steps(
            block_types, gazed,
            self.cfg.foreground_quant_step, self.cfg.background_quant_step,
        )

    def _split(self, items) -> list:
        """``items`` (T frames) as one equal chunk per device; staged
        chunks (a list of :class:`Staged`) as they are."""
        if isinstance(items, list) and items and isinstance(items[0], Staged):
            return items
        n = len(self.devices)
        if len(items) % n:
            raise ValueError(f"{len(items)} frames do not split across {n} devices")
        per = len(items) // n
        return [items[i * per:(i + 1) * per] for i in range(n)]

    def stage_coeffs(self, coeffs):
        """Ship host wire coefficients to the device for
        :meth:`decode_batch`: a ``(T, nby, nbx, C*bh*bw)`` float32 array or
        a sequence of T ``(nby, nbx, C*bh*bw)`` ones, stacked straight into
        one of two reused pinned buffers and copied on the copy stream
        (``cuda``). Once the graph of the chunk's shape exists, the copy
        goes straight into the static input of its next call not yet
        claimed; that call must then decode it. Safe to call from the
        stager's worker thread, which never captures. With a device list,
        a list of one :class:`Staged` chunk per device."""
        staged = []
        for i, (up, c) in enumerate(zip(self._uploads, self._split(coeffs))):
            shape = (len(c),) + self._wire_shape
            pair = self._graphs.get((i, len(c)))
            if pair is None:
                staged.append(up(c, shape, torch.float32))
            else:
                claim = pair.claim()
                staged.append(up(c, shape, torch.float32, into=claim.inputs[0],
                                 after=claim.last_read))
        return staged[0] if len(staged) == 1 else staged

    def _stage_batch(self, batch):
        """``(coeffs, block_types, gaze_rects)`` of one host batch staged
        for :meth:`decode_batch`: the coefficients by :meth:`stage_coeffs`,
        the block types and rects as int64 through their own pinned
        uploads."""
        coeffs, types, rects = batch
        small = [[], []]
        for (up_t, up_r), t, r in zip(self._small_uploads, self._split(types),
                                      self._split(rects)):
            small[0].append(up_t(t, np.shape(t), torch.int64))
            small[1].append(up_r(r, np.shape(r), torch.int64))
        if len(self.devices) == 1:
            small = [x[0] for x in small]
        return (self.stage_coeffs(coeffs), *small)

    def decode_batch(self, coeffs, block_types, gaze_rects) -> torch.Tensor:
        """Decode one batch to packed ``(T, H, W*C)`` uint8 rows.

        Args:
          coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients, as
            an array, a tensor or staged by :meth:`stage_coeffs` (then the
            current stream waits on the copy's event first).
          block_types: ``(T, nby, nbx)`` wire block types (or staged).
          gaze_rects: ``(T, 4)`` padded-space ``(x, y, w, h)`` rects (or
            staged).
        """
        if len(self.devices) == 1:
            return self._decode_on(0, coeffs, block_types, gaze_rects)
        rows = []
        for i, (dev, c, bt, r) in enumerate(zip(
            self.devices, self._split(coeffs), self._split(block_types),
            self._split(gaze_rects),
        )):
            with device_scope(dev):
                rows.append(self._decode_on(i, c, bt, r))
        return torch.cat([r.to(self.device) for r in rows])

    def _pair(self, entry: int, frames: int) -> GraphPair:
        """Entry ``entry``'s graphs for chunks of ``frames`` frames,
        captured on first use under its device (a capture that fails
        raises)."""
        pair = self._graphs.get((entry, frames))
        if pair is None:
            dev = self.devices[entry]
            shape = (frames,) + self._wire_shape
            example = (
                torch.zeros(shape, device=dev),
                torch.zeros(shape[:3], dtype=torch.int64, device=dev),
                torch.zeros((frames, 4), dtype=torch.int64, device=dev),
            )
            pair = self._graphs[(entry, frames)] = GraphPair(
                self._decode, example, dev)
        return pair

    def _decode_on(self, entry: int, coeffs, block_types, gaze_rects) -> torch.Tensor:
        """The single-device program on device entry ``entry``."""
        dev = self.devices[entry]
        if isinstance(coeffs, Staged):
            c = coeffs.take()
        else:
            c = torch.as_tensor(coeffs).to(dev, torch.float32)
        bt, rects = (x.take() if isinstance(x, Staged)
                     else to_device(np.asarray(x, np.int64), dev)
                     for x in (block_types, gaze_rects))
        if not self.graph:
            return self._decode(c, bt, rects)["rows"]
        return self._pair(entry, len(c))(c, bt, rects)["rows"]

    def _decode(self, coeffs: torch.Tensor, block_types: torch.Tensor,
                rects: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch, eagerly, on device tensors: int64 block types and
        rects, the per-block steps, then K1 or K6."""
        h = self.header
        steps = self._steps(block_types, rects)
        ch, tbh, tbw = h.channel_count, h.transform_block_h, h.transform_block_w
        if self.width_aligned:
            rows = idct_display(coeffs, steps, h.frame_h, ch, tbh, tbw)
        else:
            rows = idct_resize_display(coeffs, steps, h.frame_h, h.frame_w,
                                       ch, tbh, tbw)
        return {"rows": rows}

    def decode_frames(
        self,
        payloads: Iterator[bytes],
        gazes: Optional[Iterator[Optional[Tuple[int, int]]]] = None,
        tracer=None,
        stage_h2d: bool = True,
    ) -> Iterator[np.ndarray]:
        """Decode wire payloads into ``(H, W, C)`` uint8 BGR frames.

        Batches are padded to the batch shape with copies of their last
        payload; the surplus outputs are dropped. One batch is in flight:
        batch ``i`` is read back only after batch ``i + 1`` has been
        dispatched, and with ``stage_h2d`` each batch's coefficients are
        staged on a worker thread while the previous batch computes
        (svc_tpu/models/decoder.py:404-537). The bytes are the same either
        way. ``tracer`` records the ``parse``, ``device_dispatch`` and
        ``device_fetch`` spans.

        With graphs (``cuda``), each device entry's graphs for the batch
        shape are captured here, on the calling thread, before the first
        batch is staged; the padded last batch has the same shape. Batch
        ``i`` is read back before batch ``i + 2`` is dispatched, so the
        graph's outputs it reads are still its own.
        """
        h = self.header
        batch = self.batch_size
        buf_c: List[np.ndarray] = []
        buf_t: List[np.ndarray] = []
        buf_g: List[Tuple[int, int, int, int]] = []
        download = PinnedDownload()
        pending = None  # one batch in flight: fetch i while i+1 computes

        def take_buffers():
            while len(buf_c) < batch:
                buf_c.append(buf_c[-1])
                buf_t.append(buf_t[-1])
                buf_g.append(buf_g[-1])
            args = (list(buf_c), np.stack(buf_t), np.asarray(buf_g, np.int32))
            buf_c.clear()
            buf_t.clear()
            buf_g.clear()
            return args

        def fetch(done) -> np.ndarray:
            rows, n_valid = done
            # copied out: the pinned buffer is refilled two batches on
            packed = np.array(rows.wait()["rows"][:n_valid])
            return packed.reshape(n_valid, h.frame_h, h.frame_w, -1)

        def dispatch(coeffs, types, rects, n_valid: int):
            nonlocal pending
            with span(tracer, "device_dispatch", frames=n_valid):
                rows = download.start({"rows": self.decode_batch(coeffs, types, rects)})
            prev, pending = pending, (rows, n_valid)
            if prev is not None:
                with span(tracer, "device_fetch", frames=prev[1]):
                    frames = fetch(prev)
                yield from frames

        if self.graph:
            for entry in range(len(self.devices)):
                self._pair(entry, batch // len(self.devices))
        stager = DoubleBufferedStager(self._stage_batch) if stage_h2d else None
        staged_valid = None  # n_valid of the staged batch

        def run(n_valid: int):
            nonlocal staged_valid
            coeffs, types, rects = take_buffers()
            if stager is None:
                yield from dispatch(np.stack(coeffs), types, rects, n_valid)
            elif staged_valid is not None:
                staged = stager.collect()  # batch i-1's transfer
                valid = staged_valid
                stager.submit((coeffs, types, rects))  # batch i streams H2D...
                staged_valid = n_valid
                yield from dispatch(*staged, valid)  # ...while i-1 computes
            else:
                stager.submit((coeffs, types, rects))
                staged_valid = n_valid

        try:
            for payload in payloads:
                with span(tracer, "parse"):
                    types, coeffs = bitstream.deserialize_frame_blocks(payload, h)
                gaze = next(gazes, None) if gazes is not None else None
                buf_c.append(coeffs.reshape(coeffs.shape[0], coeffs.shape[1], -1))
                buf_t.append(types)
                buf_g.append(self.padded_gaze_rect(gaze))
                if len(buf_c) == batch:
                    yield from run(batch)
            if buf_c:
                yield from run(len(buf_c))
            if staged_valid is not None:
                yield from dispatch(*stager.collect(), staged_valid)
            if pending is not None:
                with span(tracer, "device_fetch", frames=pending[1]):
                    frames = fetch(pending)
                yield from frames
        finally:
            if stager is not None:
                stager.close()
                self._release_claims()

    def _release_claims(self) -> None:
        """After a staged stream, which may have ended with a batch staged
        and never decoded: the current stream waits for every upload still
        writing a static input, and no claim is left."""
        for (entry, _), pair in self._graphs.items():
            self._uploads[entry].settle()
            pair.release()
