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

``decode_frames`` streams the way ``svc_tpu`` does: wire coefficients are
staged one batch ahead on a worker thread (``stage_coeffs``: pinned
buffer, copy stream, event), and one batch stays in flight, so batch ``i``
is read back (pinned D2H on a second copy stream) only after batch
``i + 1`` has been dispatched.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svc_tpu_torch.config import DecoderConfig
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.utils.mathx import round_half_away_from_zero
from svc_tpu_torch.ops.dct import idct_display, idct_resize_display
from svc_tpu_torch.ops.quant import block_quant_steps
from svc_tpu_torch.runtime.device import DeviceLike, device_scope, resolve_device
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
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        header: bitstream.Header,
        batch_size: int = 8,
        device: DeviceLike = "cuda",
        devices: Optional[Sequence[DeviceLike]] = None,
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
        self._uploads = [PinnedUpload(d) for d in self.devices]

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
        nby = h.padded_frame_h // h.transform_block_h
        nbx = h.padded_frame_w // h.transform_block_w
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
        """``items`` (T frames) as one equal chunk per device."""
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
        (``cuda``). Safe to call from the stager's worker thread. With a
        device list, a list of one :class:`Staged` chunk per device."""
        h = self.header
        nby = h.padded_frame_h // h.transform_block_h
        nbx = h.padded_frame_w // h.transform_block_w
        per_block = h.channel_count * h.transform_block_h * h.transform_block_w
        staged = [
            up(c, (len(c), nby, nbx, per_block), torch.float32)
            for up, c in zip(self._uploads, self._split(coeffs))
        ]
        return staged[0] if len(staged) == 1 else staged

    def decode_batch(self, coeffs, block_types, gaze_rects) -> torch.Tensor:
        """Decode one batch to packed ``(T, H, W*C)`` uint8 rows.

        Args:
          coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients, as
            an array, a tensor or staged by :meth:`stage_coeffs` (then the
            current stream waits on the copy's event first).
          block_types: ``(T, nby, nbx)`` wire block types.
          gaze_rects: ``(T, 4)`` padded-space ``(x, y, w, h)`` rects.
        """
        if len(self.devices) == 1:
            return self._decode_on(self.device, coeffs, block_types, gaze_rects)
        if not isinstance(coeffs, list) or not isinstance(coeffs[0], Staged):
            coeffs = self._split(coeffs)
        rows = []
        for dev, c, bt, r in zip(
            self.devices, coeffs, self._split(np.asarray(block_types)),
            self._split(np.asarray(gaze_rects)),
        ):
            with device_scope(dev):
                rows.append(self._decode_on(dev, c, bt, r))
        return torch.cat([r.to(self.device) for r in rows])

    def _decode_on(self, dev, coeffs, block_types, gaze_rects) -> torch.Tensor:
        """The single-device program on ``dev``."""
        h = self.header
        if isinstance(coeffs, Staged):
            c = coeffs.take()
        else:
            c = torch.as_tensor(coeffs).to(dev, torch.float32)
        bt = to_device(np.asarray(block_types, np.int64), dev)
        rects = to_device(np.asarray(gaze_rects, np.int64), dev)
        steps = self._steps(bt, rects)
        ch, tbh, tbw = h.channel_count, h.transform_block_h, h.transform_block_w
        if self.width_aligned:
            return idct_display(c, steps, h.frame_h, ch, tbh, tbw)
        return idct_resize_display(c, steps, h.frame_h, h.frame_w, ch, tbh, tbw)

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

        stager = DoubleBufferedStager(self.stage_coeffs) if stage_h2d else None
        staged_meta = None  # (types, rects, n_valid) of the staged batch

        def run(n_valid: int):
            nonlocal staged_meta
            coeffs, types, rects = take_buffers()
            if stager is None:
                yield from dispatch(np.stack(coeffs), types, rects, n_valid)
            elif staged_meta is not None:
                staged = stager.collect()  # batch i-1's transfer
                meta = staged_meta
                stager.submit(coeffs)  # batch i streams H2D...
                staged_meta = (types, rects, n_valid)
                yield from dispatch(staged, *meta)  # ...while i-1 computes
            else:
                stager.submit(coeffs)
                staged_meta = (types, rects, n_valid)

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
            if staged_meta is not None:
                yield from dispatch(stager.collect(), *staged_meta)
            if pending is not None:
                with span(tracer, "device_fetch", frames=pending[1]):
                    frames = fetch(pending)
                yield from frames
        finally:
            if stager is not None:
                stager.close()
