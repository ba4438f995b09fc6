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
* general (width excess): a two-axis resize whose TPU kernel
  (``resize_pallas.resize_rows_pallas``, K6) is not ported yet. It runs in
  plain PyTorch on the CPU; on CUDA the decoder raises
  ``NotImplementedError``.

Every route returns uint8 packed ``(T, H, W*C)`` rows.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from svc_tpu.config import DecoderConfig
from svc_tpu.io import bitstream
from svc_tpu.utils.mathx import round_half_away_from_zero
from svc_tpu_torch.ops.dct import display_bytes, idct_display, idct_planes_plain
from svc_tpu_torch.ops.quant import block_quant_steps
from svc_tpu_torch.ops.resize import resize_bilinear
from svc_tpu_torch.runtime.device import DeviceLike, resolve_device

K6_MESSAGE = (
    "decoding a stream with frame width excess (frame_w {} != padded width "
    "{}) needs the two-axis display resize, whose kernel K6 "
    "(svc_tpu/ops/resize_pallas.py resize_rows_pallas) is not yet ported to "
    "svc_tpu_torch (ROADMAP.md Queue 2, K6); decode it with device='cpu'"
)


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
      device: ``"cuda"`` (kernel K1) or ``"cpu"`` (plain PyTorch).
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        header: bitstream.Header,
        batch_size: int = 8,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg
        self.header = header
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.width_aligned = header.frame_w == header.padded_frame_w
        if not self.width_aligned and self.device.type == "cuda":
            raise NotImplementedError(
                K6_MESSAGE.format(header.frame_w, header.padded_frame_w)
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

    def decode_batch(self, coeffs, block_types, gaze_rects) -> torch.Tensor:
        """Decode one batch to packed ``(T, H, W*C)`` uint8 rows.

        Args:
          coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients.
          block_types: ``(T, nby, nbx)`` wire block types.
          gaze_rects: ``(T, 4)`` padded-space ``(x, y, w, h)`` rects.
        """
        h = self.header
        dev = self.device
        c = torch.as_tensor(coeffs).to(dev, torch.float32)
        bt = torch.as_tensor(np.asarray(block_types, np.int64)).to(dev)
        rects = torch.as_tensor(np.asarray(gaze_rects, np.int64)).to(dev)
        steps = self._steps(bt, rects)
        ch, tbh, tbw = h.channel_count, h.transform_block_h, h.transform_block_w
        if self.width_aligned:
            return idct_display(c, steps, h.frame_h, ch, tbh, tbw)
        planes = idct_planes_plain(c, steps, ch, tbh, tbw)
        return display_bytes(resize_bilinear(planes, h.frame_h, h.frame_w))

    def decode_frames(
        self,
        payloads: Iterator[bytes],
        gazes: Optional[Iterator[Optional[Tuple[int, int]]]] = None,
    ) -> Iterator[np.ndarray]:
        """Decode wire payloads into ``(H, W, C)`` uint8 BGR frames, one
        batch of up to ``batch_size`` payloads at a time."""
        h = self.header
        buf_c: List[np.ndarray] = []
        buf_t: List[np.ndarray] = []
        buf_g: List[Tuple[int, int, int, int]] = []

        def flush() -> Iterator[np.ndarray]:
            out = self.decode_batch(np.stack(buf_c), np.stack(buf_t), buf_g)
            frames = out.cpu().numpy().reshape(len(buf_c), h.frame_h, h.frame_w, -1)
            buf_c.clear()
            buf_t.clear()
            buf_g.clear()
            yield from frames

        for payload in payloads:
            types, coeffs = bitstream.deserialize_frame_blocks(payload, h)
            gaze = next(gazes, None) if gazes is not None else None
            buf_c.append(coeffs.reshape(coeffs.shape[0], coeffs.shape[1], -1))
            buf_t.append(types)
            buf_g.append(self.padded_gaze_rect(gaze))
            if len(buf_c) == self.batch_size:
                yield from flush()
        if buf_c:
            yield from flush()
