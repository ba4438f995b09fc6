"""Blockwise 2-D DCT-II / DCT-III in the bitstream's wire layout
(``svc_tpu/ops/dct.py``, ``svc_tpu/ops/dct_pallas.py``).

``cv::dct`` is the orthonormal type-II DCT, so per block

    Z = D_h @ X @ D_w^T      (forward, encoder)
    X = D_h^T @ Z @ D_w      (inverse, decoder)

with ``D_n[k, j] = s_k cos(pi (2j + 1) k / 2n)``. The wire layout is
``(T, nby, nbx, C*bh*bw)``: each transform block's channel-major
coefficient rows are contiguous, so (de)serialization is a memcpy.

Two kernels live here, each beside its plain PyTorch version:

* K2 :func:`dct8x8_to_wire` (``csrc/dct_wire.cu``) — forward DCT straight
  from the packed ``(N, H, W*C)`` uint8 rows the host ships;
* K1 :func:`idct_display` (``csrc/idct_display.cu``) — the decoder's
  dequantize + inverse DCT + row resample + round/clip + interleave, to
  packed ``(T, H, W*C)`` display bytes.

The plain versions set ``allow_tf32 = False`` for matmuls and cuDNN: TF32
keeps ~3 decimal digits, far outside the 2.5e-4 coefficient gate. The
forward one computes in float64 and rounds once, so it is a reference
within half an ulp of the exact transform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svc_tpu_torch.kernels.build import INT, PTR, Kernel, stream_handle
from svc_tpu_torch.ops.quant import dequantize
from svc_tpu_torch.ops.resize import bilinear_axis_weights

DCT_WIRE = Kernel(
    "dct8x8_to_wire",
    "svc_dct8x8_to_wire",
    [PTR, PTR, PTR, PTR] + [INT] * 10 + [PTR],
    source="svc_tpu_torch/csrc/dct_wire.cu",
    replaces="svc_tpu/ops/dct_pallas.py:347",
)
IDCT_DISPLAY = Kernel(
    "idct_display",
    "svc_idct_display",
    [PTR] * 9 + [INT] * 10 + [PTR],
    source="svc_tpu_torch/csrc/idct_display.cu",
    replaces="svc_tpu/ops/dct_pallas.py:1077",
)

_SMEM_BYTES = 48 * 1024  # dynamic shared memory without the opt-in
_MAX_STRIP_BLOCKS = 16


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, float32 (``svc_tpu.ops.dct.dct_matrix``)."""
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float32)


def _matrix(n: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(dct_matrix(n), dtype=dtype, device=device)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# K2: forward DCT, packed rows -> wire
# ---------------------------------------------------------------------------


def dct8x8_to_wire_plain(
    packed: torch.Tensor,
    frame_offset: int,
    t_count: int,
    padded_h: int,
    padded_w: int,
    block_h: int,
    block_w: int,
    channels: int = 3,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (same contract as :func:`dct8x8_to_wire`)."""
    _no_tf32()
    n, h, wc = packed.shape
    w = wc // channels
    frames = packed[frame_offset : frame_offset + t_count]
    x = frames.reshape(t_count, h, w, channels).to(torch.float64)
    x = torch.nn.functional.pad(x, (0, 0, 0, padded_w - w, 0, padded_h - h))
    nby, nbx = padded_h // block_h, padded_w // block_w
    blocks = x.reshape(t_count, nby, block_h, nbx, block_w, channels).permute(
        0, 1, 3, 5, 2, 4
    )  # (T, nby, nbx, C, bh, bw)
    dh = _matrix(block_h, packed.device, torch.float64)
    dw = _matrix(block_w, packed.device, torch.float64)
    z = torch.matmul(torch.matmul(dh, blocks), dw.T)
    return z.to(torch.float32).reshape(t_count, nby, nbx, -1)


def dct8x8_to_wire(
    packed: torch.Tensor,
    frame_offset: int,
    t_count: int,
    padded_h: int,
    padded_w: int,
    block_h: int = 8,
    block_w: int = 8,
    channels: int = 3,
) -> torch.Tensor:
    """Forward blockwise DCT of packed frames into wire layout (kernel K2).

    Args:
      packed: ``(N, H, W*C)`` uint8 interleaved rows; frames
        ``[frame_offset, frame_offset + t_count)`` are transformed. Pixels
        past ``H`` / ``W`` (up to ``padded_h`` / ``padded_w``) are zero.

    Returns ``(t_count, nby, nbx, C*bh*bw)`` float32.
    """
    if packed.device.type == "cpu":
        return dct8x8_to_wire_plain(
            packed, frame_offset, t_count, padded_h, padded_w,
            block_h, block_w, channels,
        )
    _check_cuda("dct8x8_to_wire", packed)
    if packed.dtype != torch.uint8 or packed.ndim != 3:
        raise TypeError("dct8x8_to_wire: packed must be (N, H, W*C) uint8")
    n, h, wc = packed.shape
    if wc % channels or frame_offset + t_count > n:
        raise ValueError("dct8x8_to_wire: frame range or channels mismatch")
    w = wc // channels
    if padded_h % block_h or padded_w % block_w or padded_h < h or padded_w < w:
        raise ValueError("dct8x8_to_wire: padded dims must cover the frame "
                         "and be block multiples")
    nby, nbx = padded_h // block_h, padded_w // block_w
    cn = channels * block_h * block_w
    nb = min(_MAX_STRIP_BLOCKS, _SMEM_BYTES // (cn * (4 + 8)))
    if nb < 1:
        raise ValueError(f"dct8x8_to_wire: {block_h}x{block_w} blocks of "
                         f"{channels} channels exceed shared memory")
    p = packed.contiguous()
    dh = _matrix(block_h, p.device)
    dw = _matrix(block_w, p.device)
    out = torch.empty((t_count, nby, nbx, cn), dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(p.device):
        DCT_WIRE.launch(
            p.data_ptr(), dh.data_ptr(), dw.data_ptr(), out.data_ptr(),
            t_count, frame_offset, h, w, channels, nby, nbx,
            block_h, block_w, nb, stream_handle(p),
        )
    return out


# ---------------------------------------------------------------------------
# K1: dequantize + inverse DCT + row resample + display bytes
# ---------------------------------------------------------------------------


def idct_planes_plain(
    coeffs: torch.Tensor, steps: torch.Tensor, channels: int,
    block_h: int, block_w: int,
) -> torch.Tensor:
    """Dequantized inverse DCT of wire coefficients into float32
    ``(T, C, PH, PW)`` planes (the first half of K1's plain version)."""
    _no_tf32()
    t, nby, nbx, _ = coeffs.shape
    q = dequantize(coeffs, steps[..., None])
    blocks = q.reshape(t, nby, nbx, channels, block_h, block_w)
    dh = _matrix(block_h, coeffs.device)
    dw = _matrix(block_w, coeffs.device)
    x = torch.matmul(torch.matmul(dh.T, blocks), dw)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(
        t, channels, nby * block_h, nbx * block_w
    )


def display_bytes(planes: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip, uint8, interleave: ``(T, C, H, W)`` float
    planes -> packed ``(T, H, W*C)`` display rows."""
    u8 = torch.clamp(torch.round(planes), 0, 255).to(torch.uint8)
    t, c, h, w = u8.shape
    return u8.permute(0, 2, 3, 1).reshape(t, h, w * c)


def idct_display_plain(
    coeffs: torch.Tensor, steps: torch.Tensor, out_h: int, channels: int,
    block_h: int, block_w: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same contract as :func:`idct_display`)."""
    planes = idct_planes_plain(coeffs, steps, channels, block_h, block_w)
    y0, y1, fy, ident = bilinear_axis_weights(out_h, planes.shape[2])
    dev = planes.device
    top = planes[:, :, torch.as_tensor(y0, dtype=torch.int64, device=dev)]
    if not ident:
        bot = planes[:, :, torch.as_tensor(y1, dtype=torch.int64, device=dev)]
        f = torch.as_tensor(fy, device=dev)[:, None]
        top = top * (1 - f) + bot * f
    return display_bytes(top)


@functools.lru_cache(maxsize=64)
def _display_tables(out_h: int, in_h: int, block_h: int, band_rows: int):
    """Row tables and per-band source block rows for K1 (host numpy)."""
    y0, y1, fy, _ = bilinear_axis_weights(out_h, in_h)
    n_bands = -(-out_h // band_rows)
    first = np.arange(n_bands) * band_rows
    last = np.minimum(first + band_rows, out_h) - 1
    br0 = (y0[first] // block_h).astype(np.int32)
    # y0 and y1 are non-decreasing, so a band's sources span
    # [y0[first], y1[last]]
    nbr = int((y1[last] // block_h - br0).max()) + 1
    return y0, y1, fy, br0, nbr


def idct_display(
    coeffs: torch.Tensor,
    steps: torch.Tensor,
    out_h: int,
    channels: int = 3,
    block_h: int = 8,
    block_w: int = 8,
) -> torch.Tensor:
    """Dequantize + inverse DCT + bilinear row resample to ``out_h`` rows +
    display round/clip, as packed bytes (kernel K1).

    Args:
      coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients.
      steps: ``(T, nby, nbx)`` float32 per-block quantization steps (> 0).
      out_h: display height (``<= nby*bh``; equal = identity rows).

    Returns ``(T, out_h, nbx*bw*C)`` uint8 — the width is not resampled
    (the width-aligned display routes).
    """
    if coeffs.device.type == "cpu":
        return idct_display_plain(coeffs, steps, out_h, channels, block_h, block_w)
    _check_cuda("idct_display", coeffs)
    t, nby, nbx, cn = coeffs.shape
    if coeffs.dtype != torch.float32 or cn != channels * block_h * block_w:
        raise TypeError("idct_display: coeffs must be (T, nby, nbx, C*bh*bw) "
                        "float32")
    if steps.dtype != torch.float32 or tuple(steps.shape) != (t, nby, nbx):
        raise TypeError("idct_display: steps must be (T, nby, nbx) float32")
    if steps.device != coeffs.device:
        raise ValueError("idct_display: coeffs and steps on different devices")
    band_rows = 2 * block_h
    y0, y1, fy, br0, nbr = _display_tables(out_h, nby * block_h, block_h, band_rows)
    nb = min(_MAX_STRIP_BLOCKS, _SMEM_BYTES // (2 * nbr * cn * 4))
    if nb < 1:
        raise ValueError(
            f"idct_display: a {band_rows}-row band needs {nbr} source block "
            "rows, more than shared memory holds"
        )
    dev = coeffs.device
    c = coeffs.contiguous()
    s = steps.contiguous()
    dh = _matrix(block_h, dev)
    dw = _matrix(block_w, dev)
    tab_y0 = torch.as_tensor(y0, dtype=torch.int32, device=dev)
    tab_y1 = torch.as_tensor(y1, dtype=torch.int32, device=dev)
    tab_fy = torch.as_tensor(fy, dtype=torch.float32, device=dev)
    tab_br0 = torch.as_tensor(br0, dtype=torch.int32, device=dev)
    out = torch.empty(
        (t, out_h, nbx * block_w * channels), dtype=torch.uint8, device=dev
    )
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        IDCT_DISPLAY.launch(
            c.data_ptr(), s.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            tab_y0.data_ptr(), tab_y1.data_ptr(), tab_fy.data_ptr(),
            tab_br0.data_ptr(), out.data_ptr(),
            t, out_h, nby, nbx, channels, block_h, block_w, band_rows, nbr,
            nb, stream_handle(c),
        )
    return out
