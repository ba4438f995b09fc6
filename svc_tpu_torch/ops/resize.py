"""Bilinear display resize (``svc_tpu/ops/resize.py``).

The decoder scales the padded reconstruction to the original frame size
with OpenCV INTER_LINEAR's center-aligned mapping
``src = (dst + 0.5) * in / out - 0.5`` and edge clamping
(libs/decoder.cpp:210). The width-aligned routes only resample rows, inside
kernel K1 (``ops.dct.idct_display``); the general route (width excess)
resamples both axes here, in plain PyTorch — its TPU kernel
(``resize_pallas.resize_rows_pallas``, K6) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bilinear_axis_weights(
    out_n: int, in_n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Center-aligned bilinear source indices/fractions for one axis.

    Returns ``(i0, i1, frac, identity)`` as host numpy; ``identity`` is True
    when every fraction is exactly zero. (A copy of
    ``svc_tpu.ops.resize.bilinear_axis_weights``, whose module imports JAX.)
    """
    src = (np.arange(out_n) + 0.5) * in_n / out_n - 0.5
    i0 = np.floor(src).astype(np.int32)
    frac = (src - i0).astype(np.float32)
    frac = np.where(i0 < 0, 0.0, frac)
    frac = np.where(i0 >= in_n - 1, 0.0, frac).astype(np.float32)
    i0 = np.clip(i0, 0, in_n - 1)
    i1 = np.clip(i0 + 1, 0, in_n - 1)
    return i0, i1, frac, bool((frac == 0).all())


def _blend(img, axis, out_n):
    i0, i1, frac, ident = bilinear_axis_weights(out_n, img.shape[axis])
    dev = img.device
    a = img.index_select(axis, torch.as_tensor(i0, dtype=torch.int64, device=dev))
    if ident:
        return a
    b = img.index_select(axis, torch.as_tensor(i1, dtype=torch.int64, device=dev))
    shape = [1] * img.ndim
    shape[axis] = out_n
    f = torch.as_tensor(frac, device=dev).reshape(shape)
    return a * (1 - f) + b * f


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of float ``(..., H, W)`` planes: rows, then columns."""
    return _blend(_blend(img, img.ndim - 2, out_h), img.ndim - 1, out_w)
