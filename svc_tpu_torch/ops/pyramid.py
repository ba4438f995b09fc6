"""Gaussian image pyramid, bit-exact with OpenCV ``buildPyramid``
(``svc_tpu/ops/pyramid.py``).

``cv::pyrDown`` on 8-bit input: separable 5-tap [1 4 6 4 1] filter in each
dimension (sum 256) in integer arithmetic with BORDER_REFLECT_101, sampled
at even coordinates, descaled by ``(s + 128) >> 8``. Output dims are
``(h + 1) // 2, (w + 1) // 2`` for any input size.

Kernel K4 (``csrc/pyr_down.cu``) computes one level on CUDA tensors;
:func:`pyr_down_plain` is its plain PyTorch version, taken for CPU tensors.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from svc_tpu_torch.kernels.build import INT, PTR, Kernel, stream_handle

_TAPS = (1, 4, 6, 4, 1)

PYR_DOWN = Kernel(
    "pyr_down_u8",
    "svc_pyr_down_u8",
    [PTR, PTR, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/pyr_down.cu",
    replaces="svc_tpu/ops/pyramid_pallas.py:271",
)


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of ``[-pad, n + pad)`` under BORDER_REFLECT_101."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    while ((idx < 0) | (idx >= n)).any():
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= n, 2 * n - 2 - idx, idx)
    return idx


def pyr_down_plain(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level of a ``(..., H, W)`` uint8 tensor, plain PyTorch."""
    h, w = img.shape[-2], img.shape[-1]
    out_h, out_w = (h + 1) // 2, (w + 1) // 2
    dev = img.device
    cols = torch.as_tensor(_reflect101(w, 2), device=dev)
    rows = torch.as_tensor(_reflect101(h, 2), device=dev)
    x = img.to(torch.int32).index_select(-1, cols)
    x = sum(_TAPS[k] * x[..., :, k : k + 2 * out_w : 2] for k in range(5))
    x = x.index_select(-2, rows)
    x = sum(_TAPS[k] * x[..., k : k + 2 * out_h : 2, :] for k in range(5))
    return ((x + 128) >> 8).to(torch.uint8)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level of a ``(..., H, W)`` uint8 tensor.

    CPU tensors take :func:`pyr_down_plain`; CUDA tensors launch K4.
    """
    if img.device.type == "cpu":
        return pyr_down_plain(img)
    if img.device.type != "cuda":
        raise ValueError(f"pyr_down: unsupported device {img.device}")
    if img.dtype != torch.uint8 or img.ndim < 2:
        raise TypeError(
            f"pyr_down: expected a (..., H, W) uint8 tensor, got "
            f"{tuple(img.shape)} {img.dtype}"
        )
    x = img.contiguous()
    h, w = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    out = torch.empty(
        lead + ((h + 1) // 2, (w + 1) // 2), dtype=torch.uint8, device=x.device
    )
    n = math.prod(lead)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        PYR_DOWN.launch(
            x.data_ptr(), out.data_ptr(), n, h, w, stream_handle(x)
        )
    return out


def build_pyramid(img: torch.Tensor, level_count: int) -> List[torch.Tensor]:
    """Levels 0..level_count-1; level 0 is the input itself."""
    levels = [img]
    for _ in range(level_count - 1):
        levels.append(pyr_down(levels[-1]))
    return levels
