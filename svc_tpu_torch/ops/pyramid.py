"""Gaussian image pyramid, bit-exact with OpenCV ``buildPyramid``
(``svc_tpu/ops/pyramid.py``).

``cv::pyrDown`` on 8-bit input: separable 5-tap [1 4 6 4 1] filter in each
dimension (sum 256) in integer arithmetic with BORDER_REFLECT_101, sampled
at even coordinates, descaled by ``(s + 128) >> 8``. Output dims are
``(h + 1) // 2, (w + 1) // 2`` for any input size.

Kernel K4 (``csrc/pyr_down.cu``) computes one level on CUDA tensors;
:func:`pyr_down_plain` is its plain PyTorch version, taken for CPU tensors.
Kernel K8 (``csrc/pyr_down_pitched.cu``, :func:`pyr_down_pitched`) computes
the same level from column-pitched luma subplanes (:func:`to_pitched`).
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

PYR_DOWN_PITCHED = Kernel(
    "pyr_down_pitched",
    "svc_pyr_down_pitched",
    [PTR, PTR, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/pyr_down_pitched.cu",
    replaces="svc_tpu/ops/pyramid_pallas.py:435",
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


def to_pitched(planes: torch.Tensor, tbw: int) -> torch.Tensor:
    """``(N, H, W)`` planes as column-pitched subplanes ``(tbw, N, H,
    W // tbw)``: spatial column ``x`` is lane ``x // tbw`` of subplane
    ``x % tbw`` (svc_tpu's j-split luma layout)."""
    n, h, w = planes.shape
    if w % tbw:
        raise ValueError(f"width {w} is not a multiple of tbw={tbw}")
    return planes.reshape(n, h, w // tbw, tbw).permute(3, 0, 1, 2).contiguous()


def respatialize(y8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_pitched`: ``(tbw, N, H, nbx)`` -> ``(N, H,
    nbx * tbw)``."""
    tbw, n, h, nbx = y8.shape
    return y8.permute(1, 2, 3, 0).reshape(n, h, nbx * tbw)


def _check_pitched_pyr(y8: torch.Tensor) -> None:
    """``pyr_down_mxu_pitched_pallas``'s preconditions (pyramid_pallas.py:
    526-536 and 134-142): uint8 ``(tbw, N, H, nbx)``, whole 8-row blocks,
    an even width of at least 16."""
    if y8.dtype != torch.uint8 or y8.ndim != 4:
        raise TypeError(
            f"pyr_down_pitched: expected (tbw, N, H, W//tbw) uint8, got "
            f"{tuple(y8.shape)} {y8.dtype}"
        )
    tbw, _, h, nbx = y8.shape
    w = tbw * nbx
    if h % 8 or h < 8 or w % 2 or w < 16:
        raise ValueError(
            f"pyr_down_pitched: needs H % 8 == 0 and an even W >= 16 "
            f"(got H={h}, W={w})"
        )


def pyr_down_pitched_plain(y8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8's pyramid level: :func:`pyr_down_plain`
    of the respatialized input."""
    _check_pitched_pyr(y8)
    return pyr_down_plain(respatialize(y8))


def pyr_down_pitched(y8: torch.Tensor) -> torch.Tensor:
    """One pyramid level of column-pitched ``(tbw, N, H, W//tbw)`` uint8
    subplanes, returned as spatial ``(N, H//2, W//2)`` planes — what
    :func:`pyr_down` returns for the respatialized input, bit for bit.

    The preconditions of svc_tpu's ``pyr_down_mxu_pitched_pallas`` hold on
    every device (``H % 8 == 0``, an even ``W >= 16``; ``ValueError``
    outside them). CPU tensors take :func:`pyr_down_pitched_plain`; CUDA
    tensors launch K8.
    """
    if y8.device.type == "cpu":
        return pyr_down_pitched_plain(y8)
    _check_pitched_pyr(y8)
    if y8.device.type != "cuda":
        raise ValueError(f"pyr_down_pitched: unsupported device {y8.device}")
    x = y8.contiguous()
    tbw, n, h, nbx = x.shape
    out = torch.empty((n, h // 2, tbw * nbx // 2), dtype=torch.uint8,
                      device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        PYR_DOWN_PITCHED.launch(
            x.data_ptr(), out.data_ptr(), tbw, n, h, nbx, stream_handle(x)
        )
    return out
