"""Blockwise 2-D DCT-II / DCT-III in the bitstream's wire layout
(``svc_tpu/ops/dct.py``, ``svc_tpu/ops/dct_pallas.py``).

``cv::dct`` is the orthonormal type-II DCT, so per block

    Z = D_h @ X @ D_w^T      (forward, encoder)
    X = D_h^T @ Z @ D_w      (inverse, decoder)

with ``D_n[k, j] = s_k cos(pi (2j + 1) k / 2n)``. The wire layout is
``(T, nby, nbx, C*bh*bw)``: each transform block's channel-major
coefficient rows are contiguous, so (de)serialization is a memcpy.

Three wrappers live here, each beside its plain PyTorch version:

* K2 :func:`dct8x8_to_wire` — forward DCT straight from the packed
  ``(N, H, W*C)`` uint8 rows the host ships;
* K1 :func:`idct_display` — the decoder's dequantize + inverse DCT + row
  resample + round/clip + interleave, to packed ``(T, H, W*C)`` display
  bytes (the width-aligned routes);
* K6 :func:`idct_resize_display` — the same with both axes resampled (the
  general route: frame width excess).

Each dispatches by shape: 8x8 blocks of 3 channels (the codec's default)
go to a kernel specialised for them (``csrc/dct_wire.cu``,
``csrc/idct_display.cu``, ``csrc/idct_resize.cu``); the other transform
blocks users pick, of 3 channels, go to one kernel template each,
instantiated per block shape at every (rows, columns) in {1, 2, 4, 8,
16}^2 but 8x8 (``csrc/dct_wire_sq.cu``, ``csrc/idct_display_sq.cu``,
``csrc/idct_resize_sq.cu``); every other block shape or channel count
(K6 also upsampled columns) goes to the general kernel
(``csrc/dct_wire_general.cu``, ``csrc/idct_display_general.cu``,
``csrc/idct_resize_general.cu``). All give the general kernel's bits.
No call copies from host memory once its geometry is cached: tables and
DCT matrices are copied to the device once per (device, geometry) or
travel by value, so every wrapper can be captured in a CUDA graph.

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
from svc_tpu_torch.ops.resize import bilinear_axis_weights, resize_bilinear

DCT_WIRE = Kernel(
    "dct8x8_to_wire",
    "svc_dct8x8_to_wire",
    [PTR] * 3 + [INT] * 6 + [PTR],
    source="svc_tpu_torch/csrc/dct_wire.cu",
    replaces="svc_tpu/ops/dct_pallas.py:347",
)
DCT_WIRE_GENERAL = Kernel(
    "dct_to_wire_general",
    "svc_dct_to_wire_general",
    [PTR] * 4 + [INT] * 10 + [PTR],
    source="svc_tpu_torch/csrc/dct_wire_general.cu",
    replaces="svc_tpu/ops/dct_pallas.py:282",
)
IDCT_DISPLAY = Kernel(
    "idct_display",
    "svc_idct_display",
    [PTR] * 9 + [INT] * 6 + [PTR],
    source="svc_tpu_torch/csrc/idct_display.cu",
    replaces="svc_tpu/ops/dct_pallas.py:1077",
)
IDCT_DISPLAY_GENERAL = Kernel(
    "idct_display_general",
    "svc_idct_display_general",
    [PTR] * 9 + [INT] * 10 + [PTR],
    source="svc_tpu_torch/csrc/idct_display_general.cu",
    replaces="svc_tpu/ops/dct_pallas.py:692",
)
# K2, K1 and K6 for blocks of 3 channels of (rows, columns) in {1, 2, 4,
# 8, 16}^2 other than 8x8: one kernel template each, an instantiation (and
# a launch count) per block shape, named rows first; the squares and
# rectangles of sides 4, 8 and 16, then 2x2 and the blocks with a side of
# 2 and the other in {4, 8, 16}, then 1x1 and the blocks with a side of 1
# and the other in {2, 4, 8, 16}
_SQ_SHAPES = ((4, 4), (16, 16), (4, 8), (8, 4), (4, 16), (16, 4), (8, 16),
              (16, 8))
_THIN_SHAPES = ((2, 2), (2, 4), (4, 2), (2, 8), (8, 2), (2, 16), (16, 2))
_SIDE_1_SHAPES = ((1, 1), (1, 2), (2, 1), (1, 4), (4, 1), (1, 8), (8, 1),
                  (1, 16), (16, 1))
_TEMPLATED_SHAPES = _SQ_SHAPES + _THIN_SHAPES + _SIDE_1_SHAPES
DCT_WIRE_SQ = {
    (bh, bw): Kernel(
        f"dct{bh}x{bw}_to_wire",
        f"svc_dct{bh}x{bw}_to_wire",
        [PTR] * 4 + [INT] * 6 + [PTR],
        source="svc_tpu_torch/csrc/dct_wire_sq.cu",
        replaces="svc_tpu/ops/dct_pallas.py:282",
    )
    for bh, bw in _TEMPLATED_SHAPES
}
IDCT_DISPLAY_SQ = {
    (bh, bw): Kernel(
        f"idct{bh}x{bw}_display",
        f"svc_idct{bh}x{bw}_display",
        [PTR] * 10 + [INT] * 6 + [PTR],
        source="svc_tpu_torch/csrc/idct_display_sq.cu",
        replaces="svc_tpu/ops/dct_pallas.py:692",
    )
    for bh, bw in _TEMPLATED_SHAPES
}
IDCT_RESIZE = Kernel(
    "idct_resize_display",
    "svc_idct_resize_display",
    [PTR] * 12 + [INT] * 7 + [PTR],
    source="svc_tpu_torch/csrc/idct_resize.cu",
    replaces="svc_tpu/ops/resize_pallas.py:96",
)
IDCT_RESIZE_SQ = {
    (bh, bw): Kernel(
        f"idct{bh}x{bw}_resize_display",
        f"svc_idct{bh}x{bw}_resize_display",
        [PTR] * 13 + [INT] * 7 + [PTR],
        source="svc_tpu_torch/csrc/idct_resize_sq.cu",
        replaces="svc_tpu/ops/resize_pallas.py:96",
    )
    for bh, bw in _TEMPLATED_SHAPES
}
IDCT_RESIZE_GENERAL = Kernel(
    "idct_resize_display_general",
    "svc_idct_resize_display_general",
    [PTR] * 13 + [INT] * 12 + [PTR],
    source="svc_tpu_torch/csrc/idct_resize_general.cu",
    replaces="svc_tpu/ops/resize_pallas.py:96",
)

_SMEM_BYTES = 48 * 1024  # dynamic shared memory without the opt-in
_MAX_STRIP_BLOCKS = 16
# the shape the specialised kernels take: (block_h, block_w, channels)
_SPECIALISED = (8, 8, 3)
# K1's specialised kernel (csrc/idct_display.cu): 8 block columns per CTA;
# 37,184 bytes of shared memory (two coefficient slots of 24 x 104 floats,
# a 16-row pixel ring of 244 floats a row, two step slots of 8, three
# tables of up to 128 output rows), so 6 CTAs fit an SM's 228 KB
_K1_STRIP = 8
_K1_SMEM_BYTES = (2 * 24 * 104 + 16 * 244 + 2 * 8 + 3 * 128) * 4
_K1_CTAS_PER_SM = 6
_K1_BAND_ROWS = (128, 64, 32, 16, 8)
# K6's specialised kernel (csrc/idct_resize.cu): K1's band walk over strips
# of 8 block columns plus one halo block column, a thread per byte of a
# strip's run of at most 192 display-row bytes; 38,152 bytes of shared
# memory (two coefficient slots of 27 x 104 floats, a 16-row pixel ring of
# 220 floats a row, two step slots of 9, three tables of up to 128 output
# rows), so 5 CTAs fit an SM
_K6_STRIP = 8
_K6_STRIP_BYTES = _K6_STRIP * 8 * 3
_K6_SMEM_BYTES = (2 * 27 * 104 + 16 * 220 + 2 * 9 + 3 * 128) * 4
_K6_CTAS_PER_SM = 5
# K2's templated kernels (csrc/dct_wire_sq.cu): a strip of 128 pixels
# (128 / BW blocks), 384 threads; per (BH, BW) stage 1's doubles padded to
# (row stride, pair stride) and the block rows a CTA takes (a step: 8 / BH
# where a side is 1 or 2, one at 16x2 and 16x1), then the step's packed
# rows
_K2_SQ_STRIP_PIXELS = 128
_K2_SQ_GEOM = {(4, 4): (5, 20, 1), (16, 16): (17, 272, 1), (4, 8): (9, 40, 1),
               (8, 4): (5, 44, 1), (4, 16): (17, 68, 1), (16, 4): (5, 84, 1),
               (8, 16): (17, 136, 1), (16, 8): (9, 152, 1),
               (2, 2): (3, 26, 4), (2, 4): (5, 44, 4), (4, 2): (3, 26, 2),
               (2, 8): (9, 72, 4), (8, 2): (3, 26, 1), (2, 16): (17, 136, 4),
               (16, 2): (3, 50, 1),
               (1, 1): (1, 9, 8), (1, 2): (3, 26, 8), (2, 1): (1, 9, 4),
               (1, 4): (5, 44, 8), (4, 1): (1, 9, 2), (1, 8): (9, 72, 8),
               (8, 1): (1, 9, 1), (1, 16): (17, 136, 8), (16, 1): (1, 17, 1)}
# K1's templated kernels (csrc/idct_display_sq.cu): a strip of 64 pixels
# (64 / BW block columns), 192 threads; per (BH, BW) the coefficient
# slot's (row stride, pair stride) in floats, the CTAs an SM holds and the
# block rows a walk step takes; two slots, a ring of two steps' pixel rows
# of 244 floats, two steps' step slots, three tables of up to 128 output
# rows
_K1_SQ_STRIP_PIXELS = 64
_K1_SQ_GEOM = {(4, 4): (8, 36, 6, 1), (16, 16): (20, 336, 3, 1),
               (4, 8): (8, 40, 6, 1), (8, 4): (8, 68, 5, 1),
               (4, 16): (20, 80, 6, 1), (16, 4): (4, 68, 3, 1),
               (8, 16): (20, 176, 4, 1), (16, 8): (12, 200, 3, 1),
               (2, 2): (2, 20, 6, 4), (2, 4): (8, 68, 5, 4),
               (4, 2): (2, 20, 6, 2), (2, 8): (12, 104, 6, 4),
               (8, 2): (2, 20, 6, 1), (2, 16): (20, 176, 6, 4),
               (16, 2): (2, 36, 3, 1),
               (1, 1): (1, 9, 6, 8), (1, 2): (2, 20, 6, 8),
               (2, 1): (1, 12, 6, 4), (1, 4): (8, 68, 5, 8),
               (4, 1): (1, 12, 6, 2), (1, 8): (12, 104, 6, 8),
               (8, 1): (1, 12, 6, 1), (1, 16): (20, 176, 6, 8),
               (16, 1): (1, 20, 3, 1)}
# K6's templated kernels (csrc/idct_resize_sq.cu): a strip of 64 pixels
# (64 / BW block columns) plus one halo block column, a thread per byte of
# a strip's run of at most 192 display-row bytes, K1's walk steps; per
# (BH, BW) the coefficient slot's (row stride, pair stride) in floats
# (K1's, but at 16x1), the halo's pixel columns the ring keeps, the ring's
# row pitch in floats, the threads and the CTAs an SM holds; two slots
# (each rounded up to 16 bytes) and their steps, a ring of a step's pixel
# rows and one more, three tables of up to 128 output rows
_K6_SQ_STRIP_PIXELS = 64
_K6_SQ_GEOM = {(4, 4): (8, 36, 4, 206, 224, 6),
               (16, 16): (20, 336, 1, 198, 256, 4),
               (4, 8): (8, 40, 8, 218, 256, 6), (8, 4): (8, 68, 4, 206, 224, 6),
               (4, 16): (20, 80, 1, 196, 256, 5),
               (16, 4): (4, 68, 4, 206, 224, 4),
               (8, 16): (20, 176, 1, 198, 256, 4),
               (16, 8): (12, 200, 8, 218, 224, 3),
               (2, 2): (2, 20, 2, 198, 224, 6), (2, 4): (8, 68, 4, 206, 224, 6),
               (4, 2): (2, 20, 2, 198, 224, 6), (2, 8): (12, 104, 8, 218, 224, 6),
               (8, 2): (2, 20, 2, 198, 224, 6),
               (2, 16): (20, 176, 1, 198, 256, 4),
               (16, 2): (2, 36, 2, 198, 224, 4),
               (1, 1): (1, 9, 1, 196, 224, 6), (1, 2): (2, 20, 2, 198, 224, 6),
               (2, 1): (1, 12, 1, 196, 224, 6), (1, 4): (8, 68, 4, 206, 224, 6),
               (4, 1): (1, 12, 1, 196, 224, 6), (1, 8): (12, 104, 8, 218, 224, 5),
               (8, 1): (1, 12, 1, 196, 224, 6),
               (1, 16): (20, 176, 1, 198, 256, 4),
               (16, 1): (1, 16, 1, 196, 224, 5)}


def _k2_sq_smem_bytes(block_h: int, block_w: int) -> int:
    """Dynamic shared memory of K2's kernel for ``block_h`` x ``block_w``:
    the pairs' padded A, then the packed strip rows of a CTA's block
    rows."""
    groups = _K2_SQ_STRIP_PIXELS // block_w * 3
    _, group, step = _K2_SQ_GEOM[block_h, block_w]
    return groups * group * 8 + step * block_h * _K2_SQ_STRIP_PIXELS * 3


def _k1_sq_step_rows(block_h: int, block_w: int) -> int:
    """The pixel rows of a walk step of K1's kernel for ``block_h`` x
    ``block_w`` (its tables count rows in steps)."""
    return block_h * _K1_SQ_GEOM[block_h, block_w][3]


def _k1_sq_smem_bytes(block_h: int, block_w: int) -> int:
    """Dynamic shared memory of K1's kernel for ``block_h`` x ``block_w``:
    the strip (in block columns) counts ``block_w``, the ring's pixel rows
    two steps."""
    strip = _K1_SQ_STRIP_PIXELS // block_w
    _, group, _, step = _K1_SQ_GEOM[block_h, block_w]
    return 4 * (2 * strip * 3 * group
                + 2 * _k1_sq_step_rows(block_h, block_w) * 244
                + 2 * step * strip + 3 * max(_K1_BAND_ROWS))


def _k6_sq_smem_bytes(block_h: int, block_w: int) -> int:
    """Dynamic shared memory of K6's kernel for ``block_h`` x ``block_w``:
    the strip (in block columns) counts ``block_w``, the ring's pixel rows
    a walk step's (K1's, :func:`_k1_sq_step_rows`) and one more."""
    _, group, _, ring_pitch, _, _ = _K6_SQ_GEOM[block_h, block_w]
    blocks = _K6_SQ_STRIP_PIXELS // block_w + 1
    step_rows = _k1_sq_step_rows(block_h, block_w)
    slot = -(-blocks * 3 * group // 4) * 4
    return 4 * (2 * (slot + step_rows // block_h * blocks)
                + (step_rows + 1) * ring_pitch + 3 * max(_K1_BAND_ROWS))


def _specialised(block_h: int, block_w: int, channels: int) -> bool:
    return (block_h, block_w, channels) == _SPECIALISED


def _templated(block_h: int, block_w: int, channels: int) -> bool:
    """Blocks of 3 channels with both sides in {1, 2, 4, 8, 16}, but
    8x8: K2's, K1's and K6's templated kernels."""
    return (block_h, block_w) in DCT_WIRE_SQ and channels == 3


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix, float32 (``svc_tpu.ops.dct.dct_matrix``)
    unless ``dtype`` says otherwise."""
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(dtype)


def _matrix(n: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(dct_matrix(n), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _matrix_on(dev, n: int) -> torch.Tensor:
    """The float32 DCT matrix on ``dev`` for the general kernels, copied
    once per device (a copy from pageable host memory on every call would
    stall the stream and keep the wrapper out of a CUDA graph)."""
    return _matrix(n, dev)


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
    *,
    general: bool = False,
) -> torch.Tensor:
    """Forward blockwise DCT of packed frames into wire layout (kernel K2:
    the specialised kernel for 8x8 blocks of 3 channels, the templated
    kernel for the other blocks of 3 channels with both sides in {1, 2,
    4, 8, 16}, the general one otherwise: other sides, other channel
    counts).

    Args:
      packed: ``(N, H, W*C)`` uint8 interleaved rows; frames
        ``[frame_offset, frame_offset + t_count)`` are transformed. Pixels
        past ``H`` / ``W`` (up to ``padded_h`` / ``padded_w``) are zero.
      general: launch the general kernel whatever the shape (the yardstick
        the specialised and templated ones are held and timed against).

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
    out = torch.empty((t_count, nby, nbx, cn), dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(p.device):
        # host matrices, passed by value
        if _specialised(block_h, block_w, channels) and not general:
            DCT_WIRE.launch(
                p.data_ptr(), dct_matrix(8).ctypes.data, out.data_ptr(),
                t_count, frame_offset, h, w, nby, nbx, stream_handle(p),
            )
        elif _templated(block_h, block_w, channels) and not general:
            DCT_WIRE_SQ[block_h, block_w].launch(
                p.data_ptr(), dct_matrix(block_h).ctypes.data,
                dct_matrix(block_w).ctypes.data, out.data_ptr(),
                t_count, frame_offset, h, w, nby, nbx, stream_handle(p),
            )
        else:
            dh = _matrix_on(p.device, block_h)
            dw = _matrix_on(p.device, block_w)
            DCT_WIRE_GENERAL.launch(
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
def _span_tables(out_n: int, in_n: int, block: int, tile: int):
    """One axis of a display kernel's geometry (host numpy): the bilinear
    ``(i0, i1, frac)``, each tile's first source block (a tile is ``tile``
    consecutive outputs) and the most source blocks any tile reads. A
    second source ``i1`` counts only where its weight is not zero, as the
    kernels read it only there."""
    i0, i1, frac, _ = bilinear_axis_weights(out_n, in_n)
    starts = np.arange(0, out_n, tile)
    first = (i0[starts] // block).astype(np.int32)
    # i0 and i1 are non-decreasing, so a tile reads [i0[start], max read]
    last = np.maximum.reduceat(np.where(frac != 0, i1, i0), starts) // block
    return i0, i1, frac, first, int((last - first).max()) + 1


# The device tables below are cached for the life of the process, never
# evicted: a CUDA graph that captured a display kernel holds their raw
# pointers, and an evicted (freed) table would be read by its replays. A
# geometry's tables take O(out_h + out_w) words, and a process sees few.


@functools.lru_cache(maxsize=None)
def _span_tables_on(dev, out_n: int, in_n: int, block: int, tile: int):
    """:func:`_span_tables` for the general display kernels on ``dev``:
    ``(i0, i1, frac, first)`` as device tensors, copied once per geometry,
    and the most source blocks a tile reads."""
    i0, i1, frac, first, n_blk = _span_tables(out_n, in_n, block, tile)
    return [_int32(i0, dev), _int32(i1, dev), _float32(frac, dev),
            _int32(first, dev)], n_blk


@functools.lru_cache(maxsize=64)
def _band_tables(out_h: int, in_h: int, nbx: int, t: int, sm_count: int,
                 ctas_per_sm: int = _K1_CTAS_PER_SM, block: int = 8,
                 strip: int = _K1_STRIP):
    """The row geometry of the specialised display kernels K1 and K6 and of
    K1's and K6's templated kernels (host numpy), which walk
    each band of output rows down its source block rows of ``block`` pixel
    rows (the block height; K1's templated kernel walks steps of several
    block rows where a side is 1 or 2, and ``block`` is a step's pixel
    rows),
    a strip of ``strip`` block columns per CTA.

    Returns ``(y0, y1, fy, row_lo, band_b, band_rows)``: the bilinear
    ``(y0, y1, fy)`` per output row; ``row_lo[b]`` (``b`` in ``[0,
    ceil(in_h / block)]``) the first output row whose last source row
    (``y1`` where its weight is not zero, else ``y0``) lies in block row
    ``b`` or later — the kernel emits rows ``[row_lo[b], row_lo[b + 1])``
    once block row ``b`` is transformed; ``band_b`` ``(n_bands, 2)`` each
    band's first block row (that of its first ``y0``) and last (that of
    its last row's last source row); ``band_rows`` the tallest of 128,
    64, ..., 8 output rows that still gives two waves of CTAs
    (``ctas_per_sm`` per SM) on ``sm_count`` SMs, else 8.
    """
    y0, y1, fy, _ = bilinear_axis_weights(out_h, in_h)
    hi = np.where(fy != 0, y1, y0)  # non-decreasing, y0 <= hi <= y0 + 1
    # a last block row past in_h (a walk step of several block rows) ends
    # the frame
    row_lo = np.searchsorted(hi // block,
                             np.arange(-(-in_h // block) + 1)).astype(np.int32)
    strips = -(-nbx // strip)
    for band_rows in _K1_BAND_ROWS:
        if t * strips * -(-out_h // band_rows) >= 2 * ctas_per_sm * sm_count:
            break
    starts = np.arange(0, out_h, band_rows)
    ends = np.minimum(starts + band_rows, out_h) - 1
    band_b = np.stack([y0[starts] // block, hi[ends] // block],
                      axis=1).astype(np.int32)
    return y0, y1, fy, row_lo, band_b, band_rows


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _band_tables_on(dev, out_h: int, in_h: int, nbx: int, t: int,
                    ctas_per_sm: int = _K1_CTAS_PER_SM, block: int = 8,
                    strip: int = _K1_STRIP):
    """:func:`_band_tables` for ``dev``: ``(y0, y1, fy, row_lo, band_b)``
    as device tensors, copied once per geometry (a copy from pageable host
    memory on every call would stall the stream), and ``band_rows``."""
    *tabs, band_rows = _band_tables(out_h, in_h, nbx, t, _sm_count(dev),
                                    ctas_per_sm, block, strip)
    conv = (_int32, _int32, _float32, _int32, _int32)
    return [f(a, dev) for f, a in zip(conv, tabs)], band_rows


def _check_idct_inputs(name, coeffs, steps, channels, block_h, block_w):
    _check_cuda(name, coeffs)
    t, nby, nbx, cn = coeffs.shape
    if coeffs.dtype != torch.float32 or cn != channels * block_h * block_w:
        raise TypeError(f"{name}: coeffs must be (T, nby, nbx, C*bh*bw) "
                        "float32")
    if steps.dtype != torch.float32 or tuple(steps.shape) != (t, nby, nbx):
        raise TypeError(f"{name}: steps must be (T, nby, nbx) float32")
    if steps.device != coeffs.device:
        raise ValueError(f"{name}: coeffs and steps on different devices")


def _int32(a, dev):
    return torch.as_tensor(a, dtype=torch.int32, device=dev)


def _float32(a, dev):
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def idct_display(
    coeffs: torch.Tensor,
    steps: torch.Tensor,
    out_h: int,
    channels: int = 3,
    block_h: int = 8,
    block_w: int = 8,
    *,
    general: bool = False,
) -> torch.Tensor:
    """Dequantize + inverse DCT + bilinear row resample to ``out_h`` rows +
    display round/clip, as packed bytes (kernel K1).

    Args:
      coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients.
      steps: ``(T, nby, nbx)`` float32 per-block quantization steps (> 0).
      out_h: display height (``<= nby*bh``; equal = identity rows).
      general: launch the general kernel whatever the shape (the yardstick
        the specialised and templated ones are held and timed against).

    Returns ``(T, out_h, nbx*bw*C)`` uint8 — the width is not resampled
    (the width-aligned display routes). 8x8 blocks of 3 channels go to the
    specialised kernel, the other blocks of 3 channels with both sides in
    {1, 2, 4, 8, 16} to the templated kernel, every other shape (other
    sides, other channel counts) to the general one.
    """
    if coeffs.device.type == "cpu":
        return idct_display_plain(coeffs, steps, out_h, channels, block_h, block_w)
    _check_idct_inputs("idct_display", coeffs, steps, channels, block_h, block_w)
    t, nby, nbx, cn = coeffs.shape
    dev = coeffs.device
    specialised = _specialised(block_h, block_w, channels)
    if (specialised or _templated(block_h, block_w, channels)) and not general:
        bh, bw = block_h, block_w
        if specialised:
            kernel, strip, ctas = IDCT_DISPLAY, _K1_STRIP, _K1_CTAS_PER_SM
            # host matrix, passed by value
            mats = (dct_matrix(8).ctypes.data,)
            step_rows = 8
        else:
            kernel, strip = IDCT_DISPLAY_SQ[bh, bw], _K1_SQ_STRIP_PIXELS // bw
            ctas = _K1_SQ_GEOM[bh, bw][2]
            mats = (dct_matrix(bh).ctypes.data, dct_matrix(bw).ctypes.data)
            step_rows = _k1_sq_step_rows(bh, bw)
        out = torch.empty((t, out_h, nbx * bw * 3), dtype=torch.uint8, device=dev)
        if out.numel() == 0:
            return out
        c = coeffs.contiguous()
        if c.data_ptr() % 16:  # the kernel copies 16-byte chunks
            c = c.clone()
        s = steps.contiguous()
        # rows are walk steps of step_rows pixel rows (a block row, or
        # several where a side is 1 or 2); the strip counts block columns
        tabs, band_rows = _band_tables_on(dev, out_h, nby * bh, nbx, t, ctas,
                                          step_rows, strip)
        n_bands = len(tabs[-1])  # band_b: (n_bands, 2)
        with torch.cuda.device(dev):
            kernel.launch(
                c.data_ptr(), s.data_ptr(), *mats,
                *[tab.data_ptr() for tab in tabs], out.data_ptr(),
                t, out_h, nby, nbx, band_rows, n_bands, stream_handle(c),
            )
        return out
    band_rows = 2 * block_h
    tabs, nbr = _span_tables_on(dev, out_h, nby * block_h, block_h, band_rows)
    nb = min(_MAX_STRIP_BLOCKS, _SMEM_BYTES // (2 * nbr * cn * 4))
    if nb < 1:
        raise ValueError(
            f"idct_display: a {band_rows}-row band needs {nbr} source block "
            "rows, more than shared memory holds"
        )
    c = coeffs.contiguous()
    s = steps.contiguous()
    dh = _matrix_on(dev, block_h)
    dw = _matrix_on(dev, block_w)
    out = torch.empty(
        (t, out_h, nbx * block_w * channels), dtype=torch.uint8, device=dev
    )
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        IDCT_DISPLAY_GENERAL.launch(
            c.data_ptr(), s.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            *[tab.data_ptr() for tab in tabs], out.data_ptr(),
            t, out_h, nby, nbx, channels, block_h, block_w, band_rows, nbr,
            nb, stream_handle(c),
        )
    return out


# ---------------------------------------------------------------------------
# K6: dequantize + inverse DCT + row and column resample + display bytes
# ---------------------------------------------------------------------------


def idct_resize_display_plain(
    coeffs: torch.Tensor, steps: torch.Tensor, out_h: int, out_w: int,
    channels: int, block_h: int, block_w: int,
) -> torch.Tensor:
    """Plain PyTorch version of K6 (same contract as
    :func:`idct_resize_display`): rows blended first, then columns, each
    ``a * (1 - f) + b * f``, an identity axis not blended."""
    planes = idct_planes_plain(coeffs, steps, channels, block_h, block_w)
    return display_bytes(resize_bilinear(planes, out_h, out_w))


@functools.lru_cache(maxsize=64)
def _strip_tables(out_w: int, in_w: int, block: int = 8,
                  strip: int = _K6_STRIP):
    """The column geometry of K6's specialised kernel and its templated
    kernels (host numpy), whose CTAs each transform a strip of ``strip``
    block columns of ``block`` pixels (the block width; ``span = block *
    strip`` source columns, 64 for every kernel) plus one halo block
    column, and emit the output columns whose ``x0`` lies in the strip.

    Returns ``(col_e, col_f, strip_lo)``: per byte ``3 * xo + c`` of a
    display row, ``col_e`` the ring position of its ``x0`` within its strip
    (``3 * (x0 - span * strip) + c``; its ``x1``, read only where the
    weight is not zero, is ``x0 + 1``, 3 further on) and ``col_f`` its
    ``fx``; ``strip_lo`` ``(n_strips + 1,)`` the first byte of each strip,
    so strip ``s`` writes bytes ``[strip_lo[s], strip_lo[s + 1])`` of every
    row.
    """
    x0, _, fx, _ = bilinear_axis_weights(out_w, in_w)
    span = block * strip
    strip = x0 // span  # non-decreasing
    lo = np.searchsorted(strip, np.arange(-(-in_w // span) + 1))
    byte = np.arange(3 * out_w)
    col_e = 3 * (x0[byte // 3] - span * strip[byte // 3]) + byte % 3
    return (col_e.astype(np.int32), fx[byte // 3].astype(np.float32),
            (3 * lo).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _strip_tables_on(dev, out_w: int, in_w: int, block: int = 8,
                     strip: int = _K6_STRIP):
    """:func:`_strip_tables` as device tensors, copied once per geometry."""
    col_e, col_f, strip_lo = _strip_tables(out_w, in_w, block, strip)
    return [_int32(col_e, dev), _float32(col_f, dev), _int32(strip_lo, dev)]


def idct_resize_display(
    coeffs: torch.Tensor,
    steps: torch.Tensor,
    out_h: int,
    out_w: int,
    channels: int = 3,
    block_h: int = 8,
    block_w: int = 8,
    *,
    general: bool = False,
) -> torch.Tensor:
    """Dequantize + inverse DCT + bilinear resize of both axes from the
    padded frame to ``(out_h, out_w)`` + display round/clip, as packed bytes
    (kernel K6 — the general display route, frame width excess).

    Args:
      coeffs: ``(T, nby, nbx, C*bh*bw)`` float32 wire coefficients.
      steps: ``(T, nby, nbx)`` float32 per-block quantization steps (> 0).
      general: launch the general kernel whatever the shape (the yardstick
        the specialised and templated ones are held and timed against).

    Returns ``(T, out_h, out_w*C)`` uint8. 8x8 blocks of 3 channels go to
    the specialised kernel, the other blocks of 3 channels with both sides
    in {1, 2, 4, 8, 16} to the templated kernel, unless the columns are
    upsampled (``out_w`` past the padded width, which the decoder never
    asks for); every other shape goes to the general one.
    """
    if coeffs.device.type == "cpu":
        return idct_resize_display_plain(
            coeffs, steps, out_h, out_w, channels, block_h, block_w
        )
    _check_idct_inputs(
        "idct_resize_display", coeffs, steps, channels, block_h, block_w
    )
    t, nby, nbx, cn = coeffs.shape
    dev = coeffs.device
    out = torch.empty((t, out_h, out_w * channels), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    specialised = _specialised(block_h, block_w, channels)
    if ((specialised or _templated(block_h, block_w, channels))
            and out_w <= nbx * block_w and not general):
        bh, bw = block_h, block_w
        if specialised:
            kernel, strip, ctas = IDCT_RESIZE, _K6_STRIP, _K6_CTAS_PER_SM
            # host matrix, passed by value
            mats = (dct_matrix(8).ctypes.data,)
            step_rows = 8
        else:
            kernel, strip = IDCT_RESIZE_SQ[bh, bw], _K6_SQ_STRIP_PIXELS // bw
            ctas = _K6_SQ_GEOM[bh, bw][5]
            mats = (dct_matrix(bh).ctypes.data, dct_matrix(bw).ctypes.data)
            step_rows = _k1_sq_step_rows(bh, bw)
        c = coeffs.contiguous()
        if c.data_ptr() % 16:  # the kernel copies 16-byte chunks
            c = c.clone()
        s = steps.contiguous()
        # rows are walk steps of step_rows pixel rows (K1's: a block row,
        # or several where a side is 1 or 2); the strip counts block
        # columns of bw pixels
        tabs, band_rows = _band_tables_on(dev, out_h, nby * bh, nbx, t, ctas,
                                          step_rows, strip)
        n_bands = len(tabs[-1])  # band_b: (n_bands, 2)
        cols = _strip_tables_on(dev, out_w, nbx * bw, bw, strip)
        with torch.cuda.device(dev):
            kernel.launch(
                c.data_ptr(), s.data_ptr(), *mats,
                *[tab.data_ptr() for tab in tabs + cols], out.data_ptr(),
                t, out_h, out_w, nby, nbx, band_rows, n_bands,
                stream_handle(c),
            )
        return out
    band_rows = 2 * block_h
    rows, nbr = _span_tables_on(dev, out_h, nby * block_h, block_h, band_rows)
    for strip_cols in (64, 32, 16, 8):
        nbc = _span_tables(out_w, nbx * block_w, block_w, strip_cols)[4]
        if 2 * nbr * nbc * cn * 4 <= _SMEM_BYTES:
            break
    else:
        raise ValueError(
            "idct_resize_display: an output tile's source blocks exceed "
            "shared memory"
        )
    cols, _ = _span_tables_on(dev, out_w, nbx * block_w, block_w, strip_cols)
    c = coeffs.contiguous()
    s = steps.contiguous()
    dh = _matrix_on(dev, block_h)
    dw = _matrix_on(dev, block_w)
    with torch.cuda.device(dev):
        IDCT_RESIZE_GENERAL.launch(
            c.data_ptr(), s.data_ptr(), dh.data_ptr(), dw.data_ptr(),
            *[tab.data_ptr() for tab in rows + cols], out.data_ptr(),
            t, out_h, out_w, nby, nbx, channels, block_h, block_w, band_rows,
            nbr, strip_cols, nbc, stream_handle(c),
        )
    return out
