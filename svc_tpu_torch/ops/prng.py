"""Threefry2x32 counter-based random stream, bit-equal to ``jax.random``.

The encoder's randomness (RANSAC subsets, k-means++ seeding) is a pure
function of ``cfg.seed`` and the anchor index (quirk Q7 made
deterministic). The port reproduces exactly the ``jax.random`` derivations
``svc_tpu`` uses, with ``jax_threefry_partitionable=True`` (jax 0.9
default), so both packages draw the same bits:

* :func:`key` — ``jax.random.key(seed)``: words ``(seed >> 32, seed & M)``;
* :func:`fold_in` — ``threefry2x32(key, (0, data))``;
* :func:`split` — key ``i`` of ``num`` is ``threefry2x32(key, (0, i))``;
* :func:`random_bits` — element ``i`` of the flattened shape is
  ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``;
* :func:`randint` — ``jax.random.randint`` for int32 (two bit streams from
  a split key, combined modulo the span);
* :func:`uniform` — ``jax.random.uniform`` for float32 (23 mantissa bits
  under exponent 0, shifted to ``[minval, maxval)``).

A key is an int64 tensor ``(..., 2)`` holding two uint32 words (torch's
uint32 support is thin, so 32-bit words live in int64 and every add,
multiply and shift is masked with ``0xFFFFFFFF``). Leading key dims batch:
the result of a draw has the key's leading dims in front of ``shape``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise, broadcasting."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` as the port's ``(2,)`` key."""
    return torch.tensor(
        [(int(seed) >> 32) & _M, int(seed) & _M], dtype=torch.int64, device=device
    )


def key_from_jax_data(data: np.ndarray, device="cpu") -> torch.Tensor:
    """The port's key from ``jax.random.key_data(k)`` (uint32 ``(..., 2)``)."""
    return torch.as_tensor(
        np.asarray(data, dtype=np.uint32).astype(np.int64), device=device
    )


def _bits_at(k: torch.Tensor, counts: torch.Tensor, count_shape):
    """``threefry2x32(key, (0, count))`` for every key and count."""
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(lead + (1,) * len(count_shape))
    k1 = k[..., 1].reshape(lead + (1,) * len(count_shape))
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    return threefry2x32(k0, k1, zero, counts)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of uint32 ``data`` (int or tensor broadcasting
    against the key's leading dims)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], zero, d)
    return torch.stack([o0, o1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    counts = torch.arange(num, dtype=torch.int64, device=k.device)
    o0, o1 = _bits_at(k, counts, (num,))
    return torch.stack([o0, o1], dim=-1)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element: ``(*key_lead, *shape)`` int64 in
    ``[0, 2**32)``."""
    shape = _shape(shape)
    counts = torch.arange(
        math.prod(shape), dtype=torch.int64, device=k.device
    ).reshape(shape)
    o0, o1 = _bits_at(k, counts, shape)
    return o0 ^ o1


def randint(k: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 dtype)."""
    shape = _shape(shape)
    ks = split(k, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & _M if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _M) % span
    offset = (((higher % span) * multiplier) & _M) + (lower % span)
    offset = (offset & _M) % span
    return (minval + offset).to(torch.int32)


def uniform(
    k: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    shape = _shape(shape)
    bits = random_bits(k, shape)
    fbits = (bits >> 9) | 0x3F800000  # 23 mantissa bits, exponent of 1.0
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)
