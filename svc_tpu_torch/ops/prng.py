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
  under exponent 0, shifted to ``[minval, maxval)``);
* :func:`permutation` — ``jax.random.permutation(key, n)``: ``_shuffle``'s
  rounds of a stable sort of ``arange(n)`` by fresh 32-bit keys;
* :func:`choice` — ``jax.random.choice(key, n, (m,), replace=False)``, the
  first ``m`` entries of that permutation.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words (torch's
uint32 support is thin, so 32-bit words live in int64). Leading key dims
batch: the result of a draw has the key's leading dims in front of
``shape``.

The cipher runs as kernel K11 (:func:`threefry_words`,
``csrc/threefry.cu``) on a CUDA tensor: one launch for every key and
count, in native uint32 arithmetic. On a CPU tensor it runs as its plain
version :func:`threefry_words_plain` (:func:`threefry2x32`, every add and
shift of the int64-held words masked with ``0xFFFFFFFF``); the words are
equal bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from svc_tpu_torch.kernels.build import INT, INT64, PTR, Kernel, stream_handle

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]

THREEFRY = Kernel(
    "threefry2x32",
    "svc_threefry2x32",
    [PTR, PTR, PTR, INT64, INT64, INT, PTR],
    source="svc_tpu_torch/csrc/threefry.cu",
    replaces="svc_tpu/ops/kmeans.py:72",
)


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


def threefry_words_plain(
    k: torch.Tensor,
    n_counts: int,
    data: Optional[torch.Tensor] = None,
    both: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of K11 (same contract as
    :func:`threefry_words`): :func:`threefry2x32` on int64-held words."""
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(lead + (1,))
    k1 = k[..., 1].reshape(lead + (1,))
    if data is None:
        x1 = torch.arange(n_counts, dtype=torch.int64, device=k.device)
    else:
        x1 = data.to(torch.int64) & _M
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    o0, o1 = threefry2x32(k0, k1, zero, x1)
    return torch.stack([o0, o1], dim=-1) if both else o0 ^ o1


def _check_cuda(k: torch.Tensor) -> None:
    if k.device.type != "cuda":
        raise ValueError(f"threefry_words: unsupported device {k.device}")


def threefry_words(
    k: torch.Tensor,
    n_counts: int,
    data: Optional[torch.Tensor] = None,
    both: bool = True,
) -> torch.Tensor:
    """``threefry2x32(key, (0, x1))`` for every key of ``k (..., 2)`` and
    every ``x1`` in ``0 .. n_counts - 1`` — or ``x1 = data[..., j]`` when
    ``data (..., n_counts)`` is given (int64, low 32 bits).

    Returns int64 words: ``(..., n_counts, 2)`` ``(x0, x1)`` when ``both``,
    else ``(..., n_counts)`` ``x0 ^ x1``. A CUDA tensor launches K11 (the
    launch or an error, never the plain version); a CPU tensor runs
    :func:`threefry_words_plain`.
    """
    if k.device.type == "cpu":
        return threefry_words_plain(k, n_counts, data, both)
    lead = k.shape[:-1]
    _check_cuda(k)
    if k.dtype != torch.int64 or k.shape[-1:] != (2,):
        raise TypeError("threefry_words: keys must be (..., 2) int64")
    keys = k.reshape(-1, 2).contiguous()
    n_keys = keys.shape[0]
    if data is not None:
        if data.dtype != torch.int64 or tuple(data.shape) != tuple(lead) + (n_counts,):
            raise TypeError(f"threefry_words: data must be {tuple(lead) + (n_counts,)} int64")
        if data.device != k.device:
            raise ValueError("threefry_words: keys and data on different devices")
        data = data.contiguous()
    shape = tuple(lead) + (n_counts,) + ((2,) if both else ())
    out = torch.empty(shape, dtype=torch.int64, device=k.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(keys.device):
        THREEFRY.launch(
            keys.data_ptr(), None if data is None else data.data_ptr(),
            out.data_ptr(), n_keys, n_counts, int(both), stream_handle(keys),
        )
    return out


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of uint32 ``data`` (int or tensor broadcasting
    against the key's leading dims)."""
    if isinstance(data, int):  # filled on the device, no host copy
        d = torch.full((), data, dtype=torch.int64, device=k.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=k.device)
    lead = torch.broadcast_shapes(k.shape[:-1], d.shape)
    keys = k.expand(lead + (2,))
    return threefry_words(keys, 1, d.expand(lead).reshape(lead + (1,)))[..., 0, :]


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    return threefry_words(k, num)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element: ``(*key_lead, *shape)`` int64 in
    ``[0, 2**32)``."""
    shape = _shape(shape)
    bits = threefry_words(k, math.prod(shape), both=False)
    return bits.reshape(k.shape[:-1] + shape)


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
    # filled on the device: a copy from pageable memory would sync the
    # stream and keep the draw out of a CUDA graph
    lo = torch.full((), minval, dtype=torch.float32, device=k.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


#: Rows of ``n`` sort keys drawn at once by :func:`permutation`: bounds
#: the int64 temporaries of the cipher and the sort (~128 MB each).
_PERMUTATION_CHUNK = 1 << 24


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random``'s ``_shuffle`` over ``n`` elements:
    ``ceil(3 ln n / ln(2**32 - 1))`` in float64 (1 up to n = 1625, then 2
    up to ~2.6e6)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.float64(_M))))


def _permute_rows(k: torch.Tensor, n: int, rounds: int) -> torch.Tensor:
    """:func:`permutation` of ``(R, 2)`` keys: ``(R, n)`` int64."""
    perm = torch.arange(n, dtype=torch.int64, device=k.device).expand(
        k.shape[0], n
    )
    for _ in range(rounds):
        ks = split(k)
        k, sub = ks[:, 0], ks[:, 1]  # [0] carried, [1] drawn from
        # the sort keys belong to positions of the current permutation,
        # not to the original indices
        perm = sort_by_keys(perm, random_bits(sub, (n,)))
    return perm.contiguous()


def sort_by_keys(values: torch.Tensor, sort_keys: torch.Tensor) -> torch.Tensor:
    """One shuffle round, ``lax.sort_key_val(sort_keys, values)`` along the
    last axis: a stable sort, so equal keys keep their position order
    (int64-held 32-bit words sort as uint32)."""
    order = torch.sort(sort_keys, dim=-1, stable=True).indices
    return torch.gather(values, -1, order)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for every key: ``(*key_lead, n)``
    int64. The keys' rows are drawn in chunks; each row's draw depends on
    its key alone, so the chunking changes no bit."""
    lead = k.shape[:-1]
    rows = k.reshape(-1, 2)
    rounds = shuffle_rounds(n)
    step = max(1, _PERMUTATION_CHUNK // max(n, 1))
    parts = [
        _permute_rows(rows[i:i + step], n, rounds)
        for i in range(0, rows.shape[0], step)
    ]
    return torch.cat(parts).reshape(lead + (n,))


def choice(k: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (m,), replace=False)`` for every key:
    ``(*key_lead, m)`` int64 distinct indices in ``[0, n)``."""
    if m > n:
        raise ValueError(
            f"cannot take a larger sample (size {m}) than population "
            f"(size {n}) without replacement"
        )
    return permutation(k, n)[..., :m]
