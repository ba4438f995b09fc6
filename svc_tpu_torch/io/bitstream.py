"""Bitstream wire format: header + per-block serialization (the port's own
copy of ``svc_tpu/io/bitstream.py``; byte-identical output on the native and
the NumPy path).

The wire contract between encoder and decoder, preserved from the reference:

* ``Header`` — 8 raw uint32 fields written as struct bytes
  (reference: libs/codec.hpp:8-17; write libs/encoder.cpp:368-381;
  read apps/decoder.cpp:106-111).
* Frame payload — raster scan over transform blocks; per block a raw uint32
  block type followed by, per channel, ``block_h`` rows of ``block_w``
  float32 DCT coefficients (reference: libs/encoder.cpp:222-269 and
  apps/decoder.cpp:59-85, libs/decoder.cpp:102-126).

This implementation serializes the **padded** block grid with correct row
strides — the layout the reference's own decoder reader already assumes
(quirk Q4: the reference encoder passes unpadded dims with padded Mats,
libs/encoder.cpp:647-650, consistent only when padding is zero).

``BLOCK_TYPE_BACKGROUND`` is 0 (reference: libs/codec.hpp:6).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np

BLOCK_TYPE_BACKGROUND = 0

_HEADER_FMT = "<8I"
HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 32 bytes


@dataclasses.dataclass
class Header:
    """reference: libs/codec.hpp:8-17"""

    frame_count: int
    frame_w: int
    frame_h: int
    frame_excess_w: int
    frame_excess_h: int
    transform_block_w: int
    transform_block_h: int
    channel_count: int

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT,
            self.frame_count,
            self.frame_w,
            self.frame_h,
            self.frame_excess_w,
            self.frame_excess_h,
            self.transform_block_w,
            self.transform_block_h,
            self.channel_count,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Header":
        if len(data) < HEADER_SIZE:
            raise ValueError("failed to read header")
        return cls(*struct.unpack(_HEADER_FMT, data[:HEADER_SIZE]))

    def validate(self) -> None:
        """Sanity-check a header read from an untrusted stream (the
        reference trusts raw struct bytes, apps/decoder.cpp:106-111)."""
        if not (0 < self.frame_w <= 1 << 16 and 0 < self.frame_h <= 1 << 16):
            raise ValueError("invalid header: bad frame dimensions")
        if not (0 <= self.frame_excess_w <= 1 << 16
                and 0 <= self.frame_excess_h <= 1 << 16):
            raise ValueError("invalid header: bad frame excess")
        if not (0 < self.transform_block_w <= 256
                and 0 < self.transform_block_h <= 256):
            raise ValueError("invalid header: bad transform block dims")
        if self.padded_frame_w % self.transform_block_w != 0 or (
            self.padded_frame_h % self.transform_block_h != 0
        ):
            raise ValueError(
                "invalid header: padded dims not divisible by block dims"
            )
        if not (1 <= self.channel_count <= 4):
            raise ValueError("invalid header: bad channel count")
        # bound the promised stream size: a crafted count (or giant dims
        # with tiny blocks) must not drive multi-GB allocations downstream
        if self.frame_count > 1 << 24:  # ~155 h at 30 fps
            raise ValueError("invalid header: implausible frame count")
        if self.blocks_per_frame > 1 << 24:
            raise ValueError("invalid header: implausible block count")

    @property
    def padded_frame_w(self) -> int:
        return self.frame_w + self.frame_excess_w

    @property
    def padded_frame_h(self) -> int:
        return self.frame_h + self.frame_excess_h

    @property
    def blocks_per_frame(self) -> int:
        return (self.padded_frame_w // self.transform_block_w) * (
            self.padded_frame_h // self.transform_block_h
        )

    @property
    def block_byte_count(self) -> int:
        """Fixed per-block wire size (apps/decoder.cpp:59-64)."""
        area = self.transform_block_w * self.transform_block_h
        return 4 + 4 * area * self.channel_count

    @property
    def frame_byte_count(self) -> int:
        return self.blocks_per_frame * self.block_byte_count


def block_types_for_transform_grid(
    mv_field_block_types: np.ndarray,
    padded_w: int,
    padded_h: int,
    transform_block_w: int,
    transform_block_h: int,
    mv_block_w: int,
    mv_block_h: int,
) -> np.ndarray:
    """Expand MV-block types to the transform-block grid.

    Every transform block inherits the type of the MV block containing its
    top-left pixel (reference: libs/encoder.cpp:243-249).
    """
    mv_field_h, mv_field_w = mv_field_block_types.shape
    tb_ys = np.arange(0, padded_h, transform_block_h)
    tb_xs = np.arange(0, padded_w, transform_block_w)
    mv_ys = np.minimum(tb_ys // mv_block_h, mv_field_h - 1)
    mv_xs = np.minimum(tb_xs // mv_block_w, mv_field_w - 1)
    return mv_field_block_types[np.ix_(mv_ys, mv_xs)]


def serialize_frame(
    dct_coeffs: np.ndarray,
    mv_field_block_types: np.ndarray,
    transform_block_w: int,
    transform_block_h: int,
    mv_block_w: int,
    mv_block_h: int,
) -> bytes:
    """Serialize one encoded frame to wire bytes.

    Args:
      dct_coeffs: ``(channels, padded_h, padded_w)`` float32 blockwise DCT
        coefficients (channel order = the order ``cv::split`` would produce,
        i.e. B, G, R for BGR input; reference: libs/encoder.cpp:323-339).
      mv_field_block_types: ``(mv_field_h, mv_field_w)`` uint32 block types.

    Vectorized equivalent of the reference's per-block byte appends
    (libs/encoder.cpp:243-265), over the padded grid (Q4 fix).
    """
    c, ph, pw = dct_coeffs.shape
    tbw, tbh = transform_block_w, transform_block_h
    nby, nbx = ph // tbh, pw // tbw
    nblocks = nby * nbx

    types = block_types_for_transform_grid(
        mv_field_block_types, pw, ph, tbw, tbh, mv_block_w, mv_block_h
    ).astype(np.uint32)

    # native C++ hot path when available (svc_tpu_torch.runtime.native)
    from svc_tpu_torch.runtime import native as _native

    raw = _native.serialize_frame_native(dct_coeffs, types, tbw, tbh)
    if raw is not None:
        return raw

    # (C, nby, tbh, nbx, tbw) -> (nby, nbx, C, tbh, tbw)
    blocks = (
        dct_coeffs.astype(np.float32, copy=False)
        .reshape(c, nby, tbh, nbx, tbw)
        .transpose(1, 3, 0, 2, 4)
        .reshape(nblocks, c * tbh * tbw)
    )

    block_bytes = 4 + 4 * c * tbh * tbw
    out = np.empty((nblocks, block_bytes), dtype=np.uint8)
    out[:, :4] = types.reshape(nblocks, 1).view(np.uint8).reshape(nblocks, 4)
    out[:, 4:] = np.ascontiguousarray(blocks).view(np.uint8)
    return out.tobytes()


def serialize_frame_blocks(
    coeff_blocks: np.ndarray,
    mv_field_block_types: np.ndarray,
    mv_block_w: int,
    mv_block_h: int,
) -> bytes:
    """Serialize coefficients already in wire block layout.

    Args:
      coeff_blocks: ``(nby, nbx, C, bh, bw)`` float32 — each transform
        block contiguous, exactly the wire's per-block payload order.
      mv_field_block_types: ``(mv_field_h, mv_field_w)`` uint32.

    The per-block payload is a straight memcpy; only the 4 type bytes are
    interleaved.
    """
    nby, nbx, c, tbh, tbw = coeff_blocks.shape
    nblocks = nby * nbx
    types = block_types_for_transform_grid(
        mv_field_block_types, nbx * tbw, nby * tbh, tbw, tbh,
        mv_block_w, mv_block_h,
    ).astype(np.uint32)

    from svc_tpu_torch.runtime import native as _native

    raw = _native.serialize_blocks_native(coeff_blocks, types)
    if raw is not None:
        return raw

    flat = np.ascontiguousarray(
        coeff_blocks.astype(np.float32, copy=False)
    ).reshape(nblocks, c * tbh * tbw)
    block_bytes = 4 + 4 * c * tbh * tbw
    out = np.empty((nblocks, block_bytes), dtype=np.uint8)
    out[:, :4] = types.reshape(nblocks, 1).view(np.uint8).reshape(nblocks, 4)
    out[:, 4:] = flat.view(np.uint8)
    return out.tobytes()


def deserialize_frame_blocks(
    data: bytes, header: Header
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one frame's wire bytes into block layout.

    Returns ``(block_types (nby, nbx) uint32,
    coeff_blocks (nby, nbx, C, bh, bw) float32)``.
    """
    tbw, tbh = header.transform_block_w, header.transform_block_h
    c = header.channel_count
    pw, ph = header.padded_frame_w, header.padded_frame_h
    nby, nbx = ph // tbh, pw // tbw
    nblocks = nby * nbx
    block_bytes = header.block_byte_count
    expected = nblocks * block_bytes
    if len(data) < expected:
        raise ValueError("failed to read all expected blocks")
    raw = np.frombuffer(data, dtype=np.uint8, count=expected).reshape(
        nblocks, block_bytes
    )
    types = raw[:, :4].copy().view(np.uint32).reshape(nby, nbx)
    blocks = raw[:, 4:].copy().view(np.float32).reshape(nby, nbx, c, tbh, tbw)
    return types, blocks


def deserialize_frame(
    data: bytes,
    header: Header,
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one frame's wire bytes.

    Returns ``(block_types, dct_coeffs)`` with shapes
    ``(nby, nbx)`` uint32 and ``(channels, padded_h, padded_w)`` float32.

    Vectorized equivalent of the decoder's per-block ``ParseBlock``
    (reference: libs/decoder.cpp:102-126).
    """
    tbw, tbh = header.transform_block_w, header.transform_block_h
    c = header.channel_count
    pw, ph = header.padded_frame_w, header.padded_frame_h

    from svc_tpu_torch.runtime import native as _native

    parsed = _native.deserialize_frame_native(data, c, ph, pw, tbw, tbh)
    if parsed is not None:
        return parsed

    # one wire parser: the block-layout reader does the length check and
    # byte reinterpretation; this view only rearranges to plane layout
    types, coeff_blocks = deserialize_frame_blocks(data, header)
    coeffs = coeff_blocks.transpose(2, 0, 3, 1, 4).reshape(c, ph, pw)
    return types, coeffs


def read_frames(
    stream: BinaryIO, header: Header, count: Optional[int] = None
) -> Iterator[bytes]:
    """Yield raw frame payloads from a bitstream (after the header).

    Mirrors the decoder app's fixed-size reader loop
    (apps/decoder.cpp:59-85) but chunked per frame instead of per block.
    """
    n = header.frame_count if count is None else count
    for _ in range(n):
        data = stream.read(header.frame_byte_count)
        if len(data) < header.frame_byte_count:
            raise ValueError("failed to read block")
        yield data


def frame_offset(header: Header, frame_index: int) -> int:
    """Byte offset of frame ``frame_index``'s payload.

    Every block has identical wire size (apps/decoder.cpp:59-64), so the
    stream is random-access — the seek/resume capability the reference
    lacks (SURVEY.md §5: "seekable in principle ... no seeking/resume is
    implemented").
    """
    return HEADER_SIZE + frame_index * header.frame_byte_count


def seek_to_frame(stream: BinaryIO, header: Header, frame_index: int) -> None:
    """Position a stream (already past the header) at ``frame_index``.

    Seeks when the stream supports it, otherwise skip-reads — so resume
    works on both files and pipes.
    """
    if frame_index == 0:
        return
    if stream.seekable():
        stream.seek(frame_offset(header, frame_index))
        return
    remaining = frame_index * header.frame_byte_count
    chunk = 1 << 20
    while remaining > 0:
        got = stream.read(min(chunk, remaining))
        if not got:
            raise ValueError("failed to read block")
        remaining -= len(got)
