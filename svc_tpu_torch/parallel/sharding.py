"""Frame-parallel sharded encoding over a list of devices
(``svc_tpu/parallel/sharding.py``).

Frame ``t`` depends on frame ``t-1`` only through the input pyramid, so a
batch of ``n_devices * batch_per_device`` anchors splits into chunks of
``batch_per_device`` anchors, each carrying a one-frame halo (the frame
before its first anchor, duplicated on the host). Chunk ``d`` runs the
single-device pipeline (``Encoder.encode_packed``) on ``devices[d]`` with
anchor keys ``fold_in(key(seed), i)`` from its own first anchor on, exactly
svc_tpu's ``_sharded_keys`` slice ``d``. Each chunk is staged to its own
device through its encoder's pinned upload, so the super-batch never lands
on one device. The outputs are gathered along frames onto ``devices[0]``,
where the stream statistics svc_tpu reduces with ``psum`` / ``pmean``
(foreground block count, mean RANSAC RMSE) are reduced too.

The port's "mesh" is a sequence of torch devices. An entry may repeat: each
entry is one chunk, so one card can run the split (``[cuda:0, cuda:0]``).
Chunks are dispatched in order on the calling thread. On ``cuda`` each
chunk encoder replays its own CUDA graph, captured under its own device,
and the batch has no host sync: no chunk's dispatch waits for a device.

``padded_planes`` (``keep_planes``) comes out in the single-device layout
``(3, T+1, PH, PW)``: chunk 0's stack, then every later chunk without its
halo frame, so the visualizers draw every anchor on its own frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from svc_tpu_torch.config import EncoderConfig, VideoProperties
from svc_tpu_torch.models.encoder import Encoder, stream_encode
from svc_tpu_torch.runtime.device import DeviceLike, device_scope, resolve_device

#: Per-frame outputs, concatenated along frames in chunk order.
FRAME_OUTPUTS = (
    "coeffs",
    "block_types",
    "mv_field",
    "foreground_mask_raw",
    "foreground_mask",
    "cluster_labels",
    "global_motion",
    "ransac_rmse",
)


def make_frame_devices(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = "cuda",
) -> List[torch.device]:
    """The device list a batch is split over (``make_frame_mesh``).

    ``devices`` given: those entries (a device may repeat), the first
    ``n_devices`` of them if that is given too. Otherwise ``device="cuda"``
    gives ``cuda:0 .. cuda:n-1`` (every card when ``n_devices`` is None)
    and raises ``ValueError`` when fewer cards exist; ``device="cpu"``
    gives ``n_devices`` CPU entries.
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        return devs if n_devices is None else devs[:n_devices]
    dev = torch.device(device)
    if dev.type != "cuda":
        dev = resolve_device(dev)  # the CPU, or raises
        return [dev] * (1 if n_devices is None else n_devices)
    resolve_device(torch.device("cuda", 0))  # raises without a card
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else n_devices
    if n > avail:
        raise ValueError(f"requested {n} devices but only {avail} available")
    return [torch.device("cuda", i) for i in range(n)]


def halo_chunks(frames: Sequence, n_chunks: int, per_chunk: int) -> list:
    """Chunk ``d`` of ``n_chunks * per_chunk + 1`` frames: anchors
    ``[d*per_chunk+1, (d+1)*per_chunk]`` plus the frame before them."""
    return [frames[d * per_chunk:d * per_chunk + per_chunk + 1]
            for d in range(n_chunks)]


class ShardedEncoder:
    """Encoder whose batch is split across ``devices``, one single-device
    ``Encoder`` of ``batch_per_device`` anchors per entry."""

    def __init__(
        self,
        cfg: EncoderConfig,
        vidprops: VideoProperties,
        devices: Sequence[DeviceLike],
        batch_per_device: int = 4,
        keep_planes: bool = False,
    ):
        if not devices:
            raise ValueError("ShardedEncoder needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]  # where the outputs are gathered
        self.n_devices = len(self.devices)
        self.batch_per_device = batch_per_device
        self.batch_size = self.n_devices * batch_per_device
        self.inners = [
            Encoder(cfg, vidprops, batch_size=batch_per_device, device=d,
                    keep_planes=keep_planes)
            for d in self.devices
        ]
        self.inner = self.inners[0]

    @property
    def cfg(self):
        return self.inner.cfg

    @property
    def keep_planes(self):
        return self.inner.keep_planes

    def header(self, frame_count=None):
        return self.inner.header(frame_count)

    def encode_video(self, frames, **kwargs):
        """Stream shard-encode a video: ``stream_encode`` over split
        batches, byte-identical to the single-device stream."""
        return stream_encode(self, frames, **kwargs)

    def _check(self, n_frames: int) -> None:
        t = n_frames - 1
        if t != self.batch_size:
            raise ValueError(
                f"sharded batch needs {self.batch_size}+1 frames, got {t}+1"
            )

    def chunk_frames(self, frames_bgr: np.ndarray) -> np.ndarray:
        """Host-side halo chunking: ``(T+1, H, W, 3)`` uint8 frames ->
        ``(n_devices, bpd+1, H, W*3)`` packed chunks."""
        n, h, w, c = frames_bgr.shape
        return self._chunk_packed(
            np.ascontiguousarray(frames_bgr).reshape(n, h, w * c)
        )

    def _chunk_packed(self, packed: np.ndarray) -> np.ndarray:
        """Halo-chunk packed ``(T+1, H, W*3)`` frames into
        ``(n_devices, bpd+1, H, W*3)``."""
        return np.stack(
            halo_chunks(packed, self.n_devices, self.batch_per_device)
        )

    def stage_frames(self, packed) -> list:
        """Ship ``T+1`` host frames (packed ``(T+1, H, W*3)`` rows or a
        sequence of ``(H, W, 3)`` frames) chunk by chunk, each to its own
        device through its encoder's pinned upload."""
        self._check(len(packed))
        chunks = halo_chunks(packed, self.n_devices, self.batch_per_device)
        return [enc.stage_frames(c) for enc, c in zip(self.inners, chunks)]

    def encode_batch_staged(self, staged, first_anchor_index: int):
        """Dispatch on chunks staged by :meth:`stage_frames`."""
        return self._run([s.take() for s in staged], first_anchor_index)

    def encode_batch(self, frames_bgr, first_anchor_index: int):
        """Encode ``(T+1, H, W, 3)`` uint8 frames, ``T = batch_size``; each
        chunk is copied to its own device."""
        frames = np.asarray(frames_bgr)
        self._check(frames.shape[0])
        chunks = self.chunk_frames(frames)
        return self._run(
            [torch.from_numpy(c).to(d) for c, d in zip(chunks, self.devices)],
            first_anchor_index,
        )

    def _run(self, chunks, first_anchor_index: int) -> Dict[str, torch.Tensor]:
        bpd = self.batch_per_device
        outs = []
        for d, (enc, packed) in enumerate(zip(self.inners, chunks)):
            with device_scope(enc.device):
                outs.append(enc.encode_packed(packed, first_anchor_index + d * bpd))
        return self._gather(outs)

    def _gather(self, outs) -> Dict[str, torch.Tensor]:
        dst = self.device
        out = {
            k: torch.cat([o[k].to(dst) for o in outs]) for k in FRAME_OUTPUTS
        }
        fg = [o["foreground_mask"].sum(dtype=torch.int32).to(dst) for o in outs]
        out["total_foreground_blocks"] = torch.stack(fg).sum(dtype=torch.int32)
        means = torch.stack([o["ransac_rmse"].mean().to(dst) for o in outs])
        out["mean_ransac_rmse"] = means.sum() / torch.full(
            (), float(len(outs)), dtype=torch.float32, device=dst
        )
        if self.keep_planes:
            # (3, bpd+1, PH, PW) per chunk; drop every later chunk's halo
            planes = [o["padded_planes"].to(dst) for o in outs]
            out["padded_planes"] = torch.cat(
                planes[:1] + [p[:, 1:] for p in planes[1:]], dim=1
            )
        return out
