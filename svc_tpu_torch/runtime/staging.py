"""Double-buffered host <-> device staging (``svc_tpu/runtime/staging.py``).

``DoubleBufferedStager`` overlaps the host->device copy of batch ``i+1``
with the compute of batch ``i``: the staging call runs on one worker
thread as soon as a batch's host frames are assembled, the main thread
dispatches compute on the PREVIOUSLY staged batch and only then collects
the new one. One batch of lookahead is deliberate: the copy engine is
serial, so a deeper queue buys nothing and holds more device memory.

JAX's dispatch is asynchronous and its transfers thread-safe; torch eager
is neither, so on ``cuda`` the overlap is built from explicit streams and
events:

* ``PinnedUpload`` stacks a host batch straight into one of two reused
  pinned buffers and copies it with ``non_blocking=True`` on its own copy
  stream, returning the device tensor with the copy's event
  (:class:`Staged`). A pinned buffer is refilled only after the event of
  its last copy has completed. The consumer makes its stream wait on the
  event and records the tensor on that stream (:meth:`Staged.take`);
  without ``record_stream`` the caching allocator could hand the memory
  out again while the compute still reads it.
  Given a device tensor to write (``into``, a CUDA graph's static input),
  the copy stream first waits on that tensor's last-read event and copies
  there, so the batch crosses in one H2D copy with no device-to-device
  copy after it.
* ``PinnedDownload`` copies a dispatched batch's outputs into one of two
  reused sets of pinned host buffers on a second copy stream that waits
  on an event recorded after the batch; :meth:`Download.wait`
  synchronizes on the copy's event before numpy reads the buffers (a
  non-blocking D2H read early returns stale bytes, silently).

Nothing falls back: a failed pinned allocation or copy raises. On the CPU
the same calls run without streams or pinned memory, so the CPU tests
exercise the ordering.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from svc_tpu_torch.runtime.device import resolve_device


class DoubleBufferedStager:
    """Stage host batches one ahead of compute.

    Args:
      stage_fn: host batch -> staged device batch (e.g.
        ``Encoder.stage_frames``). Runs on the one worker thread; it must
        not launch compute (dispatch stays on the caller's stream).
    """

    def __init__(self, stage_fn: Callable[[Any], Any]):
        self._stage = stage_fn
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="svc-stager"
        )
        self._pending: Optional[concurrent.futures.Future] = None

    def submit(self, host_batch) -> None:
        """Begin staging ``host_batch``; at most one may be pending."""
        if self._pending is not None:
            raise RuntimeError("a staged batch is already pending; collect() it first")
        self._pending = self._pool.submit(self._stage, host_batch)

    def collect(self):
        """Wait for and return the pending staged batch; re-raises what
        the stage function raised."""
        if self._pending is None:
            raise RuntimeError("no staged batch pending")
        fut, self._pending = self._pending, None
        return fut.result()

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclasses.dataclass
class Staged:
    """A host batch on its way to the device: the tensor and, on ``cuda``,
    the event of its copy."""

    tensor: torch.Tensor
    event: Optional["torch.cuda.Event"] = None

    def take(self) -> torch.Tensor:
        """The tensor, ready for work on the current stream: that stream
        waits on the copy's event, and the tensor is recorded on it so the
        allocator keeps the memory until the work queued there is done."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


def fill_stacked(out: np.ndarray, batch) -> None:
    """Write ``batch`` — one array, or a sequence of equal-shaped arrays
    stacked along a new first axis — into ``out`` (same number of
    elements, C order)."""
    if isinstance(batch, np.ndarray):
        np.copyto(out, batch.reshape(out.shape))
    else:
        np.stack(batch, out=out.reshape((len(batch),) + np.shape(batch[0])))


class PinnedUpload:
    """H2D copies through two reused pinned host buffers on a copy stream
    (``cuda``); on the CPU a plain host tensor.

    Calls must not overlap (the stager's one worker thread makes them one
    at a time).
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream: Optional["torch.cuda.Stream"] = None
        self._slots: List[Optional[tuple]] = [None, None]  # (pinned, event)
        self._next = 0

    def __call__(self, batch, shape: Sequence[int], dtype: torch.dtype,
                 into: Optional[torch.Tensor] = None,
                 after: Optional["torch.cuda.Event"] = None) -> Staged:
        """Stage ``batch`` as a ``shape`` / ``dtype`` tensor: a new one, or
        ``into`` (on this device, written once the stream has passed
        ``after``, the event of the work that last read it)."""
        shape = tuple(shape)
        if into is not None and (tuple(into.shape) != shape or into.dtype != dtype):
            raise ValueError(f"staging {shape} {dtype} into {tuple(into.shape)} "
                             f"{into.dtype}")
        if self.device.type != "cuda":
            host = torch.empty(shape, dtype=dtype) if into is None else into
            fill_stacked(host.numpy(), batch)
            return Staged(host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(resolve_device(self.device))
        i, self._next = self._next, self._next ^ 1
        slot = self._slots[i]
        if slot is None or tuple(slot[0].shape) != shape or slot[0].dtype != dtype:
            pinned = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            pinned, last_copy = slot
            last_copy.synchronize()  # refill only once its last copy is done
        fill_stacked(pinned.numpy(), batch)
        with torch.cuda.stream(self._stream):
            if into is None:
                dev = torch.empty(shape, dtype=dtype, device=self.device)
            else:
                dev = into
                if after is not None:
                    self._stream.wait_event(after)
                # ``into`` was allocated on another stream (a graph's static
                # input: by the caching allocator before the capture, held by
                # the graph). record_stream is right for any block, a graph
                # pool's too: were it freed, the allocator would reuse it
                # only after the copy queued here is done.
                dev.record_stream(self._stream)
            dev.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[i] = (pinned, event)
        return Staged(dev, event)

    def settle(self) -> None:
        """Make the current stream wait for every copy queued so far."""
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host sync: on ``cuda``
    through a pinned copy (PyTorch's caching host allocator keeps the
    block until the copy is done); elsewhere a plain copy (none on the
    CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class Download:
    """Device outputs on their way to the host (see :class:`PinnedDownload`)."""

    host: Dict[str, torch.Tensor]
    event: Optional["torch.cuda.Event"] = None

    def wait(self) -> Dict[str, np.ndarray]:
        """Host arrays, once the copies are complete. On ``cuda`` they view
        a reused pinned buffer set, valid until the second download
        started after this one."""
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class PinnedDownload:
    """D2H copies of a batch's outputs into two reused sets of pinned host
    buffers on a copy stream; CPU tensors pass through."""

    def __init__(self):
        self._stream: Optional["torch.cuda.Stream"] = None
        self._slots: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._events: List[Optional["torch.cuda.Event"]] = [None, None]
        self._next = 0

    def start(self, tensors: Dict[str, torch.Tensor]) -> Download:
        """Queue the copies of ``tensors`` (outputs of work already queued
        on the current stream) and return at once."""
        first = next(iter(tensors.values()))
        if not first.is_cuda:
            return Download(dict(tensors))
        if self._stream is None:
            self._stream = torch.cuda.Stream(first.device)
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(first.device))
        self._stream.wait_event(produced)
        i, self._next = self._next, self._next ^ 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        slot = self._slots[i]
        with torch.cuda.stream(self._stream):
            for name, t in tensors.items():
                buf = slot.get(name)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = slot[name] = torch.empty(t.shape, dtype=t.dtype,
                                                   pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(self._stream)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[i] = event
        return Download({name: slot[name] for name in tensors}, event)
