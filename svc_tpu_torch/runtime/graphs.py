"""A batch function run as CUDA graphs: captured once per input shape,
replayed with one call.

``svc_tpu`` runs its encode and decode batches each as one compiled XLA
program per batch shape (``jax.jit``: ``svc_tpu/models/encoder.py:160``,
``svc_tpu/models/decoder.py:100-145``). The port's counterpart is
:class:`GraphPair`: the eager batch function captured into
``torch.cuda.CUDAGraph`` s and replayed, so a batch costs the host one
graph launch instead of one launch per kernel and glue operation.

* **Warm-up and capture.** On first use the function runs once eagerly on
  a side stream (``torch.cuda.graph`` needs the lazy work of a first call
  — the kernel library's build and load, cuBLAS handles, per-device table
  caches — done outside the capture), then it is captured on that stream.
  ``capture_error_mode="thread_local"``: the stager and copy threads keep
  working while this thread captures; any sync or host copy inside the
  function still fails the capture, and the failure raises.
* **Static inputs and outputs.** Each graph has its own static inputs and
  outputs. A call copies its inputs into those of its graph on the current
  stream (device to device), then replays there; an input that already is
  that static input is not copied (*Inputs written in place*). The outputs
  are the graph's own tensors.
* **Two graphs, by turns.** A replay rewrites its outputs, and the
  streamed encoder copies batch ``i``'s outputs to the host on a copy
  stream while batch ``i + 1`` runs. So each shape gets two graphs, each
  with its own memory pool and outputs, taken by call parity: the outputs
  of call ``i`` stay untouched until call ``i + 2``. This costs a second
  capture and a second pool, and keeps the copy of batch ``i`` overlapping
  the compute of batch ``i + 1`` with no wait added on the compute stream
  (making each replay wait on the previous copy's event would serialize
  the two). A caller that keeps outputs past the next call copies them.
* **Inputs written in place.** A caller may :meth:`GraphPair.claim` the
  static inputs of the next call not yet claimed, ``k``, and write them
  itself: the streamed decoder copies its coefficients from pinned memory
  straight into the graph's input, one H2D copy where a copy into the
  static input would add a device-to-device one of the same size. The
  claim carries the event recorded after the replay that last read those
  inputs, call ``k - 2``; the writer's stream waits on it first. Call
  ``k`` then passes the claimed tensors themselves, which are not copied.
  At most one call is claimed ahead of the next replay: the streamed
  decoder's one batch staged while one computes.
* **Launch counts.** A capture records its kernels' launches apart
  (:func:`svc_tpu_torch.kernels.build.captured_launches`); each replay adds
  them to the counters, since each replay launches every captured kernel
  once.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from svc_tpu_torch.kernels import build

Outputs = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Claim:
    """The static inputs of call ``call``, handed to a caller who writes
    them in place, and the event recorded after the replay that last read
    them (None before the third call)."""

    call: int
    inputs: List[torch.Tensor]
    last_read: Optional["torch.cuda.Event"]


@dataclasses.dataclass
class _Slot:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]
    out: Outputs
    counts: Dict[str, int]


class GraphPair:
    """``fn(*inputs) -> {name: tensor}`` captured twice at the shapes and
    types of ``example_inputs`` (CUDA tensors on ``device``), replayed by
    turns; the example inputs also feed the warm-up."""

    def __init__(self, fn: Callable[..., Outputs],
                 example_inputs: Sequence[torch.Tensor], device: torch.device):
        self.device = torch.device(device)
        self.shapes = [(tuple(x.shape), x.dtype) for x in example_inputs]
        self._slots: List[_Slot] = []
        self._last_read: List[Optional["torch.cuda.Event"]] = [None, None]
        self._calls = 0  # replays issued
        self._claimed = 0  # every call below this one has been claimed
        self._lock = threading.Lock()  # claims come from a stager thread
        with torch.cuda.device(self.device):
            inputs = [[x.clone() for x in example_inputs] for _ in range(2)]
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn(*inputs[0])  # warm-up: its launches are real ones
            torch.cuda.current_stream(self.device).wait_stream(side)
            for static in inputs:
                graph = torch.cuda.CUDAGraph()
                with build.captured_launches() as counts:
                    with torch.cuda.graph(graph, stream=side,
                                          capture_error_mode="thread_local"):
                        out = fn(*static)
                self._slots.append(_Slot(graph, static, out, dict(counts)))

    def claim(self) -> Claim:
        """The static inputs of the next call not yet claimed, for the
        caller to write in place, from any thread: its writes wait on
        ``last_read`` first, and that call passes the claimed tensors."""
        with self._lock:
            k = max(self._claimed, self._calls)
            if k > self._calls + 1:
                raise RuntimeError(
                    f"call {k - 1} is claimed and not replayed yet; at most "
                    "one call may be claimed ahead")
            self._claimed = k + 1
            return Claim(k, self._slots[k % 2].inputs, self._last_read[k % 2])

    def release(self) -> None:
        """Drop the claims of calls not replayed (a stream that ended
        early). The caller first makes the current stream wait for any
        write still going into them."""
        with self._lock:
            self._claimed = self._calls

    def __call__(self, *inputs: torch.Tensor) -> Outputs:
        """Replay the graph of this call's parity on the current stream,
        after copying in each input that is not its static input."""
        got = [(tuple(x.shape), x.dtype) for x in inputs]
        if got != self.shapes:
            raise ValueError(f"graph captured for {self.shapes}, called with {got}")
        # under the lock: a claim of call k + 2 must see this call's event
        with self._lock:
            k = self._calls
            slot, other = self._slots[k % 2], self._slots[(k + 1) % 2]
            in_place = [x is s for x, s in zip(inputs, slot.inputs)]
            if any(x is s for x, s in zip(inputs, other.inputs)):
                raise ValueError(
                    f"call {k} was given the static inputs of call {k + 1}")
            if self._claimed > k and not any(in_place):
                raise RuntimeError(
                    f"call {k}'s static inputs are claimed but were not passed")
            if any(in_place) and self._claimed <= k:
                raise RuntimeError(
                    f"call {k} was given its static inputs without a claim")
            with torch.cuda.device(self.device):
                for static, x, skip in zip(slot.inputs, inputs, in_place):
                    if not skip:
                        static.copy_(x)
                slot.graph.replay()
                read = torch.cuda.Event()
                read.record(torch.cuda.current_stream(self.device))
            self._last_read[k % 2] = read
            self._calls = k + 1
        build.add_launches(slot.counts)
        return dict(slot.out)

    def launches_per_replay(self) -> Dict[str, int]:
        """The kernel launches one replay makes, by kernel name."""
        return dict(self._slots[0].counts)
