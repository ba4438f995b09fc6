"""A batch function run as CUDA graphs: captured once per input shape,
replayed with one call.

``svc_tpu`` runs its encode batch as one compiled XLA program
(``jax.jit(self.encode_batch_fn)``, ``svc_tpu/models/encoder.py:160``).
The port's counterpart is :class:`GraphPair`: the eager batch function
captured into ``torch.cuda.CUDAGraph`` s and replayed, so a batch costs
the host one graph launch instead of thousands of kernel launches.

* **Warm-up and capture.** On first use the function runs once eagerly on
  a side stream (``torch.cuda.graph`` needs the lazy work of a first call
  — the kernel library's build and load, cuBLAS handles, per-device table
  caches — done outside the capture), then it is captured on that stream.
  ``capture_error_mode="thread_local"``: the stager and copy threads keep
  working while this thread captures; any sync or host copy inside the
  function still fails the capture, and the failure raises.
* **Static inputs and outputs.** Each call copies its inputs into the
  graphs' static inputs on the current stream (device to device), then
  replays there. The outputs are the graph's own tensors.
* **Two graphs, by turns.** A replay rewrites its outputs, and the
  streamed encoder copies batch ``i``'s outputs to the host on a copy
  stream while batch ``i + 1`` runs. So each shape gets two graphs, each
  with its own memory pool and outputs, taken by call parity: the outputs
  of call ``i`` stay untouched until call ``i + 2``. This costs a second
  capture and a second pool, and keeps the copy of batch ``i`` overlapping
  the compute of batch ``i + 1`` with no wait added on the compute stream
  (making each replay wait on the previous copy's event would serialize
  the two). A caller that keeps outputs past the next call copies them.
* **Launch counts.** A capture records its kernels' launches apart
  (:func:`svc_tpu_torch.kernels.build.captured_launches`); each replay adds
  them to the counters, since each replay launches every captured kernel
  once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from svc_tpu_torch.kernels import build

Outputs = Dict[str, torch.Tensor]


class GraphPair:
    """``fn(*inputs) -> {name: tensor}`` captured twice at the shapes and
    types of ``example_inputs`` (CUDA tensors on ``device``), replayed by
    turns; the first call's inputs also feed the warm-up."""

    def __init__(self, fn: Callable[..., Outputs],
                 example_inputs: Sequence[torch.Tensor], device: torch.device):
        self.device = torch.device(device)
        self.shapes = [(tuple(x.shape), x.dtype) for x in example_inputs]
        self._graphs: List[Tuple["torch.cuda.CUDAGraph", Outputs, Dict[str, int]]] = []
        self._next = 0
        with torch.cuda.device(self.device):
            self.inputs = [x.clone() for x in example_inputs]
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn(*self.inputs)  # warm-up: its launches are real ones
            torch.cuda.current_stream(self.device).wait_stream(side)
            for _ in range(2):
                graph = torch.cuda.CUDAGraph()
                with build.captured_launches() as counts:
                    with torch.cuda.graph(graph, stream=side,
                                          capture_error_mode="thread_local"):
                        out = fn(*self.inputs)
                self._graphs.append((graph, out, dict(counts)))

    def __call__(self, *inputs: torch.Tensor) -> Outputs:
        """Copy ``inputs`` into the static inputs and replay the graph of
        this call's parity, both on the current stream."""
        got = [(tuple(x.shape), x.dtype) for x in inputs]
        if got != self.shapes:
            raise ValueError(f"graph captured for {self.shapes}, called with {got}")
        with torch.cuda.device(self.device):
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            graph, out, counts = self._graphs[self._next]
            self._next ^= 1
            graph.replay()
        build.add_launches(counts)
        return dict(out)

    def launches_per_replay(self) -> Dict[str, int]:
        """The kernel launches one replay makes, by kernel name."""
        return dict(self._graphs[0][2])
