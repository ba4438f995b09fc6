"""Tracing and profiling (``svc_tpu/runtime/tracing.py``, on torch).

* ``Tracer`` — wall-clock host span recorder with JSON export and
  per-stage aggregate stats (count/total/mean/max). The streaming loops
  record ``parse``, ``device_dispatch``, ``device_fetch`` and
  ``serialize``, the same span names as ``svc_tpu``;
* ``device_profile`` — a ``torch.profiler`` window whose Chrome trace
  (host ops, and the card's kernels and copies on ``cuda``) lands in a
  directory; a no-op without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

from svc_tpu_torch.runtime.device import DeviceLike

TRACE_FILE = "trace.json"  # device_profile's Chrome trace, inside log_dir


class Tracer:
    """Wall-clock span recorder.

    >>> tracer = Tracer()
    >>> with tracer.span("encode"):
    ...     pass
    >>> tracer.stats()["encode"]["count"]
    1
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append(
                {
                    "name": name,
                    "start_s": t0,
                    "duration_s": time.perf_counter() - t0,
                    **attrs,
                }
            )

    def stats(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0}
        )
        for e in self.events:
            s = agg[e["name"]]
            s["count"] += 1
            s["total_s"] += e["duration_s"]
            s["max_s"] = max(s["max_s"], e["duration_s"])
        for s in agg.values():
            s["mean_s"] = s["total_s"] / max(s["count"], 1)
        return dict(agg)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"events": self.events, "stats": self.stats()}, f, indent=2)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name:24s} n={s['count']:<5d} total={s['total_s']:8.3f}s "
                f"mean={s['mean_s'] * 1000:8.2f}ms max={s['max_s'] * 1000:8.2f}ms"
            )
        return "\n".join(lines)


def span(tracer: Optional[Tracer], name: str, **attrs):
    """``tracer.span(name, ...)``, or a null context without a tracer."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **attrs)


@contextlib.contextmanager
def device_profile(log_dir: Optional[str], device: DeviceLike = "cuda") -> Iterator[None]:
    """Profile the enclosed work with ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace.json``: CPU and CUDA activity for a
    ``cuda`` device, CPU activity only for ``cpu``. Without ``log_dir``
    it records nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
