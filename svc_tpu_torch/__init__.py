"""svc_tpu_torch — the scalable video codec on PyTorch and CUDA.

A port of ``svc_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch with kernels
written by hand for NVIDIA Hopper (``sm_90a``). The module layout mirrors
``svc_tpu`` (``ops/``, ``models/``, ``apps/``, ``runtime/``) so every module
has an obvious counterpart, and ``svc_tpu`` stays the reference the port is
checked against.

What the port shares with ``svc_tpu`` instead of copying: the configs
(``svc_tpu.config``), the wire format (``svc_tpu.io.bitstream``), video I/O,
the CLI parser and the metrics — none of them imports JAX.

Conventions:

* every public entry takes an explicit ``device`` (``"cuda"`` by default);
  asking for ``cuda`` without a card raises instead of running on the CPU
  (``runtime.device``);
* each hand-written kernel (``csrc/*.cu``) has a plain PyTorch version in the
  same module. The wrapper takes the plain version only for tensors on the
  CPU; for a CUDA tensor it launches the kernel or raises;
* randomness comes from one explicit counter-based stream (``ops.prng``,
  threefry2x32 as in ``jax.random``), never torch's global generator.
"""

__version__ = "0.1.0"
