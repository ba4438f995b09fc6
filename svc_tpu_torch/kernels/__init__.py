"""Build and bind the hand-written CUDA kernels (``svc_tpu_torch/csrc``)."""
