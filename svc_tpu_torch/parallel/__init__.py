"""Frame-parallel splitting over several devices (counterpart of
``svc_tpu.parallel``)."""
