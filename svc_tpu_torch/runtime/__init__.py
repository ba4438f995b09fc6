"""Device resolution for the port (counterpart of ``svc_tpu.runtime``)."""
