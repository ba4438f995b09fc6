"""Command-line encoder and decoder (counterparts of ``svc_tpu.apps``)."""

UNSUPPORTED = "not yet supported by svc_tpu_torch"
