"""Command-line encoder and decoder (counterparts of ``svc_tpu.apps``)."""
