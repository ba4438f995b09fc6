"""Encoder and decoder pipelines (counterparts of ``svc_tpu.models``)."""
