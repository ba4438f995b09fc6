"""Codec operators on torch tensors (counterparts of ``svc_tpu.ops``)."""
