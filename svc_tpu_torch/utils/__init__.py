"""Utility layer of the port: scalar math helpers, error types, CLI parsing
(the port's own copies of ``svc_tpu.utils``)."""
