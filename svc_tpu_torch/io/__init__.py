"""Host I/O layer of the port: the bitstream wire format and video file
access (the port's own copies of ``svc_tpu.io``)."""
