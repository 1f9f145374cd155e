"""Paged flash decode (K2): CUDA kernel (csrc/paged_decode.cu), the plain
versions ``stream`` and ``gather`` (ref.py) and the wrappers (ops.py)."""
