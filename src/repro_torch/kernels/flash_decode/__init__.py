"""Flash decode: paged (K2, csrc/paged_decode.cu) and contiguous (K5,
csrc/flash_decode.cu) CUDA kernels, their plain versions (ref.py) and the
wrappers (ops.py)."""
