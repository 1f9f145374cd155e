"""The local-SGD worker chain (K6): CUDA kernel (csrc/local_sgd.cu), its
build and binding (build.py), the plain version (ref.py) and the wrapper
(ops.py)."""
