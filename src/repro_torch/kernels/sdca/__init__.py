"""The CoCoA local SDCA inner loop: CUDA kernel (csrc/sdca.cu), its build
and binding (build.py), the plain version (ref.py) and the wrapper (ops.py)."""
