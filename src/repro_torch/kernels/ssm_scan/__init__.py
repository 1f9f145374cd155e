"""Selective scan (Mamba-1, K4): CUDA kernel (csrc/selective_scan.cu), the
plain version (ref.py) and the wrapper (ops.py)."""
