"""Blocked causal flash-attention forward (K3): CUDA kernel
(csrc/flash_fwd.cu), the plain version (ref.py) and the wrappers (ops.py)."""
