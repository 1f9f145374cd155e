"""PyTorch/CUDA port of the Hemingway reproduction.

Mirrors the layout of the JAX package ``repro`` and imports nothing of it.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.
"""
