"""Workload configurations of the port (the paper's CoCoA/MNIST workload)."""
