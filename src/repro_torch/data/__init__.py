"""The port's data pipelines."""
