"""Gradient compression with error feedback (the port of
``repro/compression``)."""
