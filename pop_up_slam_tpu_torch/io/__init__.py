"""Sequence I/O: the TUM format, its PNGs, and the synthetic plane world."""
