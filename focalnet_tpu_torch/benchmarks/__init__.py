"""Benchmarks of the port (counterparts of the repository's ``benchmarks/``
that hold a TPU kernel)."""
