"""Checkpoints of the port (twin of the JAX package's ``repro/checkpoint``)."""
