"""Optimizer of the port (twin of the JAX package's ``repro/optim``)."""
