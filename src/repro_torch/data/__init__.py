"""Synthetic data of the port (twin of the JAX package's ``repro/data``)."""
