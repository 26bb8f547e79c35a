"""Step factories of the port (twins of the JAX package's ``repro/train``)."""
