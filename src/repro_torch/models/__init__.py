"""Model layers of the port (twins of the JAX package's ``repro/models``)."""
