"""Launchers of the port (twins of the JAX package's ``repro/launch``)."""
