"""Sharding rules of the port: the JAX package's ``PartitionSpec`` rules as
DTensor placements over a ``DeviceMesh`` (``sharding/rules.py``)."""
