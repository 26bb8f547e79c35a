"""Transfers of stash units: ``channel`` (a copy of the JAX package's channel
vocabulary, held equal by ``tests/test_torch_core.py``) and ``runtime`` (the
bounded-depth tracking of the executor's real copies, on CUDA events)."""
