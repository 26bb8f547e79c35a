"""The event schema of a traced step: ``events`` is a copy of the JAX
package's (held equal by ``tests/test_torch_core.py``), so one span format
serves both executors."""
