"""The port's own copies of the JAX package's framework-free schedule layer:
notation, schedule kinds, compiled plans (``plan.run``, the one dispatch
loop) and the memory model. Each is held equal to its twin by
``tests/test_torch_core.py``."""
