"""The port's own copies of the JAX package's framework-free core: notation,
schedule kinds, compiled plans (``plan.run``, the one dispatch loop), the
memory model, BPipe pairing, the paper's estimator, FLOP counts and the
discrete-event simulator, each held equal to its twin by
``tests/test_torch_core.py``; and the port-only ``h100`` constants."""
