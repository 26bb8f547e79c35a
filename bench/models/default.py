"""The model module of a configuration that names none (``bench/spec.py``
has the contract): a decoder-only Transformer of global-attention layers
with a dense or MoE FFN, every layer a row of ``blocks/pos0``.

Its functions are the harness's own: the layout of ``bench/inputs.py``
(which refuses what ``reference.py`` cannot compute), the plain reference
of ``bench/reference.py`` and the FLOP count of ``bench/flops.py``."""
from bench.flops import flops_per_token  # noqa: F401
from bench.inputs import leaf_names, leaf_of, param_shapes  # noqa: F401
from bench.reference import leaf_grads, loss_only  # noqa: F401
