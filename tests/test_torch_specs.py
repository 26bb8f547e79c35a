"""The port's input shapes (``repro_torch.configs``) and input stand-ins
(``repro_torch/launch/specs.py``) against the JAX package's: the same
fields, and FakeTensors of the same shapes and dtypes as the JAX
``ShapeDtypeStruct``s, leaf by leaf."""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.launch import specs as jsp
from repro_torch.launch import specs as tsp

ARCHS = list(JC.ASSIGNED) + ["gpt3-96b", "llama-65b"]
# reduced shapes of each kind, small enough for the smoke configs
SMALL = [TC.InputShape("small_train", 64, 4, "train"),
         TC.InputShape("small_prefill", 48, 2, "prefill"),
         TC.InputShape("small_decode", 40, 3, "decode")]


def test_input_shapes_equal_field_by_field():
    assert [dataclasses.fields(TC.InputShape)[i].name for i in range(4)] == \
        [f.name for f in dataclasses.fields(JC.InputShape)]
    assert list(TC.INPUT_SHAPES) == list(JC.INPUT_SHAPES)
    for name, s in JC.INPUT_SHAPES.items():
        assert dataclasses.asdict(TC.INPUT_SHAPES[name]) == dataclasses.asdict(s)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equal(arch):
    for name in JC.INPUT_SHAPES:
        assert TC.shape_applicable(TC.get_config(arch), TC.INPUT_SHAPES[name]) \
            == JC.shape_applicable(JC.get_config(arch), JC.INPUT_SHAPES[name])


def _flat(tree, jax_side):
    """{path: (shape, dtype name)} of a tree of stand-ins."""
    if jax_side:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {tuple(str(getattr(e, "key", getattr(e, "name", e))) for e in p):
                (tuple(v.shape), np.dtype(v.dtype).name) for p, v in flat}
    out = {}

    def walk(t, prefix):
        if dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name), prefix + (f.name,))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            out[prefix] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


def _same(jtree, ttree):
    want, got = _flat(jtree, True), _flat(ttree, False)
    assert got == want


def _cfgs(arch, reduced):
    j, t = JC.get_config(arch), TC.get_config(arch)
    return (j.reduced(), t.reduced()) if reduced else (j, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_match_eval_shape_reduced(arch):
    """Every spec function at each input kind, at the smoke config."""
    jc, tc = _cfgs(arch, True)
    _same(jsp.param_specs(jc), tsp.param_specs(tc))
    _same(jsp.opt_specs(jsp.param_specs(jc)), tsp.opt_specs(tsp.param_specs(tc)))
    for shape in SMALL:
        jshape = JC.InputShape(**dataclasses.asdict(shape))
        _same(jsp.input_specs(jc, jshape), tsp.input_specs(tc, shape))
        _same(jsp.decode_input_specs(jc, jshape),
              tsp.decode_input_specs(tc, shape))
        _same(jsp.prefill_batch_specs(jc, jshape),
              tsp.prefill_batch_specs(tc, shape))


@pytest.mark.parametrize("arch", ["llama-65b", "granite-moe-1b-a400m"])
def test_stand_ins_match_eval_shape_full(arch):
    jc, tc = _cfgs(arch, False)
    _same(jsp.param_specs(jc), tsp.param_specs(tc))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        if TC.shape_applicable(tc, TC.INPUT_SHAPES[name]):
            _same(jsp.input_specs(jc, JC.INPUT_SHAPES[name]),
                  tsp.input_specs(tc, TC.INPUT_SHAPES[name]))


def test_stand_ins_allocate_nothing():
    """A full-size llama-65b's params (261 GB in fp32) as stand-ins: fake
    tensors of the specs' one mode."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch import tree as T
    leaves = T.leaves(tsp.param_specs(TC.get_config("llama-65b")))
    assert all(isinstance(t, FakeTensor) and t.fake_mode is tsp.fake_mode()
               for t in leaves)
    assert sum(t.numel() for t in leaves) * 4 > 2.5e11
