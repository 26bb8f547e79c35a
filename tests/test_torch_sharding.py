"""The port's sharding rules (``repro_torch/sharding/rules.py``) against the
JAX package's (``repro/sharding/rules.py``), spec for spec.

The JAX side takes ``tests/test_substrate.py``'s ``_FakeMesh`` (a ``shape``
dict and ``axis_names``); the port's mesh is a ``DeviceMesh`` of a fake
process group of 256 or 512 ranks in this process, made and torn down by
each test. Params, batches and decode states are each side's own
stand-ins: JAX ``eval_shape``s and the port's ``launch/specs.py``.
"""
import functools

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jsp
from repro.sharding import rules as J
from repro_torch.configs import get_config
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules as R

ARCHS = list(ASSIGNED) + ["gpt3-96b", "llama-65b"]
MESHES = ["single", "multi"]


class _FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


JMESH = {"single": _FakeMesh(data=16, model=16),
         "multi": _FakeMesh(pod=2, data=16, model=16)}


@pytest.fixture
def mesh(request):
    """The port's production mesh of ``request.param`` on a fake world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    kind = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if kind == "multi" else 256)
    try:
        yield kind, make_production_mesh(multi_pod=kind == "multi",
                                         device_type="cpu")
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _param_stand_ins(arch):
    return jsp.param_specs(jget_config(arch)), tsp.param_specs(get_config(arch))


def _jax_by_path(tree):
    """{path of keys: leaf} of a JAX tree whose leaves may be specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(getattr(e, "key", getattr(e, "name", e))) for e in p): v
            for p, v in flat}


def _port_by_path(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_by_path(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _equal_specs(jspecs, tspecs):
    want, got = _jax_by_path(jspecs), _port_by_path(tspecs)
    assert set(got) == set(want)
    bad = {p: (tuple(want[p]), tuple(got[p])) for p in want
           if tuple(want[p]) != tuple(got[p])}
    assert not bad, bad
    return got


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    kind, tmesh = mesh
    jp, tp = _param_stand_ins(arch)
    J.RELOCATIONS.clear()
    R.RELOCATIONS.clear()
    got = _equal_specs(J.param_specs(jp, JMESH[kind]), R.param_specs(tp, tmesh))
    assert R.RELOCATIONS == J.RELOCATIONS
    # every spec round-trips through DTensor placements
    for spec in got.values():
        assert R.to_spec(R.to_placements(spec, tmesh), tmesh) == _normal(spec)


def _normal(spec):
    """A spec as ``to_spec`` writes it: no trailing None."""
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return R.P(*entries)


@pytest.mark.parametrize("mesh", MESHES, indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    """Train and prefill batches at train_4k / prefill_32k, and the decode
    state at decode_32k under each cache strategy."""
    kind, tmesh = mesh
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jm = JMESH[kind]
    for fn in ("train_batch_specs", "prefill_batch_specs"):
        shape = INPUT_SHAPES["prefill_32k" if "prefill" in fn else "train_4k"]
        got = _equal_specs(J.batch_specs(getattr(jsp, fn)(jcfg, shape), jm),
                           R.batch_specs(getattr(tsp, fn)(tcfg, shape), tmesh))
        for spec in got.values():
            assert R.to_spec(R.to_placements(spec, tmesh), tmesh) == _normal(spec)
    shape = INPUT_SHAPES["decode_32k"]
    jstate = jsp.decode_state_specs(jcfg, shape)
    tstate = tsp.decode_state_specs(tcfg, shape)
    for strategy in ("heads", "seq", "auto"):
        J.RELOCATIONS.clear()
        R.RELOCATIONS.clear()
        _equal_specs(J.cache_specs(jstate, jm, strategy, jcfg),
                     R.cache_specs(tstate, tmesh, strategy, tcfg))
        assert R.RELOCATIONS == J.RELOCATIONS


@pytest.mark.parametrize("mesh", ["multi"], indirect=True)
@pytest.mark.parametrize("dims", [[1], [16], [40, 128], [24, 5, 8],
                                  [256_000, 3], [3, 2, 16, 5], [8, 40, 256_000]])
def test_legalize_equals_the_reference(dims, mesh):
    """The twin of ``test_legalize_always_divides``, on the port and against
    the reference's result, for each leading axis entry."""
    _, tmesh = mesh
    for entry in ("model", ("pod", "data"), "data"):
        spec = [entry] + [None] * (len(dims) - 1)
        J.RELOCATIONS.clear()
        R.RELOCATIONS.clear()
        got = R.legalize(R.P(*spec), tuple(dims), tmesh, tag="t")
        want = J.legalize(JP(*spec), tuple(dims), JMESH["multi"], tag="t")
        assert tuple(got) == tuple(want)
        assert R.RELOCATIONS == J.RELOCATIONS
        for d, e in enumerate(got):
            if e is not None:
                assert dims[d] % R._axis_size(tmesh, e) == 0


@pytest.mark.parametrize("mesh", ["single"], indirect=True)
def test_moe_experts_shard_over_model(mesh):
    _, tmesh = mesh
    specs = R.param_specs(_param_stand_ins("granite-moe-1b-a400m")[1], tmesh)
    assert specs["blocks"]["pos0"]["ffn"]["wi"][1] == "model"
    pl = R.to_placements(specs["blocks"]["pos0"]["ffn"]["wi"], tmesh)
    assert [str(p) for p in pl] == ["R", "S(1)"]


@pytest.mark.parametrize("mesh", ["single"], indirect=True)
def test_cache_auto_policy(mesh):
    """Split-KV (seq-sharded cache) for GQA archs (gemma2); head-sharding
    for MHA (qwen1.5-32b), as the reference's policy."""
    _, tmesh = mesh

    def kv_spec(arch):
        cfg = get_config(arch)
        st_ = tsp.decode_state_specs(cfg, INPUT_SHAPES["decode_32k"])
        layer = R.cache_specs(st_, tmesh, strategy="auto", cfg=cfg)
        layer = layer["pos0" if "pos0" in layer else "rem0"]
        while "k" not in layer:
            layer = next(iter(layer.values()))
        return layer["k"]

    gem = kv_spec("gemma2-9b")
    assert gem[2] == "model" and (len(gem) <= 3 or gem[3] is None)
    qw = kv_spec("qwen1.5-32b")
    assert len(qw) <= 2 or qw[2] != "model"


def test_vocab_shard_range_and_spec_equal_the_reference():
    """The twins of ``tests/test_vocab.py:283-308``."""
    for vocab, p in ((151_936, 8), (32_000, 4), (7, 3)):
        for vp in range(1, p + 2):
            for side in ("embed", "head"):
                spans = [R.vocab_shard_range(i, p, vp, vocab, side)
                         for i in range(p)]
                assert spans == [J.vocab_shard_range(i, p, vp, vocab, side)
                                 for i in range(p)]
                held = [s for s in spans if s != (0, 0)]
                assert held[0][0] == 0 and held[-1][1] == vocab
                assert all(a[1] == b[0] for a, b in zip(held, held[1:]))
    with pytest.raises(ValueError):
        R.vocab_shard_range(0, 8, 1, 100, "logits")
    for name in ("table", "unembed"):
        for vp in (1, 4):
            assert tuple(R.vocab_param_spec(name, vp)) \
                == tuple(J.vocab_param_spec(name, vp))
    with pytest.raises(KeyError):
        R.vocab_param_spec("wq", 4)


@pytest.mark.parametrize("mesh", ["multi"], indirect=True)
def test_to_placements_orders_and_refuses(mesh):
    from torch.distributed.tensor import Replicate, Shard
    _, tmesh = mesh
    assert R.to_placements(R.P(("pod", "data"), None, "model"), tmesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert R.to_placements(R.P(), tmesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        R.to_placements(R.P(("data", "pod")), tmesh)
    with pytest.raises(ValueError, match="twice"):
        R.to_placements(R.P("model", "model"), tmesh)


@pytest.mark.parametrize("mesh", ["single"], indirect=True)
def test_maybe_constrain_and_local_slices(mesh):
    """Outside ``set_mesh`` and on a plain tensor ``maybe_constrain`` gives
    its input back; inside, a DTensor takes the legalized spec (an axis the
    mesh lacks dropped, a dim that does not divide left whole); the rank
    holds the slices ``local_slices`` names."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    _, tmesh = mesh
    x = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    assert R.maybe_constrain(x, "data", "model") is x
    d = distribute_tensor(x, tmesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    assert R.maybe_constrain(d, "model") is d
    with R.set_mesh(tmesh):
        assert R.current_mesh() is tmesh
        assert R.maybe_constrain(x, "model") is x
        y = R.maybe_constrain(d, ("pod", "data"), "model")
        assert tuple(y.placements) == (Shard(0), Shard(1))
        z = R.maybe_constrain(d, None, ("pod", "data"))
        assert tuple(z.placements) == (Shard(1), Replicate())
        assert tuple(R.maybe_constrain(d, "model", None, None).placements) \
            == (Replicate(), Shard(0))
    assert R.current_mesh() is None
    assert R.local_slices(x.shape, tmesh, y.placements) == (slice(0, 2),
                                                          slice(0, 3))
    assert torch.equal(y.to_local(), x[R.local_slices(x.shape, tmesh,
                                                      y.placements)])


@pytest.mark.parametrize("mesh", ["single"], indirect=True)
def test_flash_placements_shard_rows_where_heads_do_not_divide(mesh):
    """q/k/v enter the attention with their batch shard; a head shard stays
    where the kv heads divide "model"; otherwise "model" shards the batch
    rows further where they divide it (qwen1.5-32b's 40/8 heads over 16),
    and only rows that do not divide are replicated."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.attention import _flash_placements
    _, tmesh = mesh

    def dt(b, n, placements):
        return distribute_tensor(torch.zeros(b, 1, n, 16), tmesh, placements,
                                 src_data_rank=None)

    heads = [Shard(0), Shard(2)]
    assert _flash_placements(dt(256, 32, heads), dt(256, 16, heads)) == (
        Shard(0), Shard(2))
    relocated = [Shard(0), Shard(3)]  # heads moved onto head_dim
    assert _flash_placements(dt(256, 40, relocated), dt(256, 8, heads)) == (
        Shard(0), Shard(0))
    assert _flash_placements(dt(256, 40, [Shard(0), Replicate()]),
                             dt(256, 8, [Shard(0), Replicate()])) == (
        Shard(0), Shard(0))
    assert _flash_placements(dt(32, 40, relocated), dt(32, 8, heads)) == (
        Shard(0), Replicate())
