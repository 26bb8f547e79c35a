"""Logical sharding rules: param/batch/cache trees -> spec trees -> DTensor
placements. The twin of the JAX package's ``repro/sharding/rules.py``.

Production mesh axes (``launch/mesh.py``): ("data", "model") single-pod or
("pod", "data", "model") multi-pod. Batch shards over pod+data; weight
matrices shard their wide dimension over "model" (Megatron-style tensor
parallelism, the paper's t axis); MoE experts shard over "model" (expert
parallelism); KV caches shard batch over data and kv-heads over "model".

A spec (``P``) is the port's twin of ``PartitionSpec``: a tuple with one
entry per leading tensor dim, each ``None``, a mesh axis name or a tuple of
names. Leaf rules key off the parameter NAME (the last key of its path in
the port's nested dicts, ``repro_torch/tree.py``) and are padded with
leading ``None`` for stacked-layer dims, as in the twin. Axis sizes are read
from the ``DeviceMesh`` by name (its ``mesh_dim_names``).

``to_placements`` turns a spec into one placement per mesh dim: ``Shard(d)``
where the spec names that mesh axis at tensor dim d, else ``Replicate()``.
A dim over ("pod", "data") is sharded on both mesh dims in mesh order, the
same major-to-minor order as the twin. ``distribute`` turns a tree of
tensors into DTensors; ``maybe_constrain`` redistributes a DTensor inside
``set_mesh(mesh)``, the twin of ``with_sharding_constraint`` under
``compat.set_mesh``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

M = "model"


class P(tuple):
    """A partition spec: ``P(None, "model")``; equal to the tuple of its
    entries, as ``PartitionSpec`` is, whose normalisation it shares: a
    one-axis tuple entry is that axis, an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else tuple(e) or None)
            if isinstance(e, (tuple, list)) else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# name -> spec for the *trailing* dims of the leaf.
_PARAM_RULES = {
    # embeddings
    "table": (M, None),          # (vocab, d)
    "unembed": (None, M),        # (d, vocab)
    # attention
    "wq": (None, M, None),       # (d, heads, hd)
    "wk": (None, M, None),
    "wv": (None, M, None),
    "wo": (M, None, None),       # (heads, hd, d) — also matches mlstm/slstm
    "bq": (M, None),
    "bk": (M, None),
    "bv": (M, None),
    # dense mlp (wi/wg: (d, f); wo handled by ndim fallback below)
    "wi": (None, M),
    "wg": (None, M),
    # moe (experts lead): router replicated
    "router": (None, None),
    # recurrent (rglru)
    "in_x": (None, M),
    "in_g": (None, M),
    "out": (M, None),
    "wa": (None, M),
    "wx": (None, M),
    "ba": (M,),
    "bx": (M,),
    "lam": (M,),
    "conv_w": (None, M),
    "conv_b": (M,),
    # xlstm
    "wif": (None, M, None),      # (d, nh, 2)
    "bif": (M, None),
    "wog": (None, M, None),
    "w": (None, None, M, None),  # slstm (4, d, nh, hd)
    "r": (None, M, None, None),  # slstm (4, nh, hd, hd)
    "b": (None, M, None),        # slstm (4, nh, hd)
    # norms
    "scale": (None,),
    "bias": (None,),
}

# Experts-leading MoE weights override by ndim: (E, d, f)/(E, f, d)
_MOE_3D = {"wi": (M, None, None), "wg": (M, None, None), "wo": (M, None, None)}

# ---------------------------------------------------------------------------
# Vocabulary-parallel stage scatter (docs/memory.md "Vocab accounting")
# ---------------------------------------------------------------------------
# The mesh has no pipeline axis (stages are separate programs), so
# scattering the embedding table / LM head over pipeline stages is a
# per-stage ROW RANGE plus a within-shard spec. With the vocab dim consumed
# by the stage scatter, the tensor-parallel "model" axis moves to the other
# (d_model) dim — the vp=1 rules above keep it on vocab.
_VOCAB_STAGE_RULES = {
    "table": (None, M),          # (vocab/vp, d): stage-scattered rows
    "unembed": (M, None),        # (d, vocab/vp): stage-scattered cols
}


def vocab_shard_range(stage: int, p: int, vocab_parallel: int, vocab: int,
                      side: str = "embed") -> Tuple[int, int]:
    """Vocab row range ``[lo, hi)`` stage ``stage`` holds of the
    embedding table (``side="embed"`` — scattered over the FIRST vp
    stages) or the LM head (``side="head"`` — over the LAST vp stages).
    ``(0, 0)`` for non-participating stages; the ranges of the
    participating stages tile ``[0, vocab)`` exactly. At
    ``vocab_parallel=1`` the owner stage holds every row — the classic
    boundary-stage layout the memory model charges."""
    if side not in ("embed", "head"):
        raise ValueError(f"side must be 'embed' or 'head', got {side!r}")
    vp = max(1, min(vocab_parallel, p))
    r = stage if side == "embed" else stage - (p - vp)
    if not 0 <= r < vp:
        return (0, 0)
    return (r * vocab // vp, (r + 1) * vocab // vp)


def vocab_param_spec(name: str, vocab_parallel: int = 1) -> P:
    """Within-shard spec for ``table``/``unembed`` under a vocab-parallel
    stage scatter: vp > 1 hands the vocab dim to the stage scatter and
    moves the "model" axis to the d_model dim."""
    if name not in _VOCAB_STAGE_RULES:
        raise KeyError(f"no vocab rule for {name!r}; "
                       f"known: {sorted(_VOCAB_STAGE_RULES)}")
    rule = (_VOCAB_STAGE_RULES if vocab_parallel > 1
            else _PARAM_RULES)[name]
    return P(*rule)


def _leaf_name(path) -> str:
    return str(path[-1]) if path else ""


def _in_moe(path) -> bool:
    names = [str(e) for e in path]
    return "ffn" in names and "shared" not in names


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh order."""
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


# Relocations performed by legalize(); launchers surface these because a
# silent head->head_dim relocation was measured costing 100x in prefill
# collectives in the JAX twin (its partitioner replicates the s^2 work).
RELOCATIONS: list = []


def legalize(spec, shape, mesh, tag: str = "") -> P:
    """Explicit shardings must divide evenly. For each sharded dim that
    doesn't divide, relocate the axis to the next unsharded dim that does
    (e.g. 40 heads on 16 model ranks -> shard head_dim instead); else
    replicate it. Every relocation is recorded in RELOCATIONS — on
    attention head dims it is a measured 10-100x collective hazard (pick
    TP | num_heads!)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        size = _axis_size(mesh, entry)
        if shape[d] % size == 0:
            continue
        entries[d] = None
        for d2 in range(len(shape) - 1, -1, -1):
            if entries[d2] is None and shape[d2] % size == 0 and d2 != d:
                entries[d2] = entry
                RELOCATIONS.append((tag, tuple(shape), d, d2, entry))
                break
        else:
            RELOCATIONS.append((tag, tuple(shape), d, None, entry))
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def param_spec(path, leaf, mesh=None, moe_axis: str = M) -> P:
    name = _leaf_name(path)
    base: Tuple = _PARAM_RULES.get(name, ())
    trailing = leaf.ndim - _lead_pad(path)
    if name in _MOE_3D and _in_moe(path) and trailing == 3:
        # experts-leading (E, d, f)/(E, f, d). moe_axis="model" = expert
        # parallel (activations all-to-all); moe_axis="data" = ZeRO-3
        # style weight sharding (weights gathered per layer).
        base = tuple(moe_axis if e == M else e for e in _MOE_3D[name])
    if name == "wo" and trailing == 2:
        base = (M, None)  # dense mlp wo: (f, d)
    pad = leaf.ndim - len(base)
    if pad < 0:  # scalar-ish leaf, replicate
        return P()
    spec = P(*([None] * pad + list(base)))
    if mesh is not None:
        spec = legalize(spec, leaf.shape, mesh, tag=name)
    return spec


def _lead_pad(path) -> int:
    """Stacked-layer leading dims: 1 if under blocks['pos*'] (scan stack)."""
    return int(any(str(e).startswith("pos") for e in path))


def _map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a nested dict, visiting keys in sorted order
    as ``jax.tree`` does (so ``RELOCATIONS`` fills in the twin's order)."""
    return {k: _map_with_path(fn, tree[k], prefix + (k,))
            if isinstance(tree[k], dict) else fn(prefix + (k,), tree[k])
            for k in sorted(tree)}


def param_specs(params, mesh=None, moe_axis: str = M) -> Any:
    return _map_with_path(lambda p, l: param_spec(p, l, mesh, moe_axis),
                          params)


def param_shardings(params, mesh, moe_axis: str = M) -> Any:
    return _map_with_path(
        lambda p, l: to_placements(param_spec(p, l, mesh, moe_axis), mesh),
        params)


# ---------------------------------------------------------------------------
# Batch / cache
# ---------------------------------------------------------------------------
def batch_axes(mesh) -> Tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def batch_specs(batch, mesh) -> Any:
    ba = batch_axes(mesh)
    return _map_with_path(
        lambda p, leaf: legalize(P(*([ba] + [None] * (leaf.ndim - 1))),
                                 leaf.shape, mesh), batch)


def batch_shardings(batch, mesh) -> Any:
    return _map_with_path(lambda p, s: to_placements(s, mesh),
                          batch_specs(batch, mesh))


_CACHE_RULES = {
    "k": (None, None, M, None),     # (b, n, kv, hd)
    "v": (None, None, M, None),
    "pos": (None, None),            # (b, n)
    "h": (None, M),                 # rglru state (b, w)
    "conv": (None, None, M),        # (b, cw-1, w)
    "C": (None, M, None, None),     # mlstm (b, nh, hd, hd)
    "n": (None, M, None),           # (b, nh, hd)
    "m": (None, M),                 # (b, nh)
    "c": (None, M, None),           # slstm
}
_SLSTM_STATE = {"h": (None, M, None), "n": (None, M, None), "m": (None, M, None)}


# strategy "seq": shard the KV cache's sequence dim over "model" instead
# of kv-heads — flash-decoding-style split-KV (the lever for the
# collective-bound decode combos, where few kv heads force the legalizer
# onto head_dim).
_CACHE_RULES_SEQ = {
    "k": (None, M, None, None),
    "v": (None, M, None, None),
    "pos": (None, M),
}


def cache_spec(path, leaf, mesh, strategy: str = "heads", cfg=None) -> P:
    ba = batch_axes(mesh)
    name = _leaf_name(path)
    rules_tbl = dict(_CACHE_RULES)
    if strategy == "auto":
        # the twin's measured policy: under GQA a kv broadcast across a
        # sharded head/head_dim axis rematerializes the cache -> split-KV
        # (seq sharding); for MHA the classic head/hd sharding wins on memory.
        gqa = cfg is not None and cfg.num_heads != cfg.num_kv_heads
        strategy = "seq" if gqa else "heads"
    if strategy == "seq":
        rules_tbl.update(_CACHE_RULES_SEQ)
    base = rules_tbl.get(name, ())
    # slstm h/n/m are (b, nh, hd): disambiguate by rank
    if name in _SLSTM_STATE and leaf.ndim - _lead_pad(path) == 3:
        base = _SLSTM_STATE[name]
    pad = leaf.ndim - len(base)
    if pad < 0:
        return P()
    spec = [None] * pad + list(base)
    # batch dim is the first dim after any stack padding
    spec[_lead_pad(path)] = ba if ba else None
    return legalize(P(*spec), leaf.shape, mesh)


def cache_specs(cache, mesh, strategy: str = "heads", cfg=None) -> Any:
    return _map_with_path(lambda p, l: cache_spec(p, l, mesh, strategy, cfg),
                          cache)


def cache_shardings(cache, mesh, strategy: str = "heads", cfg=None) -> Any:
    return _map_with_path(lambda p, s: to_placements(s, mesh),
                          cache_specs(cache, mesh, strategy, cfg))


# ---------------------------------------------------------------------------
# Specs <-> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where ``spec`` names that
    mesh axis at tensor dim d, else ``Replicate()``. A tuple entry shards
    its dim over each of its axes, which must come in mesh order (the
    major-to-minor order of the twin)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec!r} names axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def to_spec(placements, mesh) -> P:
    """The spec ``to_placements`` maps to ``placements`` (trailing
    ``None`` dropped, one-axis entries as names, several as a tuple)."""
    names = axis_names(mesh)
    by_dim: Dict[int, list] = {}
    for name, pl in zip(names, placements):
        if pl.is_shard():
            by_dim.setdefault(pl.dim, []).append(name)
        elif not pl.is_replicate():
            raise ValueError(f"no spec for placement {pl!r}")
    n = max(by_dim, default=-1) + 1
    return P(*[None if d not in by_dim else
               (by_dim[d][0] if len(by_dim[d]) == 1 else tuple(by_dim[d]))
               for d in range(n)])


def local_range(size: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """``[lo, hi)`` of tensor dim ``dim`` (of ``size``) that this rank holds
    under ``placements``: each mesh dim that shards it splits the range
    before it as ``torch.chunk`` does, in mesh order."""
    lo, hi = 0, size
    for i, pl in enumerate(placements):
        if pl.is_shard() and pl.dim == dim:
            step = -(-(hi - lo) // mesh.size(i))
            r = mesh.get_local_rank(i)
            lo, hi = min(lo + r * step, hi), min(lo + (r + 1) * step, hi)
    return lo, hi


def local_slices(shape, mesh, placements) -> tuple:
    """The slices of a tensor of ``shape`` that this rank's local shard
    holds, one per dim."""
    return tuple(slice(*local_range(n, mesh, placements, d))
                 for d, n in enumerate(shape))


# Redistributions that the model's local-tensor paths run on a mesh (the
# MoE's row-local dispatch and combine, the mLSTM's recurrence on local
# heads), each (tag, the placements before, the placements after); the dry
# run clears and records them, as it does RELOCATIONS.
REDISTRIBUTIONS: list = []


def redistribute(t, placements, tag: str):
    """DTensor ``t`` redistributed to ``placements`` on its mesh, the move
    recorded in ``REDISTRIBUTIONS`` (once) where it changes them."""
    placements = tuple(placements)
    if tuple(t.placements) != placements:
        entry = (tag, tuple(t.placements), placements)
        if entry not in REDISTRIBUTIONS:
            REDISTRIBUTIONS.append(entry)
    return t.redistribute(t.device_mesh, placements)


def distribute(tree, mesh, placements):
    """Each tensor of ``tree`` as a DTensor of ``mesh`` with the matching
    placements of ``placements`` (a tree of the same nesting). Every rank
    must hold the same full tensors: each keeps a copy of its own shard of
    them (never a view that would keep the full tensor alive) and nothing
    is sent (``src_data_rank=None``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, placements[k]) for k, v in tree.items()}
    out = distribute_tensor(tree, mesh, list(placements), src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a view into the full tensor: a copy of its own, so that the full
        # tensor can go
        out = DTensor.from_local(local.clone(), mesh, list(placements),
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


# ---------------------------------------------------------------------------
# Ambient mesh (the twin's compat.set_mesh) and sharding constraints
# ---------------------------------------------------------------------------
_MESH = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Makes ``mesh`` the ambient mesh of ``maybe_constrain`` and
    ``current_mesh`` inside the block."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The innermost ``set_mesh`` block's mesh, or None outside any."""
    return _MESH[-1] if _MESH else None


def maybe_constrain(x, *entries):
    """Redistributes DTensor ``x`` to the legalized spec of ``entries``
    (axis names the ambient mesh lacks are dropped); ``x`` as it is outside
    a ``set_mesh`` block or for a plain tensor."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = axis_names(mesh)
    valid = []
    for e in entries:
        if e is None or (isinstance(e, str) and e in names):
            valid.append(e)
        elif isinstance(e, (tuple, list)):
            sub = tuple(a for a in e if a in names)
            valid.append(sub if sub else None)
        else:
            valid.append(None)
    spec = legalize(P(*valid), x.shape, mesh)
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))
