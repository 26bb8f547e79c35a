"""Production-mesh dry run: every (architecture x input shape) step on the
production meshes as DTensors, with one rank's memory, FLOPs and
collectives. The twin of the JAX package's ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k --mesh single multi

Each combo runs as rank 0 of a ``"fake"`` process group of 256 (single pod,
16 x 16) or 512 (multi-pod, 2 x 16 x 16) ranks, under the ``FakeTensorMode``
of ``launch/specs.py``: params, batches and states are the specs' stand-ins
distributed by ``sharding/rules.py``'s placements, the step runs once with
shapes and no data, nothing is allocated and no card is needed (the JAX
twin lowers and compiles for 512 fake devices). The model takes its CPU
path; a flash arm runs the kernels' plain versions on each rank's local
heads. The step runs twice: the first run fills DTensor's caches of
sharding decisions, the second is measured, so nothing of the first is
counted (DTensor computes its output shapes on fake tensors of the global
shapes when its caches miss).

Per combo this writes experiments/dryrun_torch/<arch>__<shape>__<mesh>
[__<variant>].json (never the twin's directory). Beside the twin's keys:
  * ``t_run_s`` (the measured run's host seconds) in place of
    ``t_lower_s`` / ``t_compile_s``;
  * ``memory.argument_bytes``: the rank's local params, moments, batch and
    state; ``memory.temp_bytes``: the peak of ``MemTracker``
    (``torch.distributed._tools.mem_tracker``) over the measured run less
    the arguments, torch's number for what XLA's ``memory_analysis`` calls
    temporaries; the twin's output and alias bytes have no counterpart and
    stay null, each with a ``*_why``;
  * ``cost_raw.flops``: one rank's FLOPs, counted on the ops the rank runs
    on its local tensors (``torch.utils.flop_counter``'s formulas; never a
    logical count divided by the chips); ``cost_raw.bytes_accessed``: the
    input and output bytes of every local op that is not a view (unfused,
    an upper bound of HBM traffic, where XLA's counts fused ops);
  * ``collective_bytes_raw`` / ``collective_ops``: one rank's collectives
    of the step by kind, each its output's bytes, counted where DTensor
    issues them (``_c10d_functional`` ops); the twin counts the compiled
    HLO's ops, a ``lax.scan`` body once;
  * ``memory.unread_argument_bytes``: the arguments the measured run
    never read (``LocalCounter``), which the twin's ``jax.jit`` prunes;
  * ``relocations`` (``rules.RELOCATIONS``) and ``redistributions``
    (``rules.REDISTRIBUTIONS``: the moves of the model's local-tensor paths,
    e.g. q/k/v off a head_dim shard before attention, and of gradient
    accumulation's microbatches), each [tag, before, after].
A decode step writes at ``pos = seq_len - 1``, a 0-dim int32 argument as
the twin traces it.
"""
import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as T
from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import TrainConfig
from repro_torch.core import flops as flops_mod
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.sharding import rules
from repro_torch.train.steps import _loss_and_grads

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
TEMP_BYTES_SOURCE = ("torch.distributed._tools.mem_tracker.MemTracker: the "
                     "peak over the measured run less the arguments "
                     "(torch's number, not XLA's memory_analysis)")
OUTPUT_BYTES_WHY = ("the step's outputs are not set apart from its "
                    "temporaries under FakeTensorMode; MemTracker's peak "
                    "holds both")
ALIAS_BYTES_WHY = "no donation in the port: params and moments are updated in place"
UNREAD_WHY = ("bytes of the arguments that the measured run never read (a "
              "prefill overwrites its input state, a decode never runs an "
              "encoder-decoder's encoder, an xLSTM never reads the "
              "position); the twin's jax.jit prunes such arguments "
              "(keep_unused=False), so its argument_bytes are these "
              "argument_bytes less them")

# --- the twin's variants: (cfg overrides, tcfg overrides, cache strategy
# [, moe axis]); copied as they are
VARIANTS = {
    "baseline": ({}, {}, "heads"),
    "fused_xent": ({"fused_xent": True}, {}, "heads"),
    "remat_none": ({}, {"remat": "none"}, "heads"),
    "remat_full": ({}, {"remat": "full"}, "heads"),
    "cache_seq": ({}, {}, "seq"),
    "cache_auto": ({}, {}, "auto"),
    "moe_a2a": ({"moe_constrained": True}, {}, "heads"),
    "fused_xent+remat_full": ({"fused_xent": True}, {"remat": "full"}, "heads"),
    "fused_xent+moe_a2a": ({"fused_xent": True, "moe_constrained": True},
                           {}, "heads"),
    "bf16_scores": ({"attn_fp32": False}, {}, "heads"),
    "moe_fsdp": ({}, {}, "heads", "data"),
    "moe_fsdp+a2a": ({"moe_constrained": True}, {}, "heads", "data"),
    "bf16_scores+remat_none": ({"attn_fp32": False}, {"remat": "none"},
                               "heads"),
    "window1k": ({"block_pattern": ("local_attn",), "window_size": 1024},
                 {}, "heads"),  # quantifies the s^2-score traffic share
    # the paper's own axis: micro batch size (grad accumulation)
    "accum_b8": ({}, {"micro_batch": 8}, "heads"),
    # pad q heads to the model-axis multiple (+20% attn flops for qwen3)
    # to test the head-divisibility hypothesis for the prefill collectives
    "pad_heads48": ({"num_heads": 48}, {}, "heads"),
    "pad_heads48_mha": ({"num_heads": 48, "num_kv_heads": 48}, {}, "heads"),
    "accum_b8+remat_none": ({}, {"micro_batch": 8, "remat": "none"}, "heads"),
    "moe_fsdp+accum_b8": ({}, {"micro_batch": 8}, "heads", "data"),
    "moe_a2a+accum_b8": ({"moe_constrained": True}, {"micro_batch": 8},
                         "heads"),
}


def fake_world(world: int):
    """Make this process rank 0 of a ``world``-rank fake process group: its
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# ``_c10d_functional`` ops (the collectives DTensor issues) -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ops that take a tensor for its shape, dtype and device only (and every
# ``prim`` op, such as ``prim.device``)
_METADATA_OPS = {"empty_like", "zeros_like", "ones_like", "full_like",
                 "new_empty", "new_empty_strided", "new_zeros", "new_ones",
                 "new_full"}
# in-place ops that overwrite their first argument without reading it
_OVERWRITE_OPS = {"copy_", "fill_", "zero_"}


def _storage(t):
    return t.untyped_storage()._cdata


class LocalCounter(TorchDispatchMode):
    """Counts what one rank runs on its local tensors: FLOPs (by
    ``torch.utils.flop_counter``'s formulas), the input and output bytes of
    every op that is not a view, and the collectives by kind (ops, output
    bytes). A DTensor op is handed on (``NotImplemented``) to DTensor, whose
    ops on the local tensors come back here: a DTensor op itself is never
    counted, so no logical (unpartitioned) work is.

    It also notes which of the ``arguments`` (the rank's local argument
    tensors) an op reads, through any view of them: every input of an op
    that is not a view, but the tensor an in-place copy or fill overwrites
    and the one an op takes only for its metadata (``unread``: the bytes of
    those never read)."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_ops = {k: 0 for k in rl.COLLECTIVES}
        self.coll_bytes = {k: 0.0 for k in rl.COLLECTIVES}
        self._watch = {}
        for t in arguments:
            self._watch.setdefault(_storage(t), []).append(t)
        self._read = set()

    @property
    def unread(self) -> int:
        """Bytes of the arguments that no op read."""
        return _nbytes([t for k, ts in self._watch.items()
                        if k not in self._read for t in ts])

    def _note_reads(self, func, args, kwargs):
        name = func._overloadpacket.__name__
        if func.is_view or name in _METADATA_OPS or func.namespace == "prim":
            return
        ins = _tensors(list(args)) + _tensors(list(kwargs.values()))
        if name in _OVERWRITE_OPS:
            ins = ins[1:]
        for t in ins:
            k = _storage(t)
            if k in self._watch:
                self._read.add(k)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        self._note_reads(func, args, kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = (_COLLECTIVE_OPS.get(packet.__name__)
                if func.namespace == "_c10d_functional" else None)
        if kind:
            self.coll_ops[kind] += 1
            self.coll_bytes[kind] += _nbytes(_tensors(out))
            return out
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes(_tensors(args) + _tensors(list(kwargs.values()))
                                  + _tensors(out))
        return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def measure(fn, args, arguments):
    """Runs ``fn(*args)`` twice (a warm-up for DTensor's caches, then
    measured) and returns (host seconds, ``LocalCounter``, peak bytes of
    ``MemTracker`` over the measured run). ``arguments`` are the tensors
    MemTracker counts as already there."""
    from torch.distributed._tools.mem_tracker import MemTracker
    fn(*args)
    counter, tracker = LocalCounter(arguments), MemTracker()
    tracker.track_external(*arguments)
    t0 = time.time()
    with tracker, counter:
        fn(*args)
    seconds = time.time() - t0
    peak = sum(v.get("Total", 0)
               for v in tracker.get_tracker_snapshot("peak").values())
    return seconds, counter, peak


def _distribute(tree, mesh, placements):
    """``rules.distribute`` over a tree that may hold an ``AdamState``; a
    tensor without placements as it is."""
    if placements is None:
        return tree
    if isinstance(tree, adam.AdamState):
        return adam.AdamState(
            step=rules.distribute({"s": tree.step}, mesh,
                                  {"s": placements.step})["s"],
            m=rules.distribute(tree.m, mesh, placements.m),
            v=rules.distribute(tree.v, mesh, placements.v))
    if isinstance(tree, dict):
        return rules.distribute(tree, mesh, placements)
    return rules.distribute({"x": tree}, mesh, {"x": placements})["x"]


def _leaves(tree):
    if isinstance(tree, adam.AdamState):
        return [tree.step] + T.leaves(tree.m) + T.leaves(tree.v)
    return T.leaves(tree) if isinstance(tree, dict) else [tree]


def _sharded_grads(params, batch, cfg, remat):
    loss, metrics, grads = _loss_and_grads(params, batch, cfg, remat)
    grads = T.tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                       grads, params)
    return loss, metrics, grads


def microbatches(batch, mesh, num_micro: int):
    """The ``num_micro`` microbatches of a batch of DTensors, each placed as
    ``rules.batch_shardings`` places a batch of its shape. Where that keeps
    the batch rows sharded (a microbatch the data axes divide), microbatch
    i is rows ``i::num_micro`` of each rank's local rows, a plain shard
    that moves nothing. Where it does not (8 rows on 16 data ranks), the
    rules relocate the data axes onto a later dim: the whole batch is
    redistributed to those placements once (recorded in
    ``rules.REDISTRIBUTIONS``), and microbatch i is rows ``i::num_micro``
    of its whole rows. The twin takes the contiguous rows of its
    ``reshape((num_micro, -1) + shape[1:])``, whose microbatch is no plain
    shard; both split the batch into equal-size microbatches, and the
    step's loss is the mean of their mean losses, so where each row's
    tokens are all counted (no label -1) and the loss has no MoE aux (a
    product of two means over a microbatch's tokens), any such split gives
    the loss and grads of the single-shot step."""
    from torch.distributed.tensor import DTensor
    micro = {k: torch.empty((v.shape[0] // num_micro, *v.shape[1:]),
                            device="meta") for k, v in batch.items()}
    want = rules.batch_shardings(micro, mesh)
    out = [dict() for _ in range(num_micro)]
    for k, v in batch.items():
        if v.shape[0] % num_micro:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {num_micro} microbatches")
        local = rules.redistribute(v, want[k], "accum_batch").to_local()
        for i in range(num_micro):
            out[i][k] = DTensor.from_local(
                local[i::num_micro], mesh, want[k], run_check=False,
                shape=micro[k].shape, stride=micro[k].stride())
    return out


def accumulated_grads(params, batch, cfg, remat, num_micro: int):
    """(loss, grads) of the twin's gradient accumulation over
    ``microbatches(batch, ...)``: the grads summed over the microbatches
    and divided by their number, the loss their mean."""
    grads, loss = None, 0.0
    mesh = next(iter(batch.values())).device_mesh
    for bi in microbatches(batch, mesh, num_micro):
        l, _, g = _sharded_grads(params, bi, cfg, remat)
        grads = g if grads is None else T.tree_map(torch.add, grads, g)
        loss = loss + l
    return loss / num_micro, T.tree_map(lambda g: g / num_micro, grads)


def build_step(cfg, shape, mesh, tcfg: TrainConfig, cache_strategy="heads",
               moe_axis="model"):
    """Returns (fn, arg stand-ins, their placements) for this shape kind;
    ``fn`` takes the distributed arguments."""
    from torch.distributed.tensor import Replicate
    rep = (Replicate(),) * mesh.ndim
    pspec = sp.param_specs(cfg)
    p_sh = rules.param_shardings(pspec, mesh, moe_axis)
    if shape.kind == "train":
        batch = sp.train_batch_specs(cfg, shape)
        o_spec = sp.opt_specs(pspec)
        o_sh = adam.AdamState(step=rep, m=p_sh, v=p_sh)
        b_sh = rules.batch_shardings(batch, mesh)
        num_micro = max(1, shape.global_batch // tcfg.micro_batch) \
            if tcfg.micro_batch else 1

        def step(params, opt_state, b):
            if num_micro == 1:
                loss, metrics, grads = _sharded_grads(params, b, cfg,
                                                      tcfg.remat)
            else:
                # the paper's b-axis: microbatched gradient accumulation;
                # live activations scale with micro_batch, not B
                loss, grads = accumulated_grads(params, b, cfg, tcfg.remat,
                                                num_micro)
                metrics = {"loss": loss, "aux": 0.0}
            params, opt_state, om = adam.update(params, grads, opt_state, tcfg)
            return params, opt_state, dict(metrics, **om)

        return step, (pspec, o_spec, batch), (p_sh, o_sh, b_sh)

    if shape.kind == "prefill":
        batch = sp.prefill_batch_specs(cfg, shape)
        state = sp.decode_state_specs(cfg, shape)
        b_sh = rules.batch_shardings(batch, mesh)
        s_sh = rules.cache_shardings(state, mesh, cache_strategy, cfg)

        def step(params, b, state):
            logits, state, _ = M.prefill(params, b, cfg, state)
            return logits, state

        return step, (pspec, batch, state), (p_sh, b_sh, s_sh)

    # decode
    state = sp.decode_state_specs(cfg, shape)
    dec_in = sp.decode_input_specs(cfg, shape)
    s_sh = rules.cache_shardings(state, mesh, cache_strategy, cfg)
    ba = rules.batch_axes(mesh)
    tok_sh = rules.to_placements(
        rules.legalize(rules.P(ba), dec_in["token"].shape, mesh), mesh)
    # the position a 0-dim int32 tensor on every rank, as the twin traces it
    # (replicated); the model reads it with int(), which a fake tensor made
    # from a value answers
    with sp.fake_mode():
        pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    args = [pspec, state, dec_in["token"], pos]
    shards = [p_sh, s_sh, tok_sh, None]
    if cfg.is_encdec:
        args.append(dec_in["enc_states"])
        shards.append(rules.to_placements(rules.legalize(
            rules.P(ba, None, None), dec_in["enc_states"].shape, mesh), mesh))

    def step(params, state, token, pos, enc_states=None):
        logits, state = M.decode_step(params, token, pos, state, cfg,
                                      enc_states=enc_states)
        # the vocab gathered first: DTensor's argmax over a sharded dim
        # reads its shard offsets as data, which a fake run has not got
        logits = logits.redistribute(mesh, rep)
        return torch.argmax(logits, -1).to(torch.int32), state

    return step, tuple(args), tuple(shards)


def run_combo(cfg, shape, mesh, tcfg, cache_strategy="heads",
              moe_axis="model") -> Dict:
    """One step of ``cfg`` at ``shape`` on ``mesh``, measured on rank 0."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules.RELOCATIONS.clear()
    rules.REDISTRIBUTIONS.clear()
    fn, args, placements = build_step(cfg, shape, mesh, tcfg, cache_strategy,
                                      moe_axis)
    relocs = sorted({(t, d, -1 if d2 is None else d2)
                     for t, _, d, d2, _ in rules.RELOCATIONS})
    if relocs:
        print(f"WARN sharding relocations (collective hazard, the twin's "
              f"HC-5): {relocs}", flush=True)
    with sp.fake_mode():
        dargs = [_distribute(a, mesh, pl) for a, pl in zip(args, placements)]
        local = [_local(t) for a in dargs for t in _leaves(a)]
        arg_bytes = _nbytes(local)

        def run(*a):
            with rules.set_mesh(mesh), implicit_replication():
                return fn(*a)

        seconds, counter, peak = measure(run, dargs, local)
    return {
        "t_run_s": round(seconds, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "unread_argument_bytes": counter.unread,
            "unread_argument_bytes_why": UNREAD_WHY,
            "temp_bytes": max(peak - arg_bytes, 0),
            "temp_bytes_source": TEMP_BYTES_SOURCE,
            "output_bytes": None, "output_bytes_why": OUTPUT_BYTES_WHY,
            "alias_bytes": None, "alias_bytes_why": ALIAS_BYTES_WHY,
        },
        "cost_raw": {"flops": float(counter.flops),
                     "bytes_accessed": float(counter.bytes)},
        "collective_bytes_raw": counter.coll_bytes,
        "collective_ops": counter.coll_ops,
        "relocations": [list(r) for r in relocs],
        "redistributions": [
            [tag, list(map(str, a)), list(map(str, b))]
            for tag, a, b in rules.REDISTRIBUTIONS],
    }


def variant_cfg(cfg, k: int):
    """Unrolled k-block variant (full dims) for roofline extraction."""
    kw = dict(num_layers=len(cfg.block_pattern) * k, scan_blocks=False)
    if cfg.encoder_layers:
        kw["encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


def effective_blocks(cfg) -> float:
    pat = len(cfg.block_pattern)
    return cfg.num_layers / pat


def roofline_combo(cfg, shape, mesh, tcfg, cache_strategy="heads",
                   moe_axis="model") -> Dict:
    """Extrapolated per-device roofline terms via 1- vs 2-block runs, as
    the twin (whose cost analysis counts a scan body once; here the counts
    are per step already, and the extrapolation keeps the record's form)."""
    res = {}
    for k in (1, 2):
        r = run_combo(variant_cfg(cfg, k), shape, mesh, tcfg,
                      cache_strategy, moe_axis)
        res[k] = {"flops": r["cost_raw"]["flops"],
                  "bytes": r["cost_raw"]["bytes_accessed"],
                  "coll": sum(r["collective_bytes_raw"].values()),
                  **{f"coll_{kk}": v
                     for kk, v in r["collective_bytes_raw"].items()}}
    n = effective_blocks(cfg)
    ext = rl.extrapolate(res[1], res[2], n)
    chips = mesh.size()
    terms = rl.RooflineTerms(
        flops=ext["flops"], bytes_hbm=ext["bytes"],
        bytes_collective=ext["coll"], chips=chips)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        # serve_step does not rerun the encoder (enc_states are an input)
        model_flops = flops_mod.model_flops_fwd(cfg, b, 1,
                                                include_encoder=False)
    elif shape.kind == "prefill":
        model_flops = flops_mod.model_flops_fwd(cfg, b, s)
    else:
        model_flops = flops_mod.model_flops_train(cfg, b, s)
    mf_dev = model_flops / chips
    return {
        "per_block_points": res,
        "extrapolated": ext,
        "terms": terms.to_dict(),
        "model_flops_per_device": mf_dev,
        "useful_fraction": (mf_dev / ext["flops"]) if ext["flops"] else None,
        "roofline_mfu": terms.mfu(mf_dev),
    }


def run_one(arch: str, shape_name: str, mesh_kind: str,
            *, with_roofline: bool, out_dir: str, force=False,
            variant: str = "baseline") -> Optional[str]:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return None
    spec = VARIANTS[variant]
    cfg_over, tcfg_over, cache_strategy = spec[0], spec[1], spec[2]
    moe_axis = spec[3] if len(spec) > 3 else "model"
    cfg = dataclasses.replace(cfg, **cfg_over)
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        return path
    fake_world(512 if mesh_kind == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
        # micro_batch=0 disables grad accumulation (single-shot baseline);
        # the accum_* variants set the paper's b explicitly.
        tcfg = TrainConfig(global_batch=shape.global_batch,
                           seq_len=shape.seq_len, remat="attn", micro_batch=0)
        tcfg = dataclasses.replace(tcfg, **tcfg_over)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "variant": variant, "chips": int(mesh.size()),
               "params": cfg.param_count()}
        rec["full"] = run_combo(cfg, shape, mesh, tcfg, cache_strategy,
                                moe_axis)
        if with_roofline and mesh_kind == "single":
            rec["roofline"] = roofline_combo(cfg, shape, mesh, tcfg,
                                             cache_strategy, moe_axis)
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args()

    archs = args.arch or (list(ASSIGNED) if args.all else ["qwen1.5-0.5b"])
    shapes = args.shape or (list(INPUT_SHAPES) if args.all else ["train_4k"])

    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in args.mesh:
                t0 = time.time()
                try:
                    path = run_one(arch, shape_name, mesh_kind,
                                   with_roofline=not args.no_roofline,
                                   out_dir=args.out, force=args.force,
                                   variant=args.variant)
                except Exception as e:  # noqa: BLE001 — report & continue
                    print(f"FAIL {arch} {shape_name} {mesh_kind}: {e!r}",
                          flush=True)
                    continue
                if path is None:
                    print(f"SKIP {arch} {shape_name} {mesh_kind} "
                          f"(not applicable)", flush=True)
                else:
                    with open(path) as f:
                        rec = json.load(f)
                    dom = rec.get("roofline", {}).get("terms", {}).get(
                        "dominant", "-")
                    print(f"OK   {arch} {shape_name} {mesh_kind} "
                          f"run={rec['full']['t_run_s']}s "
                          f"temp={rec['full']['memory']['temp_bytes']/2**30:.2f}GiB "
                          f"dominant={dom} ({time.time()-t0:.0f}s)",
                          flush=True)


if __name__ == "__main__":
    main()
