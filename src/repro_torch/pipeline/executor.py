"""Executable pipeline runtime: a schedule interpreter with true 1F1B /
BPipe activation-stash semantics, chunk-aware for interleaved schedules —
the twin of the JAX package's ``repro/pipeline/executor.py``.

A compiled ``plan.Schedule`` is interpreted instruction by instruction as a
handler set over the port's copy of the shared dispatch engine
(``plan.run``). Each F runs its (virtual) stage with autograd on, so the
stash — the autograd graph and the tensors it saved — is *really* held until
the matching B. The forward runs under the saved-tensor hooks of a
``memory.offload.Box``: every tensor autograd saves that the step does not
hold anyway (the stage's parameters, its input leaves, the micro-batch)
lands in the unit's box. A stash unit is ``Graph(out, leaves, box)``: the
stage's outputs (the graph hangs off them), the leaves B differentiates to
(the stage's params, then the carry's), and the box; under recompute
residency the boundary input (the carry) is kept beside it.

  * B is ``torch.autograd.grad(out, leaves, grad_outputs=cot)``: it consumes
    the graph as ``vjp_fn(cot)`` does, and the grads accumulate per virtual
    stage.
  * EVICT/LOAD move stash entries between the evictor's and acceptor's
    stores: on one card this is bookkeeping plus the byte accounting from
    ``core.memory_model``, as in the JAX executor on one host.
  * OFFLOAD/FETCH move the box to pinned host memory and back
    (``memory.offload``), each as its compiled ISSUE/WAIT halves over the
    bounded-depth transfer runtime (``transfer.runtime``).
  * DROP frees the graph and keeps the boundary input; RECOMPUTE re-runs
    the stage forward from it (deterministic, so bit-identical).

Interleaved kinds give each device v model chunks: chunk c on device s is
virtual stage ``c*p + s`` and every stash / routing key is (stage, mb,
chunk).

Sequence-sliced schedules (``ScheduleSpec.seq_chunks`` = c > 1) split every
microbatch into c sequence slices: each F runs one slice through
``make_sliced_stage_fn``, reading the retained KV of all earlier slices
through ``store.peek`` (wherever a residency policy put them). A slice's
own KV is packed into its unit's box, so it travels with the box. Its
prefix enters the forward as detached leaves, so the slice's graph ends
there and B reads the prefix's grads from them; the graph keeps an edge
(``torch.autograd.graph.get_gradient_edge``) to each of the slice's own
k and v, so B can feed them the grads the later slices' backwards (run
first: B goes in reverse slice order) emitted for them.

Numerical contract (tested against the JAX executor and against
``models.model.loss_fn``): for any schedule kind,
    executor.step(params, batch).loss == loss_fn(params, batch)
and gradients match to fp32 tolerance. BPipe's cap is asserted on the live
store, not on paper.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core import plan as P
from repro_torch.core.notation import Notation
from repro_torch.core.schedule import B, F
from repro_torch.memory import offload as mem_offload
from repro_torch.memory import policy as respol
from repro_torch.memory.store import ActivationStore, StoreStats
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.layers import cdtype
from repro_torch.obs.events import Recorder, Span
from repro_torch.obs.ranges import now_ns, span
from repro_torch.pipeline import stage as stage_mod
from repro_torch.transfer.channel import channel_key
from repro_torch.transfer.runtime import AsyncTransferRuntime


@dataclasses.dataclass
class StepResult:
    loss: torch.Tensor
    grads: Any
    stats: StoreStats
    # Spans of the traced step (``obs.events.Span``), wall-clock seconds
    # relative to step start. None unless step(trace=True).
    events: Optional[List[Span]] = None
    # The step's start in ns on the profiler's host clock
    # (``obs.ranges.now_ns``), read beside the spans' own start: a span
    # lies at t0_ns + start on a trace of the step.
    t0_ns: int = 0


@dataclasses.dataclass
class Graph:
    """One stash unit: the stage's outputs (the autograd graph hangs off
    them), the leaves its backward differentiates to (the stage's params,
    then the carry's, then a slice's KV prefix) and the box of saved
    tensors. A slice's unit also holds its own KV, one (k, v) pair per
    layer, packed into the box (``kv``), and the autograd edges of those
    tensors (``kv_edges``), which take their grads in B."""
    out: Tuple[torch.Tensor, ...]
    leaves: List[torch.Tensor]
    box: mem_offload.Box
    kv: Tuple[Any, ...] = ()
    kv_edges: Tuple[Any, ...] = ()

    def kv_own(self):
        return tuple((self.box.read(k), self.box.read(v)) for k, v in self.kv)


def _kv_own_of(entry):
    """A slice's own KV from its stash entry, wherever the unit lives: a
    Graph, a live recompute entry (Graph, carry), or a dropped one
    (carry, kv_own)."""
    if isinstance(entry, Graph):
        return entry.kv_own()
    head, tail = entry
    return head.kv_own() if isinstance(head, Graph) else tail


def _add(a, b):
    return b if a is None else a if b is None else a + b


def _range_name(ins) -> str:
    return f"pipe.{ins.op}.wait" if ins.is_wait else f"pipe.{ins.op}"


class PipelineExecutor:
    """Interprets a pipeline schedule over a real model.

        PipelineExecutor(cfg, ScheduleSpec("bpipe", p=4), micro_batch=2)

    A spec with ``m=0`` is a template the executor binds to the real batch
    at ``step()`` (m = batch_rows / micro_batch); a bound spec additionally
    pins the expected microbatch count. ``remat`` is the stage's recompute
    arm ("none", "attn", "full"; "flash" only changes the byte accounting
    — the attention kernel is ``cfg.attn_impl``'s).
    """

    def __init__(self, cfg: ModelConfig, spec: P.ScheduleSpec,
                 micro_batch: int = 1, remat: str = "none"):
        self.spec = spec
        self.cfg, self.p, self.kind = cfg, spec.p, spec.kind
        self.v = spec.v
        self.n_virtual = spec.n_virtual
        assert self.n_virtual <= cfg.num_layers, \
            (spec.p, self.v, cfg.num_layers)
        self.b = micro_batch
        self.remat = remat
        self.cap = spec.resolved_cap
        self.c = spec.seq_chunks
        if self.c > 1:
            bad = set(cfg.layer_kinds()) - set(blocks_mod.SLICEABLE_KINDS)
            assert not bad, \
                f"seq_chunks>1 needs attention mixers, got {sorted(bad)}"
            make = stage_mod.make_sliced_stage_fn
        else:
            make = stage_mod.make_stage_fn
        self.stage_fns = [make(cfg, self.n_virtual, vs, remat)
                          for vs in range(self.n_virtual)]
        self.splitter = stage_mod.StageSplitter(cfg, self.n_virtual)

    def _schedule_for(self, m: int) -> P.Schedule:
        if self.spec.bound:
            assert m == self.spec.m, \
                f"batch implies m={m} but spec binds m={self.spec.m}"
        return P.compile_plan(self.spec.with_m(m))

    def step(self, params, batch, trace: bool = False) -> StepResult:
        """One training step over ``batch``; ``trace=True`` records a span
        of each instruction, the card synchronised at its end. A profiler
        sees the step as the range ``pipe.step`` (``obs.ranges``)."""
        with span("pipe.step"):
            return self._step(params, batch, trace)

    def _step(self, params, batch, trace: bool) -> StepResult:
        cfg, p = self.cfg, self.p
        nv = self.n_virtual
        bsz = batch["tokens"].shape[0]
        assert bsz % self.b == 0
        m = bsz // self.b
        seq = batch["tokens"].shape[1]
        dev = batch["tokens"].device
        n = Notation(
            a=cfg.num_heads, b=self.b, h=cfg.d_model, l=cfg.num_layers,
            s=seq, v=cfg.vocab_size, B=bsz, p=p, t=1)
        attention = {"none": "none", "attn": "recompute", "full": "recompute",
                     "flash": "flash"}.get(self.remat, "none")
        policy = self.spec.policy
        c = self.c
        sliced = c > 1
        if sliced:
            assert seq % c == 0, f"seq {seq} not divisible by seq_chunks {c}"
        Ls = seq // c
        # One stash unit's bytes: the same v-chunk weighting
        # memory_model.act_bytes_per_stage charges, so the reported
        # peak_bytes/bytes_moved agree with the model's per-stage numbers
        # (a sliced unit holds 1/c of the stage stash plus its KV prefix).
        unit_bytes = mm.sliced_unit_bytes(n, attention, self.v, c)
        retained = policy.retained_bytes(n, attention, self.v)
        if sliced:
            # a released slice retains 1/c of the policy's bytes, plus its
            # own KV under recompute (DROP keeps (carry, kv_own) so later
            # slices' forwards still reach the prefix)
            retained = retained / c
            if policy.mechanism == "recompute":
                retained += mm.kv_bytes_per_slice(n, self.v, c)
        store = ActivationStore(p, unit_bytes, retained_bytes=retained)
        is_recompute = policy.mechanism == "recompute"
        swap_ops = frozenset(
            op for op, pol in {**respol.RELEASE_OPS,
                               **respol.RESTORE_OPS}.items() if pol.swap)

        with span("pipe.split"):
            stage_params = self.splitter.split(params)
            stage_paths, stage_leaves = zip(*(
                zip(*T.leaves_with_paths(sp)) for sp in stage_params))
            micros = [
                {k: val[j * self.b:(j + 1) * self.b]
                 for k, val in batch.items()}
                for j in range(m)]
        schedule = self._schedule_for(m)
        bounds = schedule.bounds
        partner = schedule.partner
        # trace=True attaches a Recorder; without it the step takes no
        # timings.
        observer: Optional[Recorder] = Recorder() if trace else None
        t0_ns = now_ns()
        t_step0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t_step0  # noqa: E731
        # At most ``depth`` real copies in flight per channel (the live
        # memory bound), each retiring as a channel-track span.
        xfers = AsyncTransferRuntime(self.spec.depth, observer=observer,
                                     clock=clock)

        def chan(op: str, i: int) -> Optional[tuple]:
            pol = respol.RELEASE_OPS.get(op) or respol.RESTORE_OPS[op]
            return channel_key(pol.mechanism, i, partner.get(i),
                               release=op in respol.RELEASE_OPS)

        # act_in/grad_in are keyed by the *virtual* stage they feed (plus
        # the sequence slice, always 0 here).
        act_in: Dict[Tuple[int, int, int], Any] = {}
        grad_in: Dict[Tuple[int, int, int], Any] = {}
        losses: Dict[Tuple[int, int], torch.Tensor] = {}
        grads: List[List[Optional[torch.Tensor]]] = [
            [None] * len(leaves) for leaves in stage_leaves]
        scale = torch.tensor(1.0 / m, dtype=torch.float32, device=dev)

        if sliced:
            # Per-(mb, slice) inputs: the slice's token window plus its
            # global start position (the stage fn derives positions and
            # the causal mask against the retained-KV prefix from it).
            micros_sl = {
                (j, s): {**{k: val[:, s * Ls:(s + 1) * Ls]
                            for k, val in micros[j].items()},
                         "offset": s * Ls}
                for j in range(m) for s in range(c)}
            # The sliced last stage returns nll sums that are not
            # normalised; the whole microbatch's count of valid tokens
            # normalises them, so the slices' losses sum to the unsliced one.
            cnt = [(micros[j]["labels"] >= 0).float().sum().clamp_min(1.0)
                   for j in range(m)]
            kv_zero = [tuple((torch.zeros((self.b, 0, cfg.num_kv_heads,
                                           cfg.head_dim), dtype=cdtype(cfg),
                                          device=dev),) * 2
                             for _ in self.splitter.assign[vs])
                       for vs in range(nv)]
            # (vs, mb, sl) -> pending dKV cotangent: the prefix grads the
            # LATER slices' backwards (which run first, in reverse slice
            # order) have emitted for slice sl's own KV.
            dkv_acc: Dict[Tuple[int, int, int], Any] = {}

        def kv_prefix_for(i, vs, mb, chunk, sl):
            """Concatenate the earlier slices' retained KV (slice order is
            position order), read through ``store.peek``, so the prefix is
            reached wherever a residency policy moved the earlier units
            (partner store, host, dropped)."""
            if sl == 0:
                return kv_zero[vs]
            parts = [_kv_own_of(store.peek(i, mb, chunk, j)) for j in range(sl)]
            return tuple(
                (torch.cat([part[li][0] for part in parts], dim=1),
                 torch.cat([part[li][1] for part in parts], dim=1))
                for li in range(len(kv_zero[vs])))

        def forward(i, ins, carry):
            """Stage ``ins.vs`` on microbatch ``ins.mb`` (slice ``ins.sl``)
            from ``carry`` (() for stage 0), its saved tensors boxed.
            Returns (output, Graph)."""
            vs = ins.vs
            inputs = [t.detach().requires_grad_(True) for t in carry]
            prefix = [] if not sliced else [
                t.detach().requires_grad_(True) for kv in
                kv_prefix_for(i, vs, ins.mb, ins.chunk, ins.sl) for t in kv]
            leaves = list(stage_leaves[vs]) + inputs + prefix
            micro = micros_sl[(ins.mb, ins.sl)] if sliced else micros[ins.mb]
            box = mem_offload.Box(keep=leaves + [
                t for t in micro.values() if isinstance(t, torch.Tensor)])
            kv, edges = (), ()
            with torch.enable_grad(), box.hooks():
                if sliced:
                    out, kv_own = self.stage_fns[vs](
                        stage_params[vs], tuple(inputs),
                        tuple(zip(prefix[0::2], prefix[1::2])), micro)
                    # the KV goes into the box as the forward fills it, so
                    # the box's bytes count it and it moves with the box
                    kv = tuple((box.pack(k), box.pack(v)) for k, v in kv_own)
                    edges = tuple(torch.autograd.graph.get_gradient_edge(t)
                                  for pair in kv_own for t in pair)
                    del kv_own
                else:
                    out = self.stage_fns[vs](stage_params[vs], tuple(inputs),
                                             micro)
            outs = out if isinstance(out, tuple) else (out,)
            return out, Graph(outs, leaves, box, kv, edges)

        def wrap(body):
            """Shared instruction handling: the body runs inside its
            profiler range (``pipe.<OP>``, ``pipe.<OP>.wait``); then span
            emission through the attached observer (synchronising the card
            so the span covers device time, not the launch) and the live
            stash-cap assertion. The dep-gated run hands a handler only
            ready instructions, so F's and B's pops find their input."""
            def handler(i, ins):
                with span(_range_name(ins)):
                    t0 = clock() if observer is not None else 0.0
                    sync = body(i, ins)
                    if observer is not None:
                        if sync is not None and dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        t1 = clock()
                if observer is not None:
                    observer.emit(
                        ins.op, i, ins.mb, ins.chunk, ins.sl, ins.phase,
                        t0, t1, hbm=store.resident_bytes(i))
                if self.cap is not None:
                    # swap ops (EVICT/LOAD) also touch the partner's
                    # store — check both ends so acceptor-side transients
                    # can't hide behind the acceptor's next pop.
                    for d in ((i, partner[i])
                              if ins.op in swap_ops else (i,)):
                        assert store.held(d) <= bounds[d], \
                            (d, ins, store.held(d), bounds[d])
                return None
            return handler

        def on_f(i, ins):
            vs, sl = ins.vs, ins.sl
            # pop: the boundary activation has exactly one consumer
            carry = () if vs == 0 else act_in.pop((vs, ins.mb, sl))
            out, graph = forward(i, ins, carry)
            # recompute residency keeps the boundary input alongside the
            # graph: DROP strips to it, RECOMPUTE re-forwards from it
            store.put(i, ins.mb, (graph, carry) if is_recompute else graph,
                      ins.chunk, sl)
            if vs == nv - 1:
                losses[(ins.mb, sl)] = (out[0].detach() / cnt[ins.mb]
                                        + out[1].detach()) if sliced \
                    else out.detach()
            else:
                act_in[(vs + 1, ins.mb, sl)] = tuple(t.detach() for t in out)
            return out

        def on_b(i, ins):
            vs, sl = ins.vs, ins.sl
            if vs == nv - 1:
                cot = (scale / cnt[ins.mb], scale) if sliced else (scale,)
            else:
                cot = grad_in.pop((vs, ins.mb, sl))
            entry = store.pop(i, ins.mb, ins.chunk, sl)
            graph = entry[0] if is_recompute else entry
            live = [(o, g) for o, g in zip(graph.out, cot) if o.requires_grad]
            if sliced:
                # dKV for this slice's own KV: what the LATER slices'
                # backwards (already run) emitted; the newest slice has none
                cot_kv = dkv_acc.pop((vs, ins.mb, sl), None)
                if cot_kv is not None:
                    live += zip(graph.kv_edges,
                                [g for kv in cot_kv for g in kv])
            got = torch.autograd.grad([o for o, _ in live], graph.leaves,
                                      grad_outputs=[g for _, g in live],
                                      allow_unused=True)
            k = len(stage_leaves[vs])
            with span("pipe.grad_sum"):
                grads[vs] = [_add(a, g) for a, g in zip(grads[vs], got[:k])]
            # the carry's grads, then the KV prefix's
            rest = [torch.zeros_like(t) if g is None else g
                    for t, g in zip(graph.leaves[k:], got[k:])]
            n_in = len(rest) - 2 * len(graph.kv)
            if vs > 0:
                grad_in[(vs - 1, ins.mb, sl)] = tuple(rest[:n_in])
            if sliced:
                d_kvp = rest[n_in:]
                for j in range(sl):      # scatter the prefix grads back
                    seg = tuple(g[:, j * Ls:(j + 1) * Ls] for g in d_kvp)
                    prev = dkv_acc.get((vs, ins.mb, j))
                    seg = tuple(zip(seg[0::2], seg[1::2]))
                    dkv_acc[(vs, ins.mb, j)] = seg if prev is None else tuple(
                        (pk + dk, pv + dv)
                        for (pk, pv), (dk, dv) in zip(prev, seg))
            return got

        # Every move handler follows the compiled ISSUE/WAIT contract: the
        # ISSUE half starts the (async) copy and registers it with the
        # transfer runtime; the WAIT half blocks on the channel up to that
        # unit, so the dependent compute touches the data only once the
        # copy is really complete.
        def move_handler(op_fn):
            def on_move(i, ins):
                if ins.is_wait:
                    return xfers.wait(chan(ins.op, i), ins.done_key)
                return xfers.submit(chan(ins.op, i), ins.done_key,
                                    lambda: op_fn(i, ins))
            return on_move

        on_evict = move_handler(lambda i, ins: store.evict(
            i, ins.mb, partner[i], ins.chunk, ins.sl))
        on_load = move_handler(lambda i, ins: store.load(
            i, ins.mb, partner[i], ins.chunk, ins.sl))
        on_offload = move_handler(lambda i, ins: store.offload(
            i, ins.mb, ins.chunk, ins.sl, mover=mem_offload.to_host))
        on_fetch = move_handler(lambda i, ins: store.fetch(
            i, ins.mb, ins.chunk, ins.sl, mover=mem_offload.to_device))

        def on_drop(i, ins):
            if ins.is_wait:
                return None
            # free the graph and its box, keep the boundary input the
            # re-forward starts from, plus, under slicing, the slice's own
            # KV (later slices peek at it)
            strip = (lambda e: (e[1], e[0].kv_own())) if sliced \
                else (lambda e: e[1])
            store.drop(i, ins.mb, ins.chunk, ins.sl, strip=strip)

        def on_recompute(i, ins):
            if ins.is_wait:
                return None
            kept = store.dropped_input(i, ins.mb, ins.chunk, ins.sl)
            carry = kept[0] if sliced else kept
            out, graph = forward(i, ins, carry)
            store.recompute(i, ins.mb, (graph, carry), ins.chunk, ins.sl)
            return out

        # Handlers by registered policy mechanism: a plugin policy's ops
        # are executable without edits here — the registry IS the op set.
        mech_release = {"swap": on_evict, "host": on_offload,
                        "recompute": on_drop}
        mech_restore = {"swap": on_load, "host": on_fetch,
                        "recompute": on_recompute}
        handlers = {F: wrap(on_f), B: wrap(on_b)}
        for op, pol in respol.RELEASE_OPS.items():
            handlers[op] = wrap(mech_release[pol.mechanism])
        for op, pol in respol.RESTORE_OPS.items():
            handlers[op] = wrap(mech_restore[pol.mechanism])
        P.run(schedule.streams, handlers, observer=observer, dep_gated=True)
        xfers.drain()                       # no copy escapes the step

        loss = sum(losses.values()) * scale
        with span("pipe.merge"):
            stage_grads = [
                T.unflatten(paths, [torch.zeros_like(t) if g is None else g
                                    for t, g in zip(leaves, gs)])
                for paths, leaves, gs in zip(stage_paths, stage_leaves,
                                             grads)]
            merged = self.splitter.merge(stage_grads)
        stats = store.stats()
        stats.transfers_inflight_peak = xfers.inflight_peak
        return StepResult(loss=loss, grads=merged, stats=stats,
                          events=list(observer.spans)
                          if observer is not None else None, t0_ns=t0_ns)
