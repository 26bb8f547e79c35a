"""xLSTM cells (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan with recurrent h-feedback). The
twin of the JAX package's ``repro/models/xlstm.py``.

mLSTM training uses the chunkwise formulation: the work inside a chunk of L
steps is dense (L x L) products, the state crosses chunks through a Python
loop over s / L chunks (the twin's ``lax.scan``). The exact sequential form
(``mlstm_sequential``) is kept as the oracle, and the decode step is its
single step. The sLSTM is a Python loop over time. All gate bookkeeping is
log-space stabilised (m); the stabilisers start at -inf, and exp(-inf) = 0
is the first step's decay.

dtypes, as in the twin: the mLSTM's q/k/v/output-gate products run in the
compute dtype (``cast_matmul``), q is scaled in fp32, and the recurrence
runs in fp32 with fp32 gates; the sLSTM's pre-activations are an fp32
product with the fp32 weights (TF32 stays off on a card, as for the RG-LRU
gates), and only its output projection runs in the compute dtype.

A profiler sees the mLSTM's loop over chunks as the range "mlstm_chunk" and
the sLSTM's loop over time as "slstm_scan"; their backwards are the
autograd nodes of the ops inside.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import _heads, _merge_heads
from repro_torch.models.layers import _winit, gather_dims, pointwise
from repro_torch.obs.ranges import span


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, device):
    d, nh, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    bif = torch.zeros((nh, 2), device=device)
    bif[:, 1] = 3.0
    return {
        "wq": _winit(gen, (d, nh, hd), d, device),
        "wk": _winit(gen, (d, nh, hd), d, device),
        "wv": _winit(gen, (d, nh, hd), d, device),
        "wo": _winit(gen, (nh, hd, d), nh * hd, device),
        "wif": _winit(gen, (d, nh, 2), d, device),    # i~, f~ preacts per head
        "bif": bif,
        "wog": _winit(gen, (d, nh, hd), d, device),   # output gate
    }


def _mlstm_qkvg(p, x, cfg):
    """q (fp32, scaled), k, v (compute dtype), the log input preactivation
    li, the log forget gate lf (fp32, (b, s, nh)) and the output gate og
    (fp32, (b, s, nh, hd))."""
    scale = float(np.float32(1.0 / np.sqrt(cfg.head_dim)))
    # the twin multiplies by a numpy float64 scalar, which promotes a bf16
    # product to fp32
    q = _heads(x, p["wq"]).float() * scale
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    gates = _heads(x, p["wif"]).float() + p["bif"]
    li = gates[..., 0]
    lf = pointwise(F.logsigmoid, gates[..., 1])
    og = torch.sigmoid(_heads(x, p["wog"]).float())
    return q, k, v, li, lf, og


def init_mlstm_state(cfg, batch, device):
    return _zero_mlstm_state(batch, cfg.num_heads, cfg.head_dim, device)


def _zero_mlstm_state(batch, nh, hd, device):
    return {
        "C": torch.zeros((batch, nh, hd, hd), device=device),  # (key, value)
        "n": torch.zeros((batch, nh, hd), device=device),
        "m": torch.full((batch, nh), -torch.inf, device=device),
    }


def _mlstm_step_core(q, k, v, li, lf, state):
    """One stabilised mLSTM step. q/k/v: (b, nh, hd) fp32; li/lf: (b, nh).
    Returns (h, new state); the given state is not written."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)          # decays; exp(-inf - ...) -> 0
    ip = torch.exp(li - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bnk,bnkv->bnv", q, C)
    den = torch.maximum(torch.einsum("bnk,bnk->bn", q, n).abs(), torch.exp(-m_new))
    return num / den[..., None], {"C": C, "n": n, "m": m_new}


def mlstm_sequential(p, x, cfg, state=None):
    """Oracle: step by step over time. x: (b, s, d) -> ((b, s, nh, hd),
    state)."""
    q, k, v, li, lf, og = _mlstm_qkvg(p, x, cfg)
    state = state or init_mlstm_state(cfg, x.shape[0], x.device)
    hs = []
    for qt, kt, vt, lit, lft in zip(*(t.unbind(1) for t in (
            q, k.float(), v.float(), li, lf))):
        h, state = _mlstm_step_core(qt, kt, vt, lit, lft, state)
        hs.append(h)
    h = torch.stack(hs, 1) * og
    return h.to(x.dtype), state


def _chunk(t, nc, L):
    """(b, nc * L, nh[, hd]) -> (nc, b, nh, L[, hd]): the twin's
    moveaxis + transpose of the chunked sequence."""
    b = t.shape[0]
    t = t.reshape(b, nc, L, *t.shape[2:]).transpose(2, 3)
    return t.transpose(0, 1)


def mlstm_chunkwise(p, x, cfg, state=None):
    """Chunkwise-parallel mLSTM (equals ``mlstm_sequential`` to fp32
    tolerance): chunks of length L, intra-chunk attention-like products and
    the state carried over the s / L chunks. On DTensors the recurrence runs
    on each rank's local rows and heads (``_mlstm_local``)."""
    from torch.distributed.tensor import DTensor
    b, s0, _ = x.shape
    L = min(cfg.chunk_size, s0)
    pad = (-s0) % L
    if pad:  # causal: trailing zero-pad never influences earlier outputs
        x = F.pad(x, (0, 0, 0, pad))
    s = s0 + pad
    q, k, v, li, lf, og = _mlstm_qkvg(p, x, cfg)
    if pad:  # pad steps are state-neutral: f = 1 (no decay), i = 0 (no write)
        valid = (torch.arange(s, device=x.device) < s0)[None, :, None]
        li = torch.where(valid, li, -torch.inf)
        lf = torch.where(valid, lf, 0.0)
    if not isinstance(q, DTensor):
        h, state = _chunkwise(q, k, v, li, lf, og, state, L)
    else:
        h, state = _mlstm_local(q, k, v, li, lf, og, state, L)
    return h[:, :s0].to(x.dtype), state


def _mlstm_local(q, k, v, li, lf, og, state, L):
    """``_chunkwise`` on each rank's local rows and heads. q/k/v/og (b, s,
    nh, hd) and li/lf (b, s, nh) are DTensors; they take the placements
    attention takes (``attention._flash_placements``: batch rows and whole
    heads a rank, so no rank's recurrence needs another's), every move
    recorded in ``rules.REDISTRIBUTIONS``. The state (b, nh, ...) takes the
    same placements with the heads at dim 1. Returns h (b, s, nh, hd) and
    the end state as DTensors of those placements. DTensor's rules for the
    chunk reshapes and the 4-operand state einsum fail where head_dim is
    sharded (4 heads on 16 "model" ranks relocate onto it)."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.attention import _flash_placements
    from repro_torch.sharding import rules
    mesh, want = q.device_mesh, _flash_placements(q, k)
    st_want = tuple(Shard(1) if pl == Shard(2) else pl for pl in want)
    local = [rules.redistribute(t, want, "mlstm_" + name).to_local()
             for name, t in zip(("q", "k", "v", "li", "lf", "og"),
                                (q, k, v, li, lf, og))]
    if state is not None:
        state = {n: rules.redistribute(t, st_want, "mlstm_state").to_local()
                 for n, t in state.items()}
    h, end = _chunkwise(*local, state, L)
    wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)
    return wrap(h, want), {n: wrap(t, st_want) for n, t in end.items()}


def _chunkwise(q, k, v, li, lf, og, state, L):
    """The chunkwise recurrence over plain tensors: q/k/v/og (b, s, nh, hd),
    li/lf (b, s, nh), s a multiple of L. Returns (h * og (b, s, nh, hd)
    fp32, the end state)."""
    b, s, nh, hd = q.shape
    nc = s // L
    qc, kc, vc = (_chunk(t.float(), nc, L) for t in (q, k, v))
    lic, lfc = (_chunk(t, nc, L) for t in (li, lf))       # (nc, b, nh, L)

    state = state or _zero_mlstm_state(b, nh, hd, q.device)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = state["C"], state["n"], state["m"]
    hs = []
    with span("mlstm_chunk"):
        for qt, kt, vt, lit, lft in zip(*(t.unbind(0) for t in (
                qc, kc, vc, lic, lfc))):
            g = torch.cumsum(lft, dim=-1)               # inclusive decay cumsum
            sj = lit - g                                # s_j = li_j - g_j
            M = torch.maximum(m0[..., None], torch.cummax(sj, dim=-1).values)
            # intra-chunk: D_tj = exp(s_j - M_t), j <= t
            D = torch.exp(sj[..., None, :] - M[..., :, None])
            D = torch.where(causal, D, 0.0)
            scores = torch.einsum("bnth,bnjh->bntj", qt, kt) * D
            num = torch.einsum("bntj,bnjh->bnth", scores, vt)
            # inter-chunk contributions
            w_inter = torch.exp(m0[..., None] - M)      # (b, nh, L)
            num = num + w_inter[..., None] * torch.einsum("bnth,bnhv->bntv", qt, C0)
            qn = torch.einsum("bnth,bnh->bnt", qt, n0) * w_inter
            qn_intra = scores.sum(-1)                   # sum_j D_tj (q_t . k_j)
            denom = torch.maximum((qn + qn_intra).abs(), torch.exp(-(g + M)))
            hs.append(num / denom[..., None])           # (b, nh, L, hd)
            # end-of-chunk state
            gL = g[..., -1:]                            # (b, nh, 1)
            ML = torch.maximum(m0, torch.amax(sj, dim=-1))
            m1 = gL[..., 0] + ML
            wC0 = torch.exp(m0 - ML)   # = exp(m0 + g_L - m1)
            wkj = torch.exp(gL - g + lit - m1[..., None])   # (b, nh, L)
            C0 = wC0[..., None, None] * C0 + torch.einsum(
                "bnt,bnth,bntv->bnhv", wkj, kt, vt)
            n0 = wC0[..., None] * n0 + torch.einsum("bnt,bnth->bnh", wkj, kt)
            m0 = m1
    h = torch.stack(hs, 1).transpose(2, 3).reshape(b, s, nh, hd)
    return h * og, {"C": C0, "n": n0, "m": m0}


def apply_mlstm_block(p, x, cfg):
    h, _ = mlstm_chunkwise(p, x, cfg)
    return _merge_heads(h, p["wo"])


def apply_mlstm_block_step(p, x, cfg, state):
    """Decode: x (b, 1, d) -> ((b, 1, d), state), the state written in
    place."""
    q, k, v, li, lf, og = _mlstm_qkvg(p, x, cfg)
    # a copy of the state: the step's products save it, and it is written below
    h, new = _mlstm_step_core(q[:, 0], k[:, 0].float(), v[:, 0].float(),
                              li[:, 0], lf[:, 0],
                              {k_: t.clone() for k_, t in state.items()})
    out = _merge_heads((h * og[:, 0]).to(x.dtype), p["wo"])
    for k_, t in new.items():
        state[k_].copy_(t)
    return out[:, None], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, device):
    d, nh, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    b = torch.zeros((4, nh, hd), device=device)
    b[2] = 3.0                                       # forget-bias +3
    return {"w": _winit(gen, (4, d, nh, hd), d, device),      # z, i, f, o preacts
            "r": _winit(gen, (4, nh, hd, hd), hd, device) * 0.5,  # block-diag/head
            "b": b,
            "wo": _winit(gen, (nh, hd, d), nh * hd, device)}


def init_slstm_state(cfg, batch, device):
    return _zero_slstm_state((batch, cfg.num_heads, cfg.head_dim), device)


def _zero_slstm_state(shape, device):
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, -torch.inf, device=device)}


def _slstm_pre(p, x):
    """The fp32 input preactivations, bias included: the einsum
    "...d,gdnh->...gnh" of x with w, plus b. x: (..., d) -> (..., 4, nh, hd)."""
    g, d, nh, hd = p["w"].shape
    w = gather_dims(p["w"], (2, 3)).permute(1, 0, 2, 3).reshape(d, g * nh * hd)
    # the bias whole too: a head or head_dim shard of it would shard the
    # preactivations, whose grad the product's backward merges again
    b = gather_dims(p["b"], (1, 2), tag="slstm_b")
    return (x.float() @ w).unflatten(-1, (g, nh, hd)) + b


def _recurrent_weights(r):
    """The recurrent weights r (4, nh, hd, hd) as one (nh, hd, 4 hd) matrix
    a head, so a step's recurrent product is one ``bmm``."""
    g, nh, hd, _ = r.shape
    return gather_dims(r, (3,)).permute(1, 2, 0, 3).reshape(nh, hd, g * hd)


def _slstm_step_core(pre_x, rr, state):
    """pre_x: (b, 4, nh, hd) input preactivations (bias included); rr: the
    recurrent weights of ``_recurrent_weights``. Returns (h, new state); the
    given state is not written."""
    h0, c0, n0, m0 = state["h"], state["c"], state["n"], state["m"]
    b, g, nh, hd = pre_x.shape
    # the einsum "bnh,gnhj->bgnj" of h0 with r
    rec = torch.bmm(h0.transpose(0, 1), rr).view(nh, b, g, hd).permute(1, 2, 0, 3)
    za, ia, fa, oa = (pre_x + rec).unbind(1)
    z = torch.tanh(za)
    fm = fa + m0
    m1 = torch.maximum(fm, ia)                      # exp-forget-gate variant
    fp = torch.exp(fm - m1)
    ip = torch.exp(ia - m1)
    c1 = fp * c0 + ip * z
    n1 = fp * n0 + ip
    h1 = torch.sigmoid(oa) * c1 / torch.maximum(n1, torch.exp(-m1))
    return h1, {"h": h1, "c": c1, "n": n1, "m": m1}


def _slstm_local(pre, rr, state, steps):
    """``steps(pre, rr, state)`` on each rank's local rows: the input
    preactivations pre (b, ..., 4, nh, hd) and the state (b, nh, hd) take
    attention's placements less its head shards
    (``attention._flash_placements(pre, pre, heads=False)``: a shard of the
    rows stays, any other mesh dim shards the rows further where they
    divide it and is replicated where they do not, so that no rank's
    recurrence needs another's), the recurrent weights whole (their grad a
    partial sum over the mesh dims that shard the rows), every move
    recorded in ``rules.REDISTRIBUTIONS``.
    Returns (h, state) as DTensors of those placements. The loop over time
    runs on plain tensors: DTensor's rules for the recurrent product's
    reshapes fail where head_dim is sharded (a batch of 1 relocated onto
    it), and its dispatch would cost the host a lookup an op a step."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.attention import _flash_placements
    from repro_torch.sharding import rules
    if not isinstance(pre, DTensor):
        return steps(pre, rr, state)
    mesh, want = pre.device_mesh, _flash_placements(pre, pre, heads=False)
    pre = rules.redistribute(pre, want, "slstm_pre").to_local()
    if isinstance(rr, DTensor):
        # each rank's grad of the weights sums its own rows only: a partial
        # sum over the mesh dims that shard the rows
        rr = rules.redistribute(rr, (Replicate(),) * mesh.ndim, "slstm_r").to_local(
            grad_placements=[Partial() if pl == Shard(0) else Replicate()
                             for pl in want])
    if state is not None:
        state = {n: rules.redistribute(t, want, "slstm_state").to_local()
                 for n, t in state.items()}
    h, end = steps(pre, rr, state)
    wrap = lambda t: DTensor.from_local(t, mesh, want, run_check=False)
    return wrap(h), {n: wrap(t) for n, t in end.items()}


def _slstm_steps(pre, rr, state):
    """The sLSTM loop over time on plain tensors: pre (b, s, 4, nh, hd)."""
    b, _, _, nh, hd = pre.shape
    state = state or _zero_slstm_state((b, nh, hd), pre.device)
    hs = []
    with span("slstm_scan"):
        for pre_t in pre.unbind(1):
            h, state = _slstm_step_core(pre_t, rr, state)
            hs.append(h)
    return torch.stack(hs, 1), state


def slstm_scan(p, x, cfg, state=None):
    """x: (b, s, d) -> ((b, s, nh, hd), state). Strictly sequential; on
    DTensors on each rank's local rows (``_slstm_local``)."""
    h, state = _slstm_local(_slstm_pre(p, x), _recurrent_weights(p["r"]),
                            state, _slstm_steps)
    return h.to(x.dtype), state


def apply_slstm_block(p, x, cfg):
    h, _ = slstm_scan(p, x, cfg)
    return _merge_heads(h, p["wo"])


def apply_slstm_block_step(p, x, cfg, state):
    """Decode: x (b, 1, d) -> ((b, 1, d), state), the state written in
    place."""
    h, new = _slstm_local(_slstm_pre(p, x[:, 0]), _recurrent_weights(p["r"]),
                          {k: t.clone() for k, t in state.items()},
                          _slstm_step_core)
    out = _merge_heads(h.to(x.dtype), p["wo"])
    for k, t in new.items():
        state[k].copy_(t)
    return out[:, None], state
