"""Attention: GQA/MHA, global or sliding-window, prefill and decode.

Two implementations of full-sequence causal attention, as in the JAX twin:
  * ``reference`` — plain einsum attention (``_sdpa``),
  * ``flash``     — the flash-attention kernel (``kernels/ops``): the CUDA
    kernel on a card, its plain PyTorch version on the CPU.
Decode, bidirectional attention (whisper's encoder) and ``cross_attention``
always take ``_sdpa``. ``attention_sliced`` runs
one sequence slice over the retained KV of the slices before it
(sequence-sliced pipeline schedules).

The KV cache is updated in place (``update_kv_cache``/``fill_kv_cache``
write into the cache's tensors and return the same dict), so a stacked
cache is written through its row views and decode allocates no new cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import (_winit, apply_norm, cast_matmul,
                                       init_norm, rope_qk, scalar, softcap)

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def init_attention(gen, cfg, device, cross=False):
    """A layer's self-attention params; ``cross=True`` gives a decoder
    layer's cross-attention (whisper), which has no q/k norms."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": _winit(gen, (d, nq, hd), d, device),
        "wk": _winit(gen, (d, nkv, hd), d, device),
        "wv": _winit(gen, (d, nkv, hd), d, device),
        "wo": _winit(gen, (nq, hd, d), nq * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq, hd), device=device)
        p["bk"] = torch.zeros((nkv, hd), device=device)
        p["bv"] = torch.zeros((nkv, hd), device=device)
    if cfg.qk_norm and not cross:
        p["qnorm"] = init_norm(cfg, hd, device=device)
        p["knorm"] = init_norm(cfg, hd, device=device)
    return p


def _shards_dim(t, dim) -> bool:
    """Whether DTensor ``t`` is sharded on ``dim`` (False for a plain
    tensor): merging that dim into the one before it is not a plain
    shard."""
    return any(getattr(p, "dim", None) == dim
               for p in getattr(t, "placements", ()))


def _heads(x, w):
    """The einsum "bsd,dnh->bsnh" of x with a (d, n, h) weight, as one
    ``cast_matmul``. A DTensor weight sharded on head_dim (a relocation)
    is merged (h n) instead of (n h), which keeps its shard a plain one."""
    d, n, h = w.shape
    if _shards_dim(w, 2):
        y = cast_matmul(x, w.transpose(1, 2).reshape(d, h * n))
        return y.unflatten(-1, (h, n)).transpose(-1, -2)
    return cast_matmul(x, w.reshape(d, n * h)).unflatten(-1, (n, h))


def _merge_heads(out, w):
    """The einsum "bsnh,nhd->bsd" of the heads with an (n, h, d) weight;
    summed over (h n) where head_dim is sharded, as ``_heads``."""
    n, h, d = w.shape
    if _shards_dim(w, 1) or _shards_dim(out, out.ndim - 1):
        return cast_matmul(out.transpose(-1, -2).flatten(-2),
                           w.transpose(0, 1).reshape(h * n, d))
    return cast_matmul(out.flatten(-2), w.reshape(n * h, d))


def _project_q(p, x):
    dt = x.dtype
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if "qnorm" in p:
        q = apply_norm(p["qnorm"], q)
    return q


def _project_kv(p, x):
    dt = x.dtype
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "knorm" in p:
        k = apply_norm(p["knorm"], k)
    return k, v


def _project_qkv(p, x, cfg, positions):
    """q, k and v of x, q and k normed (qk-norm) and then rotated to their
    ``positions`` together (``rope_qk``)."""
    q = _project_q(p, x)
    k, v = _project_kv(p, x)
    q, k = _rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _rope(q, k, positions, theta):
    """``rope_qk`` of q and k; on DTensors, over each rank's local q and k
    and the rows of ``positions`` that go with them, so the kernel never
    sees a DTensor. The rotation is one of each (batch, sequence, head) row
    by its row's position, so any shard of those dims may stay: q and k
    stay as they are where neither shards head_dim nor is a partial sum and
    both hold the same (batch, sequence) rows, and otherwise take
    ``_flash_placements`` (the moves, recorded as "attn_q" and "attn_kv",
    that ``_flash`` and ``_sdpa`` would make next). The results keep the
    placements the kernel ran on."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import rules
    from repro_torch.sharding.rules import local_range
    if not isinstance(q, DTensor):
        return rope_qk(q, k, positions, theta)
    mesh = q.device_mesh

    def rows(t):
        return [local_range(t.shape[d], mesh, t.placements, d) for d in (0, 1)]

    def whole(t):  # no head_dim shard, no partial sum
        return all(pl.is_replicate() or (pl.is_shard() and pl.dim < 3)
                   for pl in t.placements)

    if not (whole(q) and whole(k) and rows(q) == rows(k)):
        want = _flash_placements(q, k)
        q = rules.redistribute(q, want, "attn_q")
        k = rules.redistribute(k, _kv_placements(want, k.shape[2], mesh),
                               "attn_kv")
    (lo, hi), (slo, shi) = rows(q)
    pos = positions.full_tensor() if isinstance(positions, DTensor) else positions
    pos = torch.broadcast_to(pos, q.shape[:2])[lo:hi, slo:shi]
    ql, kl = rope_qk(q.to_local(), k.to_local(), pos, theta)
    return tuple(DTensor.from_local(
        o, mesh, t.placements, run_check=False, shape=t.shape,
        stride=torch.empty(t.shape, device="meta").stride())
        for o, t in ((ql, q), (kl, k)))


def _sdpa(q, k, v, cfg, q_pos, k_pos, *, causal, window):
    """Reference scaled-dot-product attention with additive masking; on
    DTensors, over each rank's local heads and batch rows as ``_flash``
    (``_on_local_heads``): DTensor plans the redistributions of the 5-dim
    score einsums for seconds a layer, and some PyTorch releases refuse
    them."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return _sdpa_plain(q, k, v, cfg, q_pos, k_pos, causal=causal,
                           window=window)
    return _on_local_heads(
        q, k, v, lambda ql, kl, vl, qp, kp: _sdpa_plain(
            ql, kl, vl, cfg, qp, kp, causal=causal, window=window),
        q_pos, k_pos)


def _sdpa_plain(q, k, v, cfg, q_pos, k_pos, *, causal, window):
    """Reference scaled-dot-product attention with additive masking.

    q: (b, sq, nq, hd); k/v: (b, sk, nkv, hd); *_pos: (b, s*) int.
    The score einsum runs in the input dtype and is then upcast (fp32 when
    ``cfg.attn_fp32``), divided by sqrt(hd) and masked with NEG_INF.
    """
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    m = nq // nkv
    qr = q.reshape(b, sq, nkv, m, hd)
    score_dt = torch.float32 if cfg.attn_fp32 else q.dtype
    scores = torch.einsum("bqgmh,bkgh->bgmqk", qr, k).to(score_dt)
    scores = scores / scalar(np.sqrt(hd), score_dt, q.device)
    scores = softcap(scores, cfg.attn_softcap)
    dq = q_pos[:, None, None, :, None]
    dk = k_pos[:, None, None, None, :]
    # ring-buffer slots not yet written carry pos=-1
    mask = dk >= 0
    if causal:
        mask = mask & (dq >= dk)
    if window:
        mask = mask & (dq - dk < window)
    scores = torch.where(mask, scores, scalar(NEG_INF, score_dt, q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgmqk,bkgh->bqgmh", probs, v)
    return out.reshape(b, sq, nq, hd)


def _flash_placements(q, k, heads=True):
    """The placements q, k and v enter the kernel with, one per mesh dim: a
    batch shard stays; a head shard stays where the kv heads divide the mesh
    dim (each rank's q heads are then the groups of its kv heads); any other
    mesh dim (a shard of head_dim after a relocation, of heads that do not
    divide or of the sequence, a partial sum, a replica) shards the batch
    rows further where they divide it; where they do not, a head shard of q
    stays where each rank's q heads lie in one kv group (gemma2's 16/8 heads
    over 16: k and v then come whole over that dim, ``_kv_placements``), and
    the dim is replicated only where neither holds: every placement but the
    last gives each rank whole rows and q heads with their kv heads, so
    none computes another's attention. With ``heads`` False no head shard
    stays (the sLSTM's loop over whole rows: batch rows only). Returns q's
    placements."""
    from torch.distributed.tensor import Replicate, Shard
    nq, nkv = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    pairs = list(zip(q.placements, k.placements))
    rows = q.shape[0]
    for i, (pq, pk) in enumerate(pairs):  # the batch shards that stay
        if pq == Shard(0) and pk == Shard(0):
            rows //= mesh.size(i)
    out = []
    for i, (pq, pk) in enumerate(pairs):
        size = mesh.size(i)
        if pq == Shard(0) and pk == Shard(0):
            out.append(Shard(0))
        elif heads and Shard(2) in (pq, pk) and nq % size == 0 and nkv % size == 0:
            out.append(Shard(2))
        elif rows % size == 0:
            out.append(Shard(0))
            rows //= size
        elif heads and pq == Shard(2) and nq % size == 0 \
                and (nq // nkv) % (nq // size) == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _kv_placements(want, nkv, mesh):
    """k and v's placements beside q's ``want``: the same, but whole over a
    mesh dim that shards the q heads and not the kv heads."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if pl == Shard(2) and nkv % mesh.size(i) else pl
                 for i, pl in enumerate(want))


def _on_local_heads(q, k, v, compute, *positions):
    """``compute(q, k, v, *positions)`` on this rank's local q/k/v, taken
    with ``_flash_placements`` (each move recorded in
    ``rules.REDISTRIBUTIONS``: "attn_q", "attn_kv"), and the rows
    of each (b, s) position tensor that go with its local batch rows; the
    result a DTensor of the same placements."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.sharding import rules
    from repro_torch.sharding.rules import local_range
    mesh, want = q.device_mesh, _flash_placements(q, k)
    kv_want = _kv_placements(want, k.shape[2], mesh)
    ql = rules.redistribute(q, want, "attn_q").to_local()
    if kv_want == want:
        kl, vl = (rules.redistribute(t, want, "attn_kv").to_local() for t in (k, v))
    else:  # this rank's q heads' kv head, each rank's grad of it a partial sum
        grad_pl = [Partial() if a != b else b for a, b in zip(want, kv_want)]
        qlo, qhi = local_range(q.shape[2], mesh, want, 2)
        group = q.shape[2] // k.shape[2]
        kl, vl = (rules.redistribute(t, kv_want, "attn_kv").to_local(
            grad_placements=grad_pl)[:, :, qlo // group:(qhi - 1) // group + 1]
            for t in (k, v))
    lo, hi = local_range(q.shape[0], mesh, want, 0)
    rows = [(p.full_tensor() if isinstance(p, DTensor) else p)[lo:hi]
            for p in positions]
    return DTensor.from_local(compute(ql, kl, vl, *rows), mesh, want,
                              run_check=False)


def _flash(q, k, v, cfg, *, window, q_offset=0):
    """The flash kernel over q/k/v; on DTensors, over each rank's local
    heads and batch rows (``_on_local_heads``): the kernel never sees a
    DTensor or a head_dim shard."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    kw = dict(causal=True, window=window or 0, softcap=cfg.attn_softcap,
              q_offset=q_offset)
    if not isinstance(q, DTensor):
        return ops.flash_attention(q, k, v, **kw)
    return _on_local_heads(
        q, k, v, lambda ql, kl, vl: ops.flash_attention(ql, kl, vl, **kw))


def attention(p, x, cfg, positions, *, kind, causal=True):
    """Full-sequence (train / prefill) self attention.

    kind: 'attn' (global causal) or 'local_attn' (sliding window).
    causal=False gives bidirectional self attention (whisper's encoder),
    which takes ``_sdpa`` under either arm, as in the JAX twin.
    Returns (out, (k, v)) so prefill can build the cache.
    """
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.window_size if kind == "local_attn" else 0
    if cfg.attn_impl == "flash" and causal:
        out = _flash(q, k, v, cfg, window=window)
    else:
        out = _sdpa(q, k, v, cfg, positions, positions, causal=causal,
                    window=window)
    return _merge_heads(out, p["wo"]), (k, v)


def attention_sliced(p, x, cfg, positions, kv_prefix, *, kind):
    """Self attention for ONE sequence slice over a retained-KV prefix.

    x: (b, L, d), the slice's tokens at global ``positions`` (contiguous,
    starting at the prefix length P). kv_prefix: (k, v), each (b, P, nkv,
    hd), the post-RoPE keys and values of all earlier slices (P = 0 for
    slice 0). The slice attends causally over prefix + itself; the prefix
    covers positions [0, P), so the key positions are arange(P + L).

    Returns (out, (k_own, v_own)): the slice's own post-RoPE KV, which the
    executor keeps for later slices' prefixes.
    """
    q, k_own, v_own = _project_qkv(p, x, cfg, positions)
    pk, pv = kv_prefix
    dt = x.dtype
    k = torch.cat([pk.to(dt), k_own], dim=1)
    v = torch.cat([pv.to(dt), v_own], dim=1)
    window = cfg.window_size if kind == "local_attn" else 0
    if cfg.attn_impl == "flash":
        out = _flash(q, k, v, cfg, window=window, q_offset=int(pk.shape[1]))
    else:
        b, total_k = k.shape[0], k.shape[1]
        k_pos = torch.arange(total_k, dtype=torch.int32,
                             device=x.device)[None].expand(b, total_k)
        out = _sdpa(q, k, v, cfg, positions, k_pos, causal=True,
                    window=window)
    return _merge_heads(out, p["wo"]), (k_own, v_own)


def cross_attention(p, x, enc_states, cfg):
    """Decoder -> encoder attention (whisper): k/v projected from the
    encoder's states with this layer's weights, no RoPE across modalities,
    no mask."""
    q = _project_q(p, x)
    k, v = _project_kv(p, enc_states.to(x.dtype))
    b, sq = x.shape[:2]
    q_pos = torch.zeros((b, sq), dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = _sdpa(q, k, v, cfg, q_pos, k_pos, causal=False, window=0)
    return _merge_heads(out, p["wo"])


# ---------------------------------------------------------------------------
# Decode step with KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, kind, batch, max_len, dtype, device):
    """Global layers cache max_len slots; local layers a ring of window."""
    n = min(cfg.window_size, max_len) if kind == "local_attn" else max_len
    shape = (batch, n, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # position stored in each slot; -1 = empty
        "pos": torch.full((batch, n), -1, dtype=torch.int32, device=device),
    }


def update_kv_cache(cache, k_new, v_new, pos):
    """Write one token (b, 1, nkv, hd) at position ``pos``, in place."""
    slot = int(pos) % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot].fill_(int(pos))
    return cache


def fill_kv_cache(cache, k_seq, v_seq, start=0):
    """Bulk write a prefill sequence (b, s, nkv, hd) into the cache, in place."""
    n = cache["k"].shape[1]
    s = k_seq.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=k_seq.device) + start
    if s >= n:  # keep last n positions (ring for local layers)
        # ring alignment: position p lives at slot p % n
        roll = (s - n) % n
        cache["k"].copy_(torch.roll(k_seq[:, -n:], roll, dims=1))
        cache["v"].copy_(torch.roll(v_seq[:, -n:], roll, dims=1))
        cache["pos"].copy_(torch.roll(pos[-n:], roll, dims=0).expand_as(cache["pos"]))
        return cache
    cache["k"][:, :s] = k_seq
    cache["v"][:, :s] = v_seq
    cache["pos"][:, :s] = pos
    return cache


def attention_decode(p, x, cfg, cache, pos, *, kind):
    """One-token decode: x (b, 1, d), pos an int. Returns (out, cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache = update_kv_cache(cache, k_new, v_new, pos)
    window = cfg.window_size if kind == "local_attn" else 0
    out = _sdpa(q, cache["k"], cache["v"], cfg, positions, cache["pos"],
                causal=True, window=window)
    # the twin's einsum "bsnh,nhd->bsd" with wo, as the train path merges
    # the heads (on a mesh a plain shard of the merged heads)
    return _merge_heads(out, p["wo"]), cache
