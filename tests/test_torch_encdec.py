"""The last three families of the JAX package in the port, end to end
against it (fp32, CPU): xlstm-125m (mLSTM, sLSTM), whisper-small (an
encoder and cross attention over its states) and internvl2-1b (vision
prefix embeddings before the tokens).

Params come from ``repro.models.model.init_params`` through the bridge,
tokens and stub frontend embeddings from numpy seeds, seq <= 33 (33 takes
the mLSTM's pad path at chunk 16). Bounds: loss 1e-5 and grads 2e-4 /
1e-3 (tests/test_torch_families.py), logits 2e-4 (tests/test_models.py),
the executor twins tests/test_executor.py:34-37's 1e-5 and 2e-6 / 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jdata
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import serve as tserve
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.optim import adam as tadam
from repro_torch.train import steps as TS

LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 1e-3
LOGIT_TOL = 2e-4
FAMILIES = ["xlstm-125m", "whisper-small", "internvl2-1b"]
FRAMES = 16  # the stub encoder's frames at smoke scale (examples/serve.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads (see
    tests/test_torch_executor.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, **over):
    """(JAX cfg, port cfg) at smoke scale in fp32: xlstm-125m one (MLSTM,
    SLSTM) block, whisper-small 2 encoder and 2 decoder layers, internvl2-1b
    2 layers and 4 prefix embeddings."""
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(tget_config(arch).reduced(), **over))


def _params(jc, seed=0):
    p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jc))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _frontend(cfg, b, rng):
    """The stub frontend's inputs of ``cfg``'s family, numpy fp32."""
    out = {}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _batch(cfg, b=2, s=33, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels, **_frontend(cfg, b, rng)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _trees_close(got, want, atol, rtol):
    want = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(T.leaves_with_paths(got))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], atol=atol,
                                   rtol=rtol, err_msg="/".join(k))


def _close(t, j, tol=LOGIT_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol)


# ---------------------------------------------------------------------------
# Params and the pieces whisper adds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_jax_layout(arch):
    """The port's own init gives the JAX tree (whisper's encoder under
    encoder/{blocks,norm}, a cross attention without q/k norms in each
    decoder layer) with the same shapes and dtypes, and the bridge carries
    the JAX params over bit for bit."""
    jc, tc = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    want = dict(T.leaves_with_paths(jp))
    got = dict(T.leaves_with_paths(tp))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if jc.is_encdec:
        assert ("encoder", "blocks", "pos0", "mixer", "wq") in got
        assert ("blocks", "pos0", "cross", "wk") in got
    back = dict(T.leaves_with_paths(bridge.to_numpy(bridge.to_torch(jp, device="cpu"))))
    for k in want:
        assert np.array_equal(back[k], want[k]), k


def test_sdpa_bidirectional_matches_jax():
    """causal=False: every key is seen, ring slots at -1 still masked."""
    jc, tc = _cfgs("whisper-small")
    rng = np.random.default_rng(3)
    b, sq, sk, n, hd = 2, 5, 7, jc.num_heads, jc.head_dim
    q = rng.standard_normal((b, sq, n, hd), np.float32)
    k = rng.standard_normal((b, sk, n, hd), np.float32)
    v = rng.standard_normal((b, sk, n, hd), np.float32)
    qpos = np.zeros((b, sq), np.int32)
    kpos = np.array([[0, 1, 2, 3, 4, 5, 6], [0, 0, 0, -1, 0, 0, -1]], np.int32)
    want = JA._sdpa(*map(jnp.asarray, (q, k, v, )), jc, jnp.asarray(qpos),
                    jnp.asarray(kpos), causal=False, window=0)
    got = TA._sdpa(*map(torch.from_numpy, (q, k, v)), tc, torch.from_numpy(qpos),
                   torch.from_numpy(kpos), causal=False, window=0)
    _close(got, want, 1e-5)


def test_encode_and_cross_attention_match_jax():
    """whisper's encoder (RoPE'd bidirectional self attention over the
    frames, then its norm) and one decoder layer's cross attention over
    its states; the flash arm's encoder takes _sdpa as the reference's."""
    jc, tc = _cfgs("whisper-small", attn_impl="flash")
    jp, tp = _params(jc)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, FRAMES, jc.d_model)).astype(np.float32)
    jenc = JM.encode(jp, jnp.asarray(emb), jc)
    tenc = TM.encode(tp, torch.from_numpy(emb), tc)
    _close(tenc, jenc, 1e-5)
    x = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
    jcross = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["cross"])
    tcross = T.tree_map(lambda t: t[0], tp["blocks"]["pos0"]["cross"])
    want = JA.cross_attention(jcross, jnp.asarray(x), jenc, jc)
    got = TA.cross_attention(tcross, torch.from_numpy(x), tenc, tc)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# Loss, grads, training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, impl):
    """loss_fn and its grads at b 2 x 33 tokens (internvl: after 4 prefix
    embeddings; whisper: over 16 frames), every param's grad, the
    encoder's included."""
    jc, tc = _cfgs(arch, attn_impl=impl)
    jp, tp = _params(jc)
    batch = _batch(jc)
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, _jb(batch), jc)[0])(jp)
    tl, tg = TS.make_loss_grad(tc, TrainConfig())(tp, _tb(batch))
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    _trees_close(tg, jg, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("remat", ["attn", "full"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-small"])
def test_remat_arms_equal_no_remat(arch, remat):
    """The recompute arms give the port's own no-recompute loss and grads
    bit for bit (whisper's blocks take the encoder's states through the
    checkpoint; "attn" leaves the xLSTM mixers alone, as the twin)."""
    _, tc = _cfgs(arch, attn_impl="flash")
    _, tp = _params(_cfgs(arch)[0])
    batch = _tb(_batch(tc, s=20))
    l0, g0 = TS.make_loss_grad(tc, TrainConfig())(tp, batch)
    l1, g1 = TS.make_loss_grad(tc, TrainConfig(remat=remat))(tp, batch)
    assert torch.equal(l0, l1)
    for (k, a), (_, b) in zip(T.leaves_with_paths(g0), T.leaves_with_paths(g1)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_track_jax(arch):
    """make_train_step (flash arm) on make_batch's data, three steps: each
    loss within 1e-4 of the JAX step's, the params after them within 2e-4
    / 1e-3. whisper's batches carry make_batch's 1500 frames."""
    jc, tc = _cfgs(arch, attn_impl="flash")
    jp, tp = _params(jc)
    kw = dict(global_batch=2, seq_len=16, steps=3, warmup_steps=1,
              learning_rate=1e-3)
    jstep = JS.make_train_step(jc, JTrainConfig(**kw))
    tstep = TS.make_train_step(tc, TrainConfig(**kw))
    jst, tst = jadam.init(jp), tadam.init(tp)
    dc = jdata.DataConfig(batch=1 if jc.is_encdec else 2, seq_len=16, seed=3)
    for i in range(3):
        batch = jdata.make_batch(jc, dc, i)
        jp, jst, jm = jstep(jp, jst, _jb(batch))
        tp, tst, tm = tstep(tp, tst, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4)
    _trees_close(tp, jp, GRAD_ATOL, GRAD_RTOL)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match(arch, impl):
    """The twin of tests/test_models.py:137-170: forward logits, then
    prefill of 20 tokens (after the VLM's prefix, over the encoder's
    states) and 4 decode steps at positions offset by the prefix, against
    JAX and against the port's own forward; the decode state against
    JAX's after the prefill and after the steps."""
    jc, tc = _cfgs(arch, attn_impl=impl)
    jp, tp = _params(jc)
    b, s, n_dec = 2, 24, 4
    batch = _batch(jc, b=b, s=s, seed=5)
    del batch["labels"]
    want, _ = JM.forward(jp, _jb(batch), jc)
    got, _ = TM.forward(tp, _tb(batch), tc)
    _close(got, want)
    npre = jc.num_prefix_embeds if jc.frontend == "vision" else 0
    sp = s - n_dec
    pre = dict(batch, tokens=batch["tokens"][:, :sp])
    jst = JM.init_decode_state(jc, b, s + npre)
    tst = TM.init_decode_state(tc, b, s + npre, device="cpu")
    jl, jst, jenc = JM.prefill(jp, _jb(pre), jc, jst)
    tl, tst, tenc = TM.prefill(tp, _tb(pre), tc, tst)
    _close(tl, jl)
    _close(tl, want[:, sp - 1])
    assert (tenc is None) == (jenc is None)
    _trees_close(tst, jst, LOGIT_TOL, 0)
    toks = batch["tokens"]
    for i in range(sp, s):
        jl, jst = JM.decode_step(jp, jnp.asarray(toks[:, i]), jnp.int32(i + npre),
                                 jst, jc, enc_states=jenc)
        tl, tst = TM.decode_step(tp, torch.from_numpy(toks[:, i]).long(),
                                 i + npre, tst, tc, enc_states=tenc)
        _close(tl, jl)
        _close(tl, got[:, i])
    _trees_close(tst, jst, LOGIT_TOL, 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_equal(arch):
    """``serve`` picks the tokens of the JAX loop of examples/serve.py:
    max_len sp + gen + npre, decode positions sp + npre + i, the encoder's
    states passed to each step."""
    jc, tc = _cfgs(arch, attn_impl="flash")
    jp, tp = _params(jc)
    b, sp, gen = 3, 12, 6
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jc.vocab_size, (b, sp)).astype(np.int32)
    front = _frontend(jc, b, rng)
    npre = jc.num_prefix_embeds if jc.frontend == "vision" else 0
    jst = JM.init_decode_state(jc, b, sp + gen + npre)
    prefill_logits, jst, enc = JM.prefill(jp, _jb({"tokens": toks, **front}),
                                          jc, jst)
    tok = jnp.argmax(prefill_logits, -1).astype(jnp.int32)
    want = [tok]
    step = JS.make_serve_step(jc)
    for i in range(gen - 1):
        tok, _, jst = step(jp, jst, tok, jnp.int32(sp + npre + i), enc)
        want.append(tok)
    res = tserve.serve(tp, tc, torch.from_numpy(toks).long(), gen,
                       **{k: torch.from_numpy(v) for k, v in front.items()})
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.stack(want, 1)))
    _close(res["prefill_logits"], prefill_logits)
