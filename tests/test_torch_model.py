"""The port's serving slice end to end vs the JAX model (fp32, CPU).

Params come from ``repro.models.model.init_params`` through the bridge;
tokens from a numpy seed. forward logits, and prefill + 4 decode steps,
agree at 2e-4 (the bound of tests/test_models.py), in both attention arms;
the greedy serve loop picks the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.serve import serve

TOL = 2e-4

ARCHS = [
    ("llama-65b", {}),
    ("gpt3-96b", {}),                         # LayerNorm, GELU, qkv bias
    ("qwen1.5-0.5b", {}),                     # tied embeddings
    ("qwen1.5-0.5b-swa", {"window_size": 8}),  # ring KV cache
]


def _setup(arch, kw, impl, num_layers=2):
    over = dict(dtype="float32", attn_impl=impl, num_layers=num_layers)
    jc = dataclasses.replace(get_config(arch).reduced(**kw), **over)
    tc = dataclasses.replace(tget_config(arch).reduced(**kw), **over)
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
    return (jc, tc, jax.tree.map(jnp.asarray, params),
            bridge.to_torch(params, device="cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch,kw", ARCHS)
def test_forward_prefill_decode_match(arch, kw, impl):
    jc, tc, jp, tp = _setup(arch, kw, impl)
    b, s, n_dec = 2, 20, 4
    toks = _tokens(jc, b, s)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    assert aux == 0.0
    _close(got, want)

    sp = s - n_dec
    jst = JM.init_decode_state(jc, b, s)
    tst = TM.init_decode_state(tc, b, s, device="cpu")
    jl, jst, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :sp])}, jc, jst)
    tl, tst, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :sp]).long()},
                            tc, tst)
    _close(tl, jl)
    for i in range(sp, s):
        jl, jst = JM.decode_step(jp, jnp.asarray(toks[:, i]), jnp.int32(i), jst, jc)
        tl, tst = TM.decode_step(tp, torch.from_numpy(toks[:, i]).long(), i,
                                 tst, tc)
        _close(tl, jl)
        _close(tl, want[:, i])  # decode agrees with the port's own forward too


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch,kw", ARCHS)
def test_serve_tokens_equal(arch, kw, impl):
    """The greedy serve loop (prefill step + serve steps) picks the same
    tokens as the JAX twin's."""
    jc, tc, jp, tp = _setup(arch, kw, impl, num_layers=3)
    b, sp, gen = 3, 12, 6
    toks = _tokens(jc, b, sp, seed=1)
    jst = JM.init_decode_state(jc, b, sp + gen)
    logits, jst = JS.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)}, jst)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    step = JS.make_serve_step(jc)
    for i in range(gen - 1):
        tok, _, jst = step(jp, jst, tok, jnp.int32(sp + i))
        want.append(tok)
    res = serve(tp, tc, torch.from_numpy(toks).long(), gen)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.stack(want, 1)))
    assert res["tokens"].dtype == torch.int32
