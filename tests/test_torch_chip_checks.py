"""The bf16 gradient checks of ``chip_smoke.py`` that need no card: the
float64 flash backward (``grads_float64``) against the port's plain
backward, and ``grad_agree_ulp``, which lets an element past 2.5e-2 differ
by one bf16 ulp only where the float64 value witnesses a rounding tie.
"""
import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch.kernels import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=0, softcap=0.0, q_offset=0),
    dict(causal=True, window=8, softcap=30.0, q_offset=0),
    dict(causal=True, window=0, softcap=0.0, q_offset=16),
], ids=["causal", "window-softcap", "q_offset"])
def test_grads_float64_equals_the_plain_backward(kw):
    """fp32 inputs with a GQA group of 3: dq, dk, dv within 1e-5 of
    ``ref.flash_attention_bwd_ref`` (the same function in fp32)."""
    gen = torch.Generator().manual_seed(0)
    b, sq, nq, nkv, hd = 2, 24, 6, 2, 16
    sk = sq + kw["q_offset"]
    q, do = (torch.randn((b, sq, nq, hd), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, sk, nkv, hd), generator=gen) for _ in range(2))
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    got = cs.grads_float64(torch, q, k, v, do, lse,
                           ref.flash_attention_delta(out, do, lse),
                           scale=1.0 / math.sqrt(hd), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w.double(), atol=1e-5, rtol=1e-5)


ULP = 2.0 ** -5  # one bf16 ulp in [4, 8)


@pytest.mark.parametrize("got0, exact0, ok", [
    (5.0 + ULP, 5.0 + ULP / 2, True),                 # at the tie
    (5.0 + ULP, 5.0 + ULP / 2 + ULP / 64, True),      # within 1/32 ulp
    (5.0 + ULP, 5.0 + ULP / 2 + ULP / 10, False),     # a tenth of an ulp off
    (5.0 + ULP, 5.0 - ULP / 4, False),                # outside the pair
    (5.0 + 2 * ULP, 5.0 + ULP, False),                # two ulps apart
], ids=["tie", "near-tie", "off-tie", "outside", "two-ulps"])
def test_grad_agree_ulp_takes_one_ulp_only_at_a_tie(got0, exact0, ok):
    want = torch.tensor([5.0, 1.0, -6.0]).to(torch.bfloat16)
    got = want.clone()
    got[0] = got0
    exact = torch.tensor([exact0, 1.0, -6.0], dtype=torch.float64)
    err, passed, past, tie = cs.grad_agree_ulp(torch, got, want, "bfloat16",
                                               lambda: exact)
    assert (err, past) == (got0 - 5.0, 1)
    assert passed is ok
    if got0 - 5.0 == ULP:
        assert tie == pytest.approx(abs(exact0 - (5.0 + ULP / 2)) / ULP)


def test_grad_agree_ulp_needs_no_witness_within_the_flat_bar():
    """No element past 2.5e-2: ``exact`` is never called."""
    want = torch.tensor([5.0, 1.0, -6.0]).to(torch.bfloat16)
    got = want.clone()
    got[1] = 1.0078125  # one ulp at 1: within 2.5e-2

    def exact():
        raise AssertionError("the witness ran without an element past 2.5e-2")

    assert cs.grad_agree_ulp(torch, got, want, "bfloat16", exact) == (
        0.0078125, True, 0, 0.0)
