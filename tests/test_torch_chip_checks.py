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


# ---------------------------------------------------------------------------
# Phase 14, the SPMD pipeline: the counts it holds the card's run to
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,p,want", [(4, 4, (13, 27)), (4, 3, (11, 23)),
                                      (8, 16, (45, 91)), (4, 16, (37, 75))])
def test_spmd_hops_per_step(m, p, want):
    """2T - 1 shifts for T = m + p - 1 ticks; bpipe_stash adds 2T."""
    assert (cs.spmd_hops(m, p, False), cs.spmd_hops(m, p, True)) == want
    assert cs.spmd_hops(m, p, True) - cs.spmd_hops(m, p, False) == 2 * (m + p - 1)


def test_spmd_hop_bytes_and_launches_at_phase_14():
    """A hop of llama-65b's microbatch (1 x 2048 x 8192 bf16) is 32 MiB; a
    rank of phase 14 (one layer, 7 ticks, 3 steps) launches the flash
    forward 42 times (forward and recompute) and each backward kernel 21."""
    t = cs.SPMD
    assert cs.spmd_hop_bytes(t["batch"] // t["m"], t["seq"], 8192, 2) == 32 * 2**20
    assert cs.spmd_flash_launches(t["m"], t["p"], t["layers"], t["steps"]) == {
        "flash_attention_fwd": 42, "flash_attention_dq": 21,
        "flash_attention_dkv": 21}


def _spmd_rehearsal(monkeypatch, rank_fn):
    """``rank_fn`` on four gloo CPU ranks at ``SPMD_SMALL``, handed
    ``spmd_reference``'s loss and grads on the same params and last batch
    as phase 14 hands them. Returns the ranks' results and the reference."""
    import sys

    from repro_torch import serve
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.ranks import run_ranks
    monkeypatch.syspath_prepend(str(ROOT))  # a spawned rank imports chip_smoke
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    t = cs.SPMD_SMALL
    cfg = serve.config_for(t["arch"], layers=t["layers"], reduced=True)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, DataConfig(batch=t["batch"], seq_len=t["seq"]), t["steps"] - 1).items()}
    loss, grads = cs.spmd_reference(torch, torch.device("cpu"), cfg, t, batch)
    ref = {"loss": loss, "grads": grads}
    return run_ranks(rank_fn, t["p"], args=(t, "cpu", "cpu", ref), timeout_s=90), ref


def _old_bars(ranks, ref):
    """The bars phase 14 had before its elementwise check: the loss within
    1e-2, each leaf's grad norm within 1e-2 relatively."""
    got = {cs.spmd_ref_key(k, r["stage"]): v
           for r in ranks for k, v in r["arms"]["bpipe"]["norms"].items()}
    loss_err = max(r["ref_loss_err"] for r in ranks)
    norm_err = max(abs(got[k] - float(g.norm())) / float(g.norm())
                   for k, g in ref["grads"].items())
    return loss_err <= 1e-2 and norm_err <= 1e-2, loss_err, norm_err


def test_spmd_phase_rehearsed_on_cpu_ranks(monkeypatch):
    """Phase 14's rank function on four gloo CPU ranks at ``SPMD_SMALL``:
    every step's hops and bytes as ``spmd_hops`` counts them, the arms bit
    for bit equal, and the loss and every grad leaf within phase 14's bars
    (``spmd_ref_check``) of ``spmd_reference`` on the same params."""
    from repro_torch import serve
    t = cs.SPMD_SMALL
    ranks, ref = _spmd_rehearsal(monkeypatch, cs.spmd_rank)
    cfg = serve.config_for(t["arch"], layers=t["layers"], reduced=True)
    hop = cs.spmd_hop_bytes(t["batch"] // t["m"], t["seq"], cfg.d_model, 4)
    for r in ranks:
        assert r["same"]
        for arm in cs.SPMD_ARMS:
            n = cs.spmd_hops(t["m"], t["p"], arm == "bpipe")
            for c in r["arms"][arm]["counters"]:
                assert c["ops"]["collective-permute"] == n
                assert c["bytes"]["collective-permute"] == n * hop
    ok, loss_err, worst, key = cs.spmd_ref_check(ranks, ref["grads"])
    print(f"faithful: loss err {loss_err:.3e}, worst leaf {worst:.3e} ({key}); "
          f"old bars (loss, norm) {_old_bars(ranks, ref)[1:]}")
    assert ok, (loss_err, worst, key)
    assert loss_err < 1e-5 and worst < 1e-5


def test_spmd_bars_catch_a_one_tick_shift(monkeypatch):
    """A planted fault: stage 0 injects each microbatch one tick late
    (``_torch_spmd_ranks.late_injection_spmd_rank``). The hops and the bit
    equality of the arms cannot see it; phase 14's bars against the
    reference must."""
    import _torch_spmd_ranks as R
    ranks, ref = _spmd_rehearsal(monkeypatch, R.late_injection_spmd_rank)
    assert all(r["same"] for r in ranks)
    ok, loss_err, worst, key = cs.spmd_ref_check(ranks, ref["grads"])
    print(f"one tick late: loss err {loss_err:.3e}, worst leaf {worst:.3e} ({key}); "
          f"old bars (ok, loss, norm) {_old_bars(ranks, ref)}")
    assert not ok
    assert worst > 100 * cs.SPMD_GRAD_RTOL


@pytest.fixture(scope="module")
def sharded_rehearsal():
    """Phase 15's rank function (``sharded_rank``) on four gloo CPU ranks,
    mesh (2, 2), at ``SHARDED_SMALL`` (reduced llama-65b, fp32) in place of
    the full width, handed ``sharded_reference``'s loss, grads and updated
    params as phase 15 hands them; one spawn runs it faithful and with the
    planted fault (``_torch_sharded_ranks.faithful_and_faulty_rank``).
    Returns both runs' results and the reference's leaf keys."""
    import sys

    import _torch_sharded_ranks as SR
    from repro_torch import serve
    from repro_torch.launch.ranks import run_ranks
    t = dict(cs.SHARDED_SMALL, data=2, model=2)
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash",
                           reduced=True)
    ref = cs.sharded_reference(torch, torch.device("cpu"), cfg, t)
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))  # a spawned rank imports chip_smoke
        mp.setitem(sys.modules, "chip_smoke", cs)
        both = run_ranks(SR.faithful_and_faulty_rank, 4,
                         args=(t, "cpu", {"full": ref}), timeout_s=90,
                         staged_key="CPU")
    return [b[0] for b in both], [b[1] for b in both], sorted(ref[1])


def test_sharded_phase_rehearsed_on_cpu_ranks(sharded_rehearsal):
    """The faithful step passes phase 15's bf16 bars with room (fp32 on both
    sides: only the order of sums differs), on one loss on every rank, with
    its collectives counted through the staged kernels."""
    ranks, _, keys = sharded_rehearsal
    ok, loss_err, worst, key = cs.sharded_check(ranks, keys)
    print(f"faithful: loss err {loss_err:.3e}, worst leaf {worst:.3e} ({key})")
    assert ok and loss_err < 1e-5 and worst < 1e-4, (loss_err, worst, key)
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    assert all(r["counters"][0]["ops"]["all-reduce"] > 0 for r in ranks)
    assert sorted(tuple(r["coords"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_bars_catch_a_rolled_head(sharded_rehearsal):
    """A planted fault: rank 1's local ``wq`` shard rolled by one head (its
    two heads swapped). Phase 15's bars must fail it by 10x or more."""
    _, ranks, keys = sharded_rehearsal
    ok, loss_err, worst, key = cs.sharded_check(ranks, keys)
    print(f"rolled head: loss err {loss_err:.3e}, worst leaf {worst:.3e} ({key})")
    assert not ok
    assert worst >= 10 * cs.SHARDED_RTOL


@pytest.mark.parametrize("row", cs.ROPE_TIMED, ids=lambda r: r[0])
def test_rope_phase_times_the_configs_shapes(row):
    """Phase 16 times the rope pair at each model's own heads and head_dim,
    and at granite-moe's benchmark microbatch (b 4 x 2048)."""
    from repro_torch.configs import get_config
    label, b, s, nq, nkv, hd = row
    cfg = get_config(label)
    assert (nq, nkv, hd) == (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert hd % 2 == 0 and hd <= 256 and s == 2048
    if label == "granite-moe-1b-a400m":
        import json
        traffic = json.loads((ROOT / "bench/traffic/bpipe.p4.b4.m8.s2048.flash.json")
                             .read_text())
        assert (b, s) == (traffic["micro_batch"], traffic["seq_len"])


def test_counts_read_and_zero_cover_the_rope_kernel():
    """Every path's launch counts read rope's two counters beside the flash
    kernels', and ``counts_zero`` sets them to 0 before a path's run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rope as rp
    rp.rope_fwd.launches, rp.rope_bwd.launches = 3, 2
    assert cs.counts_read(fa)["rope_fwd"] == 3 and cs.counts_read(fa)["rope_bwd"] == 2
    cs.counts_zero(fa)
    got = cs.counts_read(fa)
    assert set(got) == {*cs.FLASH_KEYS, "rope_fwd", "rope_bwd"}
    assert set(got.values()) == {0} and cs.flash_counts(got) == [0, 0, 0]


@pytest.mark.parametrize("rope,short", [((42, 21), False), ((84, 21), False),
                                        ((0, 0), True), ((42, 0), True)])
def test_rope_launch_bars(rope, short):
    """Phase 14's ranks launch rope as often as the flash forward and dq
    (42 and 21); a path that launches it less often than flash, as one
    whose rotary embeddings fall back to the plain chain does, is
    reported, and a path without attention (0 of each) is not."""
    t = cs.SPMD
    flash = cs.spmd_flash_launches(t["m"], t["p"], t["layers"], t["steps"])
    assert cs.rope_launches(flash) == {"rope_fwd": 42, "rope_bwd": 21}
    rows = {"path": {**flash, "rope_fwd": rope[0], "rope_bwd": rope[1]},
            "xlstm": dict.fromkeys((*cs.FLASH_KEYS, "rope_fwd", "rope_bwd"), 0)}
    assert set(cs.rope_short(rows)) == ({"path"} if short else set())
