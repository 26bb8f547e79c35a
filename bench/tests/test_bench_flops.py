"""The frozen FLOP and byte counts on hand-worked shapes."""
import pytest

from bench import flops, spec


# gpt3-96b (arXiv:2401.02088 Table 2) at 4 of its 80 layers, as the
# program's configs/gpt3_96b.py holds it; no shipped cell runs it yet.
GPT3_96B_4L = dict(name="gpt3-96b", family="dense", source="arXiv:2401.02088 Table 2",
                   num_layers=4, d_model=9984,
                   num_heads=104, num_kv_heads=104, head_dim=96, d_ff=39936,
                   vocab_size=51200, block_pattern=["attn"], mlp_kind="gelu",
                   norm="layernorm", qkv_bias=True, tie_embeddings=False,
                   rope_theta=10000.0, dtype="bfloat16")


def model(config):
    if config == "gpt3":
        return dict(GPT3_96B_4L)
    return spec.load_cell("granite-moe.bpipe.b4").config["model"]


def test_gpt3_96b_four_layers_is_32_27_gflop_a_token():
    m = model("gpt3")
    d, hd, ff, v = 9984, 96, 39936, 51200
    layer = d * hd * 312 + 104 * hd * d + hd * 312 + 2 * d * ff + 2 * d
    assert flops.n_active(m) == 4 * layer + v * d == 5_296_032_768
    want = 6 * (4 * layer + v * d) + 6 * 4 * 2048 * d
    assert flops.flops_per_token(m, 2048) == want
    assert round(want / 1e9, 2) == 32.27


def test_granite_is_2_874_gflop_a_token_at_2048_and_3_176_at_4096():
    m = model("granite")
    d = 1024
    layer = d * 64 * 32 + 16 * 64 * d + d * 32 + 8 * 3 * d * 512 + 2 * d
    assert flops.n_active(m) == 24 * layer + 49155 * d
    assert round(flops.flops_per_token(m, 2048) / 1e9, 3) == 2.874
    assert round(flops.flops_per_token(m, 4096) / 1e9, 3) == 3.176


def test_the_frozen_count_equals_the_programs_today():
    """Today's program counts the same (``core/flops.model_flops_6nd``); the
    frozen copy stays when the program's moves."""
    from repro_torch.core.flops import model_flops_6nd
    for name in ("gpt3", "granite"):
        cfg = spec.model_config({"model": model(name)})
        assert flops.n_active(model(name)) == round(model_flops_6nd(cfg, 1, 1) / 6)


@pytest.mark.parametrize("s", [1, 7, 2048, 4096])
def test_causal_pairs_are_the_lower_triangle(s):
    assert flops.causal_pairs(s, s) == s * (s + 1) // 2
    assert flops.causal_pairs(s, s, causal=False) == s * s


def test_attention_bounds_by_hand():
    # gpt3-96b's microbatch: b 1, s 2048, 104 x 96 heads, bf16
    pairs = 2048 * 2049 // 2
    fwd, by = flops.attention_bound(1, 2048, 2048, 104, 104, 96, 2)
    assert by == "operations" and fwd == pytest.approx(4 * 104 * 96 * pairs / 989e12)
    bwd = flops.bwd_bounds(1, 2048, 2048, 104, 104, 96, 2)
    assert bwd["dq"][0] == pytest.approx(3 * 2 * 104 * 96 * pairs / 989e12)
    assert bwd["dkv"][0] == pytest.approx(4 * 2 * 104 * 96 * pairs / 989e12)
    # a short sequence is bound by bytes: q, k, v, O in bf16, LSE in fp32
    t, by = flops.attention_bound(1, 16, 16, 8, 8, 64, 2)
    assert by == "bytes"
    assert t == pytest.approx((4 * 16 * 8 * 64 * 2 + 16 * 8 * 4) / 3.35e12)


def test_step_mfu_reads_the_device_time_and_idle_the_window():
    """step_mfu divides by the trace's busy seconds, not the window's (which
    the profiler lengthens on the host); the idle share is the rest."""
    import types
    tokens, m = 65536, model("granite")
    ctx = types.SimpleNamespace(model=m, traffic={"seq_len": 2048}, tokens=tokens,
                                module=spec.model_module({}),
                                trace=types.SimpleNamespace(busy_s=1.5, window_s=3.0))
    want = 100 * tokens * flops.flops_per_token(m, 2048) / (1.5 * 989e12)
    assert spec.metric_reader("step_mfu")(ctx) == pytest.approx(want)
    assert spec.metric_reader("device_idle_pct")(ctx) == pytest.approx(50.0)
    ctx.trace.busy_s = 0.0
    assert spec.metric_reader("step_mfu")(ctx) is None
