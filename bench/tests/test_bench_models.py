"""A configuration's model module (``bench/spec.py``): the default is the
harness's own functions, and a configuration that names a module of its
own (``windowed_model.py``: ``(local_attn, attn)`` blocks in two pattern
positions, a reference with a window mask) is set up, checked and priced
through it alone, from files added to a copy of the checkout."""
import json
import shutil
import types

import pytest
import torch
from conftest import tiny_cell

from bench import check, faults, flops, inputs, reference, run, spec
from test_bench_files import check_benchmark_json, check_cell_files, check_config_file

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
MODULE = "bench/models/windowed.py"
# Trinity-Mini's attention and widths (d 2048, GQA 32/4 x 128, window 2048
# on three of four layers), here in (local_attn, attn) blocks and dense
WINDOWED = dict(name="windowed", family="dense", source="tests", num_layers=8,
                d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128, d_ff=6144,
                vocab_size=200192, block_pattern=["local_attn", "attn"], window_size=2048,
                mlp_kind="swiglu", norm="rmsnorm", tie_embeddings=False,
                rope_theta=10000.0, dtype="bfloat16")
SEED = 2**33 + 29


def _add_windowed_cell(root):
    """A copy of the checkout at ``root`` with the windowed configuration,
    its module, a traffic mix and a cell added as files and entries."""
    shutil.copytree(spec.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "bench/models").mkdir(exist_ok=True)
    shutil.copy(spec.BENCH / "tests" / "windowed_model.py", root / MODULE)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "windowed", "source": "tests", "reduced": [],
                             "file": "bench/configs/windowed.json", "why": "t"})
    (root / "bench/configs/windowed.json").write_text(json.dumps(
        {"name": "windowed", "source": "tests", "model_module": MODULE, "model": WINDOWED,
         "reduced": {}, "assumed": ["dense FFN in place of Trinity-Mini's experts"],
         "deployment": "8 layers as p 4 stages of 2 on one card"}))
    traffic = json.loads((spec.BENCH / "traffic" / "bpipe.p4.b4.m8.s2048.flash.json").read_text())
    (root / "bench/traffic/1f1b.p4.b1.m4.s2048.flash.json").write_text(
        json.dumps(dict(traffic, schedule="1f1b", micro_batch=1, microbatches=4)))
    (root / "bench/workloads/windowed.cell.json").write_text(json.dumps(
        {"limits": {k: {"limit": 0.5, "lower": 0.1, "upper": 1.0} for k in check.NUMBERS}}))
    bench["workloads"].append({"name": "windowed.cell", "config": "windowed",
                               "traffic": "1f1b.p4.b1.m4.s2048.flash", "chips": 1, "why": "t"})
    for metric in bench["per_layer"]:  # a dense model routes nothing
        if metric["name"] != "moe_route_pct":
            metric["workloads"].append("windowed.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def windowed(tmp_path):
    return tiny_cell("windowed.cell", _add_windowed_cell(tmp_path))


def go(cell, wrapper=None):
    return run.run_cell(cell, SEED, 0.2, False, "cpu", step_wrapper=wrapper,
                        log=lambda msg: None)


def test_a_windowed_cell_runs_correct_through_its_module(windowed):
    cell = windowed
    assert cell.module.__file__.endswith(MODULE) and cell.module.TINY_MODEL["window_size"]
    assert cell.limits == cell.module.TINY_LIMITS
    cfg, params, _, _ = run.build(cell, SEED, torch.device("cpu"))
    assert sorted(params["blocks"]) == ["pos0", "pos1"]
    wq = cell.module.leaf_of(params, ("layer3", "mixer", "wq"))
    assert wq.data_ptr() == params["blocks"]["pos1"]["mixer"]["wq"][1].data_ptr()
    with pytest.raises(NotImplementedError):
        inputs.param_shapes(cfg)  # the default's layout refuses it
    out = go(cell)
    assert out["correct"], out["compared"]


def test_the_windowed_reference_matches_the_program_in_fp32(windowed):
    """The module's reference (the window mask on pos0's layers) gives the
    pipelined step's loss and every leaf's gradient to fp32 rounding."""
    windowed.config["model"]["dtype"] = "float32"
    mod = windowed.module
    cfg, params, batches, ex = run.build(windowed, 2**40 + 17, torch.device("cpu"))
    res = ex.step(params, batches[0])
    numbers, stats = check.compare(
        mod.leaf_grads(cfg, params, batches[0], int(windowed.traffic["micro_batch"])),
        lambda n: mod.leaf_of(res.grads, n), float(res.loss))
    assert sorted(stats.rows) == sorted(mod.leaf_names(cfg))
    assert numbers["loss_rel"] < 1e-6
    assert numbers["grad_norm_gap"] < 1e-5 and numbers["grad_diff"] < 1e-5, numbers


def test_the_windowed_cell_passes_the_shipped_cells_checks(tmp_path):
    """The checks of ``test_bench_files.py`` over every cell and
    configuration of the copy, the windowed ones among them: a model the
    default cannot lay out gets a cell from files and entries alone."""
    root = _add_windowed_cell(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    check_benchmark_json(bench)
    for config in bench["configs"]:
        check_config_file(config, root)
    for w in bench["workloads"]:
        check_cell_files(w["name"], root)
    assert [c["name"] for c in bench["configs"]][-1] == "windowed"


def test_a_reference_that_skips_a_leaf_raises(windowed, monkeypatch):
    """Every leaf of ``leaf_names`` has to be compared: a module whose
    reference leaves one out stops the run rather than reading correct."""
    mod, skip = windowed.module, ("layer1", "mixer", "wq")
    full = mod.leaf_grads
    monkeypatch.setattr(mod, "leaf_grads", lambda *a, **k: (
        (n, g) for n, g in full(*a, **k) if n != skip))
    with pytest.raises(ValueError, match="layer1/mixer/wq"):
        go(windowed)


@pytest.mark.parametrize("fault", ["stale", "negated_leaf"])
def test_a_windowed_cell_with_a_fault_is_not_correct(windowed, fault):
    wrap = (faults.stale(windowed) if fault == "stale"
            else faults.negated_leaf(windowed, ("layer2", "mixer", "wq")))
    out = go(windowed, wrap)
    assert not out["correct"], (fault, out["compared"])


def test_the_default_module_is_the_harness_own_functions():
    mod = spec.model_module({})
    assert spec.load_cell(BENCH["workloads"][0]["name"]).module.leaf_grads is reference.leaf_grads
    pairs = [(mod.param_shapes, inputs.param_shapes), (mod.leaf_names, inputs.leaf_names),
             (mod.leaf_of, inputs.leaf_of), (mod.leaf_grads, reference.leaf_grads),
             (mod.loss_only, reference.loss_only),
             (mod.flops_per_token, flops.flops_per_token)]
    assert all(got is want for got, want in pairs)
    assert not hasattr(mod, "TINY_MODEL") and not hasattr(mod, "TINY_LIMITS")


class _Trace:
    """A traced window's flash launches: one forward, dq and dk/dv a layer
    and microbatch, each 1 ms."""

    def __init__(self, n):
        self.n = n

    def op_totals(self):
        return {f"void flash_{k}_sm90_kernel<64, 4>": (self.n, self.n * 1e-3)
                for k in ("fwd", "dq", "dkv")}


def _roofline(model, traffic):
    ctx = types.SimpleNamespace(model=model, traffic=traffic, trace=_Trace(192))
    return spec.metric_reader("flash_roofline")(ctx)


def _all_causal_roofline(model, traffic):
    """``flash_roofline`` as it read before it priced windowed layers:
    every launch one causal launch over the whole sequence."""
    shape = (int(traffic["micro_batch"]), int(traffic["seq_len"]), int(traffic["seq_len"]),
             model["num_heads"], model["num_kv_heads"], flops.head_dim(model),
             2 if model.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4)
    least = {"fwd": flops.attention_bound(*shape)[0]}
    least.update({k: v[0] for k, v in flops.bwd_bounds(*shape).items()})
    bound = spent = 0.0
    for name, (count, seconds) in _Trace(192).op_totals().items():
        for kernel in least:
            if f"flash_{kernel}_sm90_kernel" in name:
                bound += count * least[kernel]
                spent += seconds
    return 100.0 * bound / spent


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if "local_attn" not in flops._kinds(
                                      spec.load_cell(w["name"]).config["model"])])
def test_flash_roofline_reads_a_global_attention_cell_as_before(cell):
    c = spec.load_cell(cell)
    model = c.config["model"]
    assert _roofline(model, c.traffic) == _all_causal_roofline(model, c.traffic)


def test_flash_roofline_prices_each_kind_of_layer_at_its_window():
    tr = spec.load_cell(BENCH["workloads"][0]["name"]).traffic
    s8192 = dict(tr, seq_len=8192, micro_batch=1)
    kept, causal = flops.causal_pairs(8192, 8192, window=2048), flops.causal_pairs(8192, 8192)
    assert (kept, causal) == (14_681_088, 33_558_528)
    all_causal = _all_causal_roofline(WINDOWED, s8192)
    assert _roofline(dict(WINDOWED, block_pattern=["attn"]), s8192) == pytest.approx(
        all_causal, rel=1e-12)
    assert _roofline(dict(WINDOWED, block_pattern=["local_attn"]), s8192) == pytest.approx(
        all_causal * kept / causal, rel=1e-12)
    assert _roofline(WINDOWED, s8192) == pytest.approx(  # (local_attn, attn): half each
        all_causal * (0.5 * kept / causal + 0.5), rel=1e-12)
    three_one = dict(WINDOWED, block_pattern=["local_attn"] * 3 + ["attn"])
    assert _roofline(three_one, s8192) == pytest.approx(
        all_causal * (0.75 * kept / causal + 0.25), rel=1e-12)
