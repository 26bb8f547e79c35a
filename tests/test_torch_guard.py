"""Guards of the port: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU, and its copies of the
configs stay equal to the JAX package's."""
import dataclasses
import importlib.util
import inspect
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro_torch import bridge, serve
from repro_torch.launch import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.pipeline import spmd as TSPMD
from repro_torch.train import steps as TS

ROOT = pathlib.Path(__file__).resolve().parent.parent
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads, and when several
    test workers share the cores, every process's BLAS threads waiting on
    each other make a run of small GEMMs minutes long."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_port_imports_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted(ROOT.glob("chip_*.py"))
    assert ROOT / "chip_smoke.py" in files
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in IMPORT.finditer(f.read_text())]
    assert not bad, bad


SPMD_MODULES = ["repro_torch.pipeline.collectives", "repro_torch.pipeline.spmd",
                "repro_torch.launch.mesh", "repro_torch.launch.ranks",
                "repro_torch.launch.roofline", "repro_torch.launch.pipeline_dryrun",
                "repro_torch.sharding.rules", "repro_torch.launch.specs",
                "repro_torch.launch.dryrun", "repro_torch.launch.staged"]


@pytest.mark.parametrize("module", SPMD_MODULES)
def test_spmd_modules_load_neither_jax_nor_repro(module):
    """Imported alone in a fresh interpreter, each module of the SPMD path
    pulls in no module of JAX or of the JAX package."""
    code = (f"import sys, {module}; bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr


REPRO_STRING = re.compile(r"""["']repro\.""")


def test_port_names_no_repro_module_in_a_string():
    """A copied module that looked a module up by name (``sys.modules``)
    must name the port's, or it reaches into the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted(ROOT.glob("chip_*.py"))
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if REPRO_STRING.search(line)]
    assert not bad, bad


def test_serve_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama-65b", "--reduced", "--prompt-len", "4",
                    "--gen", "2"])


def _reduced_llama():
    return dataclasses.replace(tcfgs.get_config("llama-65b").reduced(),
                               dtype="float32", num_layers=2)


@pytest.mark.parametrize("entry", ["init_params", "init_decode_state"])
def test_model_entry_points_default_to_cuda(entry):
    """Without a device the model's entry points take the card, and raise
    where there is none instead of building on the CPU."""
    assert inspect.signature(getattr(TM, entry)).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    cfg = _reduced_llama()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_params":
            TM.init_params(torch.Generator().manual_seed(0), cfg)
        else:
            TM.init_decode_state(cfg, 2, 8)
    assert TM.init_decode_state(cfg, 2, 8, device="cpu")["pos0"]["k"].is_cpu


def test_launch_train_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "llama-65b", "--reduced", "--steps", "1",
                      "--batch", "1", "--seq", "8"])


def test_launch_pipeline_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipeline.main(["--steps", "1", "--stages", "2", "--batch", "4",
                        "--seq", "8"])


def _example(name):
    """An ``examples/`` script of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launch_pipeline_plan_auto_runs_the_examples_pick(capsys):
    """``--plan auto`` asks the planner as ``examples/bpipe_pipeline.py``
    does (same table, same pick), runs the pick, traces its last step and
    recalibrates the simulator from it."""
    ex = _example("bpipe_pipeline")
    jcfg = dataclasses.replace(jcfgs.get_config("qwen1.5-0.5b").reduced(),
                               num_layers=8, dtype="float32")
    want = ex.auto_plan(jcfg, 4, 2, 8, 32)
    planner_out = capsys.readouterr().out
    res = tpipeline.main(["--plan", "auto", "--device", "cpu", "--steps",
                          "2"])
    out = capsys.readouterr().out
    assert planner_out in out
    assert dataclasses.asdict(res["plan"].cand) == \
        dataclasses.asdict(want.cand)
    label = tpipeline.arm_label(res["plan"].cand.spec(4))
    assert list(res["arms"]) == [label]
    arm = res["arms"][label]
    assert len(arm["losses"]) == 2 and all(map(math.isfinite, arm["losses"]))
    assert arm["costs"].Tf > 0 and arm["costs"].Tb > 0
    assert arm["costs"].b == want.cand.b
    assert arm["replayed"].makespan > 0
    assert "recalibrated from trace: Tf=" in out


PLAN_ARGV = [
    ("--config gpt3_96b --attention recompute --top 0",
     r"PLAN gpt3-96b \[recompute\]: bpipe"),
    ("--config llama_65b --top 0", r"PLAN llama-65b: 1f1b"),
    ("--config qwen3_14b --attention recompute --hbm-gb 14 "
     "--vocab-parallel 1 2 4 8 --top 0",
     r"PLAN qwen3-14b \[recompute\]: bpipe .*vp=4"),
    ("--config llama_65b --p 4 --B 64 --csv --spec-json", r"PLAN llama-65b"),
    ("--config gpt3_96b --attention recompute --top 5 --perfetto {tmp}/t.json "
     "--metrics-json {tmp}/m.json", r"PLAN gpt3-96b \[recompute\]: bpipe"),
]


@pytest.mark.parametrize("argv,line", PLAN_ARGV, ids=[
    "gpt3-recompute", "llama", "qwen3-14gib-vp", "llama-csv-spec-json",
    "gpt3-perfetto-metrics"])
def test_launch_plan_prints_what_the_reference_prints(argv, line, tmp_path,
                                                      capsys):
    """``python -m repro_torch.launch.plan`` with the reference's flags: its
    standard output and the files it writes equal ``repro.launch.plan``'s,
    and the Table 3 / qwen3-14b lines of ``scripts/check.sh`` hold."""
    from repro.launch import plan as jplan
    from repro_torch.launch import plan as tplan
    argv = argv.format(tmp=tmp_path).split()
    outs = []
    for main in (jplan.main, tplan.main):
        assert main(argv) == 0
        files = {f.name: f.read_text() for f in sorted(tmp_path.iterdir())}
        outs.append((capsys.readouterr().out, files))
    assert outs[0] == outs[1]
    assert re.search(line, outs[1][0])


@pytest.mark.parametrize("argv", [
    "--config llama_65b --chip h100 --link nvlink4 --top 0",
    "--config gpt3_96b --attention recompute --chip h100 --link nvlink4 "
    "--host-bw 64 --top 5"], ids=["llama", "gpt3-recompute"])
def test_launch_plan_h100_figures_print_what_the_reference_prints(
        argv, monkeypatch, capsys):
    """``--chip h100 --link nvlink4`` price the plans with ``core/h100.py``'s
    peak and NVLink 4 rate: the output equals ``repro.launch.plan``'s given
    the same two figures, and differs from the A100 default's."""
    from repro.launch import plan as jplan
    from repro_torch.core import h100
    from repro_torch.launch import plan as tplan
    monkeypatch.setitem(jplan.CHIPS, "h100", h100.H100_PEAK_BF16)
    monkeypatch.setitem(jplan.LINKS, "nvlink4", h100.H100_NVLINK_BW)
    argv = argv.split()
    outs = []
    for main in (jplan.main, tplan.main):
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    base = [a for a in argv if a not in ("--chip", "h100", "--link",
                                         "nvlink4")]
    assert tplan.main(base) == 0
    assert capsys.readouterr().out != outs[1]


@pytest.mark.parametrize("arch,attention,layers,bx,by", [
    ("llama-65b", "flash", 3, 4, 2), ("gpt3-96b", "recompute", 1, 2, 1),
    ("gpt3-96b", "flash", 2, 2, 1)])
def test_launch_estimate_full_width_measures_the_priced_stage(
        arch, attention, layers, bx, by, monkeypatch, capsys):
    """Without ``--reduced`` the estimate measures the full-width stage in
    the config's dtype, at the b pair the A100 memory model gives and at the
    seq 2048 it prices, in the arm's attention; the break-even bar is the
    estimator's. The measurement itself is stubbed here (it needs the card):
    Tx = 1.5 Ty, so the stage gain is bx / by / 1.5."""
    from repro_torch.core import estimator as E
    from repro_torch.core import notation as N
    from repro_torch.launch import estimate
    calls = []

    def stub(cfg, bx_, by_, seq, remat, device):
        calls.append((cfg, bx_, by_, seq, remat, device))
        return {"bx": bx_, "by": by_, "Tx": 0.3, "Ty": 0.2,
                "gain": (bx_ / 0.3) / (by_ / 0.2)}

    monkeypatch.setattr(estimate.measure, "measure_stage_gain", stub)
    res = estimate.main(["--arch", arch, "--attention", attention,
                         "--layers", str(layers)])
    out = capsys.readouterr().out
    (cfg, got_bx, got_by, seq, remat, device), = calls
    full = tcfgs.get_config(arch)
    impl, want_remat = estimate.ARMS[attention]
    assert (res["b_bpipe"], res["b_1f1b"], got_bx, got_by) == (bx, by, bx, by)
    assert (seq, remat, device) == (2048, want_remat, "cuda")
    assert (cfg.d_model, cfg.num_heads, cfg.dtype, cfg.num_layers,
            cfg.attn_impl) == (full.d_model, full.num_heads, "bfloat16",
                               layers, impl)
    n = N.from_model(full, b=1, s=2048, B=128, p=8, t=4)
    assert res["required"] == E.required_stage_gain(n, bx, by)
    assert res["gain"]["gain"] == pytest.approx(bx / by / 1.5)
    assert f"stage-MFU ratio {bx / by / 1.5:.3f}" in out


@pytest.mark.parametrize("argv", [
    [], ["--arch", "llama-65b"], ["--arch", "gpt3-96b", "--attention",
                                  "recompute"],
    ["--arch", "llama-65b", "--attention", "none"]],
    ids=["qwen1.5-32b-flash", "llama-65b-flash", "gpt3-96b-recompute",
         "llama-65b-none-skips"])
def test_launch_estimate_cpu_reduced_prints_the_examples_estimate(
        argv, monkeypatch, capsys):
    """``launch.estimate --device cpu --reduced`` runs the example's four
    steps: the memory model's lines, the break-even bar and the traffic are
    the example's; the stage times are measured."""
    from repro_torch.launch import estimate
    ex = _example("estimate_before_deploy")
    monkeypatch.setattr(sys, "argv", ["estimate_before_deploy.py"] + argv)
    ex.main()
    want = capsys.readouterr().out.splitlines()
    res = estimate.main(argv + ["--device", "cpu", "--reduced"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith(("[memory]", "[traffic]")) or len(want) == 2:
            assert g == w
        elif g.startswith("[break-even]"):
            assert g.partition("(measured")[0] == w.partition("(measured")[0]
    if len(want) > 2:
        gain = res["gain"]
        assert gain["Tx"] > 0 and gain["Ty"] > 0
        assert res["stage"].d_model == tcfgs.get_config(
            argv[1] if argv else "qwen1.5-32b").reduced().d_model


def test_launch_pipeline_cpu_flag_runs_every_arm():
    """Every arm of the example, on the CPU: the same losses (the same
    math, other memory), 1F1B's imbalance and BPipe's swaps."""
    res = tpipeline.main(["--device", "cpu", "--steps", "2", "--stages", "4",
                          "--batch", "4", "--seq", "8"])
    arms = res["arms"]
    assert sorted(arms) == sorted([
        "gpipe", "1f1b", "bpipe", "1f1b+host_offload",
        "1f1b+selective_recompute", "1f1b_interleaved", "bpipe_interleaved"])
    first = arms["1f1b"]["losses"]
    for label, arm in arms.items():
        assert len(arm["losses"]) == 2
        torch.testing.assert_close(torch.tensor(arm["losses"]),
                                   torch.tensor(first), atol=1e-5, rtol=0)
    assert arms["1f1b"]["stats"].peak_local == {0: 4, 1: 3, 2: 2, 3: 1}
    st = arms["bpipe"]["stats"]
    assert max(st.peak_local.values()) <= 3 and st.evictions == st.loads > 0
    st = arms["1f1b+host_offload"]["stats"]
    assert st.offloads == st.fetches > 0
    st = arms["1f1b+selective_recompute"]["stats"]
    assert st.drops == st.recomputes > 0


def test_init_all_defaults_to_cuda():
    assert inspect.signature(TS.init_all).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.init_all(_reduced_llama(), 0)
    params, opt = TS.init_all(_reduced_llama(), 0, device="cpu")
    assert params["embed"]["table"].is_cpu and opt.step.is_cpu


def test_bridge_to_torch_takes_device_without_default():
    """A caller on the card who forgets ``device`` must not get CPU
    tensors that send the model down the plain path unasked."""
    assert inspect.signature(bridge.to_torch).parameters["device"].default \
        is inspect.Parameter.empty
    with pytest.raises(TypeError):
        bridge.to_torch({"w": [1.0]})


@pytest.mark.parametrize("fn", [
    TL.init_norm, TL.init_mlp, TL.init_embed, TA.init_attention,
    TA.init_kv_cache, TB.init_layer, TB.init_layer_state,
    TB.PatternStack.init, TB.PatternStack.init_state, TX.init_mlstm,
    TX.init_slstm, TX.init_mlstm_state, TX.init_slstm_state,
    TSPMD.init_pipeline_params, TSPMD.from_jax_pipeline_params,
], ids=lambda f: f.__qualname__)
def test_internal_inits_take_device_without_default(fn):
    assert inspect.signature(fn).parameters["device"].default \
        is inspect.Parameter.empty


def test_serve_cpu_flag_runs():
    res = serve.main(["--arch", "llama-65b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert torch.isfinite(res["last_logits"]).all()


def test_registry_names_equal():
    assert tcfgs.list_configs() == jcfgs.list_configs()
    assert tcfgs.ASSIGNED == jcfgs.ASSIGNED


@pytest.mark.parametrize("name", jcfgs.list_configs())
def test_config_copies_equal_field_by_field(name):
    j, t = jcfgs.get_config(name), tcfgs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert t.layer_kinds() == j.layer_kinds()


def test_every_module_has_a_twin_but_compat():
    """Each module of the JAX package has its twin at the same path in the
    port, but ``compat.py`` (shims over JAX versions, nothing to port)."""
    jax_side = ROOT / "src" / "repro"
    missing = sorted(str(f.relative_to(jax_side)) for f in jax_side.rglob("*.py")
                     if not (ROOT / "src" / "repro_torch" / f.relative_to(jax_side)).exists())
    assert missing == ["compat.py"], missing
