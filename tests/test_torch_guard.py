"""Guards of the port: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU, and its copies of the
configs stay equal to the JAX package's."""
import dataclasses
import inspect
import pathlib
import re

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


def test_launch_pipeline_plan_auto_names_the_planner():
    with pytest.raises(NotImplementedError, match="A7"):
        tpipeline.main(["--plan", "auto", "--device", "cpu"])


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
    TB.PatternStack.init, TB.PatternStack.init_state,
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
