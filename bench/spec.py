"""Find a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics. Everything that
belongs to one of them is a file of its own under ``bench/``:

  * a configuration: the ``file`` its entry names (``bench/configs/``);
  * a traffic mix: ``bench/traffic/<traffic>.json``;
  * a cell's limits on the numbers that decide ``correct``:
    ``bench/workloads/<cell>.json``;
  * a per-layer metric: ``bench/metrics/<name>.py``, a module with
    ``read(ctx) -> float | None``;
  * a configuration's model-specific code: the module its file names under
    ``"model_module"`` (``bench/models/<name>.py``, relative to the root),
    or ``bench/models/default.py`` where it names none (``model_module``).

Adding a cell, a configuration or a metric adds files and entries; no code
here names one.

The model module's contract. Everything of the harness that depends on what
a model computes or how its parameters are laid out goes through it, so a
model that the default cannot compute brings its own as a new file:

  * ``param_shapes(cfg)``: the program's parameter layout,
    {path: (shape, kind)} nested as the params are (``inputs.layer_shapes``
    gives the kinds); ``inputs.make_params`` draws the values from the
    seed over it;
  * ``leaf_names(cfg)``: every leaf of the layout, a stacked leaf one per
    layer as ("layer<l>", ...); ``leaf_of(tree, name)``: that leaf's tensor
    in a tree of the program's layout (its params or its grads);
  * ``leaf_grads(cfg, params, batch, micro_batch, fp8=False)``: the plain
    reference's loss, then each leaf's gradient, as ``reference.leaf_grads``
    yields them, every leaf of ``leaf_names`` once (``check.compare``
    raises otherwise, so no leaf goes unchecked); ``loss_only(cfg, params, batch, micro_batch, fp8=False)``:
    its loss alone. Float32 with TF32 off (``reference.fp32_exact``), float8
    products with ``fp8`` (the control), and nothing of the program
    imported;
  * ``flops_per_token(model, seq)``: model FLOPs a token of the
    configuration file's ``model`` object at ``seq``, no recomputation
    counted (``mfu``, ``step_mfu``);
  * optionally ``TINY_MODEL`` (overrides of the ``model`` object) and
    ``TINY_LIMITS`` (the limits) of the CPU tests' tiny cell
    (``bench/tests/conftest.py``).

The flash launches' least times (``flash_roofline``) follow from the
``model`` object itself, its ``block_pattern`` and ``window_size``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DEFAULT_MODULE = "bench/models/default.py"
#: what a model module provides (this docstring's contract)
MODEL_FUNCTIONS = ("param_shapes", "leaf_names", "leaf_of", "leaf_grads", "loss_only",
                   "flops_per_token")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]      # the configuration file's object
    traffic: Dict[str, Any]     # the traffic file's object
    limits: Dict[str, float]    # number compared -> its limit
    chips: int
    end_to_end: List[Dict[str, Any]]   # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]    # this cell's per-layer metrics
    module: ModuleType          # the configuration's model module


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, read from
    ``root/bench``. Raises KeyError for a cell the file does not list and
    FileNotFoundError for a missing file."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "bench" / "workloads" / f"{name}.json")["limits"]
    return Cell(
        name=name, config=config, traffic=traffic,
        limits={k: float(v["limit"]) for k, v in limits.items()},
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        module=model_module(config, root))


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``root/bench/metrics/<name>.py``."""
    return _load(root / "bench" / "metrics" / f"{name}.py", f"bench_metric_{name}").read


def model_module(config: Dict[str, Any], root: Path = ROOT) -> ModuleType:
    """The model module of a configuration file's object ``config``: the
    file its ``"model_module"`` names, relative to ``root``, or
    ``bench/models/default.py``. Its contract is in this module's
    docstring; a module that lacks one of its functions raises
    AttributeError."""
    rel = config.get("model_module", DEFAULT_MODULE)
    mod = _load(root / rel, f"bench_model_{Path(rel).stem}")
    missing = [f for f in MODEL_FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"{rel} has no {', '.join(missing)}")
    return mod


def model_config(config: Dict[str, Any]):
    """The program's ``ModelConfig`` of a configuration file's ``model``
    object (its ``moe`` a nested object)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(config["model"])
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    kw["block_pattern"] = tuple(kw.get("block_pattern", ("attn",)))
    return ModelConfig(**kw)
