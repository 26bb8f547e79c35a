"""Find a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics. Everything that
belongs to one of them is a file of its own under ``bench/``:

  * a configuration: the ``file`` its entry names (``bench/configs/``);
  * a traffic mix: ``bench/traffic/<traffic>.json``;
  * a cell's limits on the numbers that decide ``correct``:
    ``bench/workloads/<cell>.json``;
  * a per-layer metric: ``bench/metrics/<name>.py``, a module with
    ``read(ctx) -> float | None``.

Adding a cell, a configuration or a metric adds files and entries; no code
here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]      # the configuration file's object
    traffic: Dict[str, Any]     # the traffic file's object
    limits: Dict[str, float]    # number compared -> its limit
    chips: int
    end_to_end: List[Dict[str, Any]]   # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]    # this cell's per-layer metrics


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
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``root/bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(config: Dict[str, Any]):
    """The program's ``ModelConfig`` of a configuration file's ``model``
    object (its ``moe`` a nested object)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(config["model"])
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    kw["block_pattern"] = tuple(kw.get("block_pattern", ("attn",)))
    return ModelConfig(**kw)
