"""``repro_torch.planner``: the schedule auto-planner.

Searches the (kind, residency, v, b, m, cap, attention) space for one
training config, prunes with the analytical memory model, ranks
survivors with the discrete-event simulator plus the paper's §4
break-even test, and calibrates costs from real executor traces. See
docs/planner.md and docs/memory.md (the residency dimension).

    from repro_torch.planner import plan_config
    ranked = plan_config(notation, cfg, hbm_bytes=80 * 2**30)

CLI front door: ``python -m repro_torch.launch.plan --config llama_65b``.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.notation import NVLINK_BW, Notation
from repro_torch.planner import calibrate, feasibility, rank, report, space
from repro_torch.planner.rank import (AnalyticCostModel, CostModel, RankedPlan,
                                Table5CostModel, recommend)
from repro_torch.planner.space import Candidate, SearchSpace

__all__ = [
    "AnalyticCostModel", "Candidate", "CostModel", "RankedPlan",
    "SearchSpace", "Table5CostModel", "calibrate", "cost_model_for",
    "feasibility", "plan_config", "rank", "recommend", "report", "space",
]

# Configs the paper measured (Table 5) — these get the calibrated curves.
PAPER_MODELS = ("gpt3-96b", "llama-65b")


def cost_model_for(cfg: Optional[ModelConfig],
                   peak_per_chip: Optional[float] = None) -> CostModel:
    """Table5-calibrated for the paper's models, analytic otherwise."""
    kw = {} if peak_per_chip is None else {"peak_per_chip": peak_per_chip}
    if cfg is not None and cfg.name in PAPER_MODELS:
        return Table5CostModel(cfg.name, **kw)
    return AnalyticCostModel(cfg, **kw)


def plan_config(n: Notation, cfg: Optional[ModelConfig], hbm_bytes: float,
                cost: Optional[CostModel] = None,
                search: SearchSpace = SearchSpace(),
                link_bw: float = NVLINK_BW,
                overhead: float = 0.0,
                workspace: float = feasibility.DEFAULT_WORKSPACE,
                host_bw: Optional[float] = None,
                exhaustive: bool = False,
                ) -> List[RankedPlan]:
    """End-to-end: enumerate -> prune -> rank for one config.
    ``host_bw`` (bytes/s) prices host_offload residency; None = PCIe.
    ``exhaustive=True`` disables the branch-and-bound pruning and
    simulates every feasible candidate (same recommendation, slower —
    the escape hatch and the differential-test oracle)."""
    if cost is None:
        cost = cost_model_for(cfg)
    cands = space.enumerate_candidates(
        n, search, cfg.num_layers if cfg is not None else 0)
    kw = {} if host_bw is None else {"host_bw": host_bw}
    return rank.rank(n, cands, cost, hbm_bytes, cfg, link_bw=link_bw,
                     overhead=overhead, workspace=workspace,
                     exhaustive=exhaustive, **kw)
