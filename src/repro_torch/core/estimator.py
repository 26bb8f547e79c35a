"""The paper's §4 performance-estimation method (eq. 2-4).

Core identity (eq. 3):
    MFU(b) = F * MFU_stage(b) / ((1 + b/B * (p-1)) * F_stage)

and the speedup predictor (eq. 4):
    MFU(x)/MFU(y) = (B + y(p-1))/(B + x(p-1)) * MFU_stage(x)/MFU_stage(y)

which needs only two cheap single-stage measurements — the paper's
recipe for deciding whether implementing BPipe is worth it at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.notation import Notation


def bubble_factor(n: Notation) -> float:
    """(B/b + p - 1) / (B/b): fraction of time inflated by pipeline bubbles
    under the paper's idealization (uniform stages, negligible comm)."""
    m = n.num_micro
    return (m + n.p - 1) / m


def mfu_from_T(n: Notation, F: float, T: float, P: float) -> float:
    """Eq. 2: MFU given per-microbatch fwd+bwd stage time T(b)."""
    m = n.num_micro
    return F / (P * (m + n.p - 1) * T)


def stage_T_from_mfu(n: Notation, F_stage: float, mfu_stage: float, P_stage: float) -> float:
    """Invert MFU_stage(b) = b * F_stage / (P_stage * B * T(b)) -> T(b).

    F_stage is the full-global-batch FLOPs of one stage ((b/B)*F_stage per
    microbatch); P_stage is the peak of the *stage's* device group (t
    chips) — the paper reuses the symbol P for both scopes.
    """
    return (n.b / n.B) * F_stage / (P_stage * mfu_stage)


def mfu_model(n: Notation, F: float, F_stage: float, mfu_stage: float) -> float:
    """Eq. 3: whole-pipeline MFU from single-stage MFU.

    The paper's P is per-"device" in MFU_stage (t chips) but whole-cluster
    in MFU (p*t chips); with P_tot = p * P_stage the algebra gives
        MFU = F * MFU_stage / (p * F_stage * (1 + b/B*(p-1)))
    and with the uniform split F_stage = F/p this is the clean
        MFU = MFU_stage / (1 + b/B * (p-1))   — stage efficiency divided
    by the bubble factor.
    """
    return F * mfu_stage / (n.p * (1.0 + n.b / n.B * (n.p - 1)) * F_stage)


def speedup(n: Notation, bx: int, by: int,
            mfu_stage_x: float, mfu_stage_y: float) -> float:
    """Eq. 4: predicted MFU(x)/MFU(y) when micro batch goes y -> x."""
    return ((n.B + by * (n.p - 1)) / (n.B + bx * (n.p - 1))
            * (mfu_stage_x / mfu_stage_y))


def required_stage_gain(n: Notation, bx: int, by: int,
                        overhead: float = 0.0) -> float:
    """Beyond-paper corollary of eq. 4: the minimum single-stage MFU
    *ratio* MFU_stage(bx)/MFU_stage(by) for BPipe-at-bx to break even
    against plain-1F1B-at-by, i.e. the bubble penalty of the larger
    micro batch (optionally inflated by a fractional BPipe overhead).

    Usable before ANY implementation work: if your kernel suite's
    throughput gain from by->bx is below this number, BPipe cannot win
    (this is exactly why the paper's LLaMA rows are negative: required
    gain at b=2->4, p=8, B=128 is 1.099, measured stage gain was 1.056).
    """
    need = (n.B + bx * (n.p - 1)) / (n.B + by * (n.p - 1))
    return need * (1.0 + overhead)


def fit_stage_mfu(points, k_default: float = 0.25):
    """Fit the saturating single-stage throughput curve
        MFU_stage(b) = M * b / (b + k)
    through measured (b, MFU_stage) points and return it as a callable.

    This is the paper's "two cheap single-stage measurements" recipe made
    programmatic: two points pin (M, k) exactly (the fit is linear in
    (1/b, 1/MFU) space: 1/MFU = 1/M + (k/M)/b); more points are fit by
    least squares; a single point borrows ``k_default`` for the shape.
    The planner interpolates/extrapolates stage MFU to unmeasured micro
    batch sizes with it — feasibility pruning keeps the extrapolation
    honest (b's beyond the measured range are usually OOM anyway).
    """
    pts = sorted(dict(points).items())
    assert pts and all(b > 0 and mfu > 0 for b, mfu in pts), pts
    if len(pts) == 1:
        b0, m0 = pts[0]
        M = m0 * (b0 + k_default) / b0
        k = k_default
    else:
        xs = [1.0 / b for b, _ in pts]
        ys = [1.0 / mfu for _, mfu in pts]
        nn = len(pts)
        sx, sy = sum(xs), sum(ys)
        sxx = sum(x * x for x in xs)
        sxy = sum(x * y for x, y in zip(xs, ys))
        denom = nn * sxx - sx * sx
        slope = (nn * sxy - sx * sy) / denom      # = k/M
        inter = (sy - slope * sx) / nn            # = 1/M
        if inter <= 0 or slope < 0:
            # Degenerate (non-saturating) data: fall back to a flat curve
            # at the largest measurement — conservative for BPipe, which
            # only wins through stage gain.
            top = max(mfu for _, mfu in pts)
            return lambda b: top
        M, k = 1.0 / inter, slope / inter
    return lambda b: M * b / (b + k)


# ---------------------------------------------------------------------------
# Paper data (Tables 3 and 5) for the reproduction benchmarks.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PaperRow:
    exp_id: int
    model: str
    b: int
    bpipe: bool
    attention: str
    mfu: float          # Table 3: whole-model MFU [%]
    mfu_stage: float    # Table 5: single-stage MFU [%]


PAPER_ROWS = (
    PaperRow(1, "llama-65b", 1, False, "none", 45.3, 51.1),
    PaperRow(2, "llama-65b", 2, False, "recompute", 46.0, 54.5),
    PaperRow(3, "llama-65b", 4, True, "recompute", 42.7, 57.6),
    PaperRow(4, "llama-65b", 1, False, "flash", 47.8, 53.6),
    PaperRow(5, "llama-65b", 2, False, "flash", 49.2, 58.6),
    PaperRow(6, "llama-65b", 4, True, "flash", 44.0, 61.9),
    PaperRow(7, "gpt3-96b", 1, False, "recompute", 34.0, 37.8),
    PaperRow(8, "gpt3-96b", 2, True, "recompute", 45.8, 55.2),
    PaperRow(9, "gpt3-96b", 1, False, "flash", 52.0, 57.7),
    PaperRow(10, "gpt3-96b", 2, True, "flash", 51.7, 62.4),
)


def paper_row(exp_id: int) -> PaperRow:
    return PAPER_ROWS[exp_id - 1]


def predicted_vs_observed(n: Notation, x_id: int, y_id: int) -> Dict[str, float]:
    """Apply eq. 4 to a pair of paper experiments; e.g. (8, 7) reproduces
    the paper's 1.39 predicted vs 1.35 observed."""
    rx, ry = paper_row(x_id), paper_row(y_id)
    pred = speedup(n, rx.b, ry.b, rx.mfu_stage, ry.mfu_stage)
    obs = rx.mfu / ry.mfu
    return {"predicted": pred, "observed": obs,
            "gap_pct": 100.0 * (pred - obs) / obs}
