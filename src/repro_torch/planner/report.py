"""Human- and CSV-facing views of a ranked plan list.

The table keeps every candidate — including pruned and break-even-
rejected ones — because the *reasons* are the product: each rejection row
carries the ``required_stage_gain`` bar it failed, which is exactly what
the paper asks an engineer to check before implementing BPipe.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import schedule as sched
from repro_torch.core.notation import Notation
from repro_torch.planner.rank import RankedPlan, arms_of, recommend

_COLS = ("#", "kind", "res", "v", "c", "vp", "b", "m", "cap", "d", "attn",
         "peak_GiB", "makespan_s", "MFU%", "bubble%", "stall", "eq3%",
         "req_gain", "got_gain", "moves", "verdict")


def _managed(c) -> bool:
    """Does anything manage this candidate's residency (swap policy via a
    balanced kind, or an active policy on a plain kind)?"""
    return c.kind in sched.BPIPE_FAMILY or c.residency not in ("none",)


def _cell(p: RankedPlan, col: str, idx: int) -> str:
    c = p.cand
    if col == "#":
        return str(idx)
    if col == "kind":
        return c.kind
    if col == "res":
        if c.kind in sched.BPIPE_FAMILY:
            return "swap"
        return {"none": "-", "host_offload": "offload",
                "selective_recompute": "recomp"}.get(c.residency,
                                                     c.residency)
    if col == "v":
        return str(c.v) if c.kind in sched.INTERLEAVED else "-"
    if col == "c":
        # sequence slices per microbatch (docs/longcontext.md)
        return str(c.seq_chunks) if c.seq_chunks != 1 else "-"
    if col == "vp":
        # vocab-parallel degree (docs/memory.md "Vocab accounting")
        return str(c.vocab_parallel) if c.vocab_parallel != 1 else "-"
    if col == "b":
        return str(c.b)
    if col == "m":
        return str(c.m)
    if col == "cap":
        if not _managed(c):
            return "-"
        return str(c.cap) if c.cap is not None else "def"
    if col == "d":
        # transfer-overlap depth (docs/transfer.md); only meaningful for
        # plans whose residency moves bytes over a channel
        return str(c.depth) if _managed(c) else "-"
    if col == "attn":
        return c.attention
    if col == "peak_GiB":
        return f"{p.feas.peak_gib:.3g}" if p.feas.peak_bytes else "-"
    if col == "makespan_s":
        return f"{p.makespan:.4g}" if p.makespan else "-"
    if col == "MFU%":
        return f"{100 * p.mfu:.1f}" if p.mfu else "-"
    if col == "bubble%":
        # simulated idle share (repro_torch.obs.metrics vocabulary): what the
        # paper's eq. 2 bubble penalty actually costs this candidate
        return f"{100 * p.bubble:.1f}" if p.makespan else "-"
    if col == "stall":
        # summed backward time spent waiting on in-flight restores
        return f"{p.load_stall:.3g}" if p.makespan else "-"
    if col == "eq3%":
        return f"{100 * p.mfu_eq3:.1f}" if p.mfu_eq3 else "-"
    if col == "req_gain":
        return f"{p.required_gain:.3f}" if p.required_gain else "-"
    if col == "got_gain":
        return f"{p.achieved_gain:.3f}" if p.achieved_gain else "-"
    if col == "moves":
        return str(p.moves) if _managed(c) and p.makespan else "-"
    if col == "verdict":
        return p.verdict if not p.note else f"{p.verdict}: {p.note}"
    raise KeyError(col)


def format_table(ranked: List[RankedPlan], top: int = 0) -> str:
    """Aligned text table, best plan first (0 = all rows)."""
    rows = ranked[:top] if top else ranked
    cells = [[_cell(p, c, i + 1) for c in _COLS]
             for i, p in enumerate(rows)]
    widths = [max(len(c), *(len(r[j]) for r in cells)) if cells else len(c)
              for j, c in enumerate(_COLS)]
    def fmt(row):
        return "  ".join(s.ljust(w) for s, w in zip(row, widths)).rstrip()
    lines = [fmt(_COLS), fmt(["-" * w for w in widths])]
    lines += [fmt(r) for r in cells]
    return "\n".join(lines)


def csv_rows(ranked: List[RankedPlan], tag: str, config: str) -> List[str]:
    out = []
    for i, p in enumerate(ranked):
        c = p.cand
        out.append(
            f"{tag},{config},rank={i + 1},kind={c.kind},"
            f"res={c.residency},v={c.v},c={c.seq_chunks},"
            f"vp={c.vocab_parallel},b={c.b},"
            f"m={c.m},cap={c.cap if c.cap is not None else 'def'},"
            f"depth={c.depth},"
            f"attn={c.attention},peak_gib={p.feas.peak_gib:.2f},"
            f"mfu={100 * p.mfu:.2f},bubble={100 * p.bubble:.2f},"
            f"stall={p.load_stall:.4g},req_gain={p.required_gain:.3f},"
            f"got_gain={p.achieved_gain:.3f},moves={p.moves},"
            f"traffic_gib={p.traffic_bytes / 2**30:.2f},"
            f"verdict={p.verdict}")
    return out


def recommendation_line(config: str, ranked: List[RankedPlan],
                        attention: Optional[str] = None) -> str:
    """One line per the acceptance contract: the winning plan, or why
    nothing fits; BPipe rejections cite the break-even number."""
    arm = f" [{attention}]" if attention else ""
    best = recommend(ranked, attention)
    if best is None:
        return f"PLAN {config}{arm}: no feasible plan under this HBM budget"
    c = best.cand
    bits = [c.kind, f"b={c.b}", f"m={c.m}"]
    if c.kind in sched.INTERLEAVED:
        bits.append(f"v={c.v}")
    if c.seq_chunks != 1:
        bits.append(f"c={c.seq_chunks}")
    if c.residency not in ("none", "bpipe_swap"):
        bits.append(f"res={c.residency}")
    if _managed(c):
        bits.append(f"cap={c.cap if c.cap is not None else 'default'}")
    if c.depth != 1:
        bits.append(f"depth={c.depth}")
    if c.vocab_parallel != 1:
        bits.append(f"vp={c.vocab_parallel}")
    if attention is None:
        bits.append(c.attention)
    why = f"est {100 * best.mfu:.1f}% MFU"
    if c.kind in sched.BPIPE_FAMILY and best.required_gain:
        why += (f"; break-even needed {best.required_gain:.3f}x stage gain, "
                f"calibration gives {best.achieved_gain:.3f}x")
    else:
        rej = [p for p in ranked
               if p.verdict == "reject"
               and (attention is None or p.cand.attention == attention)]
        if rej:
            # Cite the paper's story: BPipe's pitch is unlocking a LARGER
            # micro batch, so quote the best rejected plan that actually
            # raised b over the baseline (fall back to the best reject).
            raised = [p for p in rej if p.cand.b > p.baseline_b]
            r = max(raised or rej, key=lambda p: p.mfu)
            why += (f"; BPipe rejected at b={r.cand.b}: required "
                    f"{r.required_gain:.3f}x stage gain, got "
                    f"{r.achieved_gain:.3f}x")
    return f"PLAN {config}{arm}: {' '.join(bits)} — {why}"


def summarize(config: str, n: Notation,
              ranked: List[RankedPlan]) -> List[str]:
    """Per-attention-arm recommendations plus the overall pick."""
    lines = [recommendation_line(config, ranked, att)
             for att in arms_of(ranked)]
    lines.append(recommendation_line(config, ranked))
    return lines
