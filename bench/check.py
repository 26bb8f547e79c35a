"""The comparison that decides ``correct``.

A step's answer is its loss and the gradient of every parameter. Each
stacked parameter is compared a layer at a time: "leaf" below means one
layer's slice of a parameter, or an unstacked parameter (the embedding
table, an untied head, the final norm). Against the plain reference
(the model module's ``leaf_grads``) three numbers are read:

  * ``loss_rel``: |loss - reference loss| / |reference loss|, the largest
    over the steps checked;
  * ``grad_norm_gap``: over the leaves, the largest
    | ||g|| - ||g_ref|| | / max(||g_ref||, median leaf's ||g_ref||);
  * ``grad_diff``: over the leaves, the largest
    ||g - g_ref|| / max(||g_ref||, median leaf's ||g_ref||).

The median leaf in the denominators keeps leaves whose gradient is nought
to rounding in the reference (a key's bias under the softmax) from
turning rounding into a large ratio. Each number fails above its limit;
a missing or non-finite number fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

LeafName = Tuple[str, ...]
NUMBERS = ("loss_rel", "grad_norm_gap", "grad_diff")


class LeafStats:
    """Per-leaf norms of a candidate ``g`` against the reference ``r``:
    ||g||, ||r||, ||g - r|| and <g, r>, in float64 on the host."""

    def __init__(self):
        self.rows: Dict[LeafName, Tuple[float, float, float, float]] = {}

    def add(self, name: LeafName, g: torch.Tensor, r: torch.Tensor):
        if g.shape != r.shape:
            raise ValueError(f"{'/'.join(name)}: shape {tuple(g.shape)} against "
                             f"the reference's {tuple(r.shape)}")
        g, r = g.float(), r.float()
        vals = torch.stack([torch.linalg.vector_norm(g), torch.linalg.vector_norm(r),
                            torch.linalg.vector_norm(g - r), (g * r).sum()])
        self.rows[name] = tuple(float(v) for v in vals.double().cpu())

    def median_ref(self) -> float:
        return statistics.median(r for _, r, _, _ in self.rows.values())

    def worst(self, which: str) -> Tuple[float, Optional[LeafName]]:
        """The largest ``grad_norm_gap`` or ``grad_diff`` over the leaves and
        the leaf it is read on."""
        med = self.median_ref()
        best, where = -1.0, None
        for name, (g, r, diff, _) in self.rows.items():
            v = (abs(g - r) if which == "grad_norm_gap" else diff) / max(r, med)
            if not math.isfinite(v):
                return math.inf, name
            if v > best:
                best, where = v, name
        return best, where


def compare(ref: Iterable[Tuple[LeafName, torch.Tensor]],
            candidate: Callable[[LeafName], torch.Tensor],
            cand_loss: float, names: Optional[Iterable[LeafName]] = None
            ) -> Tuple[Dict[str, float], LeafStats]:
    """Runs the reference generator ``ref`` (a model module's
    ``leaf_grads``) and holds each leaf of it against ``candidate(name)``.
    Returns the numbers ``loss_rel``, ``grad_norm_gap``, ``grad_diff`` and
    the per-leaf stats. With ``names`` (the module's ``leaf_names``) it
    raises ValueError unless the reference yields each of them once and
    nothing else: a leaf it skips would go unchecked."""
    it = iter(ref)
    name, ref_loss = next(it)
    if name != ("loss",):
        raise ValueError(f"the reference yielded {name} before its loss")
    ref_loss = float(ref_loss)
    stats = LeafStats()
    yielded = 0
    for name, r in it:
        stats.add(name, candidate(name), r)
        yielded += 1
        del r
    if names is not None:
        gap = sorted("/".join(n) for n in set(names) ^ set(stats.rows))
        if gap or yielded != len(stats.rows):
            raise ValueError(f"the reference's leaves are not leaf_names: {len(gap)} "
                             f"differ ({', '.join(gap[:6])}), "
                             f"{yielded - len(stats.rows)} yielded twice")
    out = {"loss_rel": loss_rel(cand_loss, ref_loss)}
    out["grad_norm_gap"], _ = stats.worst("grad_norm_gap")
    out["grad_diff"], _ = stats.worst("grad_diff")
    return out, stats


def loss_rel(got: float, want: float) -> float:
    v = abs(got - want) / abs(want)
    return v if math.isfinite(v) else math.inf


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is present, finite and within its
    limit."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())


def lockstep(ref: Iterator[Tuple[LeafName, torch.Tensor]],
             other: Iterator[Tuple[LeafName, torch.Tensor]]):
    """(``ref`` as a generator, a candidate reading ``other``'s leaves, the
    other's loss) for two generators of the same leaves in the same order:
    the control in the program's place. ``other`` advances as ``ref``
    asks for a leaf."""
    name, other_loss = next(other)
    if name != ("loss",):
        raise ValueError(f"the candidate yielded {name} before its loss")

    def candidate(name):
        got, g = next(other)
        if got != name:
            raise ValueError(f"leaf order differs: {got} against {name}")
        return g
    return ref, candidate, float(other_loss)
