"""Long-context variants of the paper's evaluation models.

The paper runs GPT-3-96B and LLaMA-65B at s=2048; sequence-sliced
schedules (``ScheduleSpec.seq_chunks``, docs/longcontext.md) only start
to matter when the sequence — and with it the 2sbh/t boundary stash and
the attention quadratic — dominates memory. These variants pin the
32k/128k shapes the long-context sweep and the planner CLI use, so
"llama_65b_32k" means the same thing everywhere.

A variant is a *run shape*, not a new architecture: the ModelConfig is
the paper's card unchanged; only Notation-level knobs (s, B, and the
chunk ladder worth searching) move. Global batch shrinks as s grows to
keep tokens-per-batch in the paper's regime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class LongContextCase:
    """One long-context planning shape: base model + sequence override."""
    name: str
    model: str                       # base config registry name
    seq_len: int
    global_batch: int
    p: int = 8
    t: int = 4
    # chunk ladder the sweep searches (1 first: unsliced baseline)
    seq_chunkses: Tuple[int, ...] = (1, 2, 4, 8)

    def notation(self, cfg, b: int = 1):
        # deferred: core.notation imports configs.base, so a module-level
        # import here would close an import cycle through the package init
        from repro_torch.core.notation import from_model
        return from_model(cfg, b=b, s=self.seq_len, B=self.global_batch,
                          p=self.p, t=self.t)


LONG_CONTEXT: Dict[str, LongContextCase] = {
    c.name: c for c in (
        # 32k: unsliced 1F1B needs ~95-117 GiB/stage — over an A100-80G —
        # while c >= 2 fits; 128k needs t=16 on top (c=1 is 100+ GiB
        # even with recompute residency, c >= 4 fits).
        LongContextCase("llama-65b-32k", "llama-65b", 32_768, 32, p=16,
                        t=8),
        LongContextCase("llama-65b-128k", "llama-65b", 131_072, 16, p=16,
                        t=16),
        LongContextCase("gpt3-96b-32k", "gpt3-96b", 32_768, 32, p=16,
                        t=8),
        LongContextCase("gpt3-96b-128k", "gpt3-96b", 131_072, 16, p=16,
                        t=16),
    )
}


def list_cases():
    return sorted(LONG_CONTEXT)


def get_case(name: str) -> LongContextCase:
    for cand in (name, name.replace("_", "-")):
        if cand in LONG_CONTEXT:
            return LONG_CONTEXT[cand]
    raise KeyError(f"unknown long-context case {name!r}; "
                   f"known: {list_cases()}")
