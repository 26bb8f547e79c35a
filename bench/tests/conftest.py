"""Tiny cells for the benchmark's CPU tests: the shipped cells' files with
the widths, depth, vocabulary and sequence cut so that the program runs in
a second on the CPU, and limits of their own, set from CPU readings at
these sizes (bf16 program against the fp32 reference). A configuration's
model module may bring its own (``TINY_MODEL``, ``TINY_LIMITS``); the
dicts here hold those of configurations whose module has none. Besides them, two
dense cells of gpt3-96b's kind (GELU, LayerNorm, qkv bias, an untied
head; ``dense.flash`` and ``dense.recompute``, the two attention arms),
which keep the reference's dense path and the control tested while no
shipped cell runs a dense model."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spec  # noqa: E402

TINY_MODEL = {
    "granite-moe-1b-a400m": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                                 head_dim=16, vocab_size=97,
                                 moe={"num_experts": 4, "top_k": 2, "d_ff": 32,
                                      "capacity_factor": 1.25, "router_aux_weight": 0.01}),
}
# Dense tiny cells: the program reads at most loss 2.6e-4, norm gap 7.3e-3,
# diff 0.021 over seeds 1-4; the control at least 1.2e-4 (one seed; 1.4e-3
# on the others), 0.030, 0.246. The tiny MoE routes differently in bf16 and
# fp32 often enough that program (diff to 0.21) and control (0.31) overlap
# here, so its limit only separates the faults (diff >= 0.99).
TINY_LIMITS = {"dense": {"loss_rel": 1e-3, "grad_norm_gap": 0.02, "grad_diff": 0.08},
               "granite-moe-1b-a400m": {"loss_rel": 0.02, "grad_norm_gap": 0.1,
                                        "grad_diff": 0.6}}


DENSE_MODEL = dict(name="dense", family="dense", source="arXiv:2401.02088 Table 2",
                   num_layers=4, d_model=64, num_heads=4,
                   num_kv_heads=4, head_dim=16, d_ff=256, vocab_size=97,
                   block_pattern=["attn"], mlp_kind="gelu", norm="layernorm", qkv_bias=True,
                   tie_embeddings=False, rope_theta=10000.0, dtype="bfloat16")
DENSE_ARMS = {"dense.flash": dict(attn_impl="flash", remat="flash"),
              "dense.recompute": dict(attn_impl="reference", remat="attn")}


def dense_cell(name: str) -> spec.Cell:
    """A shipped cell's traffic as 1F1B p 4 at b 1 over ``DENSE_MODEL``."""
    cell = tiny_cell("granite-moe.bpipe.b4")
    cell.name = name
    cell.config = {"name": "dense", "model": dict(DENSE_MODEL)}
    cell.traffic = dict(cell.traffic, schedule="1f1b", micro_batch=1, **DENSE_ARMS[name])
    cell.limits = dict(TINY_LIMITS["dense"])
    return cell


def tiny_cell(name: str, root: Path = spec.ROOT) -> spec.Cell:
    """The cell ``name`` of ``root``'s files at its tiny size."""
    if name in DENSE_ARMS:
        return dense_cell(name)
    cell = spec.load_cell(name, root)
    cfg_name = cell.config["name"]
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(getattr(cell.module, "TINY_MODEL", None)
                                or TINY_MODEL[cfg_name])
    cell.traffic = dict(cell.traffic, seq_len=32, distinct_batches=8)
    cell.limits = dict(getattr(cell.module, "TINY_LIMITS", None) or TINY_LIMITS[cfg_name])
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
