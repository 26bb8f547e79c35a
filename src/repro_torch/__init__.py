"""PyTorch + CUDA port of the BPipe reproduction, for an NVIDIA H100.

Mirrors the layout of the JAX package (``repro_torch/<sub>/<mod>.py`` is
the twin of ``repro/<sub>/<mod>.py``) and imports nothing of it. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing GPU raises instead of falling back.

Ported so far: the serving path of the dense decoders (prefill + greedy
decode) with a hand-written CUDA flash-attention forward; the
single-device training step (``launch.train``: loss, recompute arms,
Adam, data, checkpoints) with hand-written CUDA flash-attention dq and
dk/dv backward kernels; the pipelined step (``pipeline.PipelineExecutor``,
``launch.pipeline``: GPipe, 1F1B, BPipe, interleaved, the residency
policies) over the port's own copies of the schedule layer; the fused
scale-mask-softmax op with hand-written CUDA forward and backward kernels;
the paper's estimation path over own copies of the planner, simulator,
estimator and obs layers (``launch.plan``, ``launch.estimate``,
``launch.pipeline --plan auto``, with ``planner.measure`` timing one stage
and auditing the simulator against the executor on the card).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
