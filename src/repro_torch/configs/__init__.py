"""Config registry of the PyTorch port: the same architectures, by the same
names, as the JAX package's registry.

The port keeps its own copy of every config module; ``tests/test_torch_guard.py``
holds each one equal, field by field, to its JAX twin so the copies cannot
drift. ``longcontext`` (the long-context cases) is a copy held equal by
``tests/test_torch_core.py``; the assignment's input shapes are not ported
yet.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401
from repro_torch.configs.longcontext import (LONG_CONTEXT,  # noqa: F401
                                             LongContextCase, get_case)

from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma_2b
from repro_torch.configs.qwen3_14b import CONFIG as _qwen3_14b
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2_9b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm_125m
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen1_5_32b
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen1_5_0_5b, CONFIG_SWA as _qwen1_5_0_5b_swa
from repro_torch.configs.whisper_small import CONFIG as _whisper_small
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2_1b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe
from repro_torch.configs.gpt3_96b import CONFIG as _gpt3_96b
from repro_torch.configs.llama_65b import CONFIG as _llama_65b

# The ten architectures assigned to this paper (public pool).
ASSIGNED = (
    "recurrentgemma-2b",
    "qwen3-14b",
    "gemma2-9b",
    "llama4-scout-17b-a16e",
    "xlstm-125m",
    "qwen1.5-32b",
    "qwen1.5-0.5b",
    "whisper-small",
    "internvl2-1b",
    "granite-moe-1b-a400m",
)

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _recurrentgemma_2b, _qwen3_14b, _gemma2_9b, _llama4_scout,
        _xlstm_125m, _qwen1_5_32b, _qwen1_5_0_5b, _qwen1_5_0_5b_swa,
        _whisper_small, _internvl2_1b, _granite_moe,
        _gpt3_96b, _llama_65b,
    )
}


def list_configs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")
    return _REGISTRY[name]
