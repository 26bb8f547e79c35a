"""Deterministic synthetic data pipeline: an own copy of the JAX package's
``repro/data/pipeline.py`` (numpy only).

Batches are reproducible functions of (seed, step): LM token streams with
zipf-ish marginals (so losses are non-degenerate), plus stub vision-patch
and audio-frame embeddings for the frontends. They come out as numpy
arrays; the caller moves them to its device. ``tests/test_torch_train.py``
holds every batch equal, bit for bit, to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig

ENCODER_FRAMES = 1500  # whisper-style fixed encoder length (stub frontend)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _tokens(rng, cfg: ModelConfig, shape) -> np.ndarray:
    # zipf-flavoured marginal over the vocab, clipped
    z = rng.zipf(1.3, size=shape)
    return (z % cfg.vocab_size).astype(np.int32)


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """One global training batch: next-token LM data (+ stub frontends)."""
    rng = _rng(dc.seed, step)
    n_text = dc.seq_len - (cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    toks = _tokens(rng, cfg, (dc.batch, n_text + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.standard_normal(
            (dc.batch, cfg.num_prefix_embeds, cfg.d_model), np.float32)
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (dc.batch, ENCODER_FRAMES, cfg.d_model), np.float32)
    return batch


def iterate(cfg: ModelConfig, dc: DataConfig, steps: int) -> Iterator[Dict[str, np.ndarray]]:
    for step in range(steps):
        yield make_batch(cfg, dc, step)


def make_decode_inputs(cfg: ModelConfig, batch: int, step: int = 0,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of next tokens for serve_step."""
    rng = _rng(seed, step)
    return {"token": _tokens(rng, cfg, (batch,))}
