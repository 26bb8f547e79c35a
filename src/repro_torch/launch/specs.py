"""Stand-ins for every model input: the twin of the JAX package's
``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s the JAX dry run lowers
against.

A stand-in is a ``FakeTensor`` of this module's ``FakeTensorMode``
(``fake_mode()``): it has the shape, dtype and device of the real input and
allocates nothing. The dry run (``launch/dryrun.py``) runs its step inside
the same mode. Params and decode states come from the port's own
``init_params`` / ``init_decode_state`` run under the mode, as
``launch/pipeline_dryrun.py`` does, on the CPU device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import InputShape
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.model import ENCODER_FRAMES
from repro_torch.optim import adam

_MODE = []


def fake_mode():
    """The ``FakeTensorMode`` every stand-in belongs to (one a process)."""
    if not _MODE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _MODE[0]


def sds(shape, dtype):
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype)


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, s = shape.global_batch, shape.seq_len
    n_text = s - (cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    out = {"tokens": sds((B, n_text), torch.int32),
           "labels": sds((B, n_text), torch.int32)}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = sds((B, cfg.num_prefix_embeds, cfg.d_model),
                                   torch.float32)
    if cfg.is_encdec:
        out["enc_embeds"] = sds((B, ENCODER_FRAMES, cfg.d_model), torch.float32)
    return out


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    out = train_batch_specs(cfg, shape)
    out.pop("labels")
    return out


def param_specs(cfg: ModelConfig):
    with fake_mode():
        return M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def opt_specs(params_spec):
    with fake_mode():
        return adam.init(params_spec)


def decode_state_specs(cfg: ModelConfig, shape: InputShape):
    with fake_mode():
        return M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                   "cpu")


def decode_input_specs(cfg: ModelConfig, shape: InputShape):
    out = {"token": sds((shape.global_batch,), torch.int32),
           "pos": sds((), torch.int32)}
    if cfg.is_encdec:
        out["enc_states"] = sds(
            (shape.global_batch, ENCODER_FRAMES, cfg.d_model),
            getattr(torch, cfg.dtype))
    return out


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Everything the step for this shape kind consumes (sans params)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape),
                "state": decode_state_specs(cfg, shape)}
    if shape.kind == "decode":
        return {"state": decode_state_specs(cfg, shape),
                **decode_input_specs(cfg, shape)}
    raise ValueError(shape.kind)
