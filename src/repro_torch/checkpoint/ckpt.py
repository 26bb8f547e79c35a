"""Flat-npz checkpointing with path-keyed entries, in the JAX package's
format (``repro/checkpoint/ckpt.py``), so a checkpoint moves between the
two in either direction.

A tree is nested dicts of tensors and ``AdamState``s (their fields are
path entries too): ``params/blocks/pos0/mixer/wq``, ``opt/step``,
``opt/m/...``, ``opt/v/...``. numpy cannot store bf16, so a bf16 leaf is
saved under ``__view__/<path>`` as its bit-equal uint16 view. ``restore``
reads the leaves against a template (shape checked, cast to the template's
dtype, placed on its device).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch

VIEW = "__view__/"


def _items(tree, prefix=""):
    """(path, leaf) of a tree of dicts and dataclasses."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in _items(tree):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[VIEW + key] = t.view(torch.uint16).numpy()
        else:
            out[key] = t.numpy()
    return out


def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _leaf(flat, key, want: torch.Tensor) -> torch.Tensor:
    if key in flat:
        t = torch.from_numpy(flat[key])
    elif VIEW + key in flat:
        arr = flat[VIEW + key]
        if arr.dtype != np.uint16:
            raise ValueError(f"{key}: a viewed leaf must be uint16, got {arr.dtype}")
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        raise KeyError(f"checkpoint missing {key}")
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(want.shape)}")
    return t.to(device=want.device, dtype=want.dtype)


def _rebuild(tree, flat, prefix=""):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), flat, f"{prefix}{f.name}/")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    return _leaf(flat, prefix[:-1], tree)


def restore(path: str, template: Any) -> Any:
    with np.load(path) as data:
        flat = dict(data)
    return _rebuild(template, flat)
