"""Weight bridge: the JAX package's param pytree <-> the port's tensors.

A JAX param tree, brought to the host as numpy arrays, is a nested dict:
``embed/{table,unembed}``, ``blocks/pos{j}`` (every leaf stacked along a
leading ``n_full`` dim) and ``blocks/rem{i}``, ``final_norm``. The port
keeps exactly these keys, so a checkpoint, a gradient or a parity test
maps one to one.

numpy has no bfloat16 of its own: bf16 leaves cross as a bit-equal uint16
view, as the JAX checkpoint format stores them. Turning a bf16 tensor back
into numpy needs the ``bfloat16`` dtype registered with numpy (the JAX
side's ``ml_dtypes`` does that); the port itself never imports it.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.array(a)  # a writable copy: the tensor must not alias JAX's buffer
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree: Mapping[str, Any], device):
    """Nested dict of arrays -> the same nesting of tensors on ``device``
    (no default: a caller on the card must not get CPU tensors unasked)."""
    return {k: to_torch(v, device) if isinstance(v, Mapping)
            else _leaf_to_torch(v, device) for k, v in tree.items()}


def to_numpy(tree: Mapping[str, Any]):
    """Nested dict of tensors -> the same nesting of numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, Mapping) else _leaf_to_numpy(v)
            for k, v in tree.items()}
