"""Planted faults and the control, each a step in the program's place: the
readings that the limits of ``bench/workloads/<cell>.json`` are set
between (``calibrate.py``) and the tests that see ``correct`` come out
false (``tests/test_bench_faults.py``).

Each factory takes the cell and returns ``wrap(ex) -> step``, the argument
``run.run_cell`` calls ``step_wrapper``.
"""
from __future__ import annotations

import types
from typing import Tuple

import torch


def stale(cell):
    """A step that returns its state unchanged: the first step's result,
    again at every later step."""
    def wrap(ex):
        first = []

        def step(params, batch):
            if not first:
                first.append(ex.step(params, batch))
            return first[0]
        return step
    return wrap


def half_batch(cell):
    """Half of the batch left out: the first half of the rows run as half
    as many microbatches, their mean taken as the step's."""
    from bench.run import executor

    def wrap(ex):
        half = executor(ex.cfg, cell.traffic, int(cell.traffic["microbatches"]) // 2)

        def step(params, batch):
            rows = batch["tokens"].shape[0] // 2
            return half.step(params, {k: v[:rows] for k, v in batch.items()})
        return step
    return wrap


def negated_leaf(cell, name: Tuple[str, ...]):
    """An answer altered where it is produced: the gradient of leaf
    ``name`` (the model module's ``leaf_names``) negated."""
    leaf_of = cell.module.leaf_of

    def wrap(ex):
        def step(params, batch):
            res = ex.step(params, batch)
            leaf_of(res.grads, name).neg_()
            return res
        return step
    return wrap


def control(cell):
    """The plain reference in the program's place, its products in float8
    (the model module's ``leaf_grads(fp8=True)``): the loss and the
    gradients in the program's layout."""
    mod = cell.module

    def wrap(ex):
        b = int(cell.traffic["micro_batch"])

        def step(params, batch):
            grads = _zeros_like(params)
            it = mod.leaf_grads(ex.cfg, params, batch, b, fp8=True)
            _, loss = next(it)
            for name, g in it:
                mod.leaf_of(grads, name).copy_(g)
            return types.SimpleNamespace(loss=loss.float(), grads=grads, stats=None)
        return step
    return wrap


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}
