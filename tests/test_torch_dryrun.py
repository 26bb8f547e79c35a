"""The port's production dry run (``repro_torch/launch/dryrun.py``) on a
fake process group of 256 / 512 ranks in this process: its records' keys,
its argument bytes against the JAX twin's committed records, and one
rank's FLOPs and collective bytes of a one-block MLP against a hand
count."""
import dataclasses
import json
import os
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _twin(name):
    with open(os.path.join(ROOT, "experiments", "dryrun", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_cli_on_xlstm_decode_matches_the_twins_arguments(mesh, tmp_path,
                                                         monkeypatch, capsys):
    """``python -m repro_torch.launch.dryrun --arch xlstm-125m --shape
    decode_32k --mesh M --no-roofline``: the rank's arguments are the JAX
    twin's to the byte (params, recurrent state, token) once the position
    the xLSTM never reads is taken off (4 unread bytes, which the twin's
    ``jax.jit`` prunes), and the record has the twin's keys, or their
    stand-ins with a reason."""
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh",
        mesh, "--no-roofline", "--out", str(tmp_path)])
    dryrun.main()
    assert f"OK   xlstm-125m decode_32k {mesh}" in capsys.readouterr().out
    name = f"xlstm-125m__decode_32k__{mesh}.json"
    rec = json.load(open(tmp_path / name))
    twin = _twin(name)
    assert {k: rec[k] for k in ("arch", "shape", "mesh", "variant", "chips")} \
        == {k: twin[k] for k in ("arch", "shape", "mesh", "variant", "chips")}
    full = rec["full"]
    assert full["memory"]["unread_argument_bytes"] == 4  # the int32 position
    assert full["memory"]["argument_bytes"] - 4 == twin["full"]["memory"]["argument_bytes"]
    assert set(full["memory"]) >= set(twin["full"]["memory"])
    assert full["memory"]["temp_bytes"] > 0
    assert "MemTracker" in full["memory"]["temp_bytes_source"]
    for k in ("output_bytes", "alias_bytes"):
        assert full["memory"][k] is None and full["memory"][f"{k}_why"]
    assert full["cost_raw"]["flops"] > 0 and full["cost_raw"]["bytes_accessed"] > 0
    assert set(full["collective_bytes_raw"]) == set(rl.COLLECTIVES)
    assert set(full["collective_ops"]) == set(rl.COLLECTIVES)
    assert full["t_run_s"] >= 0
    assert full["relocations"]  # 4 mLSTM heads on 16 model ranks


def test_run_one_with_the_roofline(tmp_path, monkeypatch):
    """A reduced llama-65b (2 layers, d 256, 16 heads of 16, so that every
    sharded dim divides 16 model ranks) at a small train shape: the
    roofline's 1- and 2-block points, extrapolation and terms, as the twin
    writes them."""
    cfg = dataclasses.replace(configs.get_config("llama-65b").reduced(),
                              name="llama-65b", num_heads=16, num_kv_heads=16,
                              head_dim=16)
    monkeypatch.setitem(configs._REGISTRY, "llama-65b", cfg)
    monkeypatch.setitem(configs.INPUT_SHAPES, "train_4k",
                        configs.InputShape("train_4k", 32, 32, "train"))
    path = dryrun.run_one("llama-65b", "train_4k", "single", with_roofline=True,
                          out_dir=str(tmp_path), force=True)
    rec = json.load(open(path))
    assert rec["chips"] == 256 and rec["params"] == cfg.param_count()
    roof = rec["roofline"]
    assert set(roof) == {"per_block_points", "extrapolated", "terms",
                         "model_flops_per_device", "useful_fraction",
                         "roofline_mfu"}
    p1, p2 = roof["per_block_points"]["1"], roof["per_block_points"]["2"]
    assert p2["flops"] > p1["flops"] > 0
    assert roof["extrapolated"]["flops"] == pytest.approx(
        p1["flops"] + (p2["flops"] - p1["flops"]) * (cfg.num_layers - 1))
    assert roof["terms"]["chips"] == 256
    assert roof["terms"]["dominant"] in ("compute", "memory", "collective")
    assert rec["full"]["relocations"] == []
    assert rec["full"]["redistributions"] == []
    # the train step's collectives: the tensor-parallel partial sums and
    # the replicated params' grads over "data"
    assert rec["full"]["collective_ops"]["all-reduce"] > 0


@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_one_block_mlp_counts_by_hand(fake_mesh):
    """One MLP block (gelu, fp32) as DTensors on 16 x 16 ranks: x (32, 8,
    64) batch-sharded over "data", wi (64, 128) column- and wo (128, 64)
    row-parallel over "model". A rank holds T = 32 / 16 x 8 = 16 tokens and
    f / 16 = 8 columns. Forward x wi and h wo, backward grad wo, grad h and
    grad wi: five products of 2 T d (f / 16) = 16384 FLOPs. y, partial
    sums over "model", is summed there (redistributed to replicated): one
    all-reduce of its T x d fp32 values, 4096 bytes; its backward moves
    nothing. The logical count is 256 times the FLOPs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import specs as sp
    from repro_torch.models import layers
    from repro_torch.sharding import rules
    mesh = fake_mesh
    cfg = dataclasses.replace(configs.get_config("gpt3-96b").reduced(),
                              dtype="float32")
    with sp.fake_mode():
        x = distribute_tensor(torch.empty(32, 8, 64), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        p = {"wi": distribute_tensor(torch.empty(64, 128), mesh,
                                     [Replicate(), Shard(1)], src_data_rank=None),
             "wo": distribute_tensor(torch.empty(128, 64), mesh,
                                     [Replicate(), Shard(0)], src_data_rank=None)}
        for t in p.values():
            t.requires_grad_(True)

        def block(p, x):
            with rules.set_mesh(mesh):
                y = layers.apply_mlp(p, x, cfg)  # partial sums over "model"
                y = y.redistribute(mesh, [Shard(0), Replicate()])
                return torch.autograd.grad(y.square().sum(), [p["wi"], p["wo"]])

        local = [x.to_local()] + [t.to_local() for t in p.values()]
        _, counter, peak = dryrun.measure(block, (p, x), local)
        with FlopCounterMode(display=False) as logical:
            block(p, x)
    assert counter.flops == 5 * 2 * 16 * 64 * 8
    assert counter.coll_ops == {"all-gather": 0, "all-reduce": 1,
                                "reduce-scatter": 0, "all-to-all": 0,
                                "collective-permute": 0}
    assert counter.coll_bytes["all-reduce"] == 16 * 64 * 4
    assert logical.get_total_flops() == 256 * counter.flops
    assert peak > dryrun._nbytes(local)
