"""The port's roofline module, mesh and pipeline dry run
(``repro_torch/launch/{roofline,mesh,pipeline_dryrun}.py``), held to the
JAX package's ``tests/test_dryrun.py:28-45`` at H100 constants.

The collective counter (``pipeline/collectives.py``) takes the place of
the JAX package's HLO parser (``tests/test_dryrun.py:13-25``): it is read
here after real collectives on a fake process group, in this process,
which leaves no group behind. The dry run itself runs in a subprocess.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.launch import roofline as JR
from repro_torch.core.h100 import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_BF16
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.pipeline import collectives as C

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def fake_world():
    """This process as rank 0 of a fake process group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_extrapolation():
    c1 = {"flops": 10.0, "bytes": 100.0}
    c2 = {"flops": 16.0, "bytes": 130.0}
    out = TR.extrapolate(c1, c2, 10)
    assert out["flops"] == pytest.approx(4 + 6 * 10)
    assert out["bytes"] == pytest.approx(70 + 30 * 10)
    assert out == JR.extrapolate(c1, c2, 10)


def test_roofline_terms_at_h100_constants():
    t = TR.RooflineTerms(flops=H100_PEAK_BF16, bytes_hbm=H100_HBM_BW,
                         bytes_collective=0.0, chips=4)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.dominant in ("compute", "memory")
    assert t.mfu(H100_PEAK_BF16 / 2) == pytest.approx(0.5)
    c = TR.RooflineTerms(flops=0.0, bytes_hbm=0.0,
                         bytes_collective=2 * H100_NVLINK_BW, chips=4)
    assert c.t_collective == pytest.approx(2.0) and c.dominant == "collective"
    assert c.step_time == pytest.approx(2.0)
    assert set(c.to_dict()) == set(JR.RooflineTerms(1, 1, 1, 1).to_dict())
    assert TR.COLLECTIVES == JR.COLLECTIVES


def test_collective_counter_in_place_of_the_hlo_parser(fake_world):
    """Each op counts once with its output's bytes, by kind, on the calling
    rank; a group of one rank counts nothing; ``reset`` clears it."""
    fake_world(8)
    mesh = make_host_mesh(2, 4, "cpu")
    model, data = mesh.get_group("model"), mesh.get_group("data")
    C.reset()
    x = torch.ones((2, 3, 8), dtype=torch.bfloat16)
    y = C.ppermute(x, [(i, (i + 1) % 4) for i in range(4)], model)
    C.all_reduce_(torch.ones(64), data)
    C.psum(torch.ones(()), model)
    got = TR.collective_bytes()
    assert got["collective-permute"] == 2 * 3 * 8 * 2
    assert got["all-reduce"] == 64 * 4 + 4
    assert C.read()["ops"] == {"all-gather": 0, "all-reduce": 2,
                               "reduce-scatter": 0, "all-to-all": 0,
                               "collective-permute": 1}
    assert y.shape == x.shape and y.dtype == x.dtype
    C.reset()
    assert sum(C.read()["ops"].values()) == 0


def test_ppermute_backward_runs_the_inverse_hop(fake_world):
    fake_world(4)
    group = make_host_mesh(1, 4, "cpu").get_group("model")
    x = torch.ones((2, 4), requires_grad=True)
    C.reset()
    C.ppermute(x, [(i, (i + 1) % 4) for i in range(4)], group).sum().backward()
    assert C.read()["ops"]["collective-permute"] == 2
    assert C.inverse([(0, 1), (1, 2)]) == [(1, 0), (2, 1)]


@pytest.mark.parametrize("multi,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh(fake_world, multi, shape, names):
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert mesh.get_local_rank("model") == 0


def test_host_mesh_needs_a_big_enough_world(fake_world):
    fake_world(4)
    with pytest.raises(AssertionError):
        make_host_mesh(2, 4, "cpu")
    mesh = make_host_mesh(2, 2, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_multi_pod_data_group_is_built_once(fake_world):
    """On the multi-pod mesh a stage's data group spans "pod" and "data":
    the 32 ranks of model coordinate 0, flattened once and reused."""
    from repro_torch.pipeline.spmd import _data_group
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    group = _data_group(mesh, ("pod", "data"))
    assert dist.get_process_group_ranks(group) == list(range(0, 512, 16))
    assert _data_group(mesh, ("pod", "data")) is group


DRYRUN = """
import dataclasses, sys
from repro_torch import configs
from repro_torch.launch.pipeline_dryrun import run
# the depth cut to one layer a stage, in this process only
configs._REGISTRY["llama-65b"] = dataclasses.replace(
    configs.get_config("llama-65b"), num_layers=16)
for bpipe in (False, True):
    run("llama-65b", "single", bpipe, B=32, s=64, out_dir=sys.argv[1])
"""


def test_pipeline_dryrun_subprocess(tmp_path):
    """The production single-pod mesh on a fake world of 256 (data 16, p
    16), llama-65b cut to 16 layers: B 32 gives a local batch of 2, so m 2
    and T = 17 ticks; the bpipe file has 2T more permutes a step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", DRYRUN, str(tmp_path)],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("OK pipeline llama-65b single") == 2, r.stdout
    recs = {v: json.load(open(tmp_path / f"pipeline__llama-65b__single__{v}.json"))
            for v in ("1f1b", "bpipe")}
    ticks = 2 + 16 - 1
    hop = 1 * 64 * 8192 * 2  # mb x s x d, bf16
    for v, rec in recs.items():
        assert rec["p"] == 16 and rec["num_micro"] == 2 and rec["ticks"] == ticks
        assert rec["mesh"] == "single"
        assert rec["bpipe_stash"] == (v == "bpipe")
        # MemTracker's peak less the arguments: at least a stage's
        # activations of one microbatch (mb x s x d in the compute dtype)
        assert rec["memory"]["temp_bytes"] >= hop
        assert "MemTracker" in rec["memory"]["temp_bytes_source"]
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["t_run_s"] >= 0
        assert set(rec["collective_bytes"]) == set(JR.COLLECTIVES)
    assert recs["1f1b"]["collective_permute_ops"] == 2 * ticks - 1
    assert recs["bpipe"]["collective_permute_ops"] \
        - recs["1f1b"]["collective_permute_ops"] == 2 * ticks
    assert recs["bpipe"]["collective_bytes"]["collective-permute"] \
        == (4 * ticks - 1) * hop
    assert recs["1f1b"]["collective_ops"]["all-reduce"] \
        == recs["bpipe"]["collective_ops"]["all-reduce"] > 0
