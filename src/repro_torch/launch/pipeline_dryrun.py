"""Pipeline-parallel dry run of the paper's own configuration, at
production-mesh scale: GPT-3 96B (and LLaMA 65B) with the "model" dim
carrying p=16 pipeline stages (the paper's Fig. 2 16-way setup),
data-parallel over the remaining dims, with and without the BPipe
activation-offload pattern (pipeline/spmd.py). The twin of the JAX
package's ``repro/launch/pipeline_dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.pipeline_dryrun [--arch gpt3-96b] \
        [--mesh single] [--out DIR]

It runs as rank 0 of a ``"fake"`` process group of 256 (single pod) or 512
(multi-pod) ranks, under ``FakeTensorMode``: the loss and its backward run
once with shapes and no data, nothing is allocated and no card is needed,
as the JAX twin lowers and compiles for 512 fake devices. The model takes
its CPU path (the plain attention) on fake CPU tensors; the collectives,
which this run counts, do not depend on the attention arm.

Writes experiments/dryrun_torch/pipeline__<arch>__<mesh>__<variant>.json
(never the JAX twin's directory) with the collective-permute ops and bytes
(the eviction hops) and the all-reduce ops and bytes of one step on rank
0, the argument bytes (the rank's params plus its batch shard) and the
temp bytes: the peak of ``MemTracker`` over the step less the arguments,
torch's number for what the twin's ``memory_analysis()`` calls temporaries
(``launch/dryrun.py``'s ``TEMP_BYTES_SOURCE``).

Where the counts differ from the twin's: the twin counts the ops of the
compiled HLO, where a ``lax.scan`` body holds each tick's ops once; here
the port's collective counter counts the ops a step runs (per step,
dynamic): 2T - 1 permutes for T = m + p - 1 ticks, 4T - 1 with BPipe.
"""
import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import TEMP_BYTES_SOURCE, fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.pipeline import collectives
from repro_torch.pipeline.spmd import init_pipeline_params, make_spmd_train_loss

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run(arch: str, mesh_kind: str, bpipe: bool, *, p=16, B=128, s=2048,
        num_micro=None, out_dir=None):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = get_config(arch)
    assert cfg.num_layers % p == 0
    fake_world(512 if mesh_kind == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
        # microbatches stream per data shard: num_micro must divide the
        # local batch (B / data-dims product)
        data = 1
        for a in mesh.mesh_dim_names:
            if a != "model":
                data *= mesh.size(mesh.mesh_dim_names.index(a))
        local_b = max(B // data, 1)
        num_micro = num_micro or local_b
        step = make_spmd_train_loss(cfg, mesh, p, num_micro=num_micro,
                                    bpipe_stash=bpipe)
        stage = mesh.get_local_rank("model")
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = init_pipeline_params(torch.Generator().manual_seed(0), cfg,
                                          p, stage, "cpu")
            batch = {"tokens": torch.zeros((local_b, s), dtype=torch.int32),
                     "labels": torch.zeros((local_b, s), dtype=torch.int32)}
            arguments = T.leaves(params) + list(batch.values())
            arg_bytes = _nbytes(arguments)
            tracker = MemTracker()
            tracker.track_external(*arguments)
            collectives.reset()
            t0 = time.time()
            with tracker:
                step(params, batch)
            t_run = time.time() - t0
            peak = sum(v.get("Total", 0) for v in
                       tracker.get_tracker_snapshot("peak").values())
        coll, ops = rl.collective_bytes(), collectives.read()["ops"]
    finally:
        dist.destroy_process_group()
    rec = {
        "arch": arch, "mesh": mesh_kind, "p": p, "num_micro": num_micro,
        "bpipe_stash": bpipe, "ticks": num_micro + p - 1,
        "t_run_s": round(t_run, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "temp_bytes": max(peak - arg_bytes, 0),
                   "temp_bytes_source": TEMP_BYTES_SOURCE},
        "collective_bytes": coll,
        "collective_ops": ops,
        "collective_permute_ops": ops["collective-permute"],
        "counts": "ops one loss-and-grad step runs on rank 0 (dynamic, per "
                  "step); the JAX twin counts the compiled HLO's ops",
    }
    out_dir = out_dir or os.path.abspath(OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    name = f"pipeline__{arch}__{mesh_kind}__{'bpipe' if bpipe else '1f1b'}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"OK pipeline {arch} {mesh_kind} bpipe={bpipe} "
          f"run={t_run:.1f}s temp={rec['memory']['temp_bytes'] / 2**30:.2f}GiB "
          f"cp_ops={rec['collective_permute_ops']} "
          f"cp_bytes={coll['collective-permute']/2**30:.2f}GiB "
          f"ar_ops={ops['all-reduce']} "
          f"ar_bytes={coll['all-reduce']/2**30:.2f}GiB", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=["gpt3-96b", "llama-65b"])
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"])
    ap.add_argument("--out", default=None,
                    help="directory of the JSON files (default "
                         "experiments/dryrun_torch)")
    args = ap.parse_args()
    for arch in args.arch:
        for mesh_kind in args.mesh:
            for bpipe in (False, True):
                try:
                    run(arch, mesh_kind, bpipe, out_dir=args.out)
                except Exception as e:  # noqa: BLE001
                    print(f"FAIL pipeline {arch} {mesh_kind} bpipe={bpipe}: "
                          f"{e!r}", flush=True)


if __name__ == "__main__":
    main()
