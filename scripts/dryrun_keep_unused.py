"""The JAX dry run's argument bytes with and without ``jax.jit``'s pruning
of unused arguments: its step for each combo lowered and compiled on the
single production mesh with ``keep_unused=False`` (the default, what
``repro/launch/dryrun.py`` records) and ``keep_unused=True``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dryrun_keep_unused.py \
        qwen1.5-0.5b:prefill_32k whisper-small:decode_32k

The port's dry run counts every argument and reports those its step never
reads apart (``unread_argument_bytes``); the difference printed here is
what the twin's records leave out.
"""
import sys

import repro.launch.dryrun as D  # sets the XLA host-device flag first
import jax

from repro import compat
from repro.configs import INPUT_SHAPES, get_config
from repro.configs.base import TrainConfig
from repro.launch.mesh import make_production_mesh


def main():
    mesh = make_production_mesh(multi_pod=False)
    for combo in sys.argv[1:]:
        arch, shape_name = combo.split(":")
        cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
        tcfg = TrainConfig(global_batch=shape.global_batch,
                           seq_len=shape.seq_len, remat="attn", micro_batch=0)
        fn, args, in_sh, _ = D.build_step(cfg, shape, mesh, tcfg)
        got = {}
        for keep in (False, True):
            with compat.set_mesh(mesh):
                compiled = jax.jit(fn, in_shardings=in_sh,
                                   keep_unused=keep).lower(*args).compile()
            got[keep] = compiled.memory_analysis().argument_size_in_bytes
        print(f"{arch} {shape_name}: keep_unused=False {got[False]:,} B, "
              f"keep_unused=True {got[True]:,} B, pruned {got[True] - got[False]:,} B",
              flush=True)


if __name__ == "__main__":
    main()
