"""The port's production dry run (``repro_torch/launch/dryrun.py``) against
the JAX twin's (``repro/launch/dryrun.py``) on combos the port used to fail:
one rank's arguments to the byte and the redistributions the port counts.

Each case runs the port's ``run_one`` in this process (a fake process group
of 256 / 512 ranks) and the twin's CLI in a subprocess (it sets the XLA
host-device flag at import). A case with a cut runs both at a smaller shape
(and config), patched into both registries before ``run_one`` / ``main``.
The classes of fault, each with a case:
  (a) a decode's heads merged into the output projection by a 4-dim einsum
      (a strided shard of the heads under DTensor);
  (b) the MoE dispatch's reshapes and slices of a sharded buffer;
  (c) the mLSTM's chunked recurrence and the sLSTM's loop where 4 heads on
      16 "model" ranks relocate onto head_dim;
  (d) gradient accumulation's microbatches (8 rows on 16 data ranks).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# a reduced llama-65b whose sharded dims all divide 16 model ranks
LLAMA_CUT = {"reduced": True, "num_heads": 16, "num_kv_heads": 16,
             "head_dim": 16}

# (arch, shape, mesh, variant, cut: (seq, batch, config overrides, of the
# reduced config where they say "reduced") or None, the redistribution tags
# counted)
CASES = [
    ("qwen1.5-0.5b", "decode_32k", "single", "baseline", None, set()),
    # 16/8 heads: rows 128 / 32 do not divide "model", so each rank takes
    # its q head and k/v whole over "model" for the kv head it needs
    ("granite-moe-1b-a400m", "decode_32k", "multi", "baseline",
     (32768, 128, {"num_layers": 4}), {"moe_combine", "attn_kv"}),
    # the tied vocab, 49155, relocated onto d: the logits partial sums; q/k/v
    # off their head_dim shard onto rows before attention
    ("granite-moe-1b-a400m", "train_4k", "single", "baseline",
     (256, 256, {"num_layers": 2}),
     {"moe_combine", "logits_partial", "attn_q", "attn_kv"}),
    # the sLSTM's bias gathered off its head_dim shard
    ("xlstm-125m", "long_500k", "multi", "baseline", None,
     {"slstm_state", "slstm_b"}),
    ("xlstm-125m", "train_4k", "single", "baseline", (16, 16, {}),
     {"mlstm_q", "mlstm_k", "mlstm_v", "mlstm_li", "mlstm_og", "slstm_b"}),
    # 4 microbatches of 8 rows, relocated onto the sequence: the labels
    # gathered and the rows of the products' grads merged
    ("llama-65b", "train_4k", "single", "accum_b8", (32, 32, LLAMA_CUT),
     {"accum_batch", "labels", "rows_merge"}),
]

# the twin's CLI after the same cut: argv[1] a JSON of
# [arch, shape, seq, batch, config overrides], the rest its flags
_TWIN_CUT = """
import dataclasses, json, sys
import repro.launch.dryrun as D
from repro import configs
arch, shape, seq, batch, over = json.loads(sys.argv[1])
old = configs.INPUT_SHAPES[shape]
configs.INPUT_SHAPES[shape] = configs.InputShape(shape, seq, batch, old.kind)
cfg = configs.get_config(arch)
if over.pop("reduced", False):
    cfg = cfg.reduced()
configs._REGISTRY[arch] = dataclasses.replace(cfg, name=arch, **over)
sys.argv = ["dryrun"] + sys.argv[2:]
D.main()
"""


def _twin(arch, shape, mesh, variant, cut, out):
    flags = ["--arch", arch, "--shape", shape, "--mesh", mesh, "--variant",
             variant, "--no-roofline", "--out", str(out)]
    cmd = ([sys.executable, "-m", "repro.launch.dryrun"] + flags if cut is None
           else [sys.executable, "-c", _TWIN_CUT, json.dumps([arch, shape, *cut])]
           + flags)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=120)
    assert f"OK   {arch} {shape} {mesh}" in done.stdout, done.stdout + done.stderr
    suffix = "" if variant == "baseline" else f"__{variant}"
    with open(out / f"{arch}__{shape}__{mesh}{suffix}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape,mesh,variant,cut,tags", CASES, ids=[
    f"{a}-{s}-{m}-{v}" + ("-cut" if c else "") for a, s, m, v, c, _ in CASES])
def test_port_runs_where_the_twin_runs_and_its_arguments_match(
        arch, shape, mesh, variant, cut, tags, tmp_path, monkeypatch):
    """The port writes a record; its rank's arguments less those the step
    never reads (``unread_argument_bytes``: the twin's ``jax.jit`` prunes
    them) are the twin's to the byte; the redistributions it counts are the
    repaired paths' (the tags of ``rules.REDISTRIBUTIONS``)."""
    if cut is not None:
        seq, batch, over = cut
        old = configs.INPUT_SHAPES[shape]
        monkeypatch.setitem(configs.INPUT_SHAPES, shape,
                            configs.InputShape(shape, seq, batch, old.kind))
        over = dict(over)
        cfg = configs.get_config(arch)
        if over.pop("reduced", False):
            cfg = cfg.reduced()
        monkeypatch.setitem(configs._REGISTRY, arch,
                            dataclasses.replace(cfg, name=arch, **over))
    path = dryrun.run_one(arch, shape, mesh, with_roofline=False,
                          out_dir=str(tmp_path / "port"), force=True,
                          variant=variant)
    rec = json.load(open(path))
    twin = _twin(arch, shape, mesh, variant, cut, tmp_path / "twin")
    mem = rec["full"]["memory"]
    assert mem["unread_argument_bytes_why"]
    assert mem["argument_bytes"] - mem["unread_argument_bytes"] \
        == twin["full"]["memory"]["argument_bytes"]
    assert {e[0] for e in rec["full"]["redistributions"]} == tags
    assert rec["chips"] == twin["chips"] and rec["params"] == twin["params"]
