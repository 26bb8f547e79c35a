"""xlstm-125m, whisper-small and internvl2-1b through the port's pipeline
executor and launchers on the CPU, against the JAX package (fp32).

The executor twins keep tests/test_executor.py:34-37's bounds (loss 1e-5,
grads 2e-6 / 1e-4), but for xLSTM's grads against the JAX executor's
(2e-6 / 1e-3, the mLSTM's own rtol; see that test). As in the JAX twin, a VLM pipelines text-only (its
``prefix_embeds`` are not read; ROADMAP queue C) and an encoder-decoder has
no pipelined path: the JAX executor fails on whisper with an
AttributeError, the port raises a NotImplementedError that says so.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.pipeline import PipelineExecutor as JExecutor
from repro_torch import bridge
from repro_torch import serve as tserve
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import plan as TP
from repro_torch.launch import pipeline as launch_pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.pipeline import PipelineExecutor
from repro_torch.train import steps as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads (see
    tests/test_torch_executor.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(arch, layers, b, s):
    """Smoke-scale (JAX cfg, port cfg) in fp32 at ``layers``, their params
    (JAX init through the bridge) and a batch of b x s tokens, with
    internvl2-1b's 4 prefix embeddings."""
    over = dict(dtype="float32", num_layers=layers)
    jc = dataclasses.replace(get_config(arch).reduced(), **over)
    tc = dataclasses.replace(tget_config(arch).reduced(), **over)
    p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jc.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jc.frontend == "vision":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, jc.num_prefix_embeds, jc.d_model)).astype(np.float32)
    if jc.is_encdec:
        batch["enc_embeds"] = rng.standard_normal((b, 16, jc.d_model)).astype(
            np.float32)
    return (jc, tc, jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu"),
            batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _trees_close(got, want, atol, rtol):
    want = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(T.leaves_with_paths(got))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol, rtol=rtol,
                                   err_msg="/".join(k))


@pytest.mark.parametrize("kind", ["1f1b", "bpipe"])
def test_executor_xlstm_matches_jax(kind):
    """xlstm-125m at 4 layers (two (MLSTM, SLSTM) blocks), p 4, m 4 x 2
    rows of 12 tokens; bpipe swaps (its cap 3 under 1F1B's 4 on stage 0).

    The loss within 1e-5 of the JAX executor's and of JAX's loss_fn; the
    grads within 2e-6 / 1e-4 of the port's own loss_fn (the executor's
    contract, tests/test_executor.py:34-37) and within 2e-6 / 1e-3 of the
    JAX executor's: the chunkwise mLSTM's grads round apart in fp32 (its
    own bar is rtol 1e-3, tests/test_models.py:115-118), and on this batch
    the JAX executor's own grads differ from the JAX loss_fn's past the
    1e-4 rtol."""
    jc, tc, jp, tp, batch = _setup("xlstm-125m", layers=4, b=8, s=12)
    res = PipelineExecutor(tc, TP.ScheduleSpec(kind, 4, 0),
                           micro_batch=2).step(tp, _tb(batch))
    jres = JExecutor(jc, p=4, kind=kind, micro_batch=2).step(jp, _jb(batch))
    ref_loss = JM.loss_fn(jp, _jb(batch), jc)[0]
    assert abs(float(res.loss) - float(jres.loss)) < 1e-5
    assert abs(float(res.loss) - float(ref_loss)) < 1e-5
    _, own = TS.make_loss_grad(tc, TrainConfig())(tp, _tb(batch))
    _trees_close(res.grads, T.tree_map(lambda t: t.numpy(), own), 2e-6, 1e-4)
    _trees_close(res.grads, jres.grads, 2e-6, 1e-3)
    assert (res.stats.evictions > 0) == (kind == "bpipe")


def test_executor_vlm_is_text_only_as_jax():
    """internvl2-1b (2 layers, p 2, bpipe, 2 rows a microbatch): the
    pipelined loss and grads equal the JAX executor's, which embeds the
    tokens only. They equal loss_fn without the prefix and differ from
    loss_fn with it (ROADMAP queue C)."""
    jc, tc, jp, tp, batch = _setup("internvl2-1b", layers=2, b=4, s=12)
    res = PipelineExecutor(tc, TP.ScheduleSpec("bpipe", 2, 0),
                           micro_batch=2).step(tp, _tb(batch))
    jres = JExecutor(jc, p=2, kind="bpipe", micro_batch=2).step(jp, _jb(batch))
    assert abs(float(res.loss) - float(jres.loss)) < 1e-5
    _trees_close(res.grads, jres.grads, 2e-6, 1e-4)
    text = {k: v for k, v in batch.items() if k != "prefix_embeds"}
    text_loss = TM.loss_fn(tp, _tb(text), tc)[0]
    full_loss = TM.loss_fn(tp, _tb(batch), tc)[0]
    assert abs(float(res.loss) - float(text_loss)) < 1e-5
    assert abs(float(res.loss) - float(full_loss)) > 1e-3


def test_executor_encdec_raises():
    """whisper-small: the JAX executor has no encoder in its stages and
    fails with an AttributeError; the port refuses at construction."""
    jc, tc, jp, _, batch = _setup("whisper-small", layers=2, b=2, s=8)
    with pytest.raises(AttributeError):
        JExecutor(jc, p=2, kind="1f1b", micro_batch=1).step(jp, _jb(batch))
    for spec in (TP.ScheduleSpec("1f1b", 2, 0),
                 TP.ScheduleSpec("1f1b", 2, 0, seq_chunks=2)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            PipelineExecutor(tc, spec)


# ---------------------------------------------------------------------------
# The launchers as a user runs them (``--reduced --device cpu``), in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-small", "internvl2-1b"])
def test_launch_train_cpu_runs(arch):
    """Two Adam steps on make_batch's data (whisper's 1500 frames,
    internvl's prefix), finite and moving."""
    res = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    losses = [st["loss"] for st in res["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-small", "internvl2-1b"])
def test_serve_cpu_runs(arch):
    """The serve CLI: tokens in the vocabulary, finite logits, the same
    tokens as ``serve`` on the same seeds' inputs (prefix seed 2, frames
    seed 3)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    res = tserve.main(argv)
    cfg = tserve.config_for(arch, reduced=True)
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].max()) < cfg.vocab_size
    assert torch.isfinite(res["last_logits"]).all()
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(gen, cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    again = tserve.serve(params, cfg, prompts, 4, **tserve.frontend_inputs(
        cfg, 2, torch.device("cpu"), frames=16))
    assert torch.equal(again["tokens"], res["tokens"])


@pytest.mark.parametrize("arch", ["xlstm-125m", "internvl2-1b"])
def test_launch_pipeline_cpu_runs(arch):
    """Every arm (interleaved ones included) on the same batches: the same
    losses."""
    res = launch_pipeline.main(["--arch", arch, "--reduced", "--stages", "2",
                                "--layers", "4", "--batch", "4", "--seq", "12",
                                "--steps", "2", "--device", "cpu"])
    losses = {tuple(round(x, 5) for x in arm["losses"])
              for arm in res["arms"].values()}
    assert len(res["arms"]) == 7 and len(losses) == 1


def test_launch_pipeline_encdec_raises():
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        launch_pipeline.main(["--arch", "whisper-small", "--reduced",
                              "--stages", "2", "--layers", "2", "--batch", "2",
                              "--seq", "8", "--steps", "1", "--device", "cpu"])
