"""The plain reference against the program at a tiny size in fp32 on the
CPU: the pipelined step (the timed path) and the single-device loss give
the reference's loss and every leaf's gradient to fp32 rounding."""
import pytest
import torch

from bench import check, reference, run


@pytest.mark.parametrize("name", ["dense.flash", "granite-moe.bpipe.b4",
                                  "dense.recompute", "granite-moe.1f1b.b2.s4096"])
def test_pipelined_step_matches_the_reference_in_fp32(tiny, name):
    cell = tiny(name)
    cell.config["model"]["dtype"] = "float32"
    cfg, params, batches, ex = run.build(cell, 2**40 + 17, torch.device("cpu"))
    res, mod = ex.step(params, batches[0]), cell.module
    numbers, stats = check.compare(
        mod.leaf_grads(cfg, params, batches[0], int(cell.traffic["micro_batch"])),
        lambda n: mod.leaf_of(res.grads, n), float(res.loss))
    assert len(stats.rows) == len(mod.leaf_names(cfg))
    assert numbers["loss_rel"] < 1e-6
    assert numbers["grad_norm_gap"] < 1e-5 and numbers["grad_diff"] < 1e-5, numbers


def test_single_device_loss_matches_the_reference(tiny):
    from repro_torch.models import model as M
    cell = tiny("granite-moe.bpipe.b4")
    cell.config["model"]["dtype"] = "float32"
    cfg, params, batches, _ = run.build(cell, 5, torch.device("cpu"))
    batch = {k: v[:2] for k, v in batches[1].items()}  # one microbatch of 2 rows
    with torch.no_grad():
        loss, _ = M.loss_fn(params, batch, cfg)
    want = cell.module.loss_only(cfg, params, batch, 2)
    assert abs(float(loss) - want) / want < 1e-6


def test_the_control_rounds_products_to_float8():
    x = torch.linspace(-3, 3, 101)
    nm = reference.Numerics(fp8=True)
    y = nm.op(x)
    assert not torch.equal(y, x) and torch.allclose(y, x, rtol=0.07, atol=0.03)
    assert torch.equal(reference.Numerics().op(x), x)
    assert nm.op(torch.zeros(0)).numel() == 0
