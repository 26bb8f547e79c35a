"""A run with the timed path broken underneath comes out not correct, and a
sound one correct: the harness's whole run (set-up, window, check) on tiny
cells on the CPU, its look for a chip skipped. The faults a one-chip
training cell can have: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced (one leaf's
gradient negated; all gradients zero); and the control, the reference in
float8 in the program's place. No cell here runs across chips, so there is
no exchange between chips to leave out."""
import pytest

from bench import check, faults, run

DENSE = "dense.flash"
CELLS = [DENSE, "granite-moe.bpipe.b4"]
SEED = 2**33 + 7


def go(cell, wrapper=None):
    return run.run_cell(cell, SEED, 0.2, False, "cpu", step_wrapper=wrapper,
                        log=lambda msg: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, name):
    out = go(tiny(name))
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared" and out["attempted"] >= 1
    assert list(out["compared"]) == list(check.NUMBERS)


def _zero(cell):
    def wrap(ex):
        def step(params, batch):
            res = ex.step(params, batch)
            for leaf in _leaves(res.grads):
                leaf.zero_()
            return res
        return step
    return wrap


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


FAULTS = {
    "stale": faults.stale,
    "half_batch": faults.half_batch,
    "negated_leaf": lambda cell: faults.negated_leaf(cell, ("layer1", "mixer", "wq")),
    "zero_grads": _zero,
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(tiny, name, fault):
    cell = tiny(name)
    out = go(cell, FAULTS[fault](cell))
    assert not out["correct"], (fault, out["compared"])


def test_the_control_is_not_correct(tiny):
    cell = tiny(DENSE)
    out = go(cell, faults.control(cell))
    assert not out["correct"], out["compared"]
    over = [k for k, v in out["compared"].items()
            if v["limit"] is not None and v["value"] > v["limit"]]
    assert over, out["compared"]
