"""The harness loads neither JAX nor the JAX package, reads nothing of
``benchmarks/``, and prints no result without a card or without the
program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return sorted(spec.BENCH.glob("*.py")) + sorted((spec.BENCH / "metrics").glob("*.py")) \
        + sorted((spec.BENCH / "models").glob("*.py"))


def _model_modules():
    """Every model module a configuration names, the default and the
    tests' own."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    named = [json.loads((spec.ROOT / c["file"]).read_text()).get("model_module")
             for c in bench["configs"]]
    return sorted({spec.DEFAULT_MODULE, "bench/tests/windowed_model.py",
                   *filter(None, named)})


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                assert n.split(".")[0] != "benchmarks", (path, n)
        assert "benchmarks/" not in path.read_text(), path


def test_a_run_leaves_no_forbidden_module_loaded():
    """A whole tiny run in a fresh interpreter, then the top-level names
    of every module it holds, each compared whole (``repro_torch`` is not
    ``repro``)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import tiny_cell\n"
        "from bench import run\n"
        "out = run.run_cell(tiny_cell('granite-moe.bpipe.b4'), 3, 0.1, True, 'cpu', log=lambda m: None)\n"
        "assert out['correct'], out\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(spec.ROOT), str(spec.ROOT / "src"), str(Path(__file__).parent))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    tops = set(got.stdout.split())
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)


@pytest.mark.parametrize("module", _model_modules())
def test_loading_a_model_module_imports_nothing_of_the_program(module):
    """A model module loaded in a fresh interpreter leaves neither the port
    nor the JAX package (nor JAX) in ``sys.modules``: its reference takes
    nothing of the program."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench import spec\n"
        "mod = spec.model_module({'model_module': %r})\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(spec.ROOT), str(spec.ROOT / "src"), module)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    tops = set(got.stdout.split())
    assert "torch" in tops and not tops & (FORBIDDEN | {"repro_torch"}), tops


def _harness(cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "granite-moe.bpipe.b4", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_no_card_no_result():
    got = _harness(spec.ROOT)
    assert got.returncode != 0 and got.stdout == "", (got.returncode, got.stdout)
    assert "CUDA" in got.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _harness(tmp_path)
    assert got.returncode != 0 and got.stdout == ""
    assert "repro_torch" in got.stderr


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    """Needs a CUDA card: a shipped cell for two seconds."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "granite-moe.bpipe.b4", "--seed", "12345678901", "--seconds", "2",
                          "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
                         text=True, timeout=1200)
    assert got.returncode == 0, got.stderr[-3000:]
    import json
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"]
