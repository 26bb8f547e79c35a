"""repro_torch.kernels.build: a library's target name covers the headers its
source includes, so an edit to a shared header (csrc/hopper.cuh) builds
anew instead of reusing a stale library. Pure Python: nvcc is not run."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc_version", lambda: "nvcc test version")
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n#include <math.h>\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    return tmp_path


def test_closure_follows_quoted_includes(csrc):
    assert [p.name for p in build._closure(csrc / "a.cu")] == ["a.cu", "h.cuh", "g.cuh"]
    assert [p.name for p in build._closure(csrc / "b.cu")] == ["b.cu"]


@pytest.mark.parametrize("edited", ["a.cu", "h.cuh", "g.cuh"])
def test_target_changes_with_any_included_file(csrc, edited):
    src, before = build._target("a")
    assert src == csrc / "a.cu" and before.parent == csrc / "_build"
    other = build._target("b")[1]
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    after = build._target("a")[1]
    assert after != before
    assert build._target("b")[1] == other  # a source that does not include it keeps its target
