"""The port's nvcc build-on-first-use (dag_rider_tpu_torch.utils.build).

No nvcc exists where these tests run, so a stand-in compiler script
takes its place: it writes the output file and prints ptxas-style
lines. That exercises everything around the compiler: one process per
source, the hash-keyed file names, reuse of an unchanged build, the
saved register/spill report, and the errors.
"""

import stat
import sys

import pytest

from dag_rider_tpu_torch.utils import build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
src = args[-1]
if "broken" in open(src).read():
    print("error: broken source")
    sys.exit(1)
open(args[args.index("-o") + 1], "w").write("lib")
print("ptxas info    : Compiling entry function 'k' for 'sm_90a'")
print("ptxas info    : Function properties for k")
print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
print("ptxas info    : Used 40 registers, used 0 barriers")
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build.shutil, "which", lambda name: str(nvcc))
    return csrc


def test_builds_each_source_once_and_keys_on_content(tree):
    (tree / "a.cu").write_text("// a")
    (tree / "b.cu").write_text("// b")
    first = build.build_all()
    assert set(first) == {"a", "b"} and all(p.exists() for p in first.values())
    assert build.last_build_s > 0
    assert build.build_all() == first and build.last_build_s == 0.0  # reused
    assert build.ptxas_report("a") == [
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
    ]
    (tree / "a.cu").write_text("// a, edited")
    second = build.build_all()
    assert second["a"] != first["a"] and second["b"] == first["b"]
    (tree / "common.cuh").write_text("// header")
    assert set(build.build_all().values()).isdisjoint(second.values())


def test_failed_build_raises_with_compiler_output(tree):
    (tree / "bad.cu").write_text("broken")
    with pytest.raises(RuntimeError, match="broken source"):
        build.build_all()


def test_missing_nvcc_raises(tree, monkeypatch, tmp_path):
    (tree / "a.cu").write_text("// a")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not build.BUILD_DIR.exists()
