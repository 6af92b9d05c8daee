"""The kernel build (repro_torch.kernels._build) with a stand-in nvcc, on the
CPU: every source starts at once, each one's log and wall seconds are kept
(chip_smoke.py prints flash's), a finished library replaces nothing until
it is complete, and a failed compile raises with its log."""
import stat

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: sleeps per source, prints a ptxas line, writes the -o file
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
case "$src" in *gemm.cu) sleep 0.6;; *silu.cu) echo "error: silu"; exit 2;; esac
echo "ptxas info    : Used 32 registers, 0 bytes spill stores ($src)"
echo lib > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    return tmp_path / "kernels"


def test_build_all_keeps_each_sources_log_and_seconds(fake_nvcc):
    _build.build_all(["pool", "gemm"])
    assert sorted(p.name.split("-")[0] for p in fake_nvcc.iterdir()) == [
        "libgemm", "libpool"]
    assert "Used 32 registers" in _build.build_logs["pool"]
    assert "gemm.cu" in _build.build_logs["gemm"]
    # gemm's stand-in compile takes 0.6 s longer; pool's seconds are its own
    assert _build.build_seconds["gemm"] >= 0.6
    assert _build.build_seconds["pool"] < _build.build_seconds["gemm"]
    seconds = dict(_build.build_seconds)
    _build.build_all(["pool", "gemm"])        # built: nothing runs again
    assert _build.build_seconds == seconds


def test_build_all_raises_with_the_failed_log(fake_nvcc):
    with pytest.raises(RuntimeError, match="(?s)silu.*exit 2.*error: silu"):
        _build.build_all(["silu", "pool"])
    assert [p.name.split("-")[0] for p in fake_nvcc.iterdir()] == ["libpool"]


def test_target_covers_the_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._target(name) for name in _build.SOURCES}
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


def test_only_the_shared_helper_sets_the_shared_memory_attribute():
    """Every source that takes dynamic shared memory sets the attribute
    through common.cuh's allow_smem, once per kernel and device."""
    for path in _build.CSRC.glob("*.cu"):
        src = path.read_text()
        assert "cudaFuncSetAttribute" not in src, path.name
        if "allow_smem(" in src:
            assert '#include "common.cuh"' in src, path.name
    header = (_build.CSRC / "common.cuh").read_text()
    assert header.count("cudaFuncSetAttribute(") == 1
