"""chip_smoke.py's own logic, on the CPU: it refuses any platform but the
GPU, stops at the first failing phase, and prints the exact result line.
Its phases run here at small sizes with the CUDA kernel replaced by its CPU
model (the card runs them at full size)."""

import json
import pathlib
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _dev(platform, kind="K"):
    return SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL"])
def test_refuses_other_platforms(platform):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu([_dev(platform)])


def test_refuses_no_devices_and_too_few_gpus():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu([_dev("gpu")] * 2, count=4)
    chip_smoke.require_gpu([_dev("gpu")] * 4, count=4)


@pytest.mark.parametrize("n", [1, 4])
def test_result_line_is_exact(n):
    line = chip_smoke.result_line([_dev("gpu", "NVIDIA H200")] * n)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    f'"kind": "NVIDIA H200", "count": {n}}}}}')
    assert json.loads(line)["device"]["count"] == n


def test_failing_phase_stops_the_run(capsys):
    ran = []

    def good():
        ran.append("good")
        return {"x": 1}

    def bad():
        chip_smoke.check(False, "boom")

    def never():
        ran.append("never")
        return {}

    with pytest.raises(AssertionError, match="boom"):
        chip_smoke.run_phases([("good", good), ("bad", bad), ("never", never)])
    assert ran == ["good"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["phase"] == "good"


def test_cli_on_cpu_exits_nonzero_without_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_cli_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def small_sizes(monkeypatch, cuda_model):
    from epic_tpu.solver import cuda_sweep

    monkeypatch.setattr(cuda_sweep, "build", lambda force=False: None)
    monkeypatch.setitem(chip_smoke.SIZES, "kernel", [((40, 52), 20), ((33, 47), 9)])
    monkeypatch.setitem(chip_smoke.SIZES, "solve_cap", {(33, 47): 301})
    monkeypatch.setitem(chip_smoke.SIZES, "volume", (10, 12, 14))
    monkeypatch.setitem(chip_smoke.SIZES, "mesh2d", (32, 48))
    monkeypatch.setitem(chip_smoke.SIZES, "mesh3d", (12, 10, 14))
    monkeypatch.setitem(chip_smoke.SIZES, "mesh_cap", 301)


def test_kernel_phase_small(small_sizes):
    row = chip_smoke.phase_kernel()
    assert row["40x52"]["max_abs"] == 0.0
    assert row["33x47"]["solve_iters"][0] == row["33x47"]["solve_iters"][1]


def test_volume_phase_small(small_sizes):
    row = chip_smoke.phase_volume()
    assert row["path"] == "epic_tpu.solver.core"
    assert row["max_abs"] <= 1e-5


@pytest.mark.parametrize("phase", ["phase_mesh2d", "phase_mesh3d"])
def test_mesh_phases_small(small_sizes, phase):
    assert len(jax.devices()) >= 4
    row = getattr(chip_smoke, phase)()
    assert row["iterations"][0] == row["iterations"][1]
    assert row["max_abs"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["phase_kernel", "phase_bounded",
                                   "phase_service", "phase_volume"])
def test_phases_on_gpu(gpu_device, phase):
    """The card's comparisons (kernel vs XLA, bounded and converged fields
    and paths vs the reference binary, 3D vs the CPU device) at full size."""
    getattr(chip_smoke, phase)()
