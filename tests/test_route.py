"""The one routing decision (solver.route) and every entry point's use of it."""

import subprocess
import sys

import numpy as np
import pytest

import epic_tpu
from epic_tpu import maps
from epic_tpu.solver import core, cuda_sweep, route

# The grids the CUDA kernel was timed at against XLA on the H200
# (tools/sweep_ab.py); it was faster at each, so the route picks it there.
MEASURED_2D = [(482, 482), (310, 940), (4096, 4096), (16384, 16384)]
SHAPES = {
    "2d_small": (48, 64),
    "2d_measured": (482, 482),
    "2d_wide": (310, 940),
    "2d_big": (16384, 16384),
    "3d": (64, 64, 64),
    "4d": (6, 7, 8, 9),
}
REMOVED = ["pallas", "pallas_interpret", "pallas_banded", "resident",
           "resident_interpret", "metal", ""]


@pytest.mark.parametrize("shape_class", sorted(SHAPES))
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_route_table(platform, sharded, shape_class):
    shape = SHAPES[shape_class]
    want = ("cuda" if platform == "gpu" and len(shape) == 2 and not sharded
            else "xla")
    assert route.choose(platform, shape, "auto", sharded) == want
    assert route.choose(platform, shape, "xla", sharded) == "xla"


@pytest.mark.parametrize("shape", MEASURED_2D)
def test_route_picks_the_measured_best_path(shape):
    assert route.choose("gpu", shape) == route.CUDA
    assert route.choose("cpu", shape) == route.XLA
    assert cuda_sweep.choose_geometry(shape) in cuda_sweep.GEOMETRIES


@pytest.mark.parametrize("shape_class", sorted(SHAPES))
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_forced_cuda(platform, sharded, shape_class):
    shape = SHAPES[shape_class]
    if platform == "gpu" and len(shape) == 2 and not sharded:
        assert route.choose(platform, shape, "cuda", sharded) == "cuda"
    else:
        with pytest.raises(ValueError, match="backend='cuda'"):
            route.choose(platform, shape, "cuda", sharded)


@pytest.mark.parametrize("platform", ["opencl", "rocm", "METAL", ""])
@pytest.mark.parametrize("backend", ["auto", "xla", "cuda"])
def test_unknown_platform_raises(platform, backend):
    with pytest.raises(ValueError, match="no compute path"):
        route.choose(platform, (64, 64), backend)


@pytest.mark.parametrize("backend", REMOVED)
def test_removed_options_raise(backend):
    with pytest.raises(ValueError, match="unknown solver backend"):
        route.choose("gpu", (64, 64), backend)


def test_module_for_follows_platform(monkeypatch):
    assert route.module_for((32, 32)) is core
    monkeypatch.setattr(route, "platform", lambda: "gpu")
    assert route.module_for((32, 32)) is cuda_sweep
    assert route.module_for((32, 32), "xla") is core
    assert route.module_for((8, 8, 8)) is core
    monkeypatch.setattr(route, "platform", lambda: "rocm")
    with pytest.raises(ValueError):
        route.module_for((32, 32))


def test_library_entry_points_route_on_gpu(cuda_model):
    """solve_grid/update_grid take the CUDA path on a GPU (its CPU model
    here) and match the XLA path."""
    import epic_tpu.solver as S

    img = maps.random_obstacles(40, 52, density=0.12, seed=2)

    def st():
        return epic_tpu.from_occupancy_image(img, epsilon=1e-2)

    a = S.update_grid(st(), 23)
    b = S.update_grid(st(), 23, backend="xla")
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
    a = S.solve_grid(st(), stagger=10)
    b = S.solve_grid(st(), stagger=10, backend="xla")
    assert int(a.iteration) == int(b.iteration)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_no_platform_picks_interpret_mode():
    """Interpret mode is an explicit argument only: no module of the
    package derives it from the platform."""
    import pathlib

    import re

    root = pathlib.Path(epic_tpu.__file__).parent
    for f in root.rglob("*.py"):
        text = f.read_text()
        assert not re.search(r"default_backend\(\)\s*[!=]=", text), f
    assert "jax.default_backend()" in (root / "solver" / "route.py").read_text()


def test_server_backend_choices():
    """The server CLI offers the routed backends only."""
    out = subprocess.run(
        [sys.executable, "-m", "epic_tpu.services.server", "--backend", "pallas"],
        capture_output=True, text=True, env={"JAX_PLATFORMS": "cpu",
                                              "PATH": "/usr/bin:/bin"},
        cwd=str(__import__("pathlib").Path(epic_tpu.__file__).parent.parent))
    assert out.returncode == 2
    assert "invalid choice: 'pallas'" in out.stderr
