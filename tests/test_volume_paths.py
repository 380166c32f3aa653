"""The routed 3D path and the XLA sharded paths against the references, at
the volume shapes and mesh shapes the earlier 3D kernels and mesh layouts
were tested at."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import epic_tpu
from epic_tpu import maps
from epic_tpu import solver as S
from epic_tpu.grid import make_state
from epic_tpu.parallel import make_mesh, sharded, sharded3d
from epic_tpu.solver import core, reference_np

VOLUMES = [(6, 10, 40), (7, 9, 21), (6, 8, 17), (10, 12, 14), (5, 9, 131),
           (20, 12, 24), (14, 10, 18), (8, 18, 140), (8, 34, 140),
           (10, 34, 140)]


def _volume_np(d, h, w, density=0.12, seed=0):
    rng = np.random.default_rng(seed)
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random((d, h, w)) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return u, locked


@pytest.mark.parametrize("shape", VOLUMES)
def test_update_volume_matches_oracle(shape):
    u, locked = _volume_np(*shape, seed=sum(shape))
    steps = 9
    u_ref = u.copy()
    d_first = None
    for it in range(steps):
        u_ref, d = reference_np.sweep_3d(u_ref, locked, it)
        d_first = d if d_first is None else d_first
    out = S.update_volume(make_state(u, locked, 1e-2), steps)
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)
    assert abs(float(out.delta) - float(d_first)) <= 1e-6 + 1e-5 * abs(d_first)
    assert int(out.iteration) == steps


@pytest.mark.parametrize("shape", [(14, 10, 18), (8, 34, 140), (20, 12, 24)])
def test_solve_volume_matches_core(shape):
    u, locked = _volume_np(*shape, density=0.05, seed=7)
    a = S.solve_volume(make_state(u, locked, 1e-1), stagger=7)
    b = core.solve(make_state(u, locked, 1e-1), stagger=7)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) and bool(b.converged)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_volume_entry_points_reject_2d():
    st = epic_tpu.from_occupancy_image(maps.open_room(16, 16))
    with pytest.raises(ValueError, match="3D grid"):
        S.update_volume(st, 3)
    with pytest.raises(ValueError, match="3D grid"):
        S.solve_volume(st)


# -- the XLA sharded 2D path at the earlier mesh-layout shapes -------------------

MESH2D = [((2, 4), (48, 512)), ((2, 4), (62, 1000)), ((8, 1), (64, 256)),
          ((1, 1), (40, 128)), ((4, 2), (37, 300))]


def _mesh(shape):
    n = shape[0] * shape[1]
    return make_mesh(shape, devices=np.asarray(jax.devices()[:n]))


@pytest.mark.parametrize("mesh_shape,grid", MESH2D)
def test_sharded_update_at_layout_shapes(mesh_shape, grid):
    img = maps.random_obstacles(*grid, density=0.1, seed=grid[1])
    mesh = _mesh(mesh_shape)
    a = sharded.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 21,
                         mesh, chunk_depth=8)
    b = core.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 21)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), rtol=0, atol=2e-6)
    assert float(a.delta) == float(b.delta)


@pytest.mark.parametrize("mesh_shape,grid", MESH2D[:3])
def test_sharded_solve_at_layout_shapes(mesh_shape, grid):
    img = maps.random_obstacles(*grid, density=0.1, seed=grid[0])
    mesh = _mesh(mesh_shape)
    a = sharded.solve(epic_tpu.from_occupancy_image(img, epsilon=1e-1), mesh,
                      stagger=20, max_iterations=2_000)
    b = core.solve(epic_tpu.from_occupancy_image(img, epsilon=1e-1), stagger=20,
                   max_iterations=2_000)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) == bool(b.converged)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), rtol=0, atol=1e-3)


# -- the XLA sharded 3D path at the earlier plane- and z-mesh shapes --------------

MESH3D = [("plane", (2, 4), (8, 16, 512)), ("plane", (2, 4), (10, 16, 512)),
          ("plane", (4, 2), (6, 32, 256)), ("z", (8, 1, 1), (32, 24, 256)),
          ("z", (8, 1, 1), (24, 24, 256)), ("z", (4, 1, 1), (36, 16, 128)),
          ("z", (4, 1, 1), (22, 16, 128))]


def _mesh3(kind, shape):
    n = int(np.prod(shape))
    devs = np.asarray(jax.devices()[:n])
    if kind == "z":
        return sharded3d.make_mesh3d(shape, devices=devs)
    return make_mesh(shape, devices=devs)


@pytest.mark.parametrize("kind,mesh_shape,vol", MESH3D)
def test_sharded3d_update_at_layout_shapes(kind, mesh_shape, vol):
    u, locked = _volume_np(*vol, density=0.1, seed=vol[0])
    mesh = _mesh3(kind, mesh_shape)
    a = sharded3d.update_n(make_state(u, locked, 1e-2), 7, mesh, chunk_depth=2)
    b = core.update_n(make_state(u, locked, 1e-2), 7)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), rtol=2e-6, atol=1e-4)
    assert float(a.delta) == float(b.delta)


@pytest.mark.parametrize("kind,mesh_shape,vol", [MESH3D[2], MESH3D[5], MESH3D[6]])
def test_sharded3d_solve_at_layout_shapes(kind, mesh_shape, vol):
    u, locked = _volume_np(*vol, density=0.05, seed=3)
    mesh = _mesh3(kind, mesh_shape)
    a = sharded3d.solve(make_state(u, locked, 1e-1), mesh, stagger=10,
                        max_iterations=1_000)
    b = core.solve(make_state(u, locked, 1e-1), stagger=10, max_iterations=1_000)
    assert int(a.iteration) == int(b.iteration)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), rtol=2e-6, atol=1e-3)


# -- compile cache placement ---------------------------------------------------------

ROOT = pathlib.Path(epic_tpu.__file__).resolve().parent.parent


def _cache_dir(env_extra):
    env = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin"),
           "PYTHONPATH": str(ROOT)}
    env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-c",
         "import epic_tpu, jax; print(epic_tpu.CACHE_DIR); "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd="/", timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_cache_dir_defaults_to_the_checkout():
    ours, jax_dir = _cache_dir({})
    assert ours == jax_dir == str(ROOT / ".jax_cache")


def test_cache_dir_env_var_wins(tmp_path):
    ours, jax_dir = _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert ours == jax_dir == str(tmp_path)


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()
