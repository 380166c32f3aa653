"""MeshVolumePlanner: the 3D service verb surface over mesh-resident
sharded volumes == the single-device VolumePlanner, on virtual CPU
meshes (the MeshPlanner equivalence suite, one rank up)."""

import numpy as np
import pytest

import jax

import epic_tpu
from epic_tpu import constants as C
from epic_tpu import grid as G
from epic_tpu.parallel import sharded3d
from epic_tpu.parallel.sharded3d import make_mesh3d
from epic_tpu.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu.planner_mesh import MeshVolumePlanner
from epic_tpu.solver import core


@pytest.fixture(scope="module")
def meshz8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh3d((8, 1, 1))


def _volume(d=24, h=24, w=128, density=0.08, seed=3, eps=1e-2):
    rng = np.random.default_rng(seed)
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random((d, h, w)) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return G.make_state(u, locked, epsilon=eps)


def test_sharded_volume_warm_loop_with_edits(meshz8):
    """ShardedVolume anytime loop: shard once, interleave resident ticks
    and voxel scatters; equals the single-chip functional chain."""
    st = _volume()
    ref = st
    sv = sharded3d.shard_state3d(st, meshz8)
    edits = ([(10, 11, 5), (20, 7, 9), (10, 11, 5)],
             [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE])

    sv = sharded3d.update_n_resident3d(sv, 5, meshz8, chunk_depth=2)
    ref = core.update_n(ref, 5)
    sv = sharded3d.set_cells_resident3d(sv, *edits)
    ref = G.set_cells_3d(ref, *edits)
    sv = sharded3d.update_n_resident3d(sv, 7, meshz8)
    ref = core.update_n(ref, 7)

    back = sharded3d.unshard3d(sv)
    assert int(back.iteration) == int(ref.iteration)
    np.testing.assert_allclose(
        np.asarray(back.u), np.asarray(ref.u), rtol=0, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(back.locked)[1:-1, 1:-1, 1:-1],
        np.asarray(ref.locked)[1:-1, 1:-1, 1:-1],
    )
    # Invalid edits are skipped like grid.set_cells_3d.
    sv2 = sharded3d.set_cells_resident3d(sv, [(999, 2, 1), (3, -1, 0)], [1, 1])
    np.testing.assert_array_equal(np.asarray(sv2.u), np.asarray(sv.u))


def test_solve_resident3d_matches_core(meshz8):
    st = _volume()
    ref = core.solve(_volume(), stagger=10)
    sv = sharded3d.shard_state3d(st, meshz8)
    sv2, conv = sharded3d.solve_resident3d(sv, meshz8, stagger=10)
    assert bool(conv)
    assert int(sv2.iteration) == int(ref.iteration)
    back = sharded3d.unshard3d(sv2)
    np.testing.assert_allclose(
        np.asarray(back.u), np.asarray(ref.u), rtol=0, atol=1e-3
    )


def test_mesh_volume_planner_session_matches_volume_planner(meshz8):
    """A full verb session (state ingest, goals via set_cells, ticks,
    reset, warm solve) matches the single-device VolumePlanner."""
    cfg = VolumePlannerConfig(epsilon=1e-2, steps_per_update=6)
    p1 = VolumePlanner(cfg)
    p2 = MeshVolumePlanner(cfg, mesh=meshz8)
    for pl in (p1, p2):
        pl.state = _volume()   # fresh per planner: solver verbs donate
        pl.update()
        assert pl.set_cells([(9, 9, 9)], [C.CELL_TYPE_GOAL])
        pl.update(7)
        pl.solve(max_iterations=2000)
    assert bool(p1.state.converged) and bool(p2.state.converged)
    assert int(p1.state.iteration) == int(p2.state.iteration)
    np.testing.assert_allclose(
        np.asarray(p1.state.u), np.asarray(p2.state.u), rtol=2e-6, atol=1e-3
    )
    # reset_free_cells on the resident buffers == functional reset.
    p1.reset_free_cells()
    p2.reset_free_cells()
    np.testing.assert_allclose(
        np.asarray(p1.state.u), np.asarray(p2.state.u), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("d,z_major", [(16, True), (8, True), (5, False)])
def test_mesh_volume_planner_auto_mesh_orientation(d, z_major):
    """mesh=None picks the orientation per volume: z-major when every
    device gets at least one plane, else the plane mesh."""
    p = MeshVolumePlanner(VolumePlannerConfig(epsilon=1e-1))
    p.state = _volume(d=d, h=16, w=128, density=0.0)
    assert ("mz" in p.mesh.shape) == z_major
    assert p.mesh.devices.size == len(jax.devices())
    p.update(4)
    assert int(p.state.iteration) == 4


def test_removed_kernel_options_raise_3d(meshz8):
    st = _volume()
    sv = sharded3d.shard_state3d(st, meshz8)
    with pytest.raises(TypeError):
        sharded3d.update_n_resident3d(sv, 1, meshz8, kernel="resident")
    with pytest.raises(TypeError):
        sharded3d.update_n(_volume(), 1, meshz8, kernel="pallas")
    with pytest.raises(TypeError):
        MeshVolumePlanner(VolumePlannerConfig(), mesh=meshz8,
                          kernel="resident_interpret")


