"""VolumePlanner service semantics: the 2D planner's verb surface
generalized to 3D volumes (the reference's service layer is 2D-only;
see epic_tpu/planner3d.py module docstring)."""

import numpy as np
import pytest

import epic_tpu
from epic_tpu import constants as C
from epic_tpu.errors import InvalidLocationError, InvalidPathError
from epic_tpu.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu.solver import core


@pytest.fixture()
def planner():
    p = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, steps_per_update=50))
    p.init(24, 20, 16)  # width, height, depth
    return p


def test_init_creates_boundary_shell(planner):
    st = planner.state
    assert st.u.shape == (16, 20, 24)
    u = np.asarray(st.u)
    locked = np.asarray(st.locked)
    for face in (u[0], u[-1], u[:, 0], u[:, -1], u[:, :, 0], u[:, :, -1]):
        assert np.all(face == np.float32(C.LOG_SPACE_OBSTACLE))
    assert np.all(locked[0]) and np.all(locked[:, :, -1])
    assert not locked[5, 5, 5]


def test_add_goals_update_then_path(planner):
    assert planner.add_goals([(12.0, 10.0, 8.0)])
    assert planner.get_cell(12, 10, 8) == 0.0
    for _ in range(10):
        planner.update()
    poses = planner.compute_path((4.0, 4.0, 4.0), step_size=0.2,
                                 cd_precision=0.4)
    assert len(poses) > 2
    assert poses[0].x == 4.0 and poses[0].y == 4.0 and poses[0].z == 4.0
    end = poses[-1]
    assert abs(end.x - 12) < 2 and abs(end.y - 10) < 2 and abs(end.z - 8) < 2


def test_goals_refused_inside_obstacles(planner):
    planner.set_cells([(6, 6, 6)], [C.CELL_TYPE_OBSTACLE])
    assert not planner.add_goals([(6.0, 6.0, 6.0)])
    # Boundary-shell cells are obstacles too.
    assert not planner.add_goals([(0.0, 6.0, 6.0)])


def test_remove_goals_turns_free(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    planner.remove_goals([(12.0, 10.0, 8.0)])
    st = planner.state
    assert not bool(np.asarray(st.locked)[8, 10, 12])
    assert planner.get_cell(12, 10, 8) == np.float32(C.LOG_SPACE_FREE)


def test_set_status_pauses_updates(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    planner.set_status(True)
    it0 = int(planner.state.iteration)
    planner.update()
    assert int(planner.state.iteration) == it0
    planner.set_status(False)
    planner.update(7)
    assert int(planner.state.iteration) == it0 + 7


def test_update_matches_core(planner):
    """The planner's anytime tick must be the exact XLA update.

    (core.update_n donates its input buffers, so the reference runs on a
    separately-built identical state, not on the planner's.)"""
    planner.add_goals([(12.0, 10.0, 8.0)])
    twin = epic_tpu.make_state(
        np.asarray(planner.state.u), np.asarray(planner.state.locked),
        epsilon=1e-2,
    )
    ref = core.update_n(twin, 13)
    planner.update(13)
    np.testing.assert_array_equal(
        np.asarray(planner.state.u), np.asarray(ref.u)
    )


def test_auto_backend_matches_xla():
    """backend="auto" routes volumes to XLA on every platform (there is no
    3D kernel); two ticks stay bit-identical to the forced XLA path."""
    from epic_tpu.solver import core

    p_x = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, backend="xla"))
    p_a = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, backend="auto"))
    for p in (p_x, p_a):
        p.init(24, 16, 12)
        p.add_goals([(12.0, 8.0, 6.0)])
        p.update(9)
        p.update(9)
    assert p_a._kernel_module() is core
    np.testing.assert_array_equal(
        np.asarray(p_x.state.u), np.asarray(p_a.state.u)
    )
    assert int(p_x.state.iteration) == int(p_a.state.iteration) == 18


def test_volume_routes_to_xla_on_gpu(cuda_model):
    """On a GPU, volumes still take XLA (the CUDA kernel is 2D only), and
    forcing backend="cuda" on a volume is an error."""
    from epic_tpu.solver import core

    p_a = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, backend="auto"))
    p_a.init(24, 16, 12)
    assert p_a._kernel_module() is core
    p_c = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, backend="cuda"))
    p_c.init(24, 16, 12)
    with pytest.raises(ValueError, match="2D grids"):
        p_c.update(3)


@pytest.mark.parametrize("backend", ["pallas", "resident_interpret"])
def test_removed_3d_backends_rejected(backend):
    """The removed 3D kernel options are rejected."""
    p = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, backend=backend))
    p.init(140, 34, 8)
    with pytest.raises(ValueError, match="unknown solver backend"):
        p.update(5)


def test_solve_to_convergence_and_protocol(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    planner.solve()
    st = planner.state
    assert bool(st.converged)
    assert int(st.iteration) % C.DEFAULT_STAGGER == 1
    assert int(st.iteration) >= max(st.u.shape)


def test_solve_cap_then_host_loop_converges(planner):
    """VolumePlanner.solve(max_iterations=...) mirrors the 2D escape
    hatch: capped segments loop from the host to a sound verdict."""
    planner.add_goals([(12.0, 10.0, 8.0)])
    planner.solve(max_iterations=3)
    assert not bool(planner.state.converged)
    for _ in range(50):
        planner.solve(max_iterations=200)
        if bool(planner.state.converged):
            break
    assert bool(planner.state.converged)
    assert int(planner.state.iteration) % C.DEFAULT_STAGGER == 1


def test_set_cells_voxel_coords_skip_invalid(planner):
    planner.set_cells(
        [(3, 4, 5), (999, 4, 5), (-1, 2, 2), (3, 4, 5)],
        [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_GOAL,
         C.CELL_TYPE_GOAL],
    )
    # Duplicate (3,4,5) resolves last-wins -> GOAL; invalid entries skipped.
    assert planner.get_cell(3, 4, 5) == 0.0
    assert bool(np.asarray(planner.state.locked)[5, 4, 3])


def test_reset_free_cells_clears_potential_keeps_goals(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    planner.update(20)
    assert planner.get_cell(11, 10, 8) > float(C.LOG_SPACE_FREE)
    planner.reset_free_cells()
    assert planner.get_cell(11, 10, 8) == np.float32(C.LOG_SPACE_FREE)
    assert planner.get_cell(12, 10, 8) == 0.0
    assert int(planner.state.iteration) == 0


def test_occupancy_volume_ingest_and_no_change(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    data = np.full((16, 20, 24), C.OCCUPANCY_NO_CHANGE, dtype=np.int8)
    data[4, 4, 4] = 100          # new obstacle
    data[8, 10, 12] = 100        # would hit the goal voxel — must be kept
    planner.update_occupancy(data)
    locked = np.asarray(planner.state.locked)
    u = np.asarray(planner.state.u)
    assert locked[4, 4, 4] and u[4, 4, 4] == np.float32(C.LOG_SPACE_OBSTACLE)
    assert planner.get_cell(12, 10, 8) == 0.0  # goal survived
    # Resize triggers full reinit (goals lost).
    planner.update_occupancy(np.zeros((10, 12, 14), dtype=np.int8))
    assert planner.state.u.shape == (10, 12, 14)
    assert not np.any(
        np.asarray(planner.state.u)[1:-1, 1:-1, 1:-1]
        == np.float32(C.LOG_SPACE_GOAL)
    )


def test_world_transforms_with_origin_and_resolution():
    p = VolumePlanner(VolumePlannerConfig(
        epsilon=1e-2, resolution=0.5, origin_x=-2.0, origin_y=1.0,
        origin_z=0.25,
    ))
    p.init(20, 20, 20)
    mx, my, mz = p.world_to_map(-1.0, 2.0, 1.25)
    assert (mx, my, mz) == (2.0, 2.0, 2.0)
    assert p.map_to_world(2.0, 2.0, 2.0) == (-1.0, 2.0, 1.25)
    with pytest.raises(InvalidLocationError):
        p.world_to_map(100.0, 0.0, 0.0)


def test_path_too_early_raises_invalid_path(planner):
    planner.add_goals([(12.0, 10.0, 8.0)])
    # No relaxation at all: the field is flat, gradient invalid / path <= 2.
    with pytest.raises((InvalidPathError, Exception)):
        planner.compute_path((4.0, 4.0, 4.0))


def test_from_occupancy_volume_semantics():
    vol = np.full((6, 7, 8), 128, dtype=np.uint8)
    vol[0] = 0
    vol[3, 3, 3] = 255
    st = epic_tpu.from_occupancy_volume(vol)
    u = np.asarray(st.u)
    locked = np.asarray(st.locked)
    assert u[3, 3, 3] == 0.0 and locked[3, 3, 3]
    assert np.all(u[0] == np.float32(C.LOG_SPACE_OBSTACLE)) and np.all(locked[0])
    assert u[2, 2, 2] == np.float32(C.LOG_SPACE_FREE) and not locked[2, 2, 2]
