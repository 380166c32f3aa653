"""Planner service semantics: the 7 verbs + occupancy ingest + warm restart
(SURVEY §2.1, §3.2)."""

import numpy as np
import pytest

from epic_tpu import constants as C
from epic_tpu import maps
from epic_tpu.errors import InvalidLocationError
from epic_tpu.planner import Planner, PlannerConfig
from epic_tpu.services import messages as msg
from epic_tpu.services import EpicNavCorePlugin, EpicNavigationNode, EpicNavigationNodeRviz


def _occupancy_from_img(img):
    """PNG fixture -> occupancy values (0 free, 100 obstacle)."""
    data = np.zeros(img.shape, dtype=np.int8)
    data[img == 0] = 100
    return data


@pytest.fixture()
def node():
    n = EpicNavigationNode(PlannerConfig(epsilon=1e-2, steps_per_update=50))
    img = maps.open_room(40, 40)
    grid = msg.OccupancyGrid(40, 40, 1.0, 0.0, 0.0, _occupancy_from_img(img))
    n.sub_occupancy_grid(grid)
    return n


def test_init_creates_boundary_obstacles(node):
    st = node.planner.state
    u = np.asarray(st.u)
    locked = np.asarray(st.locked)
    assert np.all(u[0, :] == np.float32(C.LOG_SPACE_OBSTACLE))
    assert np.all(locked[0, :]) and np.all(locked[:, -1])
    # Interior free cells were ingested as FREE (-1e6, unlocked).
    assert not locked[5, 5] and u[5, 5] == np.float32(C.LOG_SPACE_FREE)


def test_add_goals_then_update_then_path(node):
    ok = node.srv_add_goals(
        msg.ModifyGoalsRequest(goals=[msg.PoseStamped(20.0, 20.0)])
    ).success
    assert ok
    # Goal cell set (world == map coords at resolution 1, origin 0).
    assert node.planner.get_cell(20, 20) == 0.0
    for _ in range(20):
        node.update()
    resp = node.srv_compute_path(
        msg.ComputePathRequest(start=msg.PoseStamped(5.0, 5.0), step_size=0.2, precision=0.4)
    )
    poses = resp.path.poses
    assert len(poses) > 2
    # First pose is the request's start verbatim.
    assert poses[0].x == 5.0 and poses[0].y == 5.0
    # Path ends near the goal.
    end = poses[-1]
    assert abs(end.x - 20) < 2 and abs(end.y - 20) < 2


def test_goals_refused_inside_obstacles(node):
    # (0, 0) is the boundary obstacle ring.
    ok = node.srv_add_goals(
        msg.ModifyGoalsRequest(goals=[msg.PoseStamped(0.0, 0.0)])
    ).success
    assert not ok


def test_remove_goals_turns_free(node):
    node.srv_add_goals(msg.ModifyGoalsRequest(goals=[msg.PoseStamped(20.0, 20.0)]))
    node.srv_remove_goals(msg.ModifyGoalsRequest(goals=[msg.PoseStamped(20.0, 20.0)]))
    st = node.planner.state
    assert not bool(np.asarray(st.locked)[20, 20])
    assert float(np.asarray(st.u)[20, 20]) == float(C.LOG_SPACE_FREE)


def test_set_status_pauses_updates(node):
    node.srv_set_status(msg.SetStatusRequest(paused=True))
    it0 = int(node.planner.state.iteration)
    node.update()
    assert int(node.planner.state.iteration) == it0
    node.srv_set_status(msg.SetStatusRequest(paused=False))
    node.update()
    assert int(node.planner.state.iteration) == it0 + 50


def test_set_cells_raw_coordinates(node):
    req = msg.SetCellsRequest(v=[7, 9, 8, 9], types=[C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL])
    assert node.srv_set_cells(req).success
    st = node.planner.state
    u = np.asarray(st.u)
    assert u[9, 7] == np.float32(C.LOG_SPACE_OBSTACLE)
    assert u[9, 8] == 0.0


def test_reset_free_cells_clears_potential_keeps_goals(node):
    node.srv_add_goals(msg.ModifyGoalsRequest(goals=[msg.PoseStamped(20.0, 20.0)]))
    for _ in range(10):
        node.update()
    u_before = np.asarray(node.planner.state.u)
    assert u_before[19, 20] > -1e6  # relaxed
    node.srv_reset_free_cells(msg.ResetFreeCellsRequest())
    u_after = np.asarray(node.planner.state.u)
    assert u_after[19, 20] == np.float32(C.LOG_SPACE_FREE)
    assert u_after[20, 20] == 0.0  # goal kept


def test_warm_restart_faster_than_cold():
    # After an obstacle edit, relaxation resumes from the perturbed state —
    # far fewer sweeps to re-converge than from scratch (SURVEY §3.2).
    from epic_tpu.solver import core

    img = maps.open_room(64, 64, goal=(50, 30))
    p = Planner(PlannerConfig(epsilon=1e-2))
    p.init(64, 64)
    p.update_occupancy(_occupancy_from_img(img))
    p.add_goals([(50.0, 30.0)])
    p.solve()
    cold_iters = int(p.state.iteration)
    # Drop a small obstacle block and re-solve warm.
    cells = [(x, y) for x in range(10, 14) for y in range(10, 14)]
    p.set_cells(cells, [C.CELL_TYPE_OBSTACLE] * len(cells))
    p.solve()
    warm_iters = int(p.state.iteration)
    assert warm_iters < cold_iters


def test_solve_cap_then_host_loop_converges():
    """solve(max_iterations=...) is the single-dispatch cap escape
    hatch: a cap below the propagation guard cannot converge; looping
    capped segments from the host reaches a protocol-sound verdict."""
    img = maps.open_room(64, 64, goal=(50, 30))
    p = Planner(PlannerConfig(epsilon=1e-2))
    p.init(64, 64)
    p.update_occupancy(_occupancy_from_img(img))
    p.add_goals([(50.0, 30.0)])
    p.solve(max_iterations=5)  # < max(H, W): guard forbids convergence
    assert not bool(p.state.converged)
    for _ in range(50):
        p.solve(max_iterations=200)
        if bool(p.state.converged):
            break
    assert bool(p.state.converged)
    assert int(p.state.iteration) % C.DEFAULT_STAGGER == 1
    assert int(p.state.iteration) >= 64


def test_occupancy_refresh_keeps_goals_unless_resized(node):
    node.srv_add_goals(msg.ModifyGoalsRequest(goals=[msg.PoseStamped(20.0, 20.0)]))
    img = maps.open_room(40, 40)
    node.sub_occupancy_grid(msg.OccupancyGrid(40, 40, 1.0, 0.0, 0.0, _occupancy_from_img(img)))
    assert node.planner.get_cell(20, 20) == 0.0  # goal survived refresh
    # Resize loses everything (full reinit).
    img2 = maps.open_room(48, 48)
    node.sub_occupancy_grid(msg.OccupancyGrid(48, 48, 1.0, 0.0, 0.0, _occupancy_from_img(img2)))
    assert node.planner.state.u.shape == (48, 48)
    assert node.planner.get_cell(20, 20) == np.float32(C.LOG_SPACE_FREE)


def test_no_change_cells_untouched(node):
    node.srv_set_cells(msg.SetCellsRequest(v=[5, 5], types=[C.CELL_TYPE_OBSTACLE]))
    data = np.full((40, 40), C.OCCUPANCY_NO_CHANGE, dtype=np.int8)
    node.sub_occupancy_grid(msg.OccupancyGrid(40, 40, 1.0, 0.0, 0.0, data))
    st = node.planner.state
    assert bool(np.asarray(st.locked)[5, 5])  # obstacle untouched


def test_world_to_map_outside_raises(node):
    with pytest.raises(InvalidLocationError):
        node.planner.world_to_map(-1.0, 5.0)
    with pytest.raises(InvalidLocationError):
        node.planner.world_to_map(5.0, 40.0)


def test_rviz_goal_replacement():
    n = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2))
    img = maps.open_room(32, 32)
    n.sub_occupancy_grid(msg.OccupancyGrid(32, 32, 1.0, 0.0, 0.0, _occupancy_from_img(img)))
    assert n.set_goal(msg.PoseStamped(10.0, 10.0))
    assert n.set_goal(msg.PoseStamped(20.0, 20.0))
    # Old goal removed, new goal set.
    assert n.planner.get_cell(10, 10) == np.float32(C.LOG_SPACE_FREE)
    assert n.planner.get_cell(20, 20) == 0.0


def test_nav_core_make_plan_end_to_end():
    img = maps.open_room(48, 48)
    costmap = np.zeros(img.shape, dtype=np.uint8)
    costmap[img == 0] = 254
    plugin = EpicNavCorePlugin(interpolation="bilinear")
    plugin.initialize(costmap, resolution=0.5, origin=(-2.0, -3.0))
    plan = plugin.make_plan(
        start_world=(0.0, 0.0), goal_world=(plugin.origin_x + 20 * 0.5, plugin.origin_y + 30 * 0.5)
    )
    assert plan is not None
    assert len(plan) > 3
    # Plan starts at start, ends at the goal pose appended last.
    assert plan[0].x == 0.0 and plan[0].y == 0.0
    assert plan[-1].x == pytest.approx(plugin.origin_x + 20 * 0.5)
    # Replanning with a new goal clears the old one (single-goal semantics).
    plan2 = plugin.make_plan((0.0, 0.0), (plugin.origin_x + 10 * 0.5, plugin.origin_y + 8 * 0.5))
    assert plan2 is not None
    u = np.asarray(plugin.state.u)
    assert (u == 0.0).sum() == 1  # exactly one goal cell


def test_host_mirror_cache_one_fetch_per_epoch():
    """Cell reads share one D2H per state epoch (GetCell must cost a cached
    array index, not a full-grid transfer — the reference reads 4 bytes,
    epic_navigation_node_harmonic.cpp:522-542)."""
    from epic_tpu import grid as G
    import epic_tpu.constants
    import epic_tpu

    st = G.empty_state(16, 16)
    m1 = G.host_u(st)
    m2 = G.host_u(st)
    assert m1 is m2  # same epoch -> same mirror object
    assert G.host_locked(st) is G.host_locked(st)

    st2 = G.set_cells(st, [(3, 4)], [epic_tpu.constants.CELL_TYPE_OBSTACLE])
    m3 = G.host_u(st2)
    assert m3 is not m1  # edits create a new epoch
    assert m3[4, 3] == -1e6 and m1[4, 3] == 0.0
    assert G.is_cell_obstacle(st2, 3, 4) and not G.is_cell_obstacle(st, 3, 4)


def test_planner_from_epic_config():
    """The typed EpicConfig tree constructs a Planner directly (SURVEY §5
    config/flag system)."""
    from epic_tpu.config import EpicConfig, ServiceConfig, SolverConfig
    from epic_tpu.planner import Planner

    cfg = EpicConfig(
        solver=SolverConfig(epsilon=5e-3, backend="xla", kernel="masked"),
        service=ServiceConfig(steps_per_update=77),
    )
    pl = Planner(cfg)
    assert pl.config.epsilon == 5e-3
    assert pl.config.steps_per_update == 77
    assert pl.solver_config.kernel == "masked"
    pl.init(32, 32)
    pl.add_goals([(16.0, 16.0)])
    pl.update()
    assert int(pl.state.iteration) == 77


def test_planner_cuda_ticks_and_edits_match_xla(cuda_model):
    """On a GPU the planner ticks through the CUDA kernel (here its exact
    CPU model); ticks and edits between them match the XLA path."""
    from epic_tpu.solver import cuda_sweep

    pl = Planner(PlannerConfig(epsilon=1e-2, backend="auto"))
    ref = Planner(PlannerConfig(epsilon=1e-2, backend="xla"))
    for p in (pl, ref):
        p.init(40, 40)
        p.add_goals([(20.0, 20.0)])
    assert pl._kernel_module() is cuda_sweep
    for n in (10, 10, 1):
        pl.update(n)
        ref.update(n)
    np.testing.assert_array_equal(np.asarray(pl.state.u), np.asarray(ref.state.u))
    assert bool(pl.state.converged) == bool(ref.state.converged)
    pl.set_cells([(5, 5)], [C.CELL_TYPE_OBSTACLE])
    ref.set_cells([(5, 5)], [C.CELL_TYPE_OBSTACLE])
    pl.update(11)
    ref.update(11)
    np.testing.assert_array_equal(np.asarray(pl.state.u), np.asarray(ref.state.u))
    assert int(pl.state.iteration) == int(ref.state.iteration) == 32


def test_compute_paths_batch_matches_scalar_walks():
    """The batched multi-start extension tracks the scalar verb per lane
    (bilinear mode, tolerance-level: device walker is f32)."""
    pl = Planner(PlannerConfig(epsilon=1e-2, interpolation="bilinear"))
    pl.init(48, 48)
    pl.add_goals([(24.0, 24.0)])
    pl.update(301)
    starts = [(5.0, 5.0), (40.0, 10.0), (-3.0, 2.0), (10.0, 40.0)]
    batch = pl.compute_paths_batch(starts, step_size=0.2, cd_precision=0.4)
    assert batch[2] is None  # invalid start
    n_ok = 0
    for i in (0, 1, 3):
        assert batch[i] is not None
        solo = pl.compute_path(starts[i], step_size=0.2, cd_precision=0.4)
        end_b = batch[i][-1]
        end_s = solo[-1]
        assert abs(end_b.x - end_s.x) < 1.5 and abs(end_b.y - end_s.y) < 1.5
        n_ok += 1
    assert n_ok == 3


@pytest.mark.parametrize("key", ["tile_band", "tile_depth"])
def test_removed_tile_options_rejected(key):
    """The tiling options of the removed kernels are gone."""
    from epic_tpu.config import EpicConfig, SolverConfig

    with pytest.raises(TypeError):
        SolverConfig(**{key: 8})
    with pytest.raises(ValueError, match="unknown solver config keys"):
        EpicConfig.from_dict({"solver": {key: 8}})


def test_planner_cascade_solve():
    """PlannerConfig(cascade=True): blocking solve through the resolution
    pyramid — converged field, working paths, same verb surface."""
    from epic_tpu.planner import Planner, PlannerConfig

    img = maps.open_room(96, 96)
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    pl = Planner(PlannerConfig(epsilon=1e-3, backend="xla", cascade=True))
    pl.update_occupancy(occ)
    assert pl.add_goals([pl.map_to_world(48, 48)])
    pl.solve()
    assert bool(pl.state.converged)
    poses = pl.compute_path(pl.map_to_world(10, 10), step_size=0.2,
                            cd_precision=0.4)
    assert len(poses) > 2


def test_planner_cuda_solve_matches_xla(cuda_model):
    """The blocking solve on the CUDA path keeps the protocol: same
    iteration count, verdict and field as the XLA solve."""
    pl = Planner(PlannerConfig(epsilon=1e-2, backend="cuda"))
    ref = Planner(PlannerConfig(epsilon=1e-2, backend="xla"))
    for p in (pl, ref):
        p.init(40, 48)
        p.add_goals([(20.0, 24.0)])
        p.update(23)
        p.solve()
    assert int(pl.state.iteration) == int(ref.state.iteration)
    assert bool(pl.state.converged) and bool(ref.state.converged)
    np.testing.assert_array_equal(np.asarray(pl.state.u), np.asarray(ref.state.u))


@pytest.mark.parametrize("backend", ["pallas", "resident", "metal"])
def test_removed_backends_rejected(backend):
    pl = Planner(PlannerConfig(epsilon=1e-2, backend=backend))
    pl.init(16, 16)
    with pytest.raises(ValueError, match="unknown solver backend"):
        pl.update(3)
