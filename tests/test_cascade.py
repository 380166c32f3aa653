"""Coarse-to-fine cascade warm start (solver.cascade).

The cascade is an opt-in accelerator: the FINAL level must run the exact
reference protocol, so `converged`, the epsilon certificate, and validity
match a cold solve; only the iteration count shrinks.
"""

import numpy as np
import pytest

import epic_tpu
from epic_tpu import analysis, maps, native
from epic_tpu.solver import cascade, core


def _solve_pair(img, epsilon=1e-3, **kw):
    cold = core.solve(epic_tpu.from_occupancy_image(img, epsilon=epsilon))
    warm, stats = cascade.solve_cascade(
        epic_tpu.from_occupancy_image(img, epsilon=epsilon), **kw)
    return cold, warm, stats


def test_cascade_open_room_converges_with_far_fewer_sweeps():
    img = maps.open_room(256, 256)
    cold, warm, stats = _solve_pair(img)
    assert bool(warm.converged)
    assert int(warm.iteration) % 100 == 1  # protocol intact on the fine level
    # Diameter-dominated domain: the pyramid collapses the cost.
    assert stats.total_fine_equivalent < int(cold.iteration) / 5
    goal = img == 255
    pv_cold = analysis.percent_valid(np.asarray(cold.u), np.asarray(cold.locked), goal)
    pv_warm = analysis.percent_valid(np.asarray(warm.u), np.asarray(warm.locked), goal)
    assert pv_warm >= pv_cold - 1e-9


def test_cascade_certificate_matches_protocol():
    """The warm field's convergence certificate is real: one more protocol
    check-sweep from the cascade result stays below epsilon."""
    img = maps.random_obstacles(96, 128, density=0.1, seed=2)
    _, warm, _ = _solve_pair(img)
    assert bool(warm.converged)
    out = core.update_n(
        epic_tpu.make_state(np.asarray(warm.u), np.asarray(warm.locked), 1e-3),
        1,
    )
    assert float(out.delta) < 1e-3


def test_cascade_maze_stays_valid():
    """Thin-wall mazes coarsen conservatively (obstacle-wins): corridors can
    close at coarse levels but never leak through walls, so validity never regresses."""
    img = maps.recursive_maze(128, 128, seed=7)
    cold, warm, stats = _solve_pair(img)
    assert bool(warm.converged)
    goal = img == 255
    pv_cold = analysis.percent_valid(np.asarray(cold.u), np.asarray(cold.locked), goal)
    pv_warm = analysis.percent_valid(np.asarray(warm.u), np.asarray(warm.locked), goal)
    assert pv_warm >= pv_cold - 1e-9


def test_cascade_explicit_levels_and_shapes():
    img = maps.open_room(200, 120)
    _, warm, stats = _solve_pair(img, levels=2)
    assert stats.shapes[-1] == (200, 120)
    assert len(stats.shapes) == 3
    assert stats.shapes[0] == (50, 30)
    assert bool(warm.converged)


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_cascade_native_coarse_solver():
    img = maps.open_room(160, 160)
    warm, stats = cascade.solve_cascade(
        epic_tpu.from_occupancy_image(img, epsilon=1e-3),
        coarse_solver=cascade.native_solver,
    )
    assert bool(warm.converged)
    goal = img == 255
    pv = analysis.percent_valid(np.asarray(warm.u), np.asarray(warm.locked), goal)
    assert pv == 1.0


def test_cascade_3d_volume():
    img = np.full((24, 48, 48), 128, np.uint8)
    img[12, 24, 24] = 255
    st = epic_tpu.from_occupancy_volume(img, epsilon=1e-2)
    warm, stats = cascade.solve_cascade(st, levels=1, min_extent=12)
    assert bool(warm.converged)
    assert stats.shapes == ((12, 24, 24), (24, 48, 48))


def test_cascade_with_sharded_fine_solver():
    """Composition: coarse levels on the host/XLA, fine level on the
    multi-chip sharded solver — the pyramid and the mesh decomposition are
    orthogonal."""
    import jax

    from epic_tpu.parallel import make_mesh, sharded

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device platform")
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    img = maps.open_room(96, 128)

    def fine(st, stagger, max_iterations):
        return sharded.solve(st, mesh, stagger=stagger,
                             max_iterations=max_iterations)

    warm, stats = cascade.solve_cascade(
        epic_tpu.from_occupancy_image(img, epsilon=1e-3), solver=fine,
        coarse_solver=lambda st, stagger, max_iterations: core.solve(
            st, stagger, max_iterations))
    assert bool(warm.converged)
    cold = core.solve(epic_tpu.from_occupancy_image(img, epsilon=1e-3))
    goal = img == 255
    pv_w = analysis.percent_valid(np.asarray(warm.u), np.asarray(warm.locked), goal)
    pv_c = analysis.percent_valid(np.asarray(cold.u), np.asarray(cold.locked), goal)
    assert pv_w >= pv_c - 1e-9
    assert int(warm.iteration) < int(cold.iteration)
