"""Oracle consistency: scalar-loop reference vs vectorized NumPy vs JAX core.

The scalar loop is a literal port of harmonic_update_2d_cpu
(/root/reference/libepic/src/harmonic/harmonic_cpu.cpp:38-78); agreement of
three independent implementations is the correctness anchor for everything
else in the framework.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from epic_tpu import maps
from epic_tpu.grid import make_state
from epic_tpu.solver import core, reference_np


def _ingest(img):
    goal = img == 255
    obstacle = img == 0
    u = np.where(goal, 0.0, -1e6).astype(np.float32)
    locked = goal | obstacle
    return u, locked


@pytest.fixture(scope="module")
def small_map():
    return _ingest(maps.random_obstacles(24, 20, density=0.2, seed=3))


def test_scalar_vs_vectorized_sweep(small_map):
    u, locked = small_map
    for it in range(6):
        u_s, d_s = reference_np.sweep_scalar(u, locked, it)
        u_v, d_v = reference_np.sweep(u, locked, it)
        np.testing.assert_array_equal(u_s, u_v)
        assert d_s == pytest.approx(d_v, rel=0, abs=0)
        u = u_v


def test_parity_class_derivation():
    # Iteration t updates interior cells with (y + x) % 2 != t % 2
    # (harmonic_cpu.cpp:46-51). Verify via which cells changed.
    u = np.full((8, 8), -10.0, dtype=np.float32)
    locked = np.zeros((8, 8), dtype=bool)
    u[4, 4] = 0.0
    locked[4, 4] = True
    for it in (0, 1):
        u_new, _ = reference_np.sweep_scalar(u, locked, it)
        changed = u_new != u
        ys, xs = np.nonzero(changed)
        assert len(ys) > 0
        assert np.all(((ys + xs) % 2) != (it % 2))
        u = u_new


def test_jax_sweep_matches_oracle(small_map):
    u, locked = small_map
    uj = jnp.asarray(u)
    lj = jnp.asarray(locked)
    for it in range(4):
        u_np, d_np = reference_np.sweep(np.asarray(uj), locked, it)
        uj, dj = core.sweep(uj, lj, jnp.int32(it))
        np.testing.assert_allclose(np.asarray(uj), u_np, rtol=2e-6, atol=1e-4)
        np.testing.assert_allclose(float(dj), d_np, rtol=1e-6, atol=0)


def test_solve_matches_oracle_iterations_and_field():
    img = maps.random_obstacles(20, 18, density=0.15, seed=1)
    u, locked = _ingest(img)
    eps, stagger = 1e-2, 10
    u_ref, iters_ref, delta_ref = reference_np.solve(
        u, locked, epsilon=eps, stagger=stagger
    )
    state = make_state(u, locked, epsilon=eps)
    out = core.solve(state, stagger=stagger)
    assert int(out.iteration) == iters_ref
    assert iters_ref % stagger == 1  # exit always right after a check
    assert bool(out.converged)
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(float(out.delta), delta_ref, rtol=1e-4, atol=1e-5)


def test_solve_py_matches_solve():
    img = maps.open_room(16, 16)
    u, locked = _ingest(img)
    state1 = make_state(u, locked, epsilon=1e-2)
    state2 = make_state(u, locked, epsilon=1e-2)
    out1 = core.solve(state1, stagger=10)
    out2 = core.solve_py(state2, stagger=10)
    assert int(out1.iteration) == int(out2.iteration)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=0, atol=0
    )


def test_update_n_anytime_semantics():
    # update_n(k) == k sweeps; delta comes from the first sweep only
    # (epic_navigation_node_harmonic.cpp:165-204).
    img = maps.open_room(12, 12)
    u, locked = _ingest(img)
    state = make_state(u, locked, epsilon=1e-3)
    out = core.update_n(state, 5)
    u_ref = u
    for it in range(5):
        u_ref, d = reference_np.sweep(u_ref, locked, it)
        if it == 0:
            d_first = d
    assert int(out.iteration) == 5
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(float(out.delta), d_first, rtol=1e-6, atol=0)


def test_3d_sweep_parity_and_logsumexp():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(8, 9, 10)).astype(np.float32) * 5 - 10
    locked = rng.random((8, 9, 10)) < 0.2
    uj = jnp.asarray(u)
    for it in range(3):
        u_np, d_np = reference_np.sweep_3d(np.asarray(uj), locked, it)
        uj, dj = core.sweep(uj, jnp.asarray(locked), jnp.int32(it))
        np.testing.assert_allclose(np.asarray(uj), u_np, rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(dj), d_np, rtol=1e-5, atol=1e-6)


def test_goal_cells_stay_zero_and_obstacles_stay():
    img = maps.random_obstacles(20, 20, density=0.2, seed=5)
    u, locked = _ingest(img)
    state = make_state(u, locked, epsilon=1e-2)
    out = core.solve(state, stagger=10)
    u_out = np.asarray(out.u)
    assert np.all(u_out[img == 255] == 0.0)
    assert np.all(u_out[img == 0] == np.float32(-1e6))
    # Free cells rose from -1e6 toward the goal potential but stay < 0.
    free = img == 128
    assert np.all(u_out[free] < 0.0)
    assert np.any(u_out[free] > -1e6)


def test_3d_solve_converges():
    # 3D CPU-only variant in the reference (harmonic_cpu.cpp:81-133); ours
    # runs the same generic kernel on any backend.
    u = np.full((12, 12, 12), -1e6, dtype=np.float32)
    locked = np.zeros((12, 12, 12), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    u[6, 6, 6] = 0.0
    locked[6, 6, 6] = True
    state = make_state(u, locked, epsilon=1e-2)
    out = core.solve(state, stagger=10)
    assert bool(out.converged)
    assert int(out.iteration) % 10 == 1
    u_out = np.asarray(out.u)
    assert u_out[6, 6, 6] == 0.0
    free = ~locked
    assert np.all(u_out[free] < 0.0) and np.any(u_out[free] > -1e6)
    # Potential decays with distance from the goal.
    assert u_out[6, 6, 5] > u_out[6, 6, 2]


def test_stagger_one_checks_every_iteration():
    # stagger=1: every sweep is a check; exit at the first iteration that
    # satisfies both conditions (always ≡ 1 mod 1, trivially).
    img = maps.open_room(16, 16)
    u, locked = _ingest(img)
    u_ref, iters_ref, _ = reference_np.solve(u, locked, epsilon=1e-2, stagger=1)
    out = core.solve(make_state(u, locked, epsilon=1e-2), stagger=1)
    assert int(out.iteration) == iters_ref
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)


def test_huge_epsilon_still_respects_propagation_guard():
    # delta < eps at the very first check, but the loop cannot exit before
    # iteration >= max(H, W): counts land on the first check past the guard.
    img = maps.open_room(16, 24)
    u, locked = _ingest(img)
    out = core.solve(make_state(u, locked, epsilon=1e9), stagger=10)
    assert int(out.iteration) == 31  # first c*10+1 >= 24
    assert bool(out.converged)


def test_cuda_sweep_solve_matches_protocol():
    """The CUDA kernel's blocked schedule (its CPU model) runs the oracle's
    protocol: same iteration count, same field."""
    from epic_tpu.solver import cuda_sweep

    img = maps.random_obstacles(24, 20, density=0.15, seed=9)
    u, locked = _ingest(img)
    u_ref, iters_ref, _ = reference_np.solve(u, locked, epsilon=1e-2, stagger=10)
    out = cuda_sweep.solve(make_state(u, locked, epsilon=1e-2), stagger=10,
                           geometry=cuda_sweep.Geometry(8, 8, 4, 64),
                           interpret=True)
    assert int(out.iteration) == iters_ref
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)
