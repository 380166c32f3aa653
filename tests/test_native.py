"""Native C++ helper library: bit/behaviour agreement with the NumPy oracles."""

import numpy as np
import pytest

import epic_tpu
from epic_tpu import maps, native, path
from epic_tpu.errors import InvalidLocationError, InvalidPathError
from epic_tpu.solver import core, legacy, reference_np

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@pytest.fixture(scope="module")
def solved_maze():
    img = maps.recursive_maze(64, 64, seed=3)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
    out = core.solve(st)
    return img, np.asarray(out.u), np.asarray(out.locked)


def test_native_sweep_bitmatches_scalar_oracle():
    img = maps.random_obstacles(24, 20, density=0.2, seed=3)
    st = epic_tpu.from_occupancy_image(img)
    u = np.asarray(st.u)
    locked = np.asarray(st.locked)
    for it in range(4):
        u_n, d_n = native.sweep_2d(u, locked, it)
        u_p, d_p = reference_np.sweep_scalar(u, locked, it)
        np.testing.assert_array_equal(u_n, u_p)
        assert d_n == pytest.approx(d_p, abs=0)
        u = u_p


def test_native_sweep_openmp_thread_invariant():
    """The OpenMP row-parallel sweep must be bit-exact regardless of thread
    count: red-black parity makes in-sweep updates independent (disjoint
    writes) and the delta reduction is an order-free max."""
    import ctypes

    try:
        gomp = ctypes.CDLL("libgomp.so.1", mode=ctypes.RTLD_GLOBAL)
    except OSError:
        pytest.skip("libgomp not present (library built without OpenMP)")
    img = maps.recursive_maze(96, 128, seed=5)
    st = epic_tpu.from_occupancy_image(img)
    u0 = np.asarray(st.u)
    locked = np.asarray(st.locked)
    default_threads = gomp.omp_get_max_threads()
    try:
        results = []
        for nthreads in (1, 4):
            gomp.omp_set_num_threads(ctypes.c_int(nthreads))
            u = u0.copy()
            deltas = []
            for it in range(6):
                u, d = native.sweep_2d(u, locked, it)
                deltas.append(d)
            results.append((u, deltas))
    finally:
        gomp.omp_set_num_threads(ctypes.c_int(default_threads))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


@pytest.mark.parametrize("mode", ["reference", "bilinear"])
def test_native_path_matches_numpy(solved_maze, mode):
    img, u, locked = solved_maze
    ys, xs = np.nonzero(img == 128)
    rng = np.random.default_rng(0)
    for i in rng.choice(len(ys), 15):
        x, y = float(xs[i]), float(ys[i])
        try:
            p1 = path.compute_path(u, locked, x, y, 0.2, 0.4, mode=mode, impl="numpy")
            e1 = None
        except Exception as ex:
            p1, e1 = None, type(ex).__name__
        try:
            p2 = native.compute_path(u, locked, x, y, 0.2, 0.4, mode=mode)
            e2 = None
        except Exception as ex:
            p2, e2 = None, type(ex).__name__
        assert e1 == e2, f"error mismatch at ({x},{y}): {e1} vs {e2}"
        if e1 is None:
            assert len(p1) == len(p2)
            np.testing.assert_allclose(p1, p2, atol=1e-4)


def test_native_path_error_codes(solved_maze):
    img, u, locked = solved_maze
    with pytest.raises(InvalidLocationError):
        native.compute_path(u, locked, -4.0, 2.0)
    oy, ox = np.argwhere(img == 0)[0]
    with pytest.raises(InvalidLocationError):
        native.compute_path(u, locked, float(ox), float(oy))
    # Unrelaxed field -> invalid path / gradient.
    st = epic_tpu.from_occupancy_image(img)
    with pytest.raises((InvalidPathError, path.InvalidGradientError)):
        native.compute_path(np.asarray(st.u), locked, 2.0, 2.0)


def test_native_sor_matches_numpy_sor():
    img = maps.open_room(20, 20)
    u, locked = legacy.from_image(img)
    u_n, it_n = native.legacy_sor_2d(u, locked, epsilon=1e-4, omega=1.5,
                                     min_iterations=100)
    u_p, it_p = legacy.sor_numpy(u.copy(), locked, epsilon=1e-4, omega=1.5,
                                 min_iterations=100)
    assert it_n == it_p
    np.testing.assert_allclose(u_n, u_p, rtol=0, atol=1e-12)


def test_native_sor_f32_vs_f64_precision_collapse():
    # The paper's motivating failure: down maze corridors the linear-space
    # potential attenuates exponentially, so f32 SOR underflows to flat
    # gradients far sooner than f64. Open rooms decay polynomially and do
    # NOT show this — maze topology is required. Measured with the
    # reference's percent-valid metric (gradient-alive + goal-reachable).
    from epic_tpu import analysis

    img = maps.recursive_maze(140, 140, seed=1, corridor=8)
    u64, locked = legacy.from_image(img, dtype=np.float64)
    u32, _ = legacy.from_image(img, dtype=np.float32)
    out64, _ = native.legacy_sor_2d(u64, locked, epsilon=1e-4, omega=1.5,
                                    min_iterations=20000, dtype=np.float64)
    out32, _ = native.legacy_sor_2d(u32, locked, epsilon=1e-4, omega=1.5,
                                    min_iterations=20000, dtype=np.float32)
    goal = img == 255
    pv64 = analysis.percent_valid(out64, locked, goal)
    pv32 = analysis.percent_valid(out32, locked, goal)
    assert pv64 > 0.85, pv64
    assert pv64 > pv32 + 0.15, (pv64, pv32)


def test_native_path_truncation_retry(solved_maze):
    """A walk longer than the output buffer must not silently truncate: the
    library reports the true count (code 100) and the wrapper retries with an
    exact-size buffer, so the result is independent of buffer capacity."""
    img, u, locked = solved_maze
    free_ys, free_xs = np.nonzero(~locked)
    full = None
    for i in range(0, len(free_ys), 17):
        x, y = float(free_xs[i]), float(free_ys[i])
        try:
            cand = native.compute_path(u, locked, x, y, 0.2, 0.4, 100000)
        except Exception:
            continue
        if len(cand) > 20:
            full = cand
            break
    assert full is not None, "no start produced a >20-point walk" 
    tiny = native.compute_path(u, locked, x, y, 0.2, 0.4, 100000, _cap=4)
    np.testing.assert_array_equal(tiny, full)
    # max_length remains the walk budget regardless of capacity.
    budget = native.compute_path(u, locked, x, y, 0.2, 0.4, len(full) - 2, _cap=4)
    assert len(budget) == len(full) - 2
    np.testing.assert_array_equal(budget, full[: len(full) - 2])


def test_native_sor_f80_long_double():
    """The reference exposes float/double/long-double SOR through Python
    (epic_harmonic.py:111-113); the f80 native binding must agree with the
    NumPy long-double oracle and beat f64 on residual precision."""
    img = maps.open_room(20, 20)
    u, locked = legacy.from_image(img, dtype=np.longdouble)
    assert u.dtype == np.longdouble
    u_n, it_n = native.legacy_sor_2d(u, locked, epsilon=1e-4, omega=1.5,
                                     min_iterations=100, dtype=np.longdouble)
    assert u_n.dtype == np.longdouble
    u_p, it_p = legacy.sor_numpy(u.copy(), locked, epsilon=1e-4, omega=1.5,
                                 min_iterations=100)
    assert it_n == it_p
    np.testing.assert_allclose(np.float64(u_n), np.float64(u_p), rtol=0, atol=1e-15)
    # Ladder sanity: f80 result is at least as close to f64's as f32's is.
    u64, _ = native.legacy_sor_2d(u, locked, epsilon=1e-4, omega=1.5,
                                  min_iterations=100, dtype=np.float64)
    assert np.max(np.abs(np.float64(u_n) - u64)) <= 1e-10


def test_native_solve_matches_core_protocol():
    """epic_solve2d_f32 runs the full harmonic_complete_cpu protocol
    (harmonic_cpu.cpp:136-184): iteration counts must equal the JAX solver's
    exactly (≡ 1 mod stagger), fields to float32 tolerance, and the converged
    verdict must be the non-sticky post-check one."""
    for seed, shape in ((0, (48, 64)), (7, (65, 41))):
        img = maps.random_obstacles(*shape, density=0.12, seed=seed)
        st = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
        u0 = np.asarray(st.u)  # before solve: core.solve donates st.u
        locked0 = np.asarray(st.locked)
        out = core.solve(st)
        u_nat, iters, delta, converged = native.solve_2d(u0, locked0,
                                                         epsilon=1e-3)
        assert iters == int(out.iteration)
        assert iters % 100 == 1
        assert converged == bool(out.converged)
        assert delta < 1e-3
        np.testing.assert_allclose(u_nat, np.asarray(out.u), rtol=0, atol=2e-5)


def test_native_solve_max_iterations_cap():
    img = maps.recursive_maze(64, 64, seed=1)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-12)
    u_nat, iters, _, converged = native.solve_2d(
        np.asarray(st.u), np.asarray(st.locked), epsilon=1e-12,
        max_iterations=500,
    )
    assert not converged
    assert iters == 500


def test_iteration_drift_bounded_across_backends():
    """Pin the cross-backend iteration-count drift (VERDICT r4 item 6):
    converged iteration counts of the native C++ solver and the JAX solver
    must agree within ONE stagger cycle on battery-geometry domains
    (half-scale c_space / third-scale umass from the reference battery,
    libepic/tests/batch/batch.py:41-49), and both must satisfy the
    protocol invariant (≡ 1 mod stagger). The measured drift today is 0
    here;
    a protocol regression (wrong check cadence, sticky converged flag,
    off-by-one stagger) moves counts by many cycles and fails this."""
    for h, w in ((137, 174), (233, 72)):
        img = maps.recursive_maze(h, w, seed=0, corridor=max(6, min(h, w) // 40))
        st = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
        u0, l0 = np.asarray(st.u), np.asarray(st.locked)
        out = core.solve(st)
        _, it_nat, _, conv = native.solve_2d(u0, l0, epsilon=1e-3)
        assert conv and bool(out.converged)
        it_jax = int(out.iteration)
        assert it_nat % 100 == 1 and it_jax % 100 == 1
        assert abs(it_nat - it_jax) <= 100, (h, w, it_nat, it_jax)
