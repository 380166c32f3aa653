"""The CUDA sweep kernel's schedule, wrapper and geometry.

The kernel itself (solver/cuda/sweep2d.cu) runs only on a GPU. Its
arithmetic and blocked schedule are modelled exactly by
``cuda_sweep.model_launch`` (``interpret=True``), which these CPU tests
hold to ``solver.core`` bit for bit: odd shapes, odd start iterations,
launch plans where K does not divide n, frozen and goal cells, edits
between ticks, and the full solve protocol. Tests marked ``gpu`` compare
the compiled kernel with XLA on the card and skip elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import epic_tpu
from epic_tpu import constants as C
from epic_tpu import maps
from epic_tpu.solver import core, cuda_sweep, reference_np
from epic_tpu.solver.cuda_sweep import Geometry

SMALL = Geometry(32, 32, 8, 256)
WIDE = Geometry(64, 128, 16, 512)
# Model-only geometries: tiny tiles put many tile borders in small grids.
MID = Geometry(64, 64, 16, 512)
TINY = Geometry(4, 4, 2, 32)
THIN = Geometry(3, 8, 3, 32)


def _state(h, w, seed, it0=0, warm=0, density=0.15, goals=1, eps=1e-3):
    img = maps.random_obstacles(h, w, density=density, seed=seed)
    st = epic_tpu.from_occupancy_image(img, epsilon=eps)
    rng = np.random.default_rng(seed)
    xy = [(int(rng.integers(1, w - 1)), int(rng.integers(1, h - 1)))
          for _ in range(goals)]
    st = epic_tpu.set_cells(st, xy, [C.CELL_TYPE_GOAL] * goals)
    if warm:
        st = core.update_n(st, warm)
    return dataclasses.replace(st, iteration=jnp.int32(it0))


def _copy(st):
    """A fresh copy of every leaf (the solvers donate their input)."""
    return jax.tree.map(jnp.array, st)


# -- the launch plan ----------------------------------------------------------


@pytest.mark.parametrize("n,k,plan", [
    (1, 8, (1,)), (8, 8, (8,)), (9, 8, (5, 4)), (50, 8, (8, 7, 7, 7, 7, 7, 7)),
    (99, 16, (15, 14, 14, 14, 14, 14, 14)), (100, 16, (15, 15, 14, 14, 14, 14, 14)),
    (50, 16, (13, 13, 12, 12)), (17, 16, (9, 8)), (3, 2, (2, 1)),
])
def test_launch_plan(n, k, plan):
    got = cuda_sweep.launch_plan(n, k)
    assert got == plan
    assert sum(got) == n and max(got) <= k and len(got) == -(-n // k)


@pytest.mark.parametrize("n", [0, -3])
def test_launch_plan_rejects_empty(n):
    with pytest.raises(ValueError):
        cuda_sweep.launch_plan(n, 8)


# -- one launch against core ---------------------------------------------------


@pytest.mark.parametrize("h,w,geom,it0,ns", [
    (37, 53, SMALL, 0, 5), (37, 53, SMALL, 3, 8), (70, 45, SMALL, 1, 1),
    (33, 33, SMALL, 2, 7), (32, 32, SMALL, 0, 8), (31, 65, SMALL, 5, 3),
    (90, 130, MID, 7, 16), (65, 129, WIDE, 4, 11), (19, 23, TINY, 0, 2),
    (19, 23, TINY, 1, 1), (17, 31, THIN, 6, 3), (40, 9, THIN, 3, 2),
])
def test_model_launch_matches_core(h, w, geom, it0, ns):
    """One launch = ns plain sweeps, bit for bit, with the first sweep's
    delta; tiles overhang ragged grid edges."""
    st = _state(h, w, seed=h + w, it0=it0, warm=30)
    ref = core.update_n(_copy(st), ns)
    u, delta = cuda_sweep.model_launch(st.u, st.locked, st.iteration, 0, ns, geom)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(ref.u))
    assert float(delta) == float(ref.delta)


@pytest.mark.parametrize("off", [1, 2, 5])
def test_model_launch_offset_shifts_parity(off):
    """it_offset starts the launch at global iteration iteration + off."""
    st = _state(29, 41, seed=4, warm=20)
    ref = core.update_n(dataclasses.replace(_copy(st), iteration=jnp.int32(off)), 4)
    u, _ = cuda_sweep.model_launch(st.u, st.locked, jnp.int32(0), off, 4, SMALL)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(ref.u))


@pytest.mark.parametrize("ns", [0, 9])
def test_model_launch_rejects_sweeps_beyond_halo(ns):
    st = _state(20, 20, seed=1)
    with pytest.raises(ValueError):
        cuda_sweep.model_launch(st.u, st.locked, st.iteration, 0, ns, SMALL)


# -- the anytime stepper -------------------------------------------------------


@pytest.mark.parametrize("h,w,geom,it0,n", [
    (37, 53, SMALL, 0, 50), (37, 53, SMALL, 1, 17), (61, 47, SMALL, 3, 9),
    (48, 48, SMALL, 0, 1), (64, 96, SMALL, 2, 100), (33, 70, MID, 5, 35),
    (66, 130, WIDE, 0, 33), (23, 19, TINY, 1, 7), (27, 44, THIN, 4, 10),
    (12, 12, TINY, 0, 3),
])
def test_update_n_model_matches_core(h, w, geom, it0, n):
    """Chains of launches (K does not divide n in most cases) keep the
    global parity and report the first sweep's delta."""
    st = _state(h, w, seed=3 * h + w, it0=it0, warm=10)
    ref = core.update_n(_copy(st), n)
    out = cuda_sweep.update_n(_copy(st), n, geometry=geom, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.u), np.asarray(ref.u))
    assert float(out.delta) == float(ref.delta)
    assert int(out.iteration) == it0 + n
    assert bool(out.converged) == bool(ref.converged)


@pytest.mark.parametrize("seed", range(9))
def test_random_grids_model_matches_oracle(seed):
    """Random values, not just map-shaped grids, against the NumPy oracle
    (the fuzz contract) across geometries and start iterations."""
    rng = np.random.default_rng(200 + seed)
    h, w = int(rng.integers(8, 48)), int(rng.integers(8, 80))
    u = (rng.normal(size=(h, w)) * rng.uniform(0.1, 100)).astype(np.float32)
    locked = rng.random((h, w)) < rng.uniform(0.05, 0.5)
    for _ in range(rng.integers(0, 4)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        u[y, x], locked[y, x] = 0.0, True
    it0 = int(rng.integers(0, 7))
    steps = int(rng.integers(1, 25))
    geom = (SMALL, TINY, THIN)[seed % 3]
    u_ref = u.copy()
    for it in range(it0, it0 + steps):
        u_ref, _ = reference_np.sweep(u_ref, locked, it)
    st = dataclasses.replace(epic_tpu.make_state(u, locked),
                             iteration=jnp.int32(it0))
    out = cuda_sweep.update_n(st, steps, geometry=geom, interpret=True)
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_edits_between_ticks(seed):
    """SetCells edits between ticks (goals, obstacles, frees) then ticks:
    the model tracks core through the whole sequence."""
    rng = np.random.default_rng(100 + seed)
    h, w = 24, 37
    a = _state(h, w, seed=seed, warm=0)
    b = _copy(a)
    for _ in range(4):
        k = int(rng.integers(1, 8))
        xy = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)], axis=1)
        types = rng.integers(0, 3, k)
        a = epic_tpu.set_cells(a, xy, types)
        b = epic_tpu.set_cells(b, xy, types)
        steps = int(rng.integers(1, 20))
        a = core.update_n(a, steps)
        b = cuda_sweep.update_n(b, steps, geometry=TINY, interpret=True)
        np.testing.assert_array_equal(np.asarray(b.u), np.asarray(a.u))
        np.testing.assert_array_equal(np.asarray(b.locked), np.asarray(a.locked))


@pytest.mark.parametrize("geom", [SMALL, TINY, THIN])
def test_frozen_goal_and_ring_cells_untouched(geom):
    st = _state(30, 45, seed=9, goals=3)
    out = cuda_sweep.update_n(_copy(st), 40, geometry=geom, interpret=True)
    locked = np.asarray(st.locked)
    np.testing.assert_array_equal(np.asarray(out.u)[locked], np.asarray(st.u)[locked])
    ring = np.ones(locked.shape, bool)
    ring[1:-1, 1:-1] = False
    np.testing.assert_array_equal(np.asarray(out.u)[ring], np.asarray(st.u)[ring])


# -- the solve protocol ----------------------------------------------------------


@pytest.mark.parametrize("stagger,eps,cap,geom", [
    (100, 1e-3, 1_000_000, SMALL), (5, 1e-2, 1_000_000, TINY),
    (13, 1e-1, 1_000_000, THIN), (100, 1e-1, 1_000_000, SMALL),
    (100, 1e-3, 250, SMALL), (1, 1e-2, 1_000_000, SMALL),
])
def test_solve_model_matches_core(stagger, eps, cap, geom):
    """Same iteration count (≡ 1 mod stagger on a converged exit), delta,
    verdict and field as core.solve; a capped solve stops where core does."""
    img = maps.recursive_maze(30, 34, seed=3)
    st = epic_tpu.from_occupancy_image(img, epsilon=eps)
    ref = core.solve(_copy(st), stagger=stagger, max_iterations=cap)
    out = cuda_sweep.solve(_copy(st), stagger=stagger, max_iterations=cap,
                           geometry=geom, interpret=True)
    assert int(out.iteration) == int(ref.iteration)
    assert bool(out.converged) == bool(ref.converged)
    assert float(out.delta) == float(ref.delta)
    np.testing.assert_array_equal(np.asarray(out.u), np.asarray(ref.u))
    if bool(ref.converged):
        assert int(out.iteration) % stagger == 1 % stagger


# -- geometry and validation -------------------------------------------------------


@pytest.mark.parametrize("shape,geom", [
    ((482, 482), SMALL), ((310, 940), SMALL), ((4096, 4096), WIDE),
    ((16384, 16384), WIDE), ((8, 8), SMALL), ((2048, 2047), SMALL),
    ((2048, 2048), WIDE),
])
def test_choose_geometry(shape, geom):
    """The tile geometry measured fastest at each benchmark grid."""
    assert cuda_sweep.choose_geometry(shape) == geom
    assert geom in cuda_sweep.GEOMETRIES


def test_compiled_geometries_match_the_source():
    """GEOMETRIES lists exactly the kernel's compiled instantiations."""
    src = (cuda_sweep._SRC).read_text()
    for g in cuda_sweep.GEOMETRIES:
        assert f"launch<{g.th}, {g.tw}, {g.k}, {g.nt}>" in src
    assert src.count("launch<") == len(cuda_sweep.GEOMETRIES)


@pytest.mark.parametrize("call", ["update", "solve"])
def test_unknown_geometry_and_3d_rejected(call):
    st = _state(20, 20, seed=2)
    fn = (lambda s, **kw: cuda_sweep.update_n(s, 3, **kw)) if call == "update" \
        else (lambda s, **kw: cuda_sweep.solve(s, **kw))
    with pytest.raises(ValueError, match="no compiled kernel"):
        fn(st, geometry=Geometry(8, 8, 4, 64))
    vol = epic_tpu.empty_volume(4, 6, 8)
    with pytest.raises(ValueError):
        fn(vol, interpret=True)


def test_update_n_rejects_zero_steps():
    with pytest.raises(ValueError):
        cuda_sweep.update_n(_state(10, 10, seed=0), 0, interpret=True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler is an error."""
    monkeypatch.setattr(cuda_sweep, "_LIB", tmp_path / "lib.so")
    monkeypatch.setattr(cuda_sweep.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_sweep.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sweep.build()


# -- on the card ---------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n", [((482, 482), 50), ((310, 940), 100),
                                     ((4096, 4096), 100)])
def test_kernel_matches_xla_on_gpu(gpu_device, shape, n):
    h, w = shape
    st = _state(h, w, seed=1, density=0.1)
    ref = core.update_n(_copy(st), n)
    out = cuda_sweep.update_n(_copy(st), n)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), rtol=0,
                               atol=1e-3)
    assert abs(float(out.delta) - float(ref.delta)) <= 1e-3
