"""Property/fuzz tests: random grids and edit sequences, JAX core vs the
NumPy oracle — the exactness contract under adversarial inputs."""

import numpy as np
import pytest

import epic_tpu
from epic_tpu import constants as C
from epic_tpu.solver import core, reference_np


def _random_grid(rng, h, w):
    """Random u/locked with arbitrary values (not just map-shaped)."""
    u = (rng.normal(size=(h, w)) * rng.uniform(0.1, 100)).astype(np.float32)
    locked = rng.random((h, w)) < rng.uniform(0.05, 0.5)
    # A few goal-like cells.
    for _ in range(rng.integers(0, 4)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        u[y, x] = 0.0
        locked[y, x] = True
    return u, locked


@pytest.mark.parametrize("seed", range(8))
def test_random_grids_core_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 40)), int(rng.integers(5, 60))
    u, locked = _random_grid(rng, h, w)
    start_iter = int(rng.integers(0, 7))
    steps = int(rng.integers(1, 12))

    u_ref = u.copy()
    for it in range(start_iter, start_iter + steps):
        u_ref, d_ref = reference_np.sweep(u_ref, locked, it)

    import dataclasses
    import jax.numpy as jnp

    st = epic_tpu.make_state(u, locked)
    st = dataclasses.replace(st, iteration=jnp.int32(start_iter))
    out = core.update_n(st, steps)
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_random_edit_sequences(seed):
    rng = np.random.default_rng(100 + seed)
    h, w = 24, 32
    img = np.full((h, w), 128, np.uint8)
    img[0] = img[-1] = img[:, 0] = img[:, -1] = 0
    img[h // 2, w // 2] = 255
    st = epic_tpu.from_occupancy_image(img)
    u_ref = np.array(st.u)       # writable copies (np.asarray views are RO)
    locked_ref = np.array(st.locked)
    it = 0
    for _ in range(5):
        # Random batch of edits.
        k = int(rng.integers(1, 8))
        xy = np.stack(
            [rng.integers(0, w, k), rng.integers(0, h, k)], axis=1
        )
        types = rng.integers(0, 3, k)
        st = epic_tpu.set_cells(st, xy, types)
        for x, y, t in zip(xy[:, 0], xy[:, 1], types):
            if t == C.CELL_TYPE_GOAL:
                u_ref[y, x], locked_ref[y, x] = 0.0, True
            elif t == C.CELL_TYPE_OBSTACLE:
                u_ref[y, x], locked_ref[y, x] = -1e6, True
            else:
                u_ref[y, x], locked_ref[y, x] = -1e6, False
        steps = int(rng.integers(1, 9))
        st = core.update_n(st, steps)
        for s in range(steps):
            u_ref, _ = reference_np.sweep(u_ref, locked_ref, it + s)
        it += steps
        np.testing.assert_allclose(
            np.asarray(st.u), u_ref, rtol=2e-6, atol=1e-3
        )
        np.testing.assert_array_equal(np.asarray(st.locked), locked_ref)


def _random_volume(rng, d, h, w, density=0.15):
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random((d, h, w)) < density
    gz, gy, gx = (int(rng.integers(1, max(2, n - 1))) for n in (d, h, w))
    u[gz, gy, gx] = 0.0
    locked[gz, gy, gx] = True
    return u, locked


@pytest.mark.parametrize("seed", range(3))
def test_random_volumes_update_volume_matches_oracle(seed):
    """solver.update_volume (the routed 3D path: XLA) on random wide-plane
    volumes with ragged dims, against the NumPy oracle."""
    from epic_tpu import solver

    rng = np.random.default_rng(500 + seed)
    d = int(rng.integers(6, 20))
    h = int(rng.integers(18, 40))
    w = int(rng.integers(130, 300))
    u, locked = _random_volume(rng, d, h, w)
    steps = int(rng.integers(3, 12))
    u_ref = u.copy()
    for it in range(steps):
        u_ref, _ = reference_np.sweep_3d(u_ref, locked, it)
    out = solver.update_volume(epic_tpu.make_state(u, locked), steps)
    np.testing.assert_allclose(np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-3)


@pytest.mark.parametrize("seed", range(3))
def test_random_volumes_z_mesh_matches_oracle(seed):
    """The sharded 3D path on a z-only mesh of random size (ragged depths:
    round-up tail shards, odd per-shard z parity origins, sub-k and
    remainder chunk counts), against the NumPy oracle."""
    import jax

    from epic_tpu.parallel import sharded3d
    from epic_tpu.parallel.sharded3d import make_mesh3d

    rng = np.random.default_rng(900 + seed)
    nmz = int(rng.choice([2, 4, 8]))
    d = int(rng.integers(nmz, 4 * nmz + 3))
    h = int(rng.integers(10, 40))
    w = int(rng.integers(100, 300))
    u, locked = _random_volume(rng, d, h, w)
    steps = int(rng.integers(1, 9))
    u_ref = u.copy()
    for it in range(steps):
        u_ref, _ = reference_np.sweep_3d(u_ref, locked, it)
    mesh = make_mesh3d((nmz, 1, 1), devices=np.asarray(jax.devices()[:nmz]))
    out = sharded3d.update_n(epic_tpu.make_state(u, locked), steps, mesh,
                             chunk_depth=2)
    np.testing.assert_allclose(
        np.asarray(out.u), u_ref, rtol=2e-6, atol=1e-4
    )
