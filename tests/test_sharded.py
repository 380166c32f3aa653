"""Multi-device halo-exchange solver == single-device solver, on a virtual
8-device CPU mesh (SURVEY §4: "multi-host = single-chip equivalence on
halo-decomposed grids")."""

import numpy as np
import pytest

import jax

import epic_tpu
from epic_tpu import maps
from epic_tpu.parallel import make_mesh, sharded
from epic_tpu.solver import core


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh((2, 4))


def _state(img, eps=1e-2):
    return epic_tpu.from_occupancy_image(img, epsilon=eps)


def test_mesh_default_shape():
    m = make_mesh()
    assert m.shape["my"] * m.shape["mx"] == len(jax.devices())


def test_sharded_update_matches_core(mesh8):
    img = maps.random_obstacles(48, 64, density=0.15, seed=3)
    st1, st2 = _state(img), _state(img)
    out1 = core.update_n(st1, 5)
    out2 = sharded.update_n(st2, 5, mesh8)
    assert int(out1.iteration) == int(out2.iteration)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=2e-6, atol=1e-4
    )
    np.testing.assert_allclose(
        float(out1.delta), float(out2.delta), rtol=1e-5, atol=1e-6
    )


def test_sharded_solve_matches_core(mesh8):
    img = maps.random_obstacles(40, 48, density=0.1, seed=5)
    st1, st2 = _state(img), _state(img)
    out1 = core.solve(st1, stagger=10)
    out2 = sharded.solve(st2, mesh8, stagger=10)
    assert int(out1.iteration) == int(out2.iteration)
    assert bool(out2.converged)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=2e-6, atol=1e-3
    )


def test_sharded_nonaligned_grid(mesh8):
    # Grid not divisible by the mesh: padding must not leak into results.
    img = maps.open_room(35, 53)
    st1, st2 = _state(img), _state(img)
    out1 = core.update_n(st1, 4)
    out2 = sharded.update_n(st2, 4, mesh8)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=2e-6, atol=1e-4
    )


def test_sharded_1d_mesh():
    mesh = make_mesh((8, 1))
    img = maps.open_room(40, 40)
    st1, st2 = _state(img), _state(img)
    out1 = core.update_n(st1, 3)
    out2 = sharded.update_n(st2, 3, mesh)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=2e-6, atol=1e-4
    )


def test_chunk_depths_equivalent(mesh8):
    """K-deep halo chunks (one exchange per K sweeps) must be exactly
    equivalent to per-sweep exchange: the trapezoid guard makes each chunk
    identical to K global sweeps."""
    img = maps.recursive_maze(64, 64, seed=9)
    st0 = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
    ref = None
    for depth in (1, 4, 16, 64):
        u, frozen = sharded._pad_for_mesh(st0, mesh8)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh8, P("my", "mx"))
        u = jax.device_put(u, sh)
        frozen = jax.device_put(frozen, sh)
        out, delta = sharded._update_n_sharded(
            u, frozen, st0.iteration, mesh8, 37, depth
        )
        out = np.asarray(out)
        if ref is None:
            ref = (out, float(delta))
        else:
            np.testing.assert_array_equal(out, ref[0], err_msg=f"depth {depth}")
            assert float(delta) == ref[1]
    # And the chunked result equals the single-device path bit-for-bit on CPU.
    solo = core.update_n(st0, 37)
    h, w = st0.u.shape
    np.testing.assert_allclose(
        ref[0][:h, :w], np.asarray(solo.u), rtol=0, atol=2e-6
    )


def test_sharded_chunks_match_core(mesh8):
    """shard_map + the XLA per-shard sweep: 21 sweeps as 8 + 8 + 5 with
    K-deep halo exchanges equal the single-device path."""
    img = maps.random_obstacles(48, 64, density=0.15, seed=11)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh8, P("my", "mx"))
    u, frozen = sharded._pad_for_mesh(st, mesh8)
    u = jax.device_put(u, sh)
    frozen = jax.device_put(frozen, sh)
    out, d = sharded._update_n_sharded(u, frozen, st.iteration, mesh8, 21, 8)
    ref = core.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 21)
    h, w = st.u.shape
    np.testing.assert_allclose(np.asarray(out)[:h, :w], np.asarray(ref.u),
                               rtol=0, atol=2e-6)
    assert float(d) == float(ref.delta)


def test_sharded_remainder_chunk_matches_core(mesh8):
    """A remainder chunk shallower than the exchange depth (21 = 16 + 5)
    keeps the global parity and the first sweep's delta."""
    img = maps.random_obstacles(48, 64, density=0.15, seed=11)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh8, P("my", "mx"))
    u, frozen = sharded._pad_for_mesh(st, mesh8)
    u = jax.device_put(u, sh)
    frozen = jax.device_put(frozen, sh)
    out, d = sharded._update_n_sharded(u, frozen, st.iteration, mesh8, 21, 16)
    ref = core.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 21)
    h, w = st.u.shape
    np.testing.assert_allclose(np.asarray(out)[:h, :w], np.asarray(ref.u),
                               rtol=0, atol=2e-6)
    assert float(d) == float(ref.delta)


def test_sharded_tall_nonaligned_matches_core(mesh8):
    """A tall grid that the (2, 4) mesh does not divide: padding must not
    leak into the field or the delta."""
    img = maps.open_room(70, 53)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh8, P("my", "mx"))
    u, frozen = sharded._pad_for_mesh(st, mesh8)
    u = jax.device_put(u, sh)
    frozen = jax.device_put(frozen, sh)
    out, d = sharded._update_n_sharded(u, frozen, st.iteration, mesh8, 9, 4)
    ref = core.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 9)
    h, w = st.u.shape
    np.testing.assert_allclose(np.asarray(out)[:h, :w], np.asarray(ref.u),
                               rtol=0, atol=2e-6)
    assert float(d) == float(ref.delta)


def test_sharded_tiny_shards_match_core(mesh8):
    """Shards smaller than the requested halo depth (3 x 2 local blocks):
    the exchange depth clamps to the shard and the result stays exact."""
    img = maps.open_room(6, 8)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh8, P("my", "mx"))
    u, frozen = sharded._pad_for_mesh(st, mesh8)
    u = jax.device_put(u, sh)
    frozen = jax.device_put(frozen, sh)
    out, d = sharded._update_n_sharded(u, frozen, st.iteration, mesh8, 4, 4)
    ref = core.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-2), 4)
    h, w = st.u.shape
    np.testing.assert_allclose(np.asarray(out)[:h, :w], np.asarray(ref.u),
                               rtol=0, atol=2e-6)
    assert float(d) == float(ref.delta)


def test_sharded_solve_depth8_matches_core(mesh8):
    """Full sharded solve with 8-deep halo chunks: protocol (iteration
    count) identical, field equal to the single-device solve."""
    img = maps.random_obstacles(40, 48, density=0.1, seed=5)
    st1, st2 = _state(img), _state(img)
    out1 = core.solve(st1, stagger=10)
    out2 = sharded.solve(st2, mesh8, stagger=10, chunk_depth=8)
    assert int(out1.iteration) == int(out2.iteration)
    assert bool(out2.converged)
    np.testing.assert_allclose(
        np.asarray(out1.u), np.asarray(out2.u), rtol=2e-6, atol=1e-3
    )


def test_resident_warm_loop_with_edits(mesh8):
    """Mesh-resident anytime loop: shard once, interleave update chunks and
    SetCells edits without re-padding; equals the single-chip warm loop."""
    from epic_tpu import grid as G
    from epic_tpu import constants as C

    img = maps.random_obstacles(40, 56, density=0.15, seed=4)
    st = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    sh = sharded.shard_state(st, mesh8)
    ref = st

    edits = ([(10, 11), (20, 7), (10, 11)],
             [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE])

    sh = sharded.update_n_resident(sh, 9, mesh8, chunk_depth=4)
    ref = core.update_n(ref, 9)
    sh = sharded.set_cells_resident(sh, *edits)
    ref = G.set_cells(ref, *edits)
    sh = sharded.update_n_resident(sh, 13, mesh8, chunk_depth=8)
    ref = core.update_n(ref, 13)

    back = sharded.unshard(sh)
    assert int(back.iteration) == int(ref.iteration)
    np.testing.assert_allclose(
        np.asarray(back.u), np.asarray(ref.u), rtol=0, atol=1e-5
    )
    # Interior locked flags agree exactly (ring comes back locked).
    np.testing.assert_array_equal(
        np.asarray(back.locked)[1:-1, 1:-1],
        np.asarray(ref.locked)[1:-1, 1:-1],
    )
    # Out-of-bounds / unknown-type edits are skipped like grid.set_cells.
    sh2 = sharded.set_cells_resident(sh, [(999, 2), (3, -1)], [1, 1])
    np.testing.assert_array_equal(np.asarray(sh2.u), np.asarray(sh.u))


def test_multihost_wrapper_single_process():
    """multihost.initialize is a safe no-op single-process, and passes
    explicit coordinator args through to jax.distributed.initialize."""
    from epic_tpu.parallel import multihost

    # Single-process: must not raise.
    multihost.initialize()
    assert multihost.is_multi_process() is False

    # Args pass through verbatim (monkeypatch the jax entry point).
    import jax

    captured = {}

    orig = jax.distributed.initialize

    def fake(coordinator_address=None, num_processes=None, process_id=None,
             **kw):
        captured.update(addr=coordinator_address, n=num_processes,
                        pid=process_id)
        raise RuntimeError("backend already initialized")  # exercised branch

    jax.distributed.initialize = fake
    try:
        multihost.initialize("10.0.0.1:1234", 4, 2)
    finally:
        jax.distributed.initialize = orig
    assert captured == dict(addr="10.0.0.1:1234", n=4, pid=2)


def test_update_n_resident_wide_grid(mesh8):
    """The ShardedGrid tick on a wide grid (24 x 128 local blocks) matches
    the single-device oracle."""
    img = maps.random_obstacles(48, 512, density=0.1, seed=7)
    st = _state(img)
    sh = sharded.shard_state(st, mesh8)
    sh = sharded.update_n_resident(sh, 9, mesh8)
    ref = core.update_n(st, 9)
    back = sharded.unshard(sh)
    assert int(back.iteration) == int(ref.iteration)
    np.testing.assert_allclose(
        np.asarray(back.u), np.asarray(ref.u), rtol=0, atol=1e-5
    )


def test_removed_kernel_options_and_platforms_raise(mesh8, monkeypatch):
    """The per-shard kernel= and segment_iterations= options went with the
    removed per-shard kernels; a platform the route does not know is an
    error."""
    from epic_tpu.solver import route

    img = maps.random_obstacles(48, 512, density=0.1, seed=7)
    st = _state(img)
    sh = sharded.shard_state(st, mesh8)
    with pytest.raises(TypeError):
        sharded.update_n_resident(sh, 1, mesh8, kernel="resident")
    with pytest.raises(TypeError):
        sharded.update_n(st, 1, mesh8, kernel="pallas")
    with pytest.raises(TypeError):
        sharded.solve_resident(sh, mesh8, segment_iterations=100)
    monkeypatch.setattr(route, "platform", lambda: "rocm")
    with pytest.raises(ValueError, match="no compute path"):
        sharded.update_n(st, 1, mesh8)


def test_solve_resident_on_sharded_grid(mesh8):
    """solve_resident runs the whole convergence on the mesh-resident
    buffers (no GridState round trip) — iteration-exact vs core."""
    img = maps.random_obstacles(48, 512, density=0.1, seed=7)
    st = _state(img)
    ref = core.solve(_state(img), stagger=20)
    sh = sharded.shard_state(st, mesh8)
    sh2, conv = sharded.solve_resident(sh, mesh8, stagger=20)
    assert bool(conv)
    assert int(sh2.iteration) == int(ref.iteration)
    back = sharded.unshard(sh2)
    np.testing.assert_allclose(
        np.asarray(back.u), np.asarray(ref.u), rtol=0, atol=1e-3
    )


