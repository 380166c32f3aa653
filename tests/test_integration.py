"""Cross-backend integration: the full anytime replanning workflow produces
identical state whether sweeps run through XLA, the CUDA kernel's blocked
schedule (its CPU model), or the sharded mesh path — including
warm-started edits."""

import numpy as np
import jax

import epic_tpu
from epic_tpu import constants as C
from epic_tpu import maps
from epic_tpu.parallel import make_mesh, sharded
from epic_tpu.solver import core, cuda_sweep


def _workflow(stepper):
    """ingest -> relax -> obstacle edit -> relax -> goal move -> relax."""
    img = maps.random_obstacles(40, 48, density=0.1, seed=11)
    state = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
    state = stepper(state, 30)
    cells = [(x, y) for x in range(10, 14) for y in range(20, 24)]
    state = epic_tpu.set_cells(state, cells, [C.CELL_TYPE_OBSTACLE] * len(cells))
    state = stepper(state, 30)
    state = epic_tpu.set_cells(state, [(40, 30)], [C.CELL_TYPE_GOAL])
    state = stepper(state, 40)
    return np.asarray(state.u), int(state.iteration)


def test_workflow_identical_across_backends():
    u_xla, it_xla = _workflow(core.update_n)
    u_pal, it_pal = _workflow(
        lambda s, n: cuda_sweep.update_n(s, n, interpret=True))
    mesh = make_mesh((2, 4))
    u_shd, it_shd = _workflow(lambda s, n: sharded.update_n(s, n, mesh))
    assert it_xla == it_pal == it_shd == 100
    np.testing.assert_allclose(u_pal, u_xla, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(u_shd, u_xla, rtol=2e-6, atol=1e-3)


def test_checkpoint_mid_workflow_roundtrip(tmp_path):
    from epic_tpu import checkpoint

    img = maps.open_room(32, 32)
    state = epic_tpu.from_occupancy_image(img, epsilon=1e-3)
    state = core.update_n(state, 25)
    checkpoint.save(tmp_path / "mid.npz", state)
    resumed = checkpoint.load(tmp_path / "mid.npz")
    a = core.update_n(state, 25)
    b = core.update_n(resumed, 25)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_solve_grid_auto_dispatch_cpu():
    """solver.solve_grid / update_grid route to core on the CPU platform
    (protocol-identical to the CUDA kernel's path)."""
    import epic_tpu.solver as S

    img = maps.random_obstacles(48, 64, density=0.1, seed=3)
    state = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    out = S.solve_grid(state)
    ref = core.solve(epic_tpu.from_occupancy_image(img, epsilon=1e-2))
    assert int(out.iteration) == int(ref.iteration)
    np.testing.assert_array_equal(np.asarray(out.u), np.asarray(ref.u))

    state = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    out = S.update_grid(state, 7)
    assert int(out.iteration) == 7

    # 3D routes through the volume dispatcher, 4D through core's generic path.
    st3 = epic_tpu.empty_volume(5, 6, 7, epsilon=1e-1)
    assert int(S.update_grid(st3, 3).iteration) == 3
    st4 = epic_tpu.empty_grid_nd((4, 5, 6, 7), epsilon=1e-1)
    assert int(S.update_grid(st4, 3).iteration) == 3


def test_update_entries_reject_zero_steps_and_removed_kwargs():
    """num_steps < 1 raises on every stepper; the removed tiling and
    segmented-solve options are no longer accepted by the entry points."""
    import pytest

    import epic_tpu.solver as S

    img = maps.random_obstacles(32, 40, density=0.1, seed=1)
    state = epic_tpu.from_occupancy_image(img, epsilon=1e-2)
    with pytest.raises(ValueError):
        core.update_n(state, 0)
    with pytest.raises(ValueError):
        cuda_sweep.update_n(state, 0, interpret=True)
    for kw in ({"chunk_depth": 8}, {"interpret": True},
               {"segment_iterations": 100}):
        with pytest.raises(TypeError):
            S.solve_grid(state, max_iterations=50, **kw)
    with pytest.raises(ValueError):
        S.update_grid(state, 3, backend="pallas")
    out = S.solve_grid(state, max_iterations=50)
    assert int(out.iteration) >= 1
