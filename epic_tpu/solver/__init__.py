from . import (
    batched,
    batched_path3d,
    cascade,
    batched_path,
    core,
    cuda_sweep,
    legacy,
    reference_np,
    route,
)

__all__ = [
    "batched",
    "batched_path3d",
    "cascade",
    "batched_path",
    "core",
    "cuda_sweep",
    "legacy",
    "reference_np",
    "route",
]


def _stagger(stagger):
    from .. import constants as _C

    return _C.DEFAULT_STAGGER if stagger is None else stagger


def solve_grid(state, stagger=None, max_iterations=1_000_000, backend="auto"):
    """Solve to convergence on the path :func:`route.choose` picks for this
    grid (the functional twin of the reference's Harmonic.solve with its
    GPU/CPU choice, libepic/python/epic/harmonic.py:54-107). Every path runs
    the same protocol (harmonic_complete_cpu); the input state is donated."""
    mod = route.module_for(state.u.shape, backend)
    return mod.solve(state, _stagger(stagger), max_iterations)


def update_grid(state, num_steps, backend="auto"):
    """The anytime stepper on the routed path; see :func:`solve_grid`."""
    return route.module_for(state.u.shape, backend).update_n(state, num_steps)


def solve_volume(state, stagger=None, max_iterations=1_000_000, backend="auto"):
    """:func:`solve_grid` for 3D grids (which always route to XLA)."""
    if state.u.ndim != 3:
        raise ValueError(f"solve_volume requires a 3D grid, got {state.u.ndim}D")
    return solve_grid(state, stagger, max_iterations, backend)


def update_volume(state, num_steps, backend="auto"):
    """:func:`update_grid` for 3D grids."""
    if state.u.ndim != 3:
        raise ValueError(f"update_volume requires a 3D grid, got {state.u.ndim}D")
    return update_grid(state, num_steps, backend)


__all__ += ["solve_grid", "update_grid", "solve_volume", "update_volume"]
