"""The immutable grid state and functional cell-edit operations.

The reference's mutable ``Harmonic`` struct
(/root/reference/libepic/include/epic/harmonic/harmonic.h:44-64) holds
host+device pointer pairs plus solver bookkeeping. Here this
collapses into one immutable pytree, ``GridState``; every mutator
(``harmonic_utilities_set_cells_2d_{cpu,gpu}``, goal edits, occupancy ingest)
becomes a pure function ``state -> state``. There is no host/device mirroring:
XLA owns placement, and donation makes the functional update loop zero-copy.

Coordinate convention matches the reference: ``u`` is indexed ``[y, x]`` (row
major, ``m[0] = height``, ``m[1] = width``), and cell-edit vectors ``v`` are
``(x, y)`` pairs (harmonic_utilities_cpu.cpp:47-49).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridState:
    """Log-space harmonic grid state (2D or 3D).

    Attributes:
      u: float32[*dims] log-potentials. GOAL cells hold 0.0; OBSTACLE and
        unrelaxed FREE cells hold -1e6 (constants.h:41-43).
      locked: bool[*dims]. Locked cells are never updated by the solver
        (harmonic_cpu.cpp:53).
      iteration: int32 scalar; the reference's ``currentIteration``. Parity of
        the red-black sweep is derived from it (harmonic_cpu.cpp:49).
      delta: float32 scalar; max |u' - u| over the cells updated in the most
        recent *checked* sweep (harmonic_cpu.cpp:74).
      converged: bool scalar; result of the most recent sweep's convergence
        check. NOT sticky: plain (unchecked) sweeps reset it to False, exactly
        as the reference's ``result`` variable is overwritten every iteration
        (harmonic_cpu.cpp:158-173) — the solve loop can only exit right after
        a staggered check.
      epsilon: float32 scalar convergence threshold in log space.
    """

    u: jax.Array
    locked: jax.Array
    iteration: jax.Array
    delta: jax.Array
    converged: jax.Array
    epsilon: jax.Array

    @property
    def shape(self) -> tuple[int, ...]:
        return self.u.shape

    @property
    def height(self) -> int:
        return self.u.shape[0]

    @property
    def width(self) -> int:
        return self.u.shape[1]

    @property
    def ndim_grid(self) -> int:
        return self.u.ndim


def make_state(
    u: np.ndarray | jax.Array,
    locked: np.ndarray | jax.Array,
    epsilon: float = C.DEFAULT_EPSILON,
) -> GridState:
    """Build a fresh GridState from u/locked arrays (resets solver bookkeeping).

    ``delta`` starts at ``epsilon + 1`` and ``converged`` at False, matching
    harmonic_complete_cpu's preamble (harmonic_cpu.cpp:153-156).
    """
    if epsilon <= 0.0:
        # harmonic_complete_cpu rejects epsilon <= 0 as INVALID_DATA
        # (harmonic_cpu.cpp:141-145); the solve loop could never terminate.
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    u = jnp.asarray(u, dtype=jnp.float32)
    locked = jnp.asarray(locked).astype(jnp.bool_)
    if u.shape != locked.shape:
        raise ValueError(f"u shape {u.shape} != locked shape {locked.shape}")
    if u.ndim < 2:
        raise ValueError(f"grids must be at least 2D, got {u.ndim}D")
    return GridState(
        u=u,
        locked=locked,
        iteration=jnp.int32(0),
        delta=jnp.float32(epsilon + 1.0),
        converged=jnp.asarray(False),
        epsilon=jnp.float32(epsilon),
    )


def empty_state(height: int, width: int, epsilon: float = C.DEFAULT_EPSILON) -> GridState:
    """All-free grid with u = 0, as the ROS node's initAlg creates it
    (epic_navigation_node_harmonic.cpp:216-226), with the boundary ring forced
    to locked obstacles (setBoundariesAsObstacles, :282-307)."""
    u = np.zeros((height, width), dtype=np.float32)
    locked = np.zeros((height, width), dtype=bool)
    u[0, :] = C.LOG_SPACE_OBSTACLE
    u[-1, :] = C.LOG_SPACE_OBSTACLE
    u[:, 0] = C.LOG_SPACE_OBSTACLE
    u[:, -1] = C.LOG_SPACE_OBSTACLE
    locked[0, :] = True
    locked[-1, :] = True
    locked[:, 0] = True
    locked[:, -1] = True
    return make_state(u, locked, epsilon)


def empty_volume(
    depth: int, height: int, width: int, epsilon: float = C.DEFAULT_EPSILON
) -> GridState:
    """3D analogue of :func:`empty_state`: all-free volume with u = 0 and the
    boundary *shell* (all six faces) forced to locked obstacles. The
    reference's node layer is 2D-only; this extends its initAlg semantics
    (epic_navigation_node_harmonic.cpp:216-226, :282-307) to the 3D solver
    it never wired up."""
    u = np.zeros((depth, height, width), dtype=np.float32)
    locked = np.zeros((depth, height, width), dtype=bool)
    shell = np.ones((depth, height, width), dtype=bool)
    shell[1:-1, 1:-1, 1:-1] = False
    u[shell] = C.LOG_SPACE_OBSTACLE
    locked[shell] = True
    return make_state(u, locked, epsilon)


def empty_grid_nd(shape: tuple[int, ...], epsilon: float = C.DEFAULT_EPSILON) -> GridState:
    """N-dimensional analogue of :func:`empty_state`/:func:`empty_volume`:
    an all-free rank-n grid with u = 0 and the full boundary shell locked as
    obstacles. The reference solves 2D/3D only and stubs 4D out
    (harmonic_cpu.cpp:193-195); the XLA solver (solver/core.py) handles any
    rank >= 2 with the same update rule and protocol."""
    if len(shape) < 2 or any(s < 3 for s in shape):
        raise ValueError(f"need rank >= 2 with every dim >= 3, got {shape}")
    u = np.zeros(shape, dtype=np.float32)
    locked = np.zeros(shape, dtype=bool)
    shell = np.ones(shape, dtype=bool)
    shell[(slice(1, -1),) * len(shape)] = False
    u[shell] = C.LOG_SPACE_OBSTACLE
    locked[shell] = True
    return make_state(u, locked, epsilon)


def from_occupancy_volume(vol: np.ndarray, epsilon: float = C.DEFAULT_EPSILON) -> GridState:
    """Ingest a 3D occupancy volume with HarmonicMap.load's pixel semantics
    (libepic/python/epic/harmonic_map.py:54-100) applied per voxel:

      voxel == 255 -> GOAL (locked, u = 0.0)
      voxel == 0   -> OBSTACLE (locked, u = -1e6)
      otherwise    -> FREE (unlocked, u = -1e6)
    """
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError("expected a 3D occupancy volume")
    goal = vol == 255
    obstacle = vol == 0
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    locked = goal | obstacle
    return make_state(u, locked, epsilon)


def from_occupancy_image(img: np.ndarray, epsilon: float = C.DEFAULT_EPSILON) -> GridState:
    """Ingest a grayscale occupancy image, HarmonicMap.load semantics
    (libepic/python/epic/harmonic_map.py:54-100):

      pixel == 255 -> GOAL (locked, u = 0.0)
      pixel == 0   -> OBSTACLE (locked, u = -1e6)
      otherwise    -> FREE (unlocked, u = -1e6)
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("expected a 2D grayscale image")
    goal = img == 255
    obstacle = img == 0
    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    locked = goal | obstacle
    return make_state(u, locked, epsilon)


# ---------------------------------------------------------------------------
# Functional cell edits (the SetCells family).
# ---------------------------------------------------------------------------

_TYPE_TO_U = {
    C.CELL_TYPE_GOAL: float(C.LOG_SPACE_GOAL),
    C.CELL_TYPE_OBSTACLE: float(C.LOG_SPACE_OBSTACLE),
    C.CELL_TYPE_FREE: float(C.LOG_SPACE_FREE),
}
_TYPE_TO_LOCKED = {
    C.CELL_TYPE_GOAL: True,
    C.CELL_TYPE_OBSTACLE: True,
    C.CELL_TYPE_FREE: False,
}


def sanitize_cell_edits(xy, types, width: int, height: int):
    """Shared SetCells preprocessing (harmonic_utilities_cpu.cpp:38-76):
    drop out-of-bounds / unknown-type entries (the reference warns and
    continues) and resolve duplicate coordinates last-wins (the reference
    applies edits sequentially; two independent JAX scatters need not pick
    the same winner).

    Returns (xy[int64, N, 2], u_vals f32[N], locked_vals bool[N]); N may be 0.
    """
    xy = np.atleast_2d(np.asarray(xy, dtype=np.int64))
    types = np.asarray(types, dtype=np.int64).reshape(-1)
    if xy.shape[0] != types.shape[0]:
        raise ValueError("xy and types length mismatch")
    valid = (
        (xy[:, 0] >= 0)
        & (xy[:, 0] < width)
        & (xy[:, 1] >= 0)
        & (xy[:, 1] < height)
        & np.isin(types, list(_TYPE_TO_U))
    )
    xy = xy[valid]
    types = types[valid]
    if xy.shape[0]:
        flat = xy[:, 1] * width + xy[:, 0]
        _, last_idx = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - last_idx)
        xy = xy[keep]
        types = types[keep]
    u_vals = np.array([_TYPE_TO_U[t] for t in types], dtype=np.float32)
    l_vals = np.array([_TYPE_TO_LOCKED[t] for t in types], dtype=bool)
    return xy, u_vals, l_vals


def set_cells(
    state: GridState,
    xy: np.ndarray | Sequence[tuple[int, int]],
    types: np.ndarray | Sequence[int],
) -> GridState:
    """Point edits: (x, y, type) -> (u, locked) writes.

    Functional equivalent of ``harmonic_utilities_set_cells_2d_cpu``
    (harmonic_utilities_cpu.cpp:38-76) and its GPU twin — one code path, no
    host/device mirroring. Out-of-bounds or unknown-type entries are skipped
    (the reference warns and continues); duplicates resolve last-wins.

    Resets ``converged`` — an edit perturbs the field, so the previous
    convergence verdict no longer holds (the reference node keeps relaxing
    regardless; see SURVEY §3.2).
    """
    h, w = state.u.shape[:2]
    xy, u_vals, l_vals = sanitize_cell_edits(xy, types, w, h)
    if xy.shape[0] == 0:
        return state
    ys = jnp.asarray(xy[:, 1])
    xs = jnp.asarray(xy[:, 0])
    u = state.u.at[ys, xs].set(jnp.asarray(u_vals))
    locked = state.locked.at[ys, xs].set(jnp.asarray(l_vals))
    return dataclasses.replace(state, u=u, locked=locked, converged=jnp.asarray(False))


def sanitize_cell_edits_3d(xyz, types, width: int, height: int, depth: int):
    """3D twin of :func:`sanitize_cell_edits` for (x, y, z) voxel edits:
    drop out-of-bounds / unknown-type entries, resolve duplicates last-wins.

    Returns (xyz[int64, N, 3], u_vals f32[N], locked_vals bool[N]); N may be 0.
    """
    xyz = np.atleast_2d(np.asarray(xyz, dtype=np.int64))
    types = np.asarray(types, dtype=np.int64).reshape(-1)
    if xyz.shape[0] != types.shape[0]:
        raise ValueError("xyz and types length mismatch")
    valid = (
        (xyz[:, 0] >= 0)
        & (xyz[:, 0] < width)
        & (xyz[:, 1] >= 0)
        & (xyz[:, 1] < height)
        & (xyz[:, 2] >= 0)
        & (xyz[:, 2] < depth)
        & np.isin(types, list(_TYPE_TO_U))
    )
    xyz = xyz[valid]
    types = types[valid]
    if xyz.shape[0]:
        flat = (xyz[:, 2] * height + xyz[:, 1]) * width + xyz[:, 0]
        _, last_idx = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - last_idx)
        xyz = xyz[keep]
        types = types[keep]
    u_vals = np.array([_TYPE_TO_U[t] for t in types], dtype=np.float32)
    l_vals = np.array([_TYPE_TO_LOCKED[t] for t in types], dtype=bool)
    return xyz, u_vals, l_vals


def set_cells_3d(
    state: GridState,
    xyz: np.ndarray | Sequence[tuple[int, int, int]],
    types: np.ndarray | Sequence[int],
) -> GridState:
    """Point edits on a 3D volume: (x, y, z, type) -> (u, locked) writes.

    Same contract as :func:`set_cells` (skip-invalid, duplicate last-wins,
    resets ``converged``) applied to ``u[z, y, x]`` volumes — the 3D SetCells
    the reference never shipped (harmonic_utilities_cpu.cpp is 2D-only)."""
    if state.u.ndim != 3:
        raise ValueError(f"set_cells_3d requires a 3D grid, got {state.u.ndim}D")
    d, h, w = state.u.shape
    xyz, u_vals, l_vals = sanitize_cell_edits_3d(xyz, types, w, h, d)
    if xyz.shape[0] == 0:
        return state
    zs = jnp.asarray(xyz[:, 2])
    ys = jnp.asarray(xyz[:, 1])
    xs = jnp.asarray(xyz[:, 0])
    u = state.u.at[zs, ys, xs].set(jnp.asarray(u_vals))
    locked = state.locked.at[zs, ys, xs].set(jnp.asarray(l_vals))
    return dataclasses.replace(state, u=u, locked=locked, converged=jnp.asarray(False))


def reset_free_cells(state: GridState) -> GridState:
    """Rewrite every unlocked interior cell to the FREE value -1e6, clearing
    stale potentials (srvResetFreeCells,
    epic_navigation_node_harmonic.cpp:582-611). The explicit cold restart.
    On 3D volumes "interior" excludes all six faces."""
    interior = np.zeros(state.u.shape, dtype=bool)
    interior[(slice(1, -1),) * state.u.ndim] = True
    mask = jnp.asarray(interior) & ~state.locked
    u = jnp.where(mask, jnp.float32(C.LOG_SPACE_FREE), state.u)
    return dataclasses.replace(
        state,
        u=u,
        converged=jnp.asarray(False),
        iteration=jnp.int32(0),
        delta=state.epsilon + 1.0,
    )


class _MirrorCache:
    """Host mirrors of device arrays, keyed by buffer identity.

    Cell reads (GetCell, is_cell_*) cost the reference a 4-byte read
    (epic_navigation_node_harmonic.cpp:522-542); a naive np.asarray per query
    costs a full-grid D2H (1 GB per RPC on a 16k² grid). GridState is
    immutable, so a device array's contents can never change — one D2H per
    edit/solve epoch, shared by every subsequent query. Entries evict when
    the device buffer is garbage-collected (weakref finalizer), so the cache
    never extends buffer lifetime or blocks donation.
    """

    def __init__(self):
        self._data: dict[int, tuple[object, np.ndarray]] = {}

    def get(self, arr) -> np.ndarray:
        if isinstance(arr, np.ndarray):
            return arr
        key = id(arr)
        ent = self._data.get(key)
        if ent is not None and ent[0]() is arr:
            return ent[1]
        mirror = np.asarray(arr)
        try:
            ref = weakref.ref(arr, lambda _, key=key: self._data.pop(key, None))
        except TypeError:  # pragma: no cover - non-weakref-able array type
            return mirror
        self._data[key] = (ref, mirror)
        return mirror


_mirrors = _MirrorCache()


def host_u(state: GridState) -> np.ndarray:
    """Cached host view of state.u (do not mutate)."""
    return _mirrors.get(state.u)


def host_locked(state: GridState) -> np.ndarray:
    """Cached host view of state.locked (do not mutate)."""
    return _mirrors.get(state.locked)


def is_cell_obstacle(state: GridState, x: int, y: int) -> bool:
    """epic_navigation_node_harmonic.cpp:332-341: out-of-map counts as obstacle.

    Reads through the host mirror cache: one D2H per state epoch, not per
    query (static-index device gathers would compile one program per index,
    pathological on remote backends).
    """
    h, w = state.u.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return True
    u = host_u(state)
    locked = host_locked(state)
    return bool(locked[y, x]) and float(u[y, x]) == float(C.LOG_SPACE_OBSTACLE)


def is_cell_goal(state: GridState, x: int, y: int) -> bool:
    """epic_navigation_node_harmonic.cpp:344-353."""
    h, w = state.u.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return False
    u = host_u(state)
    locked = host_locked(state)
    return bool(locked[y, x]) and float(u[y, x]) == float(C.LOG_SPACE_GOAL)
