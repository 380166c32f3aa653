"""The anytime planner on a device mesh: service verbs over sharded state.

The reference's node is single-GPU by construction — its grid must fit one
device and every edit is mirrored between one CPU and one GPU copy
(epic_navigation_node_harmonic.cpp:357-380, harmonic_model_gpu.cu:76-106).
:class:`MeshPlanner` runs the SAME verb surface (SURVEY §2.1) with the grid
sharded across a ``jax.sharding.Mesh``:

- the authoritative state is a mesh-resident
  :class:`epic_tpu.parallel.sharded.ShardedGrid`; anytime ticks run
  :func:`epic_tpu.parallel.sharded.update_n_resident` (K-deep halo
  exchange + the XLA per-shard sweep, buffers donated across ticks — no
  re-pad, no re-upload);
- SetCells-family edits are scatters into the resident shards
  (:func:`epic_tpu.parallel.sharded.set_cells_resident`) — the owning
  shard takes the write, nothing is re-laid-out (SURVEY "warm-start under
  sharding");
- blocking solves run the sharded solve from the CURRENT resident
  buffers — warm-started, like every other verb;
- host-facing verbs (GetCell, ComputePath, occupancy ingest) gather once
  per verb batch through a lazily-invalidated host mirror — the analog of
  the reference's D2H sync per srvComputePath (:614-674).

Everything else (world<->map transforms, verb semantics, the anytime
contract) is inherited from :class:`epic_tpu.planner.Planner` verbatim: the
base verbs read/write ``self.state``, which is a property here — reads
gather lazily, writes re-shard. Hot paths (update / set_cells / goals) are
overridden with resident implementations so the gather/re-shard roundtrip
only happens for verbs that semantically need whole-grid host data.
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from . import grid as G
from .grid import GridState
from .planner import Planner, PlannerConfig
from .planner3d import VolumePlanner

logger = logging.getLogger("epic_tpu.planner_mesh")


class MeshPlanner(Planner):
    """Anytime harmonic planner whose grid lives sharded on a device mesh.

    Same verbs as :class:`Planner`; pass a ``Mesh`` (defaults to all
    devices in a near-square 2D mesh). ``chunk_depth`` (sweeps per halo
    exchange) forwards to the sharded update path.
    """

    def __init__(self, config: PlannerConfig | None = None, mesh=None,
                 chunk_depth: int | None = None):
        from .parallel import make_mesh
        from .parallel.sharded import DEFAULT_CHUNK_DEPTH

        self._sh = None            # ShardedGrid — the authoritative state
        self._host_state = None    # lazily gathered GridState mirror
        self._converged = False
        super().__init__(config)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.chunk_depth = (DEFAULT_CHUNK_DEPTH if chunk_depth is None
                            else chunk_depth)

    # -- state residency ---------------------------------------------------

    @property
    def state(self) -> GridState | None:
        """Host-facing view of the mesh-resident state (gathered lazily,
        cached until the next tick/edit)."""
        if self._sh is None:
            return None
        if self._host_state is None:
            from .parallel.sharded import unshard

            st = unshard(self._sh)
            self._host_state = dataclasses.replace(
                st, converged=jnp.asarray(self._converged))
        return self._host_state

    @state.setter
    def state(self, value: GridState | None) -> None:
        # Base-class verbs assign whole new states (functional edits);
        # landing one here re-shards it. Overridden hot verbs scatter into
        # the resident buffers instead and never reach this path.
        if value is None:
            self._sh = None
            self._host_state = None
            self._converged = False
            return
        from .parallel.sharded import shard_state

        self._sh = shard_state(value, self.mesh)
        self._converged = bool(np.asarray(value.converged))
        self._host_state = None

    def _invalidate(self) -> None:
        self._host_state = None

    # -- the anytime loop --------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        """Anytime tick on the mesh-resident buffers (donated across
        ticks; no re-pad, no gather)."""
        if self._sh is None or self.paused:
            return
        n = num_steps if num_steps is not None else self.config.steps_per_update
        if n < 1:
            return
        from .parallel.sharded import update_n_resident

        self._sh = update_n_resident(self._sh, n, self.mesh,
                                     chunk_depth=self.chunk_depth)
        # Single-step ticks carry a meaningful converged verdict (the
        # delta IS the check value), matching core.update_n semantics.
        self._converged = (bool(np.asarray(self._sh.delta)
                                < float(np.asarray(self._sh.epsilon)))
                           if n == 1 else False)
        self._invalidate()

    def solve(self, max_iterations: int | None = None) -> None:
        """Blocking sharded solve-to-convergence directly ON the resident
        buffers (warm-started; no GridState round trip, no re-shard)."""
        from .parallel import sharded

        sh = self._sh
        if sh is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        self._sh, conv = sharded.solve_resident(
            sh, self.mesh, stagger=self.config.stagger,
            max_iterations=cap, chunk_depth=self.chunk_depth)
        self._converged = bool(np.asarray(conv))
        self._invalidate()

    # -- resident service verbs -------------------------------------------

    def set_cells(self, xy, types) -> bool:
        """srvSetCells as a scatter into the resident shards."""
        from .parallel.sharded import set_cells_resident

        if self._sh is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        self._sh = set_cells_resident(self._sh, xy, types)
        self._converged = False
        self._invalidate()
        return True

    def add_goals(self, world_points) -> bool:
        """srvAddGoals: world->cells + obstacle guard via the host mirror,
        then one resident scatter."""
        st = self._require_state()   # gathers once (cached)
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        h, w = u_np.shape
        from .errors import InvalidLocationError

        xy = []
        for wx, wy in world_points:
            try:
                mx, my = self.world_to_map(wx, wy)
            except InvalidLocationError:
                continue
            cx, cy = int(mx + 0.5), int(my + 0.5)
            is_obstacle = not (0 <= cx < w and 0 <= cy < h) or (
                bool(locked_np[cy, cx])
                and float(u_np[cy, cx]) == float(C.LOG_SPACE_OBSTACLE)
            )
            if is_obstacle:
                continue
            xy.append((int(mx), int(my)))
        if not xy:
            return False
        return self.set_cells(xy, [C.CELL_TYPE_GOAL] * len(xy))

    def remove_goals(self, world_points) -> bool:
        from .errors import InvalidLocationError

        self._require_state()
        xy = []
        for wx, wy in world_points:
            try:
                mx, my = self.world_to_map(wx, wy)
            except InvalidLocationError:
                continue
            xy.append((int(mx), int(my)))
        if xy:
            self.set_cells(xy, [C.CELL_TYPE_FREE] * len(xy))
        return True

    def reset_free_cells(self) -> bool:
        """srvResetFreeCells on the resident buffers: every unfrozen cell
        back to the FREE value, no gather."""
        if self._sh is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        sh = self._sh
        self._sh = dataclasses.replace(
            sh,
            u=jnp.where(sh.frozen, sh.u,
                        jnp.float32(C.LOG_SPACE_FREE)),
        )
        self._converged = False
        self._invalidate()
        return True


class MeshVolumePlanner(VolumePlanner):
    """The 3D anytime planner on a device mesh: :class:`MeshPlanner`'s
    volume twin over a mesh-resident
    :class:`epic_tpu.parallel.sharded3d.ShardedVolume`.

    Verb semantics inherit from :class:`epic_tpu.planner3d.VolumePlanner`
    verbatim (the base verbs read/write ``self.state``, a property here:
    reads gather lazily, writes re-shard); the hot paths — anytime ticks,
    voxel edits, blocking solves — run directly on the resident buffers
    (:func:`sharded3d.update_n_resident3d`, ``set_cells_resident3d``,
    ``solve_resident3d``). Pass ``mesh=None`` for
    :func:`epic_tpu.parallel.sharded3d.choose_mesh3d`'s orientation pick
    per ingested volume. The reference cannot run 3D on an accelerator at
    all (harmonic_gpu.cu:158-165), let alone across devices."""

    def __init__(self, config=None, mesh=None, chunk_depth: int | None = None):
        from .parallel.sharded3d import DEFAULT_CHUNK_DEPTH

        self._sv = None
        self._host_state = None
        self._converged = False
        super().__init__(config)
        self.mesh = mesh                  # None -> choose per volume
        self._mesh_auto = mesh is None
        self.chunk_depth = (DEFAULT_CHUNK_DEPTH if chunk_depth is None
                            else chunk_depth)

    def _mesh_for(self, shape):
        from .parallel.sharded3d import choose_mesh3d

        if self._mesh_auto:
            self.mesh = choose_mesh3d(shape)
        return self.mesh

    # -- state residency ---------------------------------------------------

    @property
    def state(self) -> GridState | None:
        if self._sv is None:
            return None
        if self._host_state is None:
            from .parallel.sharded3d import unshard3d

            st = unshard3d(self._sv)
            self._host_state = dataclasses.replace(
                st, converged=jnp.asarray(self._converged))
        return self._host_state

    @state.setter
    def state(self, value: GridState | None) -> None:
        if value is None:
            self._sv = None
            self._host_state = None
            self._converged = False
            return
        from .parallel.sharded3d import shard_state3d

        self._sv = shard_state3d(value, self._mesh_for(value.u.shape))
        self._converged = bool(np.asarray(value.converged))
        self._host_state = None

    def _invalidate(self) -> None:
        self._host_state = None

    # -- hot verbs on the resident buffers --------------------------------

    def update(self, num_steps: int | None = None) -> None:
        if self._sv is None or self.paused:
            return
        n = (num_steps if num_steps is not None
             else self.config.steps_per_update)
        if n < 1:
            return
        from .parallel.sharded3d import update_n_resident3d

        self._sv = update_n_resident3d(self._sv, n, self.mesh,
                                       chunk_depth=self.chunk_depth)
        self._converged = (bool(np.asarray(self._sv.delta)
                                < float(np.asarray(self._sv.epsilon)))
                           if n == 1 else False)
        self._invalidate()

    def solve(self, max_iterations: int | None = None) -> None:
        from .parallel.sharded3d import solve_resident3d

        if self._sv is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        self._sv, conv = solve_resident3d(
            self._sv, self.mesh, stagger=self.config.stagger,
            max_iterations=cap, chunk_depth=self.chunk_depth)
        self._converged = bool(np.asarray(conv))
        self._invalidate()

    def set_cells(self, xyz, types) -> bool:
        from .parallel.sharded3d import set_cells_resident3d

        if self._sv is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        self._sv = set_cells_resident3d(self._sv, xyz, types)
        self._converged = False
        self._invalidate()
        return True

    def reset_free_cells(self) -> bool:
        if self._sv is None:
            from .errors import EpicError

            raise EpicError(2, "planner not initialized")
        sv = self._sv
        self._sv = dataclasses.replace(
            sv,
            u=jnp.where(sv.frozen, sv.u, jnp.float32(C.LOG_SPACE_FREE)),
        )
        self._converged = False
        self._invalidate()
        return True
