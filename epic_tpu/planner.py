"""The anytime planner: warm-started incremental re-solves + service verbs.

Functional re-design of the reference ROS node's core
(/root/reference/src/epic_navigation_node_harmonic.cpp). The reference keeps
a mutable ``Harmonic`` struct, mirrors every edit to both CPU and GPU copies
(setCells, :357-380), and relaxes forever in the background. Here the state
is one immutable ``GridState`` on the accelerator; edits are functional
scatter updates; ``update()`` is a donated jitted chunk of sweeps, so the
anytime loop is zero-copy on device and there is nothing to mirror.

Key semantic carried over (SURVEY §3.2): the planner NEVER stops relaxing —
edits perturb ``u``/``locked`` in place and relaxation resumes from the
current state. That warm-started incremental re-solve is what makes the
replanning loop cheap.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np

from . import constants as C
from . import grid as G
from .errors import EpicError, InvalidLocationError
from .path import compute_path


def _native_available() -> bool:
    from . import native

    return native.available()

logger = logging.getLogger("epic_tpu.planner")


@dataclasses.dataclass
class PlannerConfig:
    """Typed config covering the reference's ROS-parameter surface
    (src/epic_navigation_node_main.cpp:43-68 + map_server YAML metadata)."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    steps_per_update: int = 50       # launch/epic_navigation_node_maze.launch:11
    resolution: float = 1.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    interpolation: str = "reference"  # or "bilinear" (epic_tpu extension)
    # Solver backend (solver.route): "auto" runs the CUDA sweep kernel for
    # 2D grids on a GPU and XLA elsewhere; "xla" and "cuda" force one path.
    backend: str = "auto"            # "auto" | "xla" | "cuda"
    # Opt-in coarse-to-fine warm start for blocking solves (solver.cascade):
    # same convergence certificate, far fewer fine-grid sweeps on open
    # domains. Off by default — cold-start is the reference's semantics.
    # Note: a cascade solve re-derives the free field from the pyramid, so
    # it does not continue from the session's current free-cell values (cell
    # types — goals/obstacles — are preserved; they define the pyramid).
    cascade: bool = False


@dataclasses.dataclass(frozen=True)
class PathPose:
    """A path pose: world coordinates + yaw from the segment direction
    (epic_navigation_node_harmonic.cpp:655-668)."""

    x: float
    y: float
    yaw: float


class Planner:
    """Incremental anytime harmonic planner with the reference's verbs.

    Verb mapping (srv/*.srv -> methods):
      SetStatus      -> set_status(paused)
      ModifyGoals +  -> add_goals(world_points)
      ModifyGoals -  -> remove_goals(world_points)
      GetCell        -> get_cell(x, y)
      SetCells       -> set_cells(xy_cells, types)     [cell coords, no transform]
      ResetFreeCells -> reset_free_cells()
      ComputePath    -> compute_path(start_world, ...)
      (OccupancyGrid subscriber) -> update_occupancy(grid, resolution, origin)
      (main loop)    -> update(num_steps)
    """

    def __init__(self, config: "PlannerConfig | EpicConfig | None" = None):
        from .config import EpicConfig, SolverConfig

        if isinstance(config, EpicConfig):
            self.solver_config = config.solver
            config = PlannerConfig(
                epsilon=config.solver.epsilon,
                stagger=config.solver.stagger,
                steps_per_update=config.service.steps_per_update,
                backend=config.solver.backend,
            )
        else:
            self.solver_config = SolverConfig(
                epsilon=(config or PlannerConfig()).epsilon,
                stagger=(config or PlannerConfig()).stagger,
                backend=(config or PlannerConfig()).backend,
            )
        self.config = config or PlannerConfig()
        self.state: G.GridState | None = None
        self.paused = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.state is not None

    def init(self, width: int, height: int) -> None:
        """initAlg equivalent (epic_navigation_node_harmonic.cpp:207-244):
        u = 0 everywhere, unlocked, boundary ring forced obstacle."""
        self.state = G.empty_state(height, width, epsilon=self.config.epsilon)
        logger.info("planner init %dx%d eps=%g backend=%s", width, height,
                    self.config.epsilon, self.config.backend)

    def uninit(self) -> None:
        self.state = None

    def _require_state(self) -> G.GridState:
        if self.state is None:
            raise EpicError(2, "planner not initialized")
        return self.state

    # -- world <-> map transforms -----------------------------------------

    def map_to_world(self, mx: float, my: float) -> tuple[float, float]:
        """epic_navigation_node_harmonic.cpp:310-315."""
        return (
            self.config.origin_x + mx * self.config.resolution,
            self.config.origin_y + my * self.config.resolution,
        )

    def world_to_map(self, wx: float, wy: float) -> tuple[float, float]:
        """epic_navigation_node_harmonic.cpp:318-330; raises if outside."""
        cfg = self.config
        st = self._require_state()
        h, w = st.u.shape
        if (
            wx < cfg.origin_x
            or wy < cfg.origin_y
            or wx >= cfg.origin_x + w * cfg.resolution
            or wy >= cfg.origin_y + h * cfg.resolution
        ):
            raise InvalidLocationError(f"world ({wx}, {wy}) outside map")
        return (wx - cfg.origin_x) / cfg.resolution, (wy - cfg.origin_y) / cfg.resolution

    # -- the anytime loop --------------------------------------------------

    def _kernel_module(self):
        """The solver module for this session's grid, as
        :func:`epic_tpu.solver.route.choose` decides from the platform, the
        grid's shape and ``config.backend`` (the functional analog of the
        reference's gpu->cpu fallback, harmonic.py:76-102). It exposes
        ``update_n`` and ``solve``."""
        from .solver import route

        return route.module_for(self._require_state().u.shape,
                                self.config.backend)

    def update(self, num_steps: int | None = None) -> None:
        """Run a chunk of relaxation sweeps (no-op when paused / uninit),
        mirroring EpicNavigationNodeHarmonic::update (:165-204)."""
        if self.state is None or self.paused:
            return
        n = num_steps if num_steps is not None else self.config.steps_per_update
        if n < 1:
            return
        self.state = self._kernel_module().update_n(self.state, n)

    def solve(self, max_iterations: int | None = None) -> None:
        """Blocking solve-to-convergence (harmonic_complete semantics), as
        the nav_core plugin does per makePlan (epic_nav_core_plugin.cpp:256).
        With ``config.cascade`` the solve warm-starts through a resolution
        pyramid (solver.cascade) — same certificate, fewer sweeps.
        ``max_iterations`` caps the solve; a converged verdict from a capped
        solve is protocol-sound."""
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        solve_fn = self._kernel_module().solve
        if self.config.cascade:
            from .solver import cascade as _cascade

            def final(st, stagger, max_iterations):
                return solve_fn(st, stagger=stagger,
                                max_iterations=min(max_iterations, cap))

            coarse = (_cascade.native_solver
                      if _native_available() else final)
            self.state, _ = _cascade.solve_cascade(
                self._require_state(), stagger=self.config.stagger,
                solver=final, coarse_solver=coarse)
        else:
            self.state = solve_fn(self._require_state(),
                                  stagger=self.config.stagger,
                                  max_iterations=cap)

    # -- service verbs -----------------------------------------------------

    def set_status(self, paused: bool) -> bool:
        """srvSetStatus (:429-438)."""
        self.paused = bool(paused)
        return True

    def set_cells(self, xy, types) -> bool:
        """srvSetCells (:545-579): raw cell coordinates, no world transform."""
        st = self._require_state()
        self.state = G.set_cells(st, xy, types)
        return True

    def add_goals(self, world_points) -> bool:
        """srvAddGoals (:441-482): world coords -> cells; goals are refused
        inside obstacles; returns False if no goal could be added."""
        st = self._require_state()
        # One host fetch for the whole batch (per-goal device reads would
        # compile one gather program per distinct index).
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        h, w = u_np.shape
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
        self.state = G.set_cells(st, xy, [C.CELL_TYPE_GOAL] * len(xy))
        return True

    def remove_goals(self, world_points) -> bool:
        """srvRemoveGoals (:485-519): removed goals become FREE cells."""
        st = self._require_state()
        xy = []
        for wx, wy in world_points:
            try:
                mx, my = self.world_to_map(wx, wy)
            except InvalidLocationError:
                continue
            xy.append((int(mx), int(my)))
        if xy:
            self.state = G.set_cells(st, xy, [C.CELL_TYPE_FREE] * len(xy))
        return True

    def get_cell(self, x: int, y: int) -> float:
        """srvGetCell (:522-542): the cell's log hitting probability.
        (Host fetch — see add_goals note on static-index gathers.)"""
        st = self._require_state()
        h, w = st.u.shape
        if not (0 <= x < w and 0 <= y < h):
            raise InvalidLocationError(f"cell ({x}, {y}) outside map")
        return float(G.host_u(st)[y, x])

    def reset_free_cells(self) -> bool:
        """srvResetFreeCells (:582-611)."""
        self.state = G.reset_free_cells(self._require_state())
        return True

    def update_occupancy(
        self,
        data: np.ndarray,
        resolution: float | None = None,
        origin: tuple[float, float] | None = None,
    ) -> None:
        """OccupancyGrid ingest (subOccupancyGrid, :383-426).

        ``data``: int [H, W], occupancy 0..100, or OCCUPANCY_NO_CHANGE (-2).
        Values >= 50 -> OBSTACLE, else FREE; NO_CHANGE and existing-goal
        cells untouched; size change triggers full reinit (goals are lost,
        as in the reference); boundary ring stays obstacle.
        """
        data = np.asarray(data)
        h, w = data.shape
        if self.state is None or self.state.u.shape != (h, w):
            if self.state is not None:
                logger.warning(
                    "occupancy resize %s -> (%d, %d): full reinit, goals lost"
                    " (reference behaviour)", self.state.u.shape, h, w)
            self.uninit()
            self.init(w, h)
        if resolution is not None:
            self.config.resolution = float(resolution)
        if origin is not None:
            self.config.origin_x, self.config.origin_y = map(float, origin)

        st = self._require_state()
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        goal_mask = locked_np & (u_np == float(C.LOG_SPACE_GOAL))

        interior = np.zeros((h, w), dtype=bool)
        interior[1:-1, 1:-1] = True
        changeable = interior & (data != C.OCCUPANCY_NO_CHANGE) & ~goal_mask
        obstacle = changeable & (data >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
        free = changeable & ~obstacle
        ys, xs = np.nonzero(obstacle | free)
        if len(ys) == 0:
            return
        types = np.where(obstacle[ys, xs], C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_FREE)
        self.state = G.set_cells(st, np.stack([xs, ys], axis=1), types)

    def compute_path(
        self,
        start_world: tuple[float, float],
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_length: int | None = None,
    ) -> list[PathPose]:
        """srvComputePath (:614-674): extract a streamline from the current
        field and convert to world poses with per-segment yaw.

        Parameter defaults follow the rviz node
        (epic_navigation_node_harmonic_rviz.cpp:114-116); max_length defaults
        to w*h/step_size as there.
        """
        st = self._require_state()
        h, w = st.u.shape
        if max_length is None:
            max_length = int(w * h / step_size)
        mx, my = self.world_to_map(*start_world)
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        pts = compute_path(
            u_np,
            locked_np,
            mx,
            my,
            step_size=step_size,
            cd_precision=cd_precision,
            max_length=max_length,
            mode=self.config.interpolation,
        )
        poses: list[PathPose] = []
        sx, sy = self.map_to_world(float(pts[0, 0]), float(pts[0, 1]))
        poses.append(PathPose(sx, sy, 0.0))
        for i in range(1, len(pts)):
            x, y = float(pts[i, 0]), float(pts[i, 1])
            yaw = math.atan2(y - float(pts[i - 1, 1]), x - float(pts[i - 1, 0]))
            wx, wy = self.map_to_world(x, y)
            poses.append(PathPose(wx, wy, yaw))
        return poses

    def compute_paths_batch(
        self,
        starts_world,
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_steps: int = 4096,
        mode: str | None = None,
    ) -> list[list[PathPose] | None]:
        """Many streamlines at once through the device walker (epic_tpu
        extension — multi-robot / rollout workloads; the reference extracts
        one scalar path per ComputePath call). Lanes in lockstep on the
        accelerator (:mod:`epic_tpu.solver.batched_path`); entries are None
        for invalid starts or <= 2-point walks (the reference's
        EPIC_ERROR_INVALID_PATH contract per lane).

        ``mode`` defaults to ``config.interpolation`` — the same streamlines
        the scalar ComputePath verb walks."""
        import jax.numpy as jnp

        from .solver import batched_path

        st = self._require_state()
        starts_world = list(starts_world)
        if mode is None:
            mode = self.config.interpolation
        starts_map = []
        valid_idx = []
        for i, (wx, wy) in enumerate(starts_world):
            try:
                starts_map.append(self.world_to_map(wx, wy))
                valid_idx.append(i)
            except InvalidLocationError:
                continue
        results: list[list[PathPose] | None] = [None] * len(starts_world)
        if not starts_map:
            return results
        # Pad the lane count to a power of two (min 8) so distinct request
        # sizes reuse a handful of compiled programs — a fresh jaxpr per B
        # costs minutes through remote-compile services. Padding lanes use
        # an out-of-map start; the walker marks them invalid at step 0.
        n_lanes = max(8, 1 << (len(starts_map) - 1).bit_length())
        padded = starts_map + [(-1.0, -1.0)] * (n_lanes - len(starts_map))
        out = batched_path.walk(
            st.u,
            st.locked,
            jnp.asarray(np.asarray(padded, np.float32)),
            step_size=step_size,
            cd_precision=cd_precision,
            max_steps=max_steps,
            mode=mode,
        )
        positions = np.asarray(out["positions"])
        lengths = np.asarray(out["lengths"])
        for lane, i in enumerate(valid_idx):
            n = int(lengths[lane])
            if n <= 2:
                continue
            pts = positions[lane, :n]
            poses: list[PathPose] = []
            sx, sy = self.map_to_world(float(pts[0, 0]), float(pts[0, 1]))
            poses.append(PathPose(sx, sy, 0.0))
            for j in range(1, n):
                x, y = float(pts[j, 0]), float(pts[j, 1])
                yaw = math.atan2(y - float(pts[j - 1, 1]),
                                 x - float(pts[j - 1, 0]))
                wx, wy = self.map_to_world(x, y)
                poses.append(PathPose(wx, wy, yaw))
            results[i] = poses
        return results
