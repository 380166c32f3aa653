"""The anytime planner for 3D volumes: warm-started re-solves + service verbs.

The reference's service layer is strictly 2D — its ROS node embeds a 2D
``Harmonic`` (epic_navigation_node_harmonic.cpp) and its CUDA path refuses
3D outright (harmonic_gpu.cu:158-165 returns 0 blocks). Its 3D solver
(harmonic_update_3d_cpu, harmonic_cpu.cpp:81-133) was therefore reachable
only through raw library calls, with no path extraction to consume the
field. This module closes that gap: the same verb surface as
:class:`epic_tpu.planner.Planner` (SURVEY §2.1), generalized to volumes,
backed by the XLA 3D sweep (:mod:`epic_tpu.solver.core`) and the
trilinear streamline walker (:mod:`epic_tpu.path3d`).

The core semantic carried over from the 2D planner (SURVEY §3.2) is
unchanged: the planner never stops relaxing; verbs perturb ``u``/``locked``
functionally and relaxation resumes warm from the current state.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np

from . import constants as C
from . import grid as G
from .errors import EpicError, InvalidLocationError
from .path3d import compute_path

logger = logging.getLogger("epic_tpu.planner3d")


@dataclasses.dataclass
class VolumePlannerConfig:
    """3D extension of PlannerConfig: one more origin axis; interpolation is
    always the trilinear (non-extrapolating) walker — there is no reference
    3D quirk to replicate (see path3d module docstring)."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    steps_per_update: int = 50
    resolution: float = 1.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    origin_z: float = 0.0
    backend: str = "auto"            # "auto" | "xla" (solver.route)


@dataclasses.dataclass(frozen=True)
class PathPose3D:
    """A 3D path pose: world coordinates + yaw/pitch from the segment
    direction (the 3D analogue of the 2D node's per-pose yaw,
    epic_navigation_node_harmonic.cpp:655-668)."""

    x: float
    y: float
    z: float
    yaw: float
    pitch: float


class VolumePlanner:
    """Incremental anytime harmonic planner over a 3D volume.

    Verb mapping (same surface as the 2D Planner, srv/*.srv semantics
    generalized one dimension up):

      SetStatus      -> set_status(paused)
      ModifyGoals +  -> add_goals(world_points_3d)
      ModifyGoals -  -> remove_goals(world_points_3d)
      GetCell        -> get_cell(x, y, z)
      SetCells       -> set_cells(xyz_cells, types)   [voxel coords]
      ResetFreeCells -> reset_free_cells()
      ComputePath    -> compute_path(start_world_3d, ...)
      (occupancy)    -> update_occupancy(volume, resolution, origin)
      (main loop)    -> update(num_steps)
    """

    def __init__(self, config: VolumePlannerConfig | None = None):
        self.config = config or VolumePlannerConfig()
        self.state: G.GridState | None = None
        self.paused = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.state is not None

    def init(self, width: int, height: int, depth: int) -> None:
        """initAlg generalized to 3D: all-free volume, boundary shell forced
        obstacle (epic_navigation_node_harmonic.cpp:207-244, :282-307)."""
        self.state = G.empty_volume(depth, height, width,
                                    epsilon=self.config.epsilon)
        logger.info("volume planner init %dx%dx%d eps=%g backend=%s",
                    width, height, depth, self.config.epsilon,
                    self.config.backend)

    def uninit(self) -> None:
        self.state = None

    def _require_state(self) -> G.GridState:
        if self.state is None:
            raise EpicError(2, "planner not initialized")
        return self.state

    # -- world <-> map transforms -----------------------------------------

    def map_to_world(self, mx: float, my: float, mz: float):
        cfg = self.config
        return (
            cfg.origin_x + mx * cfg.resolution,
            cfg.origin_y + my * cfg.resolution,
            cfg.origin_z + mz * cfg.resolution,
        )

    def world_to_map(self, wx: float, wy: float, wz: float):
        cfg = self.config
        st = self._require_state()
        d, h, w = st.u.shape
        if (
            wx < cfg.origin_x
            or wy < cfg.origin_y
            or wz < cfg.origin_z
            or wx >= cfg.origin_x + w * cfg.resolution
            or wy >= cfg.origin_y + h * cfg.resolution
            or wz >= cfg.origin_z + d * cfg.resolution
        ):
            raise InvalidLocationError(f"world ({wx}, {wy}, {wz}) outside map")
        return (
            (wx - cfg.origin_x) / cfg.resolution,
            (wy - cfg.origin_y) / cfg.resolution,
            (wz - cfg.origin_z) / cfg.resolution,
        )

    # -- the anytime loop --------------------------------------------------

    def _kernel_module(self):
        """The solver module :func:`epic_tpu.solver.route.choose` picks for
        this volume (XLA on every platform: there is no 3D kernel)."""
        from .solver import route

        return route.module_for(self._require_state().u.shape,
                                self.config.backend)

    def update(self, num_steps: int | None = None) -> None:
        """Run a chunk of relaxation sweeps (no-op when paused / uninit)."""
        if self.state is None or self.paused:
            return
        n = num_steps if num_steps is not None else self.config.steps_per_update
        if n < 1:
            return
        self.state = self._kernel_module().update_n(self.state, n)

    def solve(self, max_iterations: int | None = None) -> None:
        """Blocking solve-to-convergence (harmonic_complete semantics);
        ``max_iterations`` caps it, and a converged verdict from a capped
        solve is protocol-sound."""
        cap = 1_000_000 if max_iterations is None else int(max_iterations)
        self.state = self._kernel_module().solve(
            self._require_state(), stagger=self.config.stagger,
            max_iterations=cap)

    # -- service verbs -----------------------------------------------------

    def set_status(self, paused: bool) -> bool:
        self.paused = bool(paused)
        return True

    def set_cells(self, xyz, types) -> bool:
        """SetCells on voxel coordinates, no world transform."""
        st = self._require_state()
        self.state = G.set_cells_3d(st, xyz, types)
        return True

    def add_goals(self, world_points) -> bool:
        """ModifyGoals(add): world (x, y, z) -> voxels; goals refused inside
        obstacles; False when no goal could be added."""
        st = self._require_state()
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        d, h, w = u_np.shape
        xyz = []
        for wx, wy, wz in world_points:
            try:
                mx, my, mz = self.world_to_map(wx, wy, wz)
            except InvalidLocationError:
                continue
            cx, cy, cz = int(mx + 0.5), int(my + 0.5), int(mz + 0.5)
            is_obstacle = not (
                0 <= cx < w and 0 <= cy < h and 0 <= cz < d
            ) or (
                bool(locked_np[cz, cy, cx])
                and float(u_np[cz, cy, cx]) == float(C.LOG_SPACE_OBSTACLE)
            )
            if is_obstacle:
                continue
            xyz.append((int(mx), int(my), int(mz)))
        if not xyz:
            return False
        self.state = G.set_cells_3d(st, xyz, [C.CELL_TYPE_GOAL] * len(xyz))
        return True

    def remove_goals(self, world_points) -> bool:
        """ModifyGoals(remove): removed goals become FREE voxels."""
        st = self._require_state()
        xyz = []
        for wx, wy, wz in world_points:
            try:
                mx, my, mz = self.world_to_map(wx, wy, wz)
            except InvalidLocationError:
                continue
            xyz.append((int(mx), int(my), int(mz)))
        if xyz:
            self.state = G.set_cells_3d(st, xyz, [C.CELL_TYPE_FREE] * len(xyz))
        return True

    def get_cell(self, x: int, y: int, z: int) -> float:
        """GetCell: the voxel's log hitting probability (host-mirror read)."""
        st = self._require_state()
        d, h, w = st.u.shape
        if not (0 <= x < w and 0 <= y < h and 0 <= z < d):
            raise InvalidLocationError(f"cell ({x}, {y}, {z}) outside map")
        return float(G.host_u(st)[z, y, x])

    def reset_free_cells(self) -> bool:
        self.state = G.reset_free_cells(self._require_state())
        return True

    def update_occupancy(
        self,
        data: np.ndarray,
        resolution: float | None = None,
        origin: tuple[float, float, float] | None = None,
    ) -> None:
        """Occupancy-volume ingest with the 2D subscriber's update rules
        (epic_navigation_node_harmonic.cpp:383-426) per voxel: >= 50 ->
        OBSTACLE, else FREE; NO_CHANGE (-2) and existing-goal voxels
        untouched; size change triggers full reinit (goals lost); the
        boundary shell stays obstacle."""
        data = np.asarray(data)
        d, h, w = data.shape
        if self.state is None or self.state.u.shape != (d, h, w):
            if self.state is not None:
                logger.warning(
                    "occupancy resize %s -> (%d, %d, %d): full reinit, goals"
                    " lost (reference behaviour)", self.state.u.shape, d, h, w)
            self.uninit()
            self.init(w, h, d)
        if resolution is not None:
            self.config.resolution = float(resolution)
        if origin is not None:
            (self.config.origin_x, self.config.origin_y,
             self.config.origin_z) = map(float, origin)

        st = self._require_state()
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        goal_mask = locked_np & (u_np == float(C.LOG_SPACE_GOAL))

        interior = np.zeros((d, h, w), dtype=bool)
        interior[1:-1, 1:-1, 1:-1] = True
        changeable = interior & (data != C.OCCUPANCY_NO_CHANGE) & ~goal_mask
        obstacle = changeable & (data >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
        free = changeable & ~obstacle
        zs, ys, xs = np.nonzero(obstacle | free)
        if len(zs) == 0:
            return
        types = np.where(obstacle[zs, ys, xs], C.CELL_TYPE_OBSTACLE,
                         C.CELL_TYPE_FREE)
        self.state = G.set_cells_3d(st, np.stack([xs, ys, zs], axis=1), types)

    def compute_path(
        self,
        start_world: tuple[float, float, float],
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_length: int | None = None,
    ) -> list[PathPose3D]:
        """ComputePath: trilinear streamline from the current field, world
        poses with per-segment yaw (about z) and pitch (elevation)."""
        st = self._require_state()
        d, h, w = st.u.shape
        if max_length is None:
            max_length = int(w * h * d / step_size)
        mx, my, mz = self.world_to_map(*start_world)
        pts = compute_path(
            G.host_u(st),
            G.host_locked(st),
            mx,
            my,
            mz,
            step_size=step_size,
            cd_precision=cd_precision,
            max_length=max_length,
        )
        poses: list[PathPose3D] = []
        sx, sy, sz = self.map_to_world(*map(float, pts[0]))
        poses.append(PathPose3D(sx, sy, sz, 0.0, 0.0))
        for i in range(1, len(pts)):
            x, y, z = map(float, pts[i])
            dx = x - float(pts[i - 1, 0])
            dy = y - float(pts[i - 1, 1])
            dz = z - float(pts[i - 1, 2])
            yaw = math.atan2(dy, dx)
            pitch = math.atan2(dz, math.hypot(dx, dy))
            wx, wy, wz = self.map_to_world(x, y, z)
            poses.append(PathPose3D(wx, wy, wz, yaw, pitch))
        return poses

    def compute_paths_batch(
        self,
        starts_world,
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_steps: int = 4096,
    ) -> list[list[PathPose3D] | None]:
        """Many 3D streamlines at once through the device walker
        (:mod:`epic_tpu.solver.batched_path3d`) — the volume analogue of
        Planner.compute_paths_batch. Entries are None for invalid starts or
        <= 2-point walks (the per-lane EPIC_ERROR_INVALID_PATH contract)."""
        import jax.numpy as jnp

        from .solver import batched_path3d

        st = self._require_state()
        starts_world = list(starts_world)
        starts_map = []
        valid_idx = []
        for i, (wx, wy, wz) in enumerate(starts_world):
            try:
                starts_map.append(self.world_to_map(wx, wy, wz))
                valid_idx.append(i)
            except InvalidLocationError:
                continue
        results: list[list[PathPose3D] | None] = [None] * len(starts_world)
        if not starts_map:
            return results
        # Power-of-two lane padding: one compiled program per size class
        # (remote compiles cost minutes; see Planner.compute_paths_batch).
        n_lanes = max(8, 1 << (len(starts_map) - 1).bit_length())
        padded = starts_map + [(-1.0, -1.0, -1.0)] * (n_lanes - len(starts_map))
        out = batched_path3d.walk(
            st.u,
            st.locked,
            jnp.asarray(np.asarray(padded, np.float32)),
            step_size=step_size,
            cd_precision=cd_precision,
            max_steps=max_steps,
        )
        positions = np.asarray(out["positions"])
        lengths = np.asarray(out["lengths"])
        for lane, i in enumerate(valid_idx):
            n = int(lengths[lane])
            if n <= 2:
                continue
            pts = positions[lane, :n]
            poses: list[PathPose3D] = []
            sx, sy, sz = self.map_to_world(*map(float, pts[0]))
            poses.append(PathPose3D(sx, sy, sz, 0.0, 0.0))
            for j in range(1, n):
                x, y, z = map(float, pts[j])
                dx = x - float(pts[j - 1, 0])
                dy = y - float(pts[j - 1, 1])
                dz = z - float(pts[j - 1, 2])
                yaw = math.atan2(dy, dx)
                pitch = math.atan2(dz, math.hypot(dx, dy))
                wx, wy, wz = self.map_to_world(x, y, z)
                poses.append(PathPose3D(wx, wy, wz, yaw, pitch))
            results[i] = poses
        return results
