"""epic_tpu — a log-space harmonic-function path-planning engine in JAX.

A from-scratch JAX/XLA re-design, with one CUDA kernel for the 2D sweep on
NVIDIA GPUs, of the reference CUDA/C++/ROS package `epic` (kylewray/epic)
and its capabilities: occupancy-grid ingest,
log-space red-black relaxation of a harmonic potential, gradient-ascent
streamline extraction, incremental warm-started replanning services, batched
multi-scenario solves, and multi-chip spatial domain decomposition.
"""

import os as _os
import pathlib as _pathlib

import jax as _jax

# Persistent compilation cache, shared across processes: JAX itself reads
# JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache lives at a
# fixed path in the checkout (the path is part of the cache key).
CACHE_DIR = _os.environ.get(
    "JAX_COMPILATION_CACHE_DIR",
    str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"))
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from . import analysis, checkpoint, config, constants, errors, maps, path, path3d, path_nd, profiling, viz
from .grid import (
    GridState,
    empty_grid_nd,
    empty_state,
    empty_volume,
    from_occupancy_image,
    from_occupancy_volume,
    make_state,
    reset_free_cells,
    set_cells,
    set_cells_3d,
)
from .planner import Planner, PlannerConfig
from .planner_mesh import MeshPlanner
from .planner3d import VolumePlanner, VolumePlannerConfig
from .solver import core as solver_core
from .solver import reference_np as solver_oracle

__version__ = "0.1.0"

__all__ = [
    "GridState",
    "MeshPlanner",
    "Planner",
    "PlannerConfig",
    "VolumePlanner",
    "VolumePlannerConfig",
    "analysis",
    "checkpoint",
    "config",
    "constants",
    "errors",
    "empty_grid_nd",
    "empty_state",
    "empty_volume",
    "from_occupancy_image",
    "from_occupancy_volume",
    "make_state",
    "maps",
    "path",
    "path3d",
    "path_nd",
    "profiling",
    "reset_free_cells",
    "set_cells",
    "set_cells_3d",
    "solver_core",
    "solver_oracle",
    "viz",
]
