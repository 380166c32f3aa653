"""The one decision of which compute path relaxes a grid.

Every entry point (``solver.solve_grid``/``update_grid``, the planners, the
sharded paths) asks :func:`choose`. The answer depends only on the
platform, the grid's shape, whether the grid is sharded over a mesh, and
the caller's ``backend`` option:

- ``"xla"``: ``solver.core`` (or the XLA per-shard sweep under
  ``shard_map``), which runs on every platform;
- ``"cuda"``: the temporally blocked CUDA kernel (``solver.cuda_sweep``),
  2D and unsharded only, on a GPU.

``backend="auto"`` picks the CUDA kernel for unsharded 2D grids on a GPU
and XLA everywhere else: on an H200 the kernel was faster than XLA end to
end at every measured grid, from the 482x482 maze to 16384x16384, in the
anytime tick and in the full solve (tools/sweep_ab.py).
``backend="cuda"`` forces it (for tests and A/B timing) and fails where it
cannot run. A platform other than ``"cpu"`` or ``"gpu"`` is an error, never
a default.
"""

from __future__ import annotations

import jax

XLA = "xla"
CUDA = "cuda"
BACKENDS = ("auto", XLA, CUDA)
PLATFORMS = ("cpu", "gpu")


def platform() -> str:
    """The platform JAX computes on by default."""
    return jax.default_backend()


def choose(platform: str, shape: tuple[int, ...], backend: str = "auto",
           sharded: bool = False) -> str:
    """Return ``"xla"`` or ``"cuda"`` for a grid of ``shape``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown solver backend {backend!r}; expected one of {BACKENDS}")
    if platform not in PLATFORMS:
        raise ValueError(f"no compute path for platform {platform!r}")
    if backend == XLA:
        return XLA
    cuda_ok = platform == "gpu" and len(shape) == 2 and not sharded
    if backend == CUDA:
        if not cuda_ok:
            raise ValueError(
                "backend='cuda' runs unsharded 2D grids on a GPU only "
                f"(platform {platform!r}, shape {tuple(shape)}, "
                f"sharded={sharded})")
        return CUDA
    return CUDA if cuda_ok else XLA


def module_for(shape: tuple[int, ...], backend: str = "auto",
               sharded: bool = False):
    """The solver module (``core`` or ``cuda_sweep``) for ``shape`` on the
    current platform; both expose ``update_n`` and ``solve``."""
    if choose(platform(), shape, backend, sharded) == CUDA:
        from . import cuda_sweep

        return cuda_sweep
    from . import core

    return core
