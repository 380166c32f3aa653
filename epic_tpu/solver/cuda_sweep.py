"""The 2D relaxation as a temporally blocked CUDA kernel (Hopper, sm_90a).

``solver.core`` pays at least one kernel launch per sweep: XLA does not
fuse across ``fori_loop`` trips, and a maze-sized sweep moves about 2 MB,
far less than a launch costs. ``cuda/sweep2d.cu`` runs up to K sweeps per
launch on tiles held in shared memory (see the header of that file for the
scheme). This module is its Python side:

- :func:`update_n` and :func:`solve` keep ``core.update_n`` /
  ``core.solve``'s contract and protocol bit for bit: the staggered check,
  the exit rule, iteration counts ≡ 1 (mod stagger), the while loop in XLA
  with the launches inside it;
- :func:`launch_plan` splits n sweeps into launches of at most K;
- :func:`model_launch` is a ``jnp`` model of exactly one launch (tile
  origins, the K-deep halo, the shrinking valid region, parity offsets,
  write-back of the tile interior, the per-tile delta). ``interpret=True``
  runs it instead of the CUDA kernel, which is how the CPU tests reach the
  schedule and everything around it;
- :func:`build` compiles the library with ``nvcc`` into ``cuda/build/``
  (``python -m epic_tpu.solver.cuda_sweep`` does it ahead of time).

The route (``solver.route``) decides where this kernel runs.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..grid import GridState
from . import core

_DIR = pathlib.Path(__file__).parent / "cuda"
_SRC = _DIR / "sweep2d.cu"
_LIB = _DIR / "build" / "libepic_sweep2d.so"
_TARGET = "epic_sweep2d"


class Geometry(NamedTuple):
    """One compiled tile shape: th x tw cells per block, a k-deep halo (so
    at most k sweeps per launch), nt threads per block."""

    th: int
    tw: int
    k: int
    nt: int


# The fastest tick on an H200 among eight tile geometries (tools/sweep_ab.py
# --tune): 32x32 tiles with K=8 at 482x482 and 940x310, whose small tiles
# keep enough blocks in flight; 64x128 tiles with K=16 at 4096^2 and 16384^2.
SMALL_GEOMETRY = Geometry(32, 32, 8, 256)
LARGE_GEOMETRY = Geometry(64, 128, 16, 512)
# The compiled instantiations; keep in step with kVariants in cuda/sweep2d.cu.
GEOMETRIES = (SMALL_GEOMETRY, LARGE_GEOMETRY)
# Grids below this many cells take SMALL_GEOMETRY. The crossover lies
# between the measured 0.29M and 16.8M cells; this cut is not measured.
LARGE_GRID_CELLS = 1 << 22


def choose_geometry(shape: tuple[int, int]) -> Geometry:
    h, w = shape
    return SMALL_GEOMETRY if h * w < LARGE_GRID_CELLS else LARGE_GEOMETRY


def launch_plan(num_sweeps: int, k: int) -> tuple[int, ...]:
    """Sweeps per launch: the fewest launches of at most k sweeps, as even
    as possible, longer ones first."""
    if num_sweeps < 1:
        raise ValueError(f"num_sweeps must be >= 1, got {num_sweeps}")
    n_launch = -(-num_sweeps // k)
    q, r = divmod(num_sweeps, n_launch)
    return (q + 1,) * r + (q,) * (n_launch - r)


def model_launch(u, locked, iteration, it_offset: int, num_sweeps: int,
                 geom: Geometry, with_delta: bool = True):
    """One launch of the kernel in ``jnp``: returns ``(u', delta)``.

    Every block's window starts at ``(by * th - k, bx * tw - k)`` and spans
    ``(th + 2k) x (tw + 2k)`` cells; cells outside the grid hold the
    obstacle value and are frozen, as are locked cells and the boundary
    ring. Sweep s (global iteration ``iteration + it_offset + s``) updates
    the unfrozen cells with ``(y + x + t)`` odd at least s + 1 cells inside
    the window; the window's centre tile is written back. ``delta`` is the
    first sweep's max |change| over the centre tiles (0 if not asked)."""
    th, tw, k = geom.th, geom.tw, geom.k
    if not 1 <= num_sweeps <= k:
        raise ValueError(f"a launch runs 1..{k} sweeps, got {num_sweeps}")
    h, w = u.shape
    nty, ntx = -(-h // th), -(-w // tw)
    eh, ew = th + 2 * k, tw + 2 * k
    gy = jnp.arange(h)[:, None]
    gx = jnp.arange(w)[None, :]
    frozen = locked | (gy == 0) | (gy == h - 1) | (gx == 0) | (gx == w - 1)
    pad = ((k, nty * th + k - h), (k, ntx * tw + k - w))
    up = jnp.pad(u, pad, constant_values=np.float32(C.LOG_SPACE_OBSTACLE))
    fp = jnp.pad(frozen, pad, constant_values=True)
    rows = (np.arange(nty) * th)[:, None] + np.arange(eh)[None, :]   # (nty, eh)
    cols = (np.arange(ntx) * tw)[:, None] + np.arange(ew)[None, :]   # (ntx, ew)
    ri = rows[:, None, :, None]
    ci = cols[None, :, None, :]
    win = up[ri, ci]                                   # (nty, ntx, eh, ew)
    live = ~fp[ri, ci][..., 1:-1, 1:-1]
    # Global (y + x) of each window cell, inner part (rows/cols 1..-2).
    gsum = (rows[:, None, 1:-1, None] - k) + (cols[None, :, None, 1:-1] - k)
    lr = np.arange(1, eh - 1)[:, None]
    lc = np.arange(1, ew - 1)[None, :]
    t0 = jnp.asarray(iteration, jnp.int32) + it_offset
    log2n = core._log2n(2)

    def sweep(s, win):
        n0 = win[..., :-2, 1:-1]
        n1 = win[..., 2:, 1:-1]
        n2 = win[..., 1:-1, :-2]
        n3 = win[..., 1:-1, 2:]
        m = jnp.maximum(jnp.maximum(jnp.maximum(n0, n1), n2), n3)
        acc = jnp.exp(n0 - m)
        acc = acc + jnp.exp(n1 - m)
        acc = acc + jnp.exp(n2 - m)
        acc = acc + jnp.exp(n3 - m)
        val = (m + jnp.log(acc)) - log2n
        valid = (lr >= s + 1) & (lr < eh - 1 - s) & (lc >= s + 1) & (lc < ew - 1 - s)
        odd = (gsum + t0 + s) % 2 == 1
        old = win[..., 1:-1, 1:-1]
        new = jnp.where(valid & odd & live, val, old)
        return win.at[..., 1:-1, 1:-1].set(new), jnp.abs(new - old)

    win, change = sweep(0, win)
    delta = jnp.float32(0.0)
    if with_delta:
        delta = jnp.max(change[..., k - 1:k - 1 + th, k - 1:k - 1 + tw])
    win = jax.lax.fori_loop(1, num_sweeps, lambda s, x: sweep(s, x)[0], win)
    tiles = win[:, :, k:k + th, k:k + tw].transpose(0, 2, 1, 3)
    return tiles.reshape(nty * th, ntx * tw)[:h, :w], delta


def _ffi_launch(u, locked, iteration, it_offset: int, num_sweeps: int,
                geom: Geometry, with_delta: bool):
    _register()
    h, w = u.shape
    blocks = -(-h // geom.th) * -(-w // geom.tw)
    out_types = (
        jax.ShapeDtypeStruct(u.shape, jnp.float32),
        jax.ShapeDtypeStruct((), jnp.float32),
        jax.ShapeDtypeStruct((blocks if with_delta else 1,), jnp.float32),
    )
    # One sweep may update in place; a multi-sweep launch must not (blocks
    # read halos that other blocks own).
    aliases = {0: 0} if num_sweeps == 1 else {}
    call = jax.ffi.ffi_call(_TARGET, out_types, input_output_aliases=aliases)
    u_new, delta, _ = call(
        u, locked.astype(jnp.bool_), jnp.asarray(iteration, jnp.int32),
        nsweeps=np.int32(num_sweeps), it_offset=np.int32(it_offset),
        tile_h=np.int32(geom.th), tile_w=np.int32(geom.tw),
        depth=np.int32(geom.k), threads=np.int32(geom.nt),
        with_delta=np.int32(with_delta), log2n=np.float32(core._log2n(2)),
    )
    return u_new, delta


def sweeps(u, locked, iteration, num_sweeps: int, geom: Geometry,
           interpret: bool = False, it_offset: int = 0):
    """``num_sweeps`` sweeps from global iteration ``iteration + it_offset``
    as a chain of launches; returns ``(u', first-sweep delta)``."""
    launch = model_launch if interpret else _ffi_launch
    delta = None
    off = it_offset
    for ns in launch_plan(num_sweeps, geom.k):
        u, d = launch(u, locked, iteration, off, ns, geom, delta is None)
        delta = d if delta is None else delta
        off += ns
    return u, delta


def _geometry(shape, geometry, interpret):
    """The tile geometry to run; the model accepts any, the kernel only its
    compiled ones."""
    if geometry is None:
        return choose_geometry(shape)
    if not interpret and geometry not in GEOMETRIES:
        raise ValueError(f"no compiled kernel for geometry {geometry}")
    return Geometry(*geometry)


@functools.partial(jax.jit, static_argnames=("num_steps", "geometry", "interpret"),
                   donate_argnums=(0,))
def _update_n(state: GridState, num_steps: int, geometry: Geometry,
              interpret: bool) -> GridState:
    u, delta = sweeps(state.u, state.locked, state.iteration, num_steps,
                      geometry, interpret)
    return dataclasses.replace(
        state,
        u=u,
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1 else jnp.asarray(False),
    )


def update_n(state: GridState, num_steps: int, geometry=None,
             interpret: bool = False) -> GridState:
    """``core.update_n`` through the kernel (the input state is donated)."""
    if state.u.ndim != 2:
        raise ValueError(f"the CUDA sweep is 2D only, got {state.u.ndim}D")
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    return _update_n(state, num_steps,
                     _geometry(state.u.shape, geometry, interpret), interpret)


@functools.partial(
    jax.jit,
    static_argnames=("stagger", "max_iterations", "geometry", "interpret"),
    donate_argnums=(0,),
)
def _solve(state: GridState, stagger: int, max_iterations: int,
           geometry: Geometry, interpret: bool) -> GridState:
    m_max = max(state.u.shape)
    locked = state.locked
    epsilon = state.epsilon

    def cond(carry):
        _, iteration, _, converged = carry
        return ~converged & (iteration < max_iterations)

    def body(carry):
        u, iteration, _, _ = carry
        u, delta = sweeps(u, locked, iteration, 1, geometry, interpret)
        done = (delta < epsilon) & (iteration + 1 >= m_max)

        def run_rest(u):
            return sweeps(u, locked, iteration, stagger - 1, geometry,
                          interpret, it_offset=1)[0]

        if stagger > 1:
            u = jax.lax.cond(done, lambda u: u, run_rest, u)
        iteration = iteration + jnp.where(done, 1, stagger)
        return u, iteration, delta, done

    u, iteration, delta, converged = jax.lax.while_loop(
        cond, body, (state.u, jnp.int32(0), epsilon + 1.0, jnp.asarray(False)))
    return dataclasses.replace(state, u=u, iteration=iteration, delta=delta,
                               converged=converged)


def solve(state: GridState, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, geometry=None,
          interpret: bool = False) -> GridState:
    """``core.solve`` through the kernel: same check cadence, exit rule and
    iteration counts (the input state is donated)."""
    if state.u.ndim != 2:
        raise ValueError(f"the CUDA sweep is 2D only, got {state.u.ndim}D")
    return _solve(state, stagger, max_iterations,
                  _geometry(state.u.shape, geometry, interpret), interpret)


# -- the library ---------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA sweep kernel cannot be built")


def build(force: bool = False) -> pathlib.Path:
    """Compile ``cuda/sweep2d.cu`` for sm_90a unless an up-to-date library
    exists. A failed build raises."""
    if (not force and _LIB.exists()
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime):
        return _LIB
    nvcc = _nvcc()
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB.parent)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB


@functools.cache
def _register() -> None:
    import ctypes

    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.EpicSweep2d),
                                platform="CUDA")


if __name__ == "__main__":
    print(build(force=True))
