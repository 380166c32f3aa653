"""Batched multi-scenario solves: vmap over (map, goal-set) lanes.

The reference solves one map at a time on one GPU; the accelerator win is
amortizing a whole batch of scenarios — shared base map with different
goal-sets / obstacle edits, or entirely different maps of one shape — through
the same compiled program (BASELINE.json config 3: 4096 solves/chip).

Per-lane exactness: every lane follows the reference solve protocol
(harmonic_complete_cpu, see :mod:`epic_tpu.solver.core`) independently.
Lanes run in lockstep; a lane "retires" (freezes) the moment its own
staggered check satisfies the exit rule, so its final field and iteration
count equal a solo solve of that lane. The batch finishes when all lanes
have retired.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import core
from ._padding import box_mask


def _sweep_batch(u, locked, iteration):
    """vmapped red-black sweep: u [B, H, W] -> (u', delta [B])."""
    return jax.vmap(core.sweep, in_axes=(0, 0, None))(u, locked, iteration)


def _frozen_batch(locked):
    """locked | ~interior per lane, as one [B, H, W] mask (interior ring
    built on device — see solver/_padding.py)."""
    b, h, w = locked.shape
    return locked | ~box_mask((h, w), (1, 1), (h - 1, w - 1))[None]


def _sweep_batch_rolled(u, frozen, iteration):
    """Roll-based batched sweep (no slice/update ops, fuses cleanly in XLA).

    frozen must include the boundary ring per lane (see _frozen_batch);
    wrap-around roll values only reach frozen cells. Returns (u', delta[B]).
    """
    un = jnp.roll(u, 1, 1)
    us = jnp.roll(u, -1, 1)
    uw = jnp.roll(u, 1, 2)
    ue = jnp.roll(u, -1, 2)
    m = jnp.maximum(jnp.maximum(un, us), jnp.maximum(uw, ue))
    s = ((jnp.exp(un - m) + jnp.exp(us - m)) + jnp.exp(uw - m)) + jnp.exp(ue - m)
    val = (m + jnp.log(s)) - core._LOG2N_2D
    b, h, w = u.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    parity = ((row + col) % 2)[None]
    update = (parity != (iteration % 2)) & ~frozen
    u_new = jnp.where(update, val, u)
    delta = jnp.max(jnp.abs(u_new - u), axis=(1, 2))
    return u_new, delta


@functools.partial(jax.jit, static_argnames=("num_steps",), donate_argnums=(0,))
def update_n_batch_rolled(u, frozen, iteration, num_steps: int):
    """Fused batched chunk on the roll formulation; delta from sweep 0.
    ``frozen`` from :func:`_frozen_batch` (or any mask covering boundaries)."""

    def body(i, carry):
        u, delta = carry
        u, d = _sweep_batch_rolled(u, frozen, iteration + i)
        delta = jnp.where(i == 0, d, delta)
        return u, delta

    b = u.shape[0]
    return jax.lax.fori_loop(
        0, num_steps, body, (u, jnp.zeros((b,), jnp.float32))
    )


@functools.partial(
    jax.jit,
    static_argnames=("stagger", "max_iterations"),
    donate_argnums=(0,),
)
def solve_batch(
    u: jax.Array,
    locked: jax.Array,
    epsilon: float | jax.Array = C.DEFAULT_EPSILON,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
):
    """Solve B scenarios to convergence in lockstep.

    Args:
      u: f32[B, H, W] initial log-potentials.
      locked: bool[B, H, W].
      epsilon: scalar or [B] thresholds.

    Returns (u, iterations[B] i32, delta[B] f32, converged[B] bool).
    """
    b, h, w = u.shape
    m_max = max(h, w)
    epsilon = jnp.broadcast_to(jnp.asarray(epsilon, jnp.float32), (b,))

    def cond(carry):
        _, _, _, retired, t = carry
        return ~jnp.all(retired) & (t < max_iterations)

    def body(carry):
        u, iters, deltas, retired, t = carry
        active = ~retired
        # Check sweep (t % stagger == 0 by construction of the loop).
        u_new, d = _sweep_batch(u, locked, t)
        u = jnp.where(active[:, None, None], u_new, u)
        deltas = jnp.where(active, d, deltas)
        t1 = t + 1
        iters = jnp.where(active, t1, iters)
        just_done = active & (d < epsilon) & (t1 >= m_max)
        retired = retired | just_done
        active = ~retired

        # stagger - 1 plain sweeps for still-active lanes.
        def inner(i, carry):
            u, iters = carry
            u_new, _ = _sweep_batch(u, locked, t1 + i)
            u = jnp.where(active[:, None, None], u_new, u)
            iters = jnp.where(active, t1 + i + 1, iters)
            return u, iters

        u, iters = jax.lax.fori_loop(0, stagger - 1, inner, (u, iters))
        return u, iters, deltas, retired, t + stagger

    u, iters, deltas, retired, _ = jax.lax.while_loop(
        cond,
        body,
        (
            u,
            jnp.zeros((b,), jnp.int32),
            epsilon + 1.0,
            jnp.zeros((b,), bool),
            jnp.int32(0),
        ),
    )
    return u, iters, deltas, retired


@functools.partial(jax.jit, static_argnames=("num_steps",), donate_argnums=(0,))
def update_n_batch(u, locked, iteration, num_steps: int):
    """Batched anytime chunk: num_steps sweeps, per-lane delta from sweep 0."""

    def body(i, carry):
        u, delta = carry
        u, d = _sweep_batch(u, locked, iteration + i)
        delta = jnp.where(i == 0, d, delta)
        return u, delta

    b = u.shape[0]
    return jax.lax.fori_loop(
        0, num_steps, body, (u, jnp.zeros((b,), jnp.float32))
    )


def batch_from_goal_sets(
    base_img: np.ndarray, goal_sets: list[list[tuple[int, int]]]
):
    """Build a (u, locked) batch from one occupancy image and B goal-sets.

    The base image supplies obstacles/free space (its own 255-goals are
    ignored); each lane gets its goal cells from ``goal_sets`` — the batched
    ModifyGoals scenario (SURVEY §6 workloads).
    """
    img = np.asarray(base_img)
    obstacle = img == 0
    u0 = np.full(img.shape, C.LOG_SPACE_FREE, np.float32)
    u0[obstacle] = C.LOG_SPACE_OBSTACLE
    b = len(goal_sets)
    u = np.tile(u0, (b, 1, 1))
    locked = np.tile(obstacle, (b, 1, 1))
    h, w = img.shape
    for lane, goals in enumerate(goal_sets):
        for gx, gy in goals:
            # Skip out-of-range goals like grid.set_cells / the reference do
            # (harmonic_utilities_cpu.cpp:50-55); negative indices must not
            # wrap to the opposite edge.
            if not (0 <= gx < w and 0 <= gy < h):
                continue
            if obstacle[gy, gx]:
                continue
            u[lane, gy, gx] = C.LOG_SPACE_GOAL
            locked[lane, gy, gx] = True
    return jnp.asarray(u), jnp.asarray(locked)
