"""JAX/XLA log-space red-black relaxation — the portable compute path.

This is the functional re-design of the reference's twin CPU/GPU solvers
(/root/reference/libepic/src/harmonic/harmonic_cpu.cpp,
harmonic_gpu.cu): one functional program, jitted for whatever backend is
present (GPU, CPU). The mutable in-place checkerboard update is re-expressed
as a pure ``where``-masked stencil: because a cell's 4 (or 6) neighbours are
always the opposite parity class, the reference's in-place "Gauss-Seidel"
sweep is mathematically a Jacobi update on one parity class per iteration —
purely functional by construction (no __syncthreads hacks, no race windows).

Convergence protocol matches harmonic_complete_cpu (:136-184) exactly,
including the non-obvious part: a converged verdict is forgotten by plain
sweeps, so the loop only exits right after a staggered check at iteration
``c*stagger`` with ``delta < eps`` and ``c*stagger + 1 >= max(shape)``.
The staggered delta check is device-side (no 4-byte D2H per check as in
harmonic_gpu.cu:402); the host reads back one scalar at the very end.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..grid import GridState

@functools.lru_cache(maxsize=8)
def _log2n(nd: int) -> np.float32:
    """log(2n) divisor, f32: log(4) in 2D, log(6) in 3D, log(2n) generally
    (harmonic_cpu.cpp:124 uses 2.0*n universally — correct for any rank)."""
    return np.float32(np.log(np.float64(2.0 * nd)))


def _interior(u: jax.Array) -> tuple:
    return tuple(slice(1, -1) for _ in range(u.ndim))


def _neighbor_logsumexp(u: jax.Array) -> jax.Array:
    """Masked-shift logsumexp of the 2n axis neighbours over the interior.

    Operation order is pinned to the reference update
    (harmonic_cpu.cpp:59-70): max tree over ((N,S),(W,E)), left-associated sum
    of shifted exponentials, log, add max, subtract log(2n). Keeping the order
    identical makes this bit-match the NumPy oracle.
    """
    nd = u.ndim
    nbrs = []
    for axis in range(nd):
        idx_lo = tuple(
            slice(0, -2) if a == axis else slice(1, -1) for a in range(nd)
        )
        idx_hi = tuple(
            slice(2, None) if a == axis else slice(1, -1) for a in range(nd)
        )
        nbrs.append(u[idx_lo])
        nbrs.append(u[idx_hi])
    m = nbrs[0]
    for nb in nbrs[1:]:
        m = jnp.maximum(m, nb)
    s = jnp.exp(nbrs[0] - m)
    for nb in nbrs[1:]:
        s = s + jnp.exp(nb - m)
    return (m + jnp.log(s)) - _log2n(nd)


@functools.lru_cache(maxsize=64)
def _parity_grid(shape: tuple[int, ...]) -> np.ndarray:
    """(sum of interior coordinates) % 2, as uint8, for the interior region."""
    grids = np.meshgrid(*[np.arange(1, s - 1) for s in shape], indexing="ij")
    total = grids[0]
    for g in grids[1:]:
        total = total + g
    return (total % 2).astype(np.uint8)


def sweep(u: jax.Array, locked: jax.Array, iteration: jax.Array):
    """One red-black sweep over the parity class selected by ``iteration``.

    Returns ``(u_new, delta)`` where delta = max |u' - u| over updated cells
    (0 if the parity class is fully locked). Equivalent to
    harmonic_update_{2d,3d}_cpu with checkConvergence=True — computing delta
    is fused into the same pass, so there is no separate "no check"
    kernel; the caller just ignores delta on unchecked sweeps.
    """
    inner = _interior(u)
    val = _neighbor_logsumexp(u)
    parity = jnp.asarray(_parity_grid(u.shape))
    # 2D updates the class != t%2 (harmonic_cpu.cpp:49); 3D's extra x1-even
    # offset negation (harmonic_cpu.cpp:96-99) flips it to == t%2 — i.e. the
    # class != (t+1)%2 (cross-validated vs the prebuilt binary,
    # tests/test_reference_binary.py::test_3d_bounded_sweeps_match_binary).
    # The reference's loop recursion generalizes to flip = ndim % 2 for any
    # rank (reference_np.sweep_scalar_nd derives it; the reference itself
    # stubs 4D out at harmonic_cpu.cpp:193-195).
    flip = u.ndim % 2
    update = (parity != ((iteration + flip) % 2).astype(jnp.uint8)) & ~locked[inner]
    new_inner = jnp.where(update, val, u[inner])
    delta = jnp.max(jnp.abs(new_inner - u[inner]))
    u_new = u.at[inner].set(new_inner)
    return u_new, delta


@functools.partial(jax.jit, static_argnames=("num_steps",), donate_argnums=(0,))
def update_n(state: GridState, num_steps: int) -> GridState:
    """The anytime stepper: ``num_steps`` sweeps, delta checked on the first.

    Functional equivalent of EpicNavigationNodeHarmonic::update
    (epic_navigation_node_harmonic.cpp:165-204): one update-and-check followed
    by ``num_steps - 1`` plain updates. The whole chunk is one XLA program —
    the reference's one-kernel-launch-per-iteration pattern
    (harmonic_gpu.cu:266-290) becomes a single fused device loop.

    NOTE: the input state's buffers are DONATED (the anytime loop is
    zero-copy); the passed-in state must not be used after the call — keep
    only the returned state. Same for :func:`solve`.

    ``num_steps`` must be >= 1 (the reference's update() always sweeps;
    a zero-step call would have no delta to report).
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    u0, delta = sweep(state.u, state.locked, state.iteration)
    converged = delta < state.epsilon

    def body(i, u):
        u_new, _ = sweep(u, state.locked, state.iteration + 1 + i)
        return u_new

    u = jax.lax.fori_loop(0, num_steps - 1, body, u0)
    return dataclasses.replace(
        state,
        u=u,
        iteration=state.iteration + num_steps,
        delta=delta,
        # Matches the reference verdict semantics: if plain sweeps followed
        # the check, the verdict is stale and the loop-level code treats it
        # as informational only. We still record it for observability.
        converged=converged if num_steps == 1 else jnp.asarray(False),
    )


@functools.partial(
    jax.jit,
    static_argnames=("stagger", "max_iterations"),
    donate_argnums=(0,),
)
def solve(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
) -> GridState:
    """Relax to convergence; exact port of harmonic_complete_cpu (:136-184).

    Iteration counting, check cadence, and the exit rule are identical to the
    reference, so final iteration counts (always ≡ 1 mod ``stagger``) and the
    resulting field match the oracle bit-for-bit on the same backend.

    Implementation: an outer ``while_loop`` whose body does one checked sweep
    and then, unless the exit condition fired, ``stagger - 1`` plain sweeps in
    a fused ``fori_loop``. Host sees no scalars until the loop finishes.
    ``currentIteration`` is reset to 0 on entry (harmonic_cpu.cpp:153).
    """
    m_max = max(state.u.shape)
    locked = state.locked
    epsilon = state.epsilon

    def cond(carry):
        _, iteration, _, converged = carry
        return ~converged & (iteration < max_iterations)

    def body(carry):
        u, iteration, _, _ = carry
        u, delta = sweep(u, locked, iteration)
        iteration = iteration + 1
        # Exit is only possible here: delta below eps AND the propagation
        # guard satisfied (harmonic_cpu.cpp:147-158 + loop structure).
        done = (delta < epsilon) & (iteration >= m_max)

        def run_rest(args):
            u, iteration = args

            def inner(i, u):
                u_new, _ = sweep(u, locked, iteration + i)
                return u_new

            u = jax.lax.fori_loop(0, stagger - 1, inner, u)
            return u, iteration + (stagger - 1)

        u, iteration = jax.lax.cond(done, lambda args: args, run_rest, (u, iteration))
        return u, iteration, delta, done

    u, iteration, delta, converged = jax.lax.while_loop(
        cond,
        body,
        (state.u, jnp.int32(0), epsilon + 1.0, jnp.asarray(False)),
    )
    return dataclasses.replace(
        state, u=u, iteration=iteration, delta=delta, converged=converged
    )


def solve_py(
    state: GridState,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    sweep_fn: Callable | None = None,
) -> GridState:
    """Host-driven variant of :func:`solve` (per-chunk dispatch).

    Useful when the caller wants to observe progress (deltas per check) or
    interleave edits; semantics identical to :func:`solve`.
    """
    sweep_fn = sweep_fn or _jit_sweep
    m_max = max(state.u.shape)
    u = state.u
    iteration = 0
    delta = float(state.epsilon) + 1.0
    converged = False
    eps = float(state.epsilon)
    while not converged and iteration < max_iterations:
        u, d = sweep_fn(u, state.locked, jnp.int32(iteration))
        iteration += 1
        delta = float(d)
        if delta < eps and iteration >= m_max:
            converged = True
            break
        u = _run_plain(u, state.locked, jnp.int32(iteration), stagger - 1)
        iteration += stagger - 1
    return dataclasses.replace(
        state,
        u=u,
        iteration=jnp.int32(iteration),
        delta=jnp.float32(delta),
        converged=jnp.asarray(converged),
    )


_jit_sweep = jax.jit(sweep)


@functools.partial(jax.jit, static_argnames=("n",), donate_argnums=(0,))
def _run_plain(u, locked, iteration, n: int):
    def body(i, u):
        u_new, _ = sweep(u, locked, iteration + i)
        return u_new

    return jax.lax.fori_loop(0, n, body, u)
