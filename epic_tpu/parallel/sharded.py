"""Multi-chip spatial domain decomposition: shard_map + halo exchange.

The reference is strictly single-GPU — the whole grid must fit one device
(harmonic_model_gpu.cu:76-106). The scaling analog here (SURVEY §5,
"long-context analog") is 2D spatial decomposition over a device Mesh:

- the grid is sharded P('my', 'mx') across a 2D mesh;
- K sweeps need a K-deep halo from each neighbour, exchanged with
  ``jax.lax.ppermute`` once per K sweeps (NVLink between the cards of one
  host; across hosts when ``jax.distributed`` is initialised);
- the staggered convergence check is a ``jax.lax.pmax`` of the local deltas —
  replacing the reference's two-stage shared-memory block reduction plus
  4-byte D2H copy (harmonic_gpu.cu:113-153, 402);
- the solve protocol (exit right after a check iteration with delta < eps and
  iter >= max(H, W)) is bit-identical to the single-chip path.

Update numerics are pinned to the oracle exactly as in
:mod:`epic_tpu.solver.core`; a sharded solve equals the single-device solve
to float tolerance (tested on a virtual 8-device CPU mesh). The per-shard
sweep is XLA on every platform (``solver.route`` with ``sharded=True``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..grid import GridState

from ..solver import route
from ..solver._padding import box_mask
from ..solver.core import _log2n


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A 2D ('my', 'mx') mesh. Default: all devices in a near-square grid."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if shape is None:
        my = int(np.floor(np.sqrt(n)))
        while n % my:
            my -= 1
        shape = (my, n // my)
    return Mesh(devices.reshape(shape), ("my", "mx"))


def _neighbor_perm(n: int, direction: int):
    """Non-wrapping shift permutation: direction +1 sends shard j -> j+1."""
    if direction > 0:
        return [(j, j + 1) for j in range(n - 1)]
    return [(j, j - 1) for j in range(1, n)]


def _exchange_halos_k(u: jax.Array, mesh: Mesh, k: int):
    """Fetch K-deep halos (including corners) via a two-phase exchange.

    Phase 1 extends vertically with the K boundary rows of the my-neighbours;
    phase 2 exchanges K-column strips of the *already row-extended* arrays,
    so the mx-neighbours' strips carry the diagonal (corner) blocks a K-sweep
    dependency cone needs. One ppermute pair per axis per K sweeps instead
    of one per sweep.

    Out-of-mesh halos arrive as zeros; callers mask them via the frozen
    exchange (inverted convention, see _exchange_frozen_k) so they are never
    written, and the global frozen boundary ring stops any read of them.
    """
    nmy = mesh.shape["my"]
    nmx = mesh.shape["mx"]
    north = jax.lax.ppermute(u[-k:, :], "my", _neighbor_perm(nmy, +1))
    south = jax.lax.ppermute(u[:k, :], "my", _neighbor_perm(nmy, -1))
    rows = jnp.concatenate([north, u, south], axis=0)
    west = jax.lax.ppermute(rows[:, -k:], "mx", _neighbor_perm(nmx, +1))
    east = jax.lax.ppermute(rows[:, :k], "mx", _neighbor_perm(nmx, -1))
    return jnp.concatenate([west, rows, east], axis=1)


def _exchange_frozen_k(frozen: jax.Array, mesh: Mesh, k: int):
    """Extended frozen mask: exchanged as 'unfrozen' int32 so ppermute's
    zero-fill marks out-of-mesh cells frozen."""
    unfrozen = (~frozen).astype(jnp.int32)
    ext = _exchange_halos_k(unfrozen, mesh, k)
    return ext == 0


def _sweep_k_local(u_ext, frozen_ext, parity_ext, it0, num_sweeps, k):
    """num_sweeps (<= k) sweeps on the K-extended local block.

    The valid region shrinks one cell per side per sweep (temporal-blocking
    trapezoid); the center block is exact after num_sweeps sweeps. Delta is
    recorded from sweep 0 over that sweep's valid updated cells — halo-band
    updates duplicate the owning shard's own arithmetic, so the cross-shard
    pmax equals the global staggered-check delta exactly.
    """
    he, we = u_ext.shape
    lr = jax.lax.broadcasted_iota(jnp.int32, (he, we), 0)
    lc = jax.lax.broadcasted_iota(jnp.int32, (he, we), 1)
    not_frozen = ~frozen_ext

    def sweep(s, u):
        un = jnp.roll(u, 1, 0)
        us = jnp.roll(u, -1, 0)
        uw = jnp.roll(u, 1, 1)
        ue = jnp.roll(u, -1, 1)
        m = jnp.maximum(jnp.maximum(un, us), jnp.maximum(uw, ue))
        ssum = ((jnp.exp(un - m) + jnp.exp(us - m)) + jnp.exp(uw - m)) + jnp.exp(ue - m)
        val = (m + jnp.log(ssum)) - _log2n(2)
        valid = (lr >= s + 1) & (lr < he - 1 - s) & (lc >= s + 1) & (lc < we - 1 - s)
        # Wait-free edge case: with k == num_sweeps the first sweep's valid
        # ring starts one cell inside the extension, so roll wrap-around
        # values are never read by a valid updated cell.
        update = (parity_ext != ((it0 + s) % 2)) & not_frozen & valid
        return jnp.where(update, val, u)

    u1 = sweep(0, u_ext)
    delta = jnp.max(jnp.abs(u1 - u_ext))
    u_out = jax.lax.fori_loop(1, num_sweeps, sweep, u1)
    return u_out, delta


def _local_parity_ext(shape_local, mesh, k):
    """Global (y + x) % 2 for this shard's K-extended block; the extension
    shifts local coordinates by -k on both axes ((-k) ≡ k mod 2)."""
    h, w = shape_local
    iy = jax.lax.axis_index("my") * h
    ix = jax.lax.axis_index("mx") * w
    row = jax.lax.broadcasted_iota(jnp.int32, (h + 2 * k, w + 2 * k), 0) + iy + k
    col = jax.lax.broadcasted_iota(jnp.int32, (h + 2 * k, w + 2 * k), 1) + ix + k
    return (row + col) % 2


@functools.partial(jax.jit, static_argnames=("h", "w"))
def _frozen_arrays(locked, h: int, w: int):
    # Device-built boundary ring — a host mask upload here cost a
    # full-grid H2D per update call (see solver/_padding.py).
    return locked | ~box_mask((h, w), (1, 1), (h - 1, w - 1))


def _frozen_mask(state: GridState) -> jax.Array:
    h, w = state.u.shape
    return _frozen_arrays(state.locked, h, w)


def padded_shape(shape: tuple[int, int], mesh: Mesh) -> tuple[int, int]:
    h, w = shape
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    return (-(-h // nmy) * nmy, -(-w // nmx) * nmx)


def _pad_for_mesh(state: GridState, mesh: Mesh):
    h, w = state.u.shape
    hp, wp = padded_shape((h, w), mesh)
    u = jnp.pad(state.u, ((0, hp - h), (0, wp - w)),
                constant_values=np.float32(C.LOG_SPACE_OBSTACLE))
    frozen = jnp.pad(_frozen_mask(state), ((0, hp - h), (0, wp - w)),
                     constant_values=True)
    return u, frozen


# Default K: sweeps per halo exchange. Amortizes the exchange 16x over a
# per-sweep exchange; halo redundancy is 2K cells per axis per shard.
DEFAULT_CHUNK_DEPTH = 16


def _check_route(shape) -> None:
    """The sharded path is XLA on every platform route.choose accepts; an
    unsupported platform raises here."""
    route.choose(route.platform(), shape, sharded=True)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "num_steps", "chunk_depth"),
    donate_argnums=(0,),
)
def _update_n_sharded(
    u, frozen, iteration, mesh: Mesh, num_steps: int,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
):
    """num_steps sweeps as ceil(num_steps / chunk_depth) halo-exchange
    rounds; delta (pmax-reduced) from the overall first sweep."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("my", "mx"), P("my", "mx"), P()),
        out_specs=(P("my", "mx"), P()),
    )
    def run(u_loc, frozen_loc, it0):
        # Halo depth cannot exceed the local block extent.
        h_loc, w_loc = u_loc.shape
        depth = min(chunk_depth, h_loc, w_loc)
        # The frozen mask is static within the call: exchange its halos ONCE
        # at full depth and slice for shallower remainder chunks, instead of
        # paying a ppermute pair per chunk.
        frozen_full = _exchange_frozen_k(frozen_loc, mesh, depth)

        def chunk(u_loc, it, k):
            """One exchange at depth k + k local sweeps (k static)."""
            u_ext = _exchange_halos_k(u_loc, mesh, k)
            d0 = depth - k
            frozen_ext = frozen_full[d0 : d0 + h_loc + 2 * k,
                                     d0 : d0 + w_loc + 2 * k]
            parity_ext = _local_parity_ext(u_loc.shape, mesh, k)
            u_ext, d = _sweep_k_local(u_ext, frozen_ext, parity_ext, it, k, k)
            return u_ext[k:-k, k:-k], d

        # First chunk carries the staggered-check delta; remaining full
        # chunks run through a fori over ONE call site, plus one remainder.
        d1 = min(depth, num_steps)
        u_loc, delta = chunk(u_loc, it0, d1)
        n_full, rem = divmod(num_steps - d1, depth)

        def body(i, carry):
            u_loc, it = carry
            u_loc, _ = chunk(u_loc, it, depth)
            return u_loc, it + depth

        u_loc, it = jax.lax.fori_loop(0, n_full, body, (u_loc, it0 + d1))
        if rem:
            u_loc, _ = chunk(u_loc, it, rem)
        delta = jax.lax.pmax(jax.lax.pmax(delta, "my"), "mx")
        return u_loc, delta.reshape(1)

    u, delta = run(u, frozen, iteration)
    return u, delta[0]


# ---------------------------------------------------------------------------
# Sharded anytime state: keep the padded arrays resident on the mesh across
# warm-started update/edit cycles (SURVEY "warm-start under sharding"):
# edits are scatters into the sharded arrays, never a full re-layout.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedGrid:
    """Mesh-resident padded grid state for the sharded anytime loop."""

    u: jax.Array          # f32[Hp, Wp], sharded P('my','mx')
    frozen: jax.Array     # bool[Hp, Wp], sharded
    iteration: jax.Array
    delta: jax.Array
    epsilon: jax.Array
    height: int = dataclasses.field(metadata=dict(static=True))
    width: int = dataclasses.field(metadata=dict(static=True))


def shard_state(state: GridState, mesh: Mesh) -> ShardedGrid:
    """Pad + place a GridState on the mesh once; later updates and edits
    keep the buffers resident."""
    h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, P("my", "mx"))
    # Scalars are committed to the mesh as replicated arrays: solver verbs
    # return mesh-committed scalars, and a fresh-vs-post-solve mismatch in
    # the iteration's committed-ness changes the tick jit's cache key — a
    # hidden recompile on the first tick after a solve.
    rep = NamedSharding(mesh, P())
    return ShardedGrid(
        u=jax.device_put(u, sharding),
        frozen=jax.device_put(frozen, sharding),
        iteration=jax.device_put(jnp.asarray(state.iteration, jnp.int32),
                                 rep),
        delta=jax.device_put(jnp.asarray(state.delta, jnp.float32), rep),
        epsilon=jax.device_put(jnp.asarray(state.epsilon, jnp.float32),
                               rep),
        height=h,
        width=w,
    )


def unshard(sh: ShardedGrid) -> GridState:
    """Gather back to a host-side GridState (e.g. for path extraction).

    The boundary ring comes back locked (the sharded representation folds
    ``locked | ~interior`` into one mask, and the service plane forces
    boundary walls anyway — setBoundariesAsObstacles,
    epic_navigation_node_harmonic.cpp:282-307)."""
    import numpy as _np

    u = _np.asarray(sh.u)[: sh.height, : sh.width]
    locked = _np.asarray(sh.frozen)[: sh.height, : sh.width]
    return GridState(
        u=jnp.asarray(u),
        locked=jnp.asarray(locked),
        iteration=sh.iteration,
        delta=sh.delta,
        converged=jnp.asarray(False),
        epsilon=sh.epsilon,
    )


def update_n_resident(
    sh: ShardedGrid, num_steps: int, mesh: Mesh,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
) -> ShardedGrid:
    """Anytime chunk on a mesh-resident state: no re-pad, no re-upload;
    the sharded buffers are donated across ticks."""
    _check_route((sh.height, sh.width))
    u, delta = _update_n_sharded(
        sh.u, sh.frozen, sh.iteration, mesh, num_steps, chunk_depth)
    return dataclasses.replace(
        sh, u=u, iteration=sh.iteration + num_steps, delta=delta
    )


def solve_resident(
    sh: ShardedGrid, mesh: Mesh,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
):
    """Blocking solve-to-convergence directly ON the mesh-resident
    buffers (the MeshPlanner srvComputePath path): the padded sharded
    arrays feed the sharded solve loop and come back resident, with no
    re-pad and no re-shard. Returns ``(sh', converged)``."""
    _check_route((sh.height, sh.width))
    u, iteration, delta, converged = _solve_sharded(
        sh.u, sh.frozen, sh.epsilon, mesh, stagger, max_iterations,
        sh.height, sh.width, chunk_depth)
    return dataclasses.replace(sh, u=u, iteration=iteration,
                               delta=delta), converged


def set_cells_resident(sh: ShardedGrid, xy, types) -> ShardedGrid:
    """SetCells on the sharded arrays (harmonic_utilities semantics: skip
    invalid, last-wins on duplicates — shared preprocessing with
    grid.set_cells): a scatter into the resident buffers — XLA routes the
    updates to the owning shards, no re-layout.

    Values on the boundary ring are written like the reference's (a GOAL on
    the ring influences interior neighbors), but ring cells stay frozen in
    the sharded mask: no solver path ever updates ring cells (the reference
    loops x=1..m-2, harmonic_cpu.cpp:46-51), and an unfrozen ring cell would
    read out-of-mesh halo fill."""
    from .. import grid as G

    xy, u_vals, locked_vals = G.sanitize_cell_edits(
        xy, types, sh.width, sh.height
    )
    if xy.shape[0] == 0:
        return sh
    on_ring = (
        (xy[:, 0] == 0) | (xy[:, 0] == sh.width - 1)
        | (xy[:, 1] == 0) | (xy[:, 1] == sh.height - 1)
    )
    f_vals = locked_vals | on_ring
    ys = jnp.asarray(xy[:, 1])
    xs = jnp.asarray(xy[:, 0])
    return dataclasses.replace(
        sh,
        u=sh.u.at[ys, xs].set(jnp.asarray(u_vals)),
        frozen=sh.frozen.at[ys, xs].set(jnp.asarray(f_vals)),
    )


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> GridState:
    """Sharded anytime chunk; semantics of core.update_n on a device mesh."""
    _check_route(state.u.shape)
    h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, P("my", "mx"))
    u = jax.device_put(u, sharding)
    frozen = jax.device_put(frozen, sharding)
    u, delta = _update_n_sharded(u, frozen, state.iteration, mesh, num_steps,
                                 chunk_depth)
    return dataclasses.replace(
        state,
        u=u[:h, :w],
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1 else jnp.asarray(False),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "stagger", "max_iterations", "height", "width",
                     "chunk_depth"),
    donate_argnums=(0,),
)
def _solve_sharded(
    u, frozen, epsilon, mesh: Mesh, stagger: int, max_iterations: int,
    height: int, width: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
):
    m_max = max(height, width)

    def cond(carry):
        _, iteration, _, converged = carry
        return ~converged & (iteration < max_iterations)

    def body(carry):
        u, iteration, _, _ = carry
        u, delta = _update_n_sharded.__wrapped__(
            u, frozen, iteration, mesh, 1, chunk_depth
        )
        iteration = iteration + 1
        done = (delta < epsilon) & (iteration >= m_max)

        def run_rest(args):
            u, iteration = args
            u, _ = _update_n_sharded.__wrapped__(
                u, frozen, iteration, mesh, stagger - 1, chunk_depth
            )
            return u, iteration + (stagger - 1)

        u, iteration = jax.lax.cond(done, lambda a: a, run_rest, (u, iteration))
        return u, iteration, delta, done

    return jax.lax.while_loop(
        cond, body, (u, jnp.int32(0), epsilon + 1.0, jnp.asarray(False))
    )


def solve(
    state: GridState,
    mesh: Mesh,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
) -> GridState:
    """Sharded solve-to-convergence; protocol identical to core.solve."""
    _check_route(state.u.shape)
    h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, P("my", "mx"))
    u = jax.device_put(u, sharding)
    frozen = jax.device_put(frozen, sharding)
    u, iteration, delta, converged = _solve_sharded(
        u, frozen, state.epsilon, mesh, stagger, max_iterations, h, w,
        chunk_depth,
    )
    return dataclasses.replace(
        state,
        u=u[:h, :w],
        iteration=iteration,
        delta=delta,
        converged=converged,
    )
