"""Multi-chip spatial decomposition of 3D volumes: shard_map + halo exchange.

The reference cannot scale 3D at all — its 3D solver is a scalar CPU loop
(/root/reference/libepic/src/harmonic/harmonic_cpu.cpp:81-133) and its CUDA
path refuses 3D outright (harmonic_gpu.cu:158-165). This module carries the
2D decomposition (:mod:`epic_tpu.parallel.sharded`) to volumes:

- ``u[D, H, W]`` is sharded ``P(None, 'my', 'mx')`` — every shard holds the
  FULL depth of its (y, x) tile, so the z-neighbour reads of the 6-point
  stencil are always local and only y/x halos cross the mesh. (Depth is the
  small axis of typical volumes; the plane axes carry the parallelism.)
- DEEP volumes (z >> plane) can shard the depth too: a mesh built with
  :func:`make_mesh3d` carries an extra ``'mz'`` axis and the same entry
  points run ``P('mz', 'my', 'mx')`` with a three-phase halo exchange and a
  z-shrinking validity trapezoid (the 2D analog applied to all three axes).
- K-deep halos ride the same multi-phase exchange as 2D (each later axis
  exchanges strips of the already-extended array, so corner blocks arrive
  transitively), one ``ppermute`` pair per axis per K sweeps.
- The staggered-check delta is a cross-shard ``pmax``; the solve protocol
  (exit right after a check sweep with delta < eps and iter >= max(dims))
  is identical to :mod:`epic_tpu.solver.core`.

Per-shard compute: the XLA 6-neighbour sweep with a y/x-shrinking validity
trapezoid (z never shrinks unless the mesh shards it), on every platform
(``solver.route`` with ``sharded=True``).

A sharded solve equals the single-device solve bit/tolerance-exactly
(tested on virtual 8-device CPU meshes, tests/test_sharded3d.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.sharding import Mesh

from .. import constants as C
from ..grid import GridState
from .sharded import _neighbor_perm, make_mesh  # noqa: F401  (re-export mesh helper)

from ..solver import route
from ..solver._padding import box_mask
from ..solver.core import _log2n


def make_mesh3d(shape: tuple[int, int, int] | None = None, devices=None) -> Mesh:
    """A 3-axis ('mz', 'my', 'mx') mesh for deep volumes (z sharded too).

    Default: all devices on the z axis (deep volumes are z-dominant, so
    depth carries the parallelism); pass an explicit shape to mix axes."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size, 1, 1)
    return Mesh(devices.reshape(shape), ("mz", "my", "mx"))


def choose_mesh3d(shape: tuple[int, int, int], devices=None) -> Mesh:
    """Pick the mesh orientation for a volume: all devices on z when the
    volume has at least one plane per device (every card keeps whole
    planes, and one halo exchange per chunk moves one contiguous slab),
    else the near-square plane mesh of :func:`make_mesh`."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if shape[0] >= n:
        return make_mesh3d((n, 1, 1), devices=devices)
    my = int(np.floor(np.sqrt(n)))
    while n % my:
        my -= 1
    return make_mesh((my, n // my), devices=devices)


def _has_z(mesh: Mesh) -> bool:
    return "mz" in mesh.shape


def _exchange_halos_k(u: jax.Array, mesh: Mesh, k: int):
    """K-deep halos (including corners) for a rank-3 [D, h, w] block via
    the multi-phase exchange (sharded.py:_exchange_halos_k, one rank up).
    Meshes with an 'mz' axis exchange z-slabs first; the later y/x phases
    move strips of the already-z-extended array, so z-corners arrive
    transitively."""
    if _has_z(mesh):
        nmz = mesh.shape["mz"]
        zlo = jax.lax.ppermute(u[-k:, :, :], "mz", _neighbor_perm(nmz, +1))
        zhi = jax.lax.ppermute(u[:k, :, :], "mz", _neighbor_perm(nmz, -1))
        u = jnp.concatenate([zlo, u, zhi], axis=0)
    nmy = mesh.shape["my"]
    nmx = mesh.shape["mx"]
    north = jax.lax.ppermute(u[:, -k:, :], "my", _neighbor_perm(nmy, +1))
    south = jax.lax.ppermute(u[:, :k, :], "my", _neighbor_perm(nmy, -1))
    rows = jnp.concatenate([north, u, south], axis=1)
    west = jax.lax.ppermute(rows[:, :, -k:], "mx", _neighbor_perm(nmx, +1))
    east = jax.lax.ppermute(rows[:, :, :k], "mx", _neighbor_perm(nmx, -1))
    return jnp.concatenate([west, rows, east], axis=2)


def _exchange_frozen_k(frozen: jax.Array, mesh: Mesh, k: int):
    """Extended frozen mask, exchanged as 'unfrozen' so ppermute's zero-fill
    marks out-of-mesh cells frozen."""
    unfrozen = (~frozen).astype(jnp.int32)
    ext = _exchange_halos_k(unfrozen, mesh, k)
    return ext == 0


def _sweep_k_local(u_ext, frozen_ext, parity_ext, it0, num_sweeps,
                   z_sharded: bool = False):
    """num_sweeps (<= k) 6-neighbour sweeps on the extended local block.

    The y/x validity ring shrinks one cell per side per sweep; depth shrinks
    too iff the mesh shards z (otherwise z-neighbours are resident and the
    full depth stays valid). Delta comes from sweep 0 — halo updates
    duplicate the owning shard's arithmetic, so the cross-shard pmax equals
    the global staggered-check delta exactly.
    """
    d, he, we = u_ext.shape
    ly = jax.lax.broadcasted_iota(jnp.int32, (d, he, we), 1)
    lx = jax.lax.broadcasted_iota(jnp.int32, (d, he, we), 2)
    lz = jax.lax.broadcasted_iota(jnp.int32, (d, he, we), 0)
    not_frozen = ~frozen_ext

    def sweep(s, u):
        uzm = jnp.roll(u, 1, 0)
        uzp = jnp.roll(u, -1, 0)
        uym = jnp.roll(u, 1, 1)
        uyp = jnp.roll(u, -1, 1)
        uxm = jnp.roll(u, 1, 2)
        uxp = jnp.roll(u, -1, 2)
        m = jnp.maximum(uzm, uzp)
        m = jnp.maximum(m, uym)
        m = jnp.maximum(m, uyp)
        m = jnp.maximum(m, uxm)
        m = jnp.maximum(m, uxp)
        ssum = jnp.exp(uzm - m)
        ssum = ssum + jnp.exp(uzp - m)
        ssum = ssum + jnp.exp(uym - m)
        ssum = ssum + jnp.exp(uyp - m)
        ssum = ssum + jnp.exp(uxm - m)
        ssum = ssum + jnp.exp(uxp - m)
        val = (m + jnp.log(ssum)) - _log2n(3)
        valid = (ly >= s + 1) & (ly < he - 1 - s) & (lx >= s + 1) & (lx < we - 1 - s)
        if z_sharded:
            valid &= (lz >= s + 1) & (lz < d - 1 - s)
        # 3D updates the class == t%2 (reference_np.sweep_3d parity note).
        update = (parity_ext != ((it0 + s + 1) % 2)) & not_frozen & valid
        return jnp.where(update, val, u)

    u1 = sweep(0, u_ext)
    delta = jnp.max(jnp.abs(u1 - u_ext))
    u_out = jax.lax.fori_loop(1, num_sweeps, sweep, u1)
    return u_out, delta


def _local_parity_ext(shape_local, mesh, k):
    """Global (z + y + x) % 2 for the extended block ((-k) ≡ k mod 2)."""
    d, h, w = shape_local
    zsh = _has_z(mesh)
    de = d + 2 * k if zsh else d
    iy = jax.lax.axis_index("my") * h
    ix = jax.lax.axis_index("mx") * w
    lz = jax.lax.broadcasted_iota(jnp.int32, (de, h + 2 * k, w + 2 * k), 0)
    if zsh:
        lz = lz + jax.lax.axis_index("mz") * d + k
    ly = jax.lax.broadcasted_iota(jnp.int32, (de, h + 2 * k, w + 2 * k), 1) + iy + k
    lx = jax.lax.broadcasted_iota(jnp.int32, (de, h + 2 * k, w + 2 * k), 2) + ix + k
    return (lz + ly + lx) % 2


@functools.partial(jax.jit, static_argnames=("d", "h", "w"))
def _frozen_arrays(locked, d: int, h: int, w: int):
    # Device-built boundary shell — a host mask upload here cost a
    # full-volume H2D per update call (see solver/_padding.py).
    return locked | ~box_mask((d, h, w), (1, 1, 1), (d - 1, h - 1, w - 1))


def _frozen_mask(state: GridState) -> jax.Array:
    d, h, w = state.u.shape
    return _frozen_arrays(state.locked, d, h, w)


def padded_shape(shape, mesh: Mesh):
    d, h, w = shape
    nmz = mesh.shape["mz"] if _has_z(mesh) else 1
    nmy, nmx = mesh.shape["my"], mesh.shape["mx"]
    return (-(-d // nmz) * nmz, -(-h // nmy) * nmy, -(-w // nmx) * nmx)


def _pad_for_mesh(state: GridState, mesh: Mesh):
    d, h, w = state.u.shape
    dp, hp, wp = padded_shape((d, h, w), mesh)
    u = jnp.pad(state.u, ((0, dp - d), (0, hp - h), (0, wp - w)),
                constant_values=np.float32(C.LOG_SPACE_OBSTACLE))
    frozen = jnp.pad(_frozen_mask(state), ((0, dp - d), (0, hp - h), (0, wp - w)),
                     constant_values=True)
    return u, frozen


def _spec(mesh: Mesh):
    return P("mz", "my", "mx") if _has_z(mesh) else P(None, "my", "mx")


def _pmax(x, mesh: Mesh):
    if _has_z(mesh):
        x = jax.lax.pmax(x, "mz")
    return jax.lax.pmax(jax.lax.pmax(x, "my"), "mx")


DEFAULT_CHUNK_DEPTH = 8


def _check_route(shape) -> None:
    """The sharded 3D path is XLA on every platform route.choose accepts."""
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
    """num_steps 3D sweeps as ceil(num_steps / chunk_depth) halo-exchange
    rounds; delta (pmax-reduced) from the overall first sweep."""
    zsh = _has_z(mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(_spec(mesh), _spec(mesh), P()),
        out_specs=(_spec(mesh), P()),
    )
    def run(u_loc, frozen_loc, it0):
        d, h_loc, w_loc = u_loc.shape
        depth = min(chunk_depth, h_loc, w_loc)
        if zsh:
            depth = min(depth, d)
        frozen_full = _exchange_frozen_k(frozen_loc, mesh, depth)

        def chunk(u_loc, it, k):
            u_ext = _exchange_halos_k(u_loc, mesh, k)
            d0 = depth - k
            zs = slice(d0, d0 + d + 2 * k) if zsh else slice(None)
            frozen_ext = frozen_full[zs, d0 : d0 + h_loc + 2 * k,
                                     d0 : d0 + w_loc + 2 * k]
            parity_ext = _local_parity_ext(u_loc.shape, mesh, k)
            u_ext, dd = _sweep_k_local(u_ext, frozen_ext, parity_ext, it, k, zsh)
            zc = slice(k, -k) if zsh else slice(None)
            return u_ext[zc, k:-k, k:-k], dd

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
        delta = _pmax(delta, mesh)
        return u_loc, delta.reshape(1)

    u, delta = run(u, frozen, iteration)
    return u, delta[0]


# ---------------------------------------------------------------------------
# Mesh-resident 3D anytime state (the 2D ShardedGrid pattern for volumes):
# padded arrays stay resident on the mesh across warm-started update/edit
# cycles; edits are scatters into the sharded arrays, never a re-layout.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedVolume:
    """Mesh-resident padded 3D state for the sharded anytime loop."""

    u: jax.Array          # f32[Dp, Hp, Wp], sharded _spec(mesh)
    frozen: jax.Array     # bool[Dp, Hp, Wp], sharded
    iteration: jax.Array
    delta: jax.Array
    epsilon: jax.Array
    depth: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    width: int = dataclasses.field(metadata=dict(static=True))


def shard_state3d(state: GridState, mesh: Mesh) -> ShardedVolume:
    """Pad + place a 3D GridState on the mesh once; later updates and
    edits keep the buffers resident."""
    d, h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, _spec(mesh))
    # Commit the scalars to the mesh (replicated) — see shard_state: a
    # committed-ness mismatch between fresh and post-solve scalars
    # recompiles the tick jit.
    rep = NamedSharding(mesh, P())
    return ShardedVolume(
        u=jax.device_put(u, sharding),
        frozen=jax.device_put(frozen, sharding),
        iteration=jax.device_put(jnp.asarray(state.iteration, jnp.int32),
                                 rep),
        delta=jax.device_put(jnp.asarray(state.delta, jnp.float32), rep),
        epsilon=jax.device_put(jnp.asarray(state.epsilon, jnp.float32),
                               rep),
        depth=d, height=h, width=w,
    )


def unshard3d(sv: ShardedVolume) -> GridState:
    """Gather back to a host-side GridState (e.g. for path extraction).
    The boundary faces come back locked (the sharded representation folds
    ``locked | ~interior`` into one mask)."""
    import numpy as _np

    u = _np.asarray(sv.u)[: sv.depth, : sv.height, : sv.width]
    locked = _np.asarray(sv.frozen)[: sv.depth, : sv.height, : sv.width]
    return GridState(
        u=jnp.asarray(u),
        locked=jnp.asarray(locked),
        iteration=sv.iteration,
        delta=sv.delta,
        converged=jnp.asarray(False),
        epsilon=sv.epsilon,
    )


def set_cells_resident3d(sv: ShardedVolume, xyz, types) -> ShardedVolume:
    """SetCells on the sharded volume (skip-invalid, last-wins — shared
    preprocessing with grid.set_cells_3d): a scatter into the resident
    buffers. Values on the boundary faces are written like the
    reference's, but face voxels stay frozen in the sharded mask (no
    solver path updates faces, and an unfrozen face would read
    out-of-mesh halo fill — the 2D set_cells_resident rule)."""
    from .. import grid as G

    xyz, u_vals, locked_vals = G.sanitize_cell_edits_3d(
        xyz, types, sv.width, sv.height, sv.depth
    )
    if xyz.shape[0] == 0:
        return sv
    on_face = (
        (xyz[:, 0] == 0) | (xyz[:, 0] == sv.width - 1)
        | (xyz[:, 1] == 0) | (xyz[:, 1] == sv.height - 1)
        | (xyz[:, 2] == 0) | (xyz[:, 2] == sv.depth - 1)
    )
    f_vals = locked_vals | on_face
    zs = jnp.asarray(xyz[:, 2])
    ys = jnp.asarray(xyz[:, 1])
    xs = jnp.asarray(xyz[:, 0])
    return dataclasses.replace(
        sv,
        u=sv.u.at[zs, ys, xs].set(jnp.asarray(u_vals)),
        frozen=sv.frozen.at[zs, ys, xs].set(jnp.asarray(f_vals)),
    )


def update_n_resident3d(
    sv: ShardedVolume, num_steps: int, mesh: Mesh,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
) -> ShardedVolume:
    """Anytime chunk on a mesh-resident volume: no re-pad, no re-upload;
    the sharded buffers are donated across ticks."""
    _check_route((sv.depth, sv.height, sv.width))
    u, delta = _update_n_sharded(
        sv.u, sv.frozen, sv.iteration, mesh, num_steps, chunk_depth)
    return dataclasses.replace(
        sv, u=u, iteration=sv.iteration + num_steps, delta=delta
    )


def solve_resident3d(
    sv: ShardedVolume, mesh: Mesh,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    chunk_depth: int = DEFAULT_CHUNK_DEPTH,
):
    """Blocking solve-to-convergence directly ON the mesh-resident volume
    buffers (the 2D sharded.solve_resident pattern). Returns
    ``(sv', converged)``."""
    dims = (sv.depth, sv.height, sv.width)
    _check_route(dims)
    u, iteration, delta, converged = _solve_sharded(
        sv.u, sv.frozen, sv.epsilon, mesh, stagger, max_iterations, dims,
        chunk_depth)
    return dataclasses.replace(sv, u=u, iteration=iteration,
                               delta=delta), converged


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> GridState:
    """Sharded 3D anytime chunk; semantics of core.update_n on a mesh."""
    _check_route(state.u.shape)
    d, h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, _spec(mesh))
    u = jax.device_put(u, sharding)
    frozen = jax.device_put(frozen, sharding)
    u, delta = _update_n_sharded(u, frozen, state.iteration, mesh, num_steps,
                                 chunk_depth)
    return dataclasses.replace(
        state,
        u=u[:d, :h, :w],
        iteration=state.iteration + num_steps,
        delta=delta,
        converged=(delta < state.epsilon) if num_steps == 1 else jnp.asarray(False),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "stagger", "max_iterations", "dims",
                     "chunk_depth"),
    donate_argnums=(0,),
)
def _solve_sharded(
    u, frozen, epsilon, mesh: Mesh, stagger: int, max_iterations: int,
    dims, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
):
    m_max = max(dims)

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
                u, frozen, iteration, mesh, stagger - 1, chunk_depth,
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
    """Sharded 3D solve-to-convergence; protocol identical to core.solve."""
    _check_route(state.u.shape)
    d, h, w = state.u.shape
    u, frozen = _pad_for_mesh(state, mesh)
    sharding = NamedSharding(mesh, _spec(mesh))
    u = jax.device_put(u, sharding)
    frozen = jax.device_put(frozen, sharding)
    u, iteration, delta, converged = _solve_sharded(
        u, frozen, state.epsilon, mesh, stagger, max_iterations,
        (d, h, w), chunk_depth,
    )
    return dataclasses.replace(
        state,
        u=u[:d, :h, :w],
        iteration=iteration,
        delta=delta,
        converged=converged,
    )
