"""Legacy (non-log) SOR solver twins — the precision-collapse baseline.

The reference keeps a classic SOR solver in float/double/long-double
(/root/reference/libepic/src/harmonic/harmonic_legacy_cpu.cpp) purely to
demonstrate the paper's point: on large maps, non-log float relaxation
underflows into flat/invalid gradients while the log-space solver does not
(SURVEY §0 "legacy" + §4 percent-valid metric).

Conventions (harmonic_legacy_map.py:76-93): u in linear space, goals = 0.0,
free/obstacle = 1.0; streamlines *descend* toward 0 unless ``flipped`` (then
u -> 1 - u and streamlines ascend). Default omega = 1.5, epsilon floor of
10000 iterations (harmonic_legacy_cpu.cpp:34,42).

Three implementations:
  * native C++ (epic_tpu.native.legacy_sor_2d) — fast, exact row-major
    in-place Gauss-Seidel like the reference; used by default when built;
  * ``sor_numpy`` — literal scalar port (slow; oracle for the native lib);
  * ``sor_red_black_jax`` — a device-friendly red-black-ordered SOR. Not the
    same iteration ordering as the reference's row-major sweep (row-major
    Gauss-Seidel is inherently sequential), but the same fixed point and the
    same precision-collapse behaviour, and it runs on the accelerator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C


def from_image(img: np.ndarray, flipped: bool = False, dtype=np.float64):
    """(u, locked) in the legacy linear-space convention."""
    img = np.asarray(img)
    goal = img == 255
    obstacle = img == 0
    u = (1.0 - goal.astype(np.float64)).astype(dtype)
    if flipped:
        u = (1.0 - u).astype(dtype)
    locked = goal | obstacle
    return u, locked


def sor_numpy(
    u: np.ndarray,
    locked: np.ndarray,
    epsilon: float = 1e-4,
    omega: float = C.DEFAULT_OMEGA,
    min_iterations: int = C.LEGACY_MIN_ITERATIONS,
    max_iterations: int | None = None,
):
    """Row-major in-place Gauss-Seidel SOR; scalar port of
    harmonic_legacy_sor_2d_*_cpu (:36-141). Returns (u, iterations)."""
    u = np.array(u)
    locked = np.asarray(locked)
    h, w = u.shape
    one = u.dtype.type(1)
    four = u.dtype.type(4)
    om = u.dtype.type(omega)
    delta = u.dtype.type(epsilon + 1)
    it = 0
    while delta >= epsilon or it < min_iterations:
        delta = u.dtype.type(0)
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                if locked[y, x]:
                    continue
                prev = u[y, x]
                u[y, x] = (one - om) * u[y, x] + om / four * (
                    u[y - 1, x] + u[y + 1, x] + u[y, x - 1] + u[y, x + 1]
                )
                d = abs(u[y, x] - prev)
                if d > delta:
                    delta = d
        it += 1
        if max_iterations is not None and it >= max_iterations:
            break
    return u, it


def sor(
    u: np.ndarray,
    locked: np.ndarray,
    epsilon: float = 1e-4,
    omega: float = C.DEFAULT_OMEGA,
    min_iterations: int = C.LEGACY_MIN_ITERATIONS,
    dtype=np.float64,
):
    """Reference-exact legacy SOR: native C++ when available, else NumPy."""
    from .. import native

    if native.available():
        return native.legacy_sor_2d(
            u, locked, epsilon=epsilon, omega=omega,
            min_iterations=min_iterations, dtype=dtype,
        )
    return sor_numpy(
        np.asarray(u, dtype=dtype), locked, epsilon, omega, min_iterations
    )


@functools.partial(
    jax.jit, static_argnames=("min_iterations", "max_iterations"), donate_argnums=(0,)
)
def sor_red_black_jax(
    u: jax.Array,
    locked: jax.Array,
    epsilon: float,
    omega: float = C.DEFAULT_OMEGA,
    min_iterations: int = C.LEGACY_MIN_ITERATIONS,
    max_iterations: int = 1_000_000,
):
    """Red-black-ordered SOR on device: each iteration updates red cells from
    the previous field, then black cells from the half-updated field — the
    standard parallel SOR decomposition. Returns (u, iterations, delta)."""
    dtype = u.dtype
    h, w = u.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    parity = (row + col) % 2
    interior = (
        (row >= 1) & (row <= h - 2) & (col >= 1) & (col <= w - 2)
    )
    om = jnp.asarray(omega, dtype)
    one = jnp.asarray(1.0, dtype)
    four = jnp.asarray(4.0, dtype)

    def half_sweep(u, which):
        nbr = (
            jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0)
            + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1)
        )
        val = (one - om) * u + om / four * nbr
        update = (parity == which) & interior & ~locked
        return jnp.where(update, val, u)

    def body(carry):
        u, it, _ = carry
        u1 = half_sweep(u, 0)
        u2 = half_sweep(u1, 1)
        delta = jnp.max(jnp.abs(u2 - u))
        return u2, it + 1, delta

    def cond(carry):
        _, it, delta = carry
        return ((delta >= epsilon) | (it < min_iterations)) & (it < max_iterations)

    u, it, delta = jax.lax.while_loop(
        cond, body, (u, jnp.int32(0), jnp.asarray(epsilon, dtype) + one)
    )
    return u, it, delta


# ---------------------------------------------------------------------------
# Legacy path extraction (double precision, flipped-aware) — semantics of
# harmonic_legacy_path_cpu.cpp.
# ---------------------------------------------------------------------------


def compute_path(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    step_size: float = 0.2,
    cd_precision: float = 0.4,
    max_length: int = 1_000_000,
    flipped: bool = False,
    mode: str = "reference",
) -> np.ndarray:
    """Legacy streamline (harmonic_legacy_path_cpu.cpp:150-221): double
    precision; descent toward u = 0 goals unless ``flipped`` (then ascent);
    the loop bound counts *scalars*, so max points = max_length / 2; start
    invalid if the cell is locked at the non-goal extreme."""
    from ..errors import (
        InvalidGradientError,
        InvalidLocationError,
        InvalidPathError,
    )

    u = np.asarray(u, dtype=np.float64)
    locked = np.asarray(locked).astype(bool)
    h, w = u.shape

    def gradient(x, y):
        gx, gy = compute_gradient(u, locked, x, y,
                                  cd_precision=cd_precision, mode=mode)
        if not (np.isfinite(gx) and np.isfinite(gy)):
            raise InvalidGradientError(f"flat gradient at ({x}, {y})")
        return gx, gy

    cell = _legacy_cell
    xc, yc = _legacy_check(u, locked, x, y, flipped)
    points = [(x, y)]
    while (
        not locked[yc, xc]
        and not _is_stuck_legacy(points, step_size)
        and 2 * len(points) < max_length
    ):
        gx, gy = gradient(x, y)
        if flipped:
            x += gx * step_size
            y += gy * step_size
        else:
            x -= gx * step_size
            y -= gy * step_size
        points.append((x, y))
        xc, yc = cell(x), cell(y)
        if xc < 0 or yc < 0 or xc >= w or yc >= h:
            raise InvalidGradientError(f"walked off the map at ({x}, {y})")
    if len(points) <= 2:
        raise InvalidPathError("path has <= 2 points")
    return np.asarray(points, dtype=np.float64)


def _legacy_cell(v):
    f = v + 0.5
    return -1 if f < 0 else int(f)


def _legacy_check(u, locked, x, y, flipped):
    from ..errors import InvalidLocationError

    h, w = u.shape
    xc, yc = _legacy_cell(x), _legacy_cell(y)
    if xc < 0 or yc < 0 or xc >= w or yc >= h:
        raise InvalidLocationError(f"({x}, {y}) outside the map")
    bad = u[yc, xc] == (0.0 if flipped else 1.0)
    if locked[yc, xc] and bad:
        raise InvalidLocationError(f"({x}, {y}) is inside an obstacle")
    return xc, yc


def compute_potential(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    mode: str = "reference",
) -> float:
    """Bilinear potential at a continuous point
    (harmonic_legacy_compute_potential_2d_cpu,
    harmonic_legacy_path_cpu.cpp:41-79). ``mode="reference"`` keeps the
    reference's corner selection (which extrapolates when alpha/beta > 1);
    ``mode="bilinear"`` clamps to the containing cell.

    The validity check is the reference's own: out-of-bounds, or locked with
    ``u < 0`` — the latter never fires on legacy fields (u in [0, 1]; the
    condition was inherited from the log-space variant), kept faithfully."""
    from ..errors import InvalidLocationError

    u = np.asarray(u, dtype=np.float64)
    locked = np.asarray(locked).astype(bool)
    h, w = u.shape
    xc, yc = _legacy_cell(x), _legacy_cell(y)
    if (xc < 0 or yc < 0 or xc >= w or yc >= h
            or (locked[yc, xc] and u[yc, xc] < 0.0)):
        raise InvalidLocationError(f"({x}, {y}) invalid")
    if mode == "reference":
        xl = max(int(x - 0.5), 0)
        yl = max(int(y - 0.5), 0)
        xr = int(x + 0.5)
        yb = int(y + 0.5)
    else:
        xl = min(int(x), w - 2)
        yl = min(int(y), h - 2)
        xr, yb = xl + 1, yl + 1
    alpha = x - xl
    beta = y - yl
    top = (1.0 - alpha) * u[yl, xl] + alpha * u[yl, xr]
    bot = (1.0 - alpha) * u[yb, xl] + alpha * u[yb, xr]
    return (1.0 - beta) * top + beta * bot


def compute_gradient(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    cd_precision: float = 0.4,
    mode: str = "reference",
) -> tuple[float, float]:
    """Unit-normalised central-difference gradient
    (harmonic_legacy_compute_gradient_2d_cpu,
    harmonic_legacy_path_cpu.cpp:83-114). The reference normalises without
    a zero check (:110-112), so a flat gradient yields non-finite components
    with success — mirrored here; the walk layer treats non-finite as
    InvalidGradientError."""
    from ..errors import InvalidGradientError, InvalidLocationError

    u = np.asarray(u, dtype=np.float64)
    locked = np.asarray(locked).astype(bool)
    try:
        v0 = compute_potential(u, locked, x - cd_precision, y, mode)
        v1 = compute_potential(u, locked, x + cd_precision, y, mode)
        v2 = compute_potential(u, locked, x, y - cd_precision, mode)
        v3 = compute_potential(u, locked, x, y + cd_precision, mode)
    except InvalidLocationError as e:
        raise InvalidGradientError(str(e)) from e
    px = (v1 - v0) / (2.0 * cd_precision)
    py = (v3 - v2) / (2.0 * cd_precision)
    denom = np.sqrt(px * px + py * py)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(px / denom), float(py / denom)


def _is_stuck_legacy(points, step_size):
    n = len(points)
    if n < 2:
        return False
    x, y = points[-1]
    lo = max(0, n - 1 - C.PATH_STUCK_HISTORY_LENGTH)
    for i in range(n - 2, lo - 1, -1):
        xi, yi = points[i]
        if np.sqrt((x - xi) ** 2 + (y - yi) ** 2) < step_size / 2.0:
            return True
    return False
