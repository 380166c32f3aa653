"""Generate reference-binary goldens into ``tests/goldens/``.

Run manually with the reference tree mounted at /root/reference (the prebuilt
``libepic/lib/libepic.so`` CPU entry points are the ground truth — see
tests/test_reference_binary.py, whose ctypes bindings this script reuses).
The stored .npz files let ``tests/test_goldens.py`` assert bit/tolerance
exactness in a standalone checkout where the reference is absent and
test_reference_binary.py would skip wholesale.

Contents (all arrays float32 unless noted):

- fuzz2d_seed{0,2}.npz   — full solves: inputs + converged field + iteration
  count + every staggered check delta (harmonic_complete_cpu loop,
  harmonic_cpu.cpp:147-183).
- paths2d_seed7.npz      — converged field + exact streamline walks
  (harmonic_compute_path_2d_cpu) from 8 starts, incl. rejected ones.
- maze.npz / umass.npz   — the shipped demo maps (maps/*.yaml): occupancy
  image, field after 300 bounded sweeps, converged field + iterations +
  check deltas, and exact path walks on the converged field.
- fuzz3d_seed0.npz       — 60 update_and_check sweeps on a volume: per-sweep
  deltas + final field (pins the inverted 3D parity,
  harmonic_cpu.cpp:96-99).
- set_cells.npz          — duplicate-batch SetCells parity
  (harmonic_utilities_cpu.cpp:38-76).
- legacy.npz             — SOR f32/f64 fields + iteration counts
  (harmonic_legacy_cpu.cpp:34-141) and double-precision legacy path walks.

Takes ~5-10 min (the maze/umass solves dominate).
"""

from __future__ import annotations

import ctypes as ct
import pathlib
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")  # goldens are computed on the CPU

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_reference_binary as trb  # noqa: E402  (needs the binary)
from epic_tpu import constants as C  # noqa: E402
from epic_tpu import grid, maps  # noqa: E402

OUT = ROOT / "tests" / "goldens"
OUT.mkdir(exist_ok=True)


def save(name: str, **arrs) -> None:
    np.savez_compressed(OUT / name, **arrs)
    kb = (OUT / f"{name}.npz").stat().st_size / 1024
    print(f"  {name}.npz  {kb:.0f} KB")


def walk_paths(ref: trb.RefHarmonic, starts, step=0.2, cd=0.4, maxlen=int(1e6)):
    """Walk each start; rejected paths record length 0."""
    lens, pts = [], []
    for x, y in starts:
        try:
            p = ref.compute_path(float(x), float(y), step, cd, maxlen)
        except AssertionError:
            lens.append(0)
            continue
        lens.append(len(p))
        pts.append(p)
    concat = (np.concatenate(pts, axis=0) if pts
              else np.zeros((0, 2), np.float32))
    return np.asarray(lens, np.int64), concat


def gen_fuzz2d(seed: int, h: int, w: int) -> None:
    rng = np.random.default_rng(seed)
    u0, locked = trb._fuzz_grid(rng, h, w)
    eps = 1e-2
    ref = trb.RefHarmonic(u0, locked, eps)
    iters, checks = trb._ref_solve_recording_checks(
        ref, max(h, w), C.DEFAULT_STAGGER
    )
    save(
        f"fuzz2d_seed{seed}",
        u0=u0, locked=locked, epsilon=np.float32(eps),
        ref_u=ref.u, ref_iters=np.int64(iters),
        check_iters=np.asarray(sorted(checks), np.int64),
        check_deltas=np.asarray([checks[k] for k in sorted(checks)],
                                np.float32),
    )


def gen_paths2d() -> None:
    rng = np.random.default_rng(7)
    u0, locked = trb._fuzz_grid(rng, 64, 96)
    ref = trb.RefHarmonic(u0, locked, 1e-3)
    ref.complete()
    free_ys, free_xs = np.nonzero(~locked)
    idx = rng.permutation(len(free_ys))[:8]
    starts = np.stack(
        [free_xs[idx].astype(np.float32), free_ys[idx].astype(np.float32)],
        axis=1,
    )
    lens, concat = walk_paths(ref, starts)
    save(
        "paths2d_seed7",
        u0=u0, locked=locked, ref_u=ref.u,
        starts=starts, path_lens=lens, paths_concat=concat,
    )


def gen_demo(name: str, starts_xy) -> None:
    p = maps.reference_map_path(f"{name}.png")
    assert p is not None, "reference demo maps not mounted"
    img = maps.load_png(p)
    state = grid.from_occupancy_image(img)
    u0 = np.asarray(state.u)
    locked = np.asarray(state.locked)

    ref = trb.RefHarmonic(u0, locked, 1e-3)
    ref.update_n(300)
    u300 = ref.u.copy()

    t0 = time.time()
    ref2 = trb.RefHarmonic(u0, locked, 1e-3)
    iters, checks = trb._ref_solve_recording_checks(
        ref2, max(u0.shape), C.DEFAULT_STAGGER
    )
    print(f"  [{name}: converged in {iters} iters, "
          f"{time.time() - t0:.0f} s]")
    starts = np.asarray(starts_xy, np.float32)
    lens, concat = walk_paths(ref2, starts)
    save(
        name,
        img=img.astype(np.uint8), ref_u300=u300,
        ref_u=ref2.u, ref_iters=np.int64(iters),
        check_iters=np.asarray(sorted(checks), np.int64),
        check_deltas=np.asarray([checks[k] for k in sorted(checks)],
                                np.float32),
        starts=starts, path_lens=lens, paths_concat=concat,
    )


def gen_fuzz3d() -> None:
    rng = np.random.default_rng(0)
    u0, locked = trb._fuzz_volume(rng, 12, 16, 20)
    ref = trb.RefHarmonic3D(u0, locked, 1e-2)
    deltas = []
    for _ in range(60):
        ref.update_and_check()
        deltas.append(float(ref.s.delta))
    save(
        "fuzz3d_seed0",
        u0=u0, locked=locked, ref_u=ref.u,
        deltas=np.asarray(deltas, np.float32),
    )


def gen_set_cells() -> None:
    rng = np.random.default_rng(11)
    u0, locked = trb._fuzz_grid(rng, 32, 40)
    ref = trb.RefHarmonic(u0, locked, 1e-2)
    xy = np.array(
        [[5, 6], [7, 8], [5, 6], [9, 10], [7, 8], [5, 6], [0, 4], [12, 31]],
        np.int64,
    )
    types = np.array(
        [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_GOAL,
         C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_FREE, C.CELL_TYPE_FREE,
         C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE],
        np.int64,
    )
    ref.set_cells(xy, types)
    save(
        "set_cells",
        u0=u0, locked=locked, xy=xy, types=types,
        ref_u=ref.u, ref_locked=ref.locked,
    )


def gen_legacy() -> None:
    _, u0, locked = trb._legacy_fixture()
    locked_u = np.ascontiguousarray(locked, dtype=np.uint32)
    eps, omega = 1e-4, 1.5

    u32 = np.ascontiguousarray(u0, dtype=np.float32)
    it32 = ct.c_uint(0)
    assert trb._epic.harmonic_legacy_sor_2d_float_cpu(
        u32.shape[1], u32.shape[0], eps, omega,
        locked_u.ctypes.data_as(ct.POINTER(ct.c_uint)),
        u32.ctypes.data_as(ct.POINTER(ct.c_float)), ct.byref(it32),
    ) == 0

    u64 = np.ascontiguousarray(u0, dtype=np.float64)
    it64 = ct.c_uint(0)
    assert trb._epic.harmonic_legacy_sor_2d_double_cpu(
        u64.shape[1], u64.shape[0], eps, omega,
        locked_u.ctypes.data_as(ct.POINTER(ct.c_uint)),
        u64.ctypes.data_as(ct.POINTER(ct.c_double)), ct.byref(it64),
    ) == 0

    h, w = u64.shape
    starts = np.asarray(
        [(4.0, 4.0), (w - 5.0, 6.0), (5.0, h - 5.0)], np.float64
    )
    lens, pts = [], []
    for x, y in starts:
        k = ct.c_uint(0)
        raw = ct.POINTER(ct.c_double)()
        r = trb._epic.harmonic_legacy_compute_path_2d_cpu(
            w, h, locked_u.ctypes.data_as(ct.POINTER(ct.c_uint)),
            u64.ctypes.data_as(ct.POINTER(ct.c_double)),
            float(x), float(y), 0.2, 0.4, 100000, 0,
            ct.byref(k), ct.byref(raw),
        )
        if r != 0:
            lens.append(0)
            continue
        n = int(k.value)
        pts.append(np.array([(raw[2 * i], raw[2 * i + 1]) for i in range(n)],
                            np.float64))
        trb._epic.harmonic_legacy_free_path_cpu(ct.byref(raw))
        lens.append(n)
    concat = (np.concatenate(pts, axis=0) if pts
              else np.zeros((0, 2), np.float64))
    save(
        "legacy",
        u0=u0, locked=locked,
        u_f32=u32, iters_f32=np.int64(it32.value),
        u_f64=u64, iters_f64=np.int64(it64.value),
        starts=starts, path_lens=np.asarray(lens, np.int64),
        paths_concat=concat,
    )


def main() -> None:
    print("generating goldens into", OUT)
    gen_fuzz2d(0, 40, 56)
    gen_fuzz2d(2, 96, 130)
    gen_paths2d()
    gen_fuzz3d()
    gen_set_cells()
    gen_legacy()
    # Path starts in free corridors of each demo map (cell coordinates),
    # picked from the loaded occupancy below; converged fields support walks
    # from anywhere, so scatter across the map.
    gen_demo("maze", [(30.0, 30.0), (450.0, 30.0), (30.0, 450.0),
                      (450.0, 450.0), (240.0, 240.0), (120.0, 360.0)])
    gen_demo("umass", [(50.0, 50.0), (900.0, 250.0), (470.0, 155.0),
                       (100.0, 250.0), (800.0, 60.0), (300.0, 200.0)])
    print("done")


if __name__ == "__main__":
    main()
