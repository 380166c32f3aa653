"""Time the CUDA sweep kernel against XLA's ``core`` on a GPU.

Runs on the GPU only (it exits non-zero anywhere else). For each grid it
prints one JSON line per measurement: warm times on the host clock, each
call ending in ``block_until_ready``, with the card's name and power limit.

  python tools/sweep_ab.py --tune          # every compiled tile geometry, ticks
  python tools/sweep_ab.py                 # the routing decision: Planner.update
                                           # and solver.solve_grid, xla vs cuda
  python tools/sweep_ab.py --shapes maze,4096

The ``--tune`` table picks ``cuda_sweep.SMALL_GEOMETRY`` / ``LARGE_GEOMETRY``;
the default table backs ``solver.route.CUDA_MIN_CELLS``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> (shape or golden fixture, sweeps per tick, solve cap)
SHAPES = {
    "maze": ("maze", 50, 1_000_000),
    "umass": ("umass", 100, 1_000_000),
    "4096": ((4096, 4096), 100, 10_001),
    "16384": ((16384, 16384), 100, None),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def grid_np(spec, seed: int = 1):
    """(u, locked) for a golden fixture or a random-obstacle grid with a
    centre goal."""
    from epic_tpu import grid

    if isinstance(spec, str):
        img = np.load(ROOT / "tests" / "goldens" / f"{spec}.npz")["img"]
        st = grid.from_occupancy_image(img)
        return np.asarray(st.u), np.asarray(st.locked)
    h, w = spec
    rng = np.random.default_rng(seed)
    locked = rng.random((h, w)) < 0.1
    locked[0], locked[-1], locked[:, 0], locked[:, -1] = True, True, True, True
    u = np.full((h, w), -1e6, np.float32)
    u[h // 2, w // 2] = 0.0
    locked[h // 2, w // 2] = True
    return u, locked


def state_of(u, locked, eps=1e-3):
    import jax

    from epic_tpu import grid

    st = grid.make_state(u, locked, eps)
    return jax.block_until_ready(st)


def timed(fn, reps):
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return ts


def tune(names, out):
    import jax

    from epic_tpu.solver import core, cuda_sweep

    for name in names:
        spec, n, _ = SHAPES[name]
        u, locked = grid_np(spec)
        reps = 5 if u.size > 1 << 26 else 20
        box = {"st": state_of(u, locked)}

        def tick_xla():
            box["st"] = jax.block_until_ready(core.update_n(box["st"], n))

        tick_xla()
        row = {"shape": list(u.shape), "sweeps": n,
               "xla_ms": 1e3 * statistics.median(timed(tick_xla, reps))}
        ref = np.asarray(core.update_n(state_of(u, locked), n).u)
        for g in cuda_sweep.GEOMETRIES:
            box["st"] = state_of(u, locked)

            def tick_cuda():
                box["st"] = jax.block_until_ready(
                    cuda_sweep.update_n(box["st"], n, geometry=g))

            tick_cuda()
            err = float(np.max(np.abs(np.asarray(box["st"].u) - ref)))
            row[f"cuda_{'x'.join(map(str, g))}_ms"] = (
                1e3 * statistics.median(timed(tick_cuda, reps)))
            row[f"cuda_{'x'.join(map(str, g))}_maxdiff"] = err
            box["st"] = None
        out(row)


def decide(names, out):
    """Planner.update ticks and solver.solve_grid solves, xla vs cuda."""
    import jax

    from epic_tpu import solver
    from epic_tpu.planner import Planner, PlannerConfig

    for name in names:
        spec, n, cap = SHAPES[name]
        u, locked = grid_np(spec)
        reps = 5 if u.size > 1 << 26 else 20
        row = {"shape": list(u.shape), "tick_sweeps": n}
        for backend in ("xla", "cuda", "cuda", "xla"):
            pl = Planner(PlannerConfig(epsilon=1e-3, backend=backend,
                                       steps_per_update=n))
            pl.state = state_of(u, locked)

            def tick():
                pl.update()
                jax.block_until_ready(pl.state.u)

            tick()
            row.setdefault(f"tick_{backend}_ms", []).append(
                1e3 * statistics.median(timed(tick, reps)))
            pl.uninit()
            if cap is None:
                continue
            st = state_of(u, locked)
            out_st = jax.block_until_ready(
                solver.solve_grid(st, max_iterations=cap, backend=backend))
            t_solve = []
            for _ in range(3 if u.size < 1 << 22 else 1):
                st = state_of(u, locked)
                t = time.perf_counter()
                out_st = jax.block_until_ready(
                    solver.solve_grid(st, max_iterations=cap, backend=backend))
                t_solve.append(time.perf_counter() - t)
            row.setdefault(f"solve_{backend}_s", []).append(min(t_solve))
            row[f"solve_{backend}_iters"] = int(out_st.iteration)
            row[f"solve_{backend}_converged"] = bool(out_st.converged)
        out(row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sweep_ab.jsonl"))
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("sweep_ab: no GPU found", file=sys.stderr)
        return 2
    from epic_tpu.solver import cuda_sweep

    info = {"card": card(), "device_kind": jax.devices()[0].device_kind}
    t = time.perf_counter()
    cuda_sweep.build()
    info["build_s"] = time.perf_counter() - t
    print(json.dumps(info), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(info) + "\n")

        def out(row):
            row["card"] = info["card"]
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")

        names = args.shapes.split(",")
        (tune if args.tune else decide)(names, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
