#!/usr/bin/env python
"""Benchmark battery — re-creation of the reference's batch harness.

Mirrors /root/reference/libepic/tests/batch/batch.py:105-164: for each
domain, run (a) legacy CPU SOR (omega 1.5), (b) the log-space solver on CPU
(XLA), and (c) the log-space solver on the accelerator (the CUDA sweep kernel on a GPU), then
emit a CSV with ``Percent Valid, Time per Update, Time to Converge`` per
solver at the requested precision.

Domains are procedural stand-ins for the reference's PNG battery (same sizes:
c_space 348x274, small_maze 802x242, umass 218x700, large_maze 962x962 ...),
or the reference's own PNGs when /root/reference is mounted.

``--sweep`` reproduces the reference's visual-harness battery mode
(libepic/tests/maps/maps.py:51-52,81-91): epsilon in {1e-1, 1e-2, 1e-3}
crossed with every available solver, wall times per row.

Usage: python tools/batch_bench.py [--domain large_maze] [--epsilon 1e-3]
       [--sweep] [--out results.csv]
"""

import argparse
import csv
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

DOMAINS = {
    # name: (height, width) — sizes from BASELINE.md workload table. The
    # full set mirrors the reference battery's domain list
    # (libepic/tests/batch/batch.py:41-49).
    "c_space": (274, 348),
    "small_maze": (242, 802),
    "umass": (700, 218),
    "large_maze": (962, 962),
    "small_mine": (954, 1280),
    "large_mine": (1419, 1735),
    "willow_garage": (1213, 1397),
    "maze": (482, 482),
}


def load_domain(name: str):
    from epic_tpu import maps

    ref = maps.reference_map_path(f"{name}.png")
    if ref is not None:
        img = maps.load_png(ref)
        # Reference PNGs may lack a goal pixel (255); add one mid-free-space.
        if not (img == 255).any():
            free = np.argwhere(img >= 250)
            if len(free) == 0:
                free = np.argwhere(img > 0)
            y, x = free[len(free) // 2]
            img = img.copy()
            img[y, x] = 255
        return img
    h, w = DOMAINS[name]
    return maps.recursive_maze(h, w, seed=0, corridor=max(6, min(h, w) // 40))


def _bench_epsilon(domain, img, goal, epsilon, cfg, rows):
    import jax

    import epic_tpu
    from epic_tpu import analysis, native
    from epic_tpu import solver
    from epic_tpu.solver import core, legacy, route

    # --- legacy CPU SOR (float32 and float64) ---------------------------
    for dtype, label in ((np.float32, "cpu_sor_f32"), (np.float64, "cpu_sor_f64")):
        u0, locked = legacy.from_image(img, dtype=dtype)
        t0 = time.perf_counter()
        u_out, iters = legacy.sor(u0, locked, epsilon=epsilon, omega=1.5,
                                  dtype=dtype)
        dt = time.perf_counter() - t0
        pv = analysis.percent_valid(u_out, locked, goal)
        rows.append([domain, label, epsilon, pv, dt / max(iters, 1), dt, iters])

    # --- log-space solver, native C++ CPU ---------------------------------
    # The reference battery's middle column ("CPU log-GS",
    # batch.py:137-144) is harmonic_complete_cpu; epic_solve2d_f32 is its
    # protocol-exact native twin, so this row runs on every host with no
    # device compiles.
    if native.available():
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        u0 = np.asarray(st.u)
        locked0 = np.asarray(st.locked)
        t0 = time.perf_counter()
        u_out, iters, _, _ = native.solve_2d(
            u0, locked0, epsilon=epsilon, stagger=cfg.solver.stagger,
            max_iterations=cfg.solver.max_iterations)
        dt = time.perf_counter() - t0
        pv = analysis.percent_valid(u_out, locked0, goal)
        rows.append([domain, "log_native_cpu", epsilon, pv,
                     dt / max(iters, 1), dt, iters])

    # --- log-space solver, XLA (CPU or current backend) ------------------
    if cfg.solver.backend in ("auto", "xla"):
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        t0 = time.perf_counter()
        out = core.solve(st, stagger=cfg.solver.stagger,
                         max_iterations=cfg.solver.max_iterations)
        iters = int(out.iteration)  # D2H readback = reliable completion barrier
        dt = time.perf_counter() - t0
        pv = analysis.percent_valid(np.asarray(out.u), np.asarray(out.locked), goal)
        rows.append([domain, f"log_xla_{jax.default_backend()}", epsilon, pv,
                     dt / max(iters, 1), dt, iters])

    # --- log-space cascade (opt-in; epic_tpu extension) -------------------
    if getattr(cfg.solver, "cascade", False):
        from epic_tpu.solver import cascade as _cascade

        coarse = (_cascade.native_solver if native.available() else None)
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        out, stats = _cascade.solve_cascade(st, stagger=cfg.solver.stagger,
                                            coarse_solver=coarse)
        _ = int(out.iteration)  # warm-up/compile barrier
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        t0 = time.perf_counter()
        out, stats = _cascade.solve_cascade(st, stagger=cfg.solver.stagger,
                                            coarse_solver=coarse)
        iters = int(out.iteration)
        dt = time.perf_counter() - t0
        pv = analysis.percent_valid(np.asarray(out.u), np.asarray(out.locked),
                                    goal)
        rows.append([domain, f"log_cascade_{jax.default_backend()}", epsilon,
                     pv, dt / max(iters, 1), dt, iters])

    # --- log-space solver on the routed path (the CUDA sweep kernel for
    # 2D grids on a GPU) -------------------------------------------------
    if (cfg.solver.backend in ("auto", "cuda")
            and route.choose(route.platform(), img.shape,
                             cfg.solver.backend) == route.CUDA):
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        out = solver.solve_grid(st, stagger=cfg.solver.stagger, backend="cuda")
        _ = int(out.iteration)  # compile warm-up + completion
        # Warm (steady-state) timing, second run:
        st = epic_tpu.from_occupancy_image(img, epsilon=epsilon)
        t0 = time.perf_counter()
        out = solver.solve_grid(st, stagger=cfg.solver.stagger, backend="cuda")
        iters = int(out.iteration)  # D2H readback barrier
        dt = time.perf_counter() - t0
        pv = analysis.percent_valid(np.asarray(out.u), np.asarray(out.locked), goal)
        rows.append([domain, f"log_cuda_{jax.default_backend()}", epsilon, pv,
                     dt / max(iters, 1), dt, iters])


def run(domain: str, cfg, out_path: str | None, epsilons=None):
    domains = sorted(DOMAINS) if domain == "all" else [domain]
    header = ["Domain", "Solver", "Epsilon", "Percent Valid",
              "Time per Update", "Time to Converge", "Iterations"]
    out = open(out_path, "w", newline="") if out_path else sys.stdout
    writer = csv.writer(out)
    writer.writerow(header)
    for name in domains:
        img = load_domain(name)
        goal = img == 255
        rows = []
        for epsilon in epsilons or [cfg.solver.epsilon]:
            _bench_epsilon(name, img, goal, epsilon, cfg, rows)
        for r in rows:
            writer.writerow(r)
        out.flush()
        print(f"# {name} done ({len(rows)} rows)", file=sys.stderr, flush=True)


if __name__ == "__main__":
    from epic_tpu.config import EpicConfig, SolverConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--domain", default="maze",
                    choices=sorted(DOMAINS) + ["all"])
    ap.add_argument("--epsilon", type=float, default=1e-3)
    ap.add_argument("--sweep", action="store_true",
                    help="epsilon battery {1e-1,1e-2,1e-3} x solvers "
                    "(reference maps.py batch mode)")
    ap.add_argument("--backend", default="auto", choices=["auto", "xla", "cuda"])
    ap.add_argument("--cascade", action="store_true",
                    help="add a log_cascade row (coarse-to-fine warm start)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = EpicConfig(solver=SolverConfig(epsilon=args.epsilon,
                                         backend=args.backend,
                                         cascade=args.cascade))
    run(args.domain, cfg, args.out,
        epsilons=[1e-1, 1e-2, 1e-3] if args.sweep else None)
