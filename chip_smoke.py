#!/usr/bin/env python3
"""Bring-up check of the planner on one NVIDIA GPU (or, with --mesh4, four).

Drives the system's main paths once through the entry points a user calls,
at the reference's real fixture sizes, and compares each with a plain
reference:

  kernel      the CUDA sweep kernel vs XLA's ``solver.core`` on the card, a
              tick at 482x482, 310x940, 4096^2 and 16384^2 (solve_grid /
              update_grid with backend="cuda" vs backend="xla")
  bounded     300 sweeps on the maze and umass fixtures vs the reference
              binary's field (tests/goldens/*.npz, ref_u300)
  service     services/server.py in a thread, driven over a socket at the
              reference launch budgets (maze 50, umass 100 sweeps per tick):
              occupancy_grid, set_cells, add_goals, remove_goals, get_cell,
              reset_free_cells, compute_path; a blocking Planner.solve from
              the cold field vs the binary's converged field and
              iteration count, and compute_path from the golden starts vs
              the binary's streamlines
  volume      a 3D VolumePlanner session on the card vs the same sweeps on
              the in-process CPU device
  --mesh4     only: MeshPlanner at 8192^2 and MeshVolumePlanner on a z mesh
              over four cards vs the same sequences on one card

Each phase prints one JSON line with its numbers and tolerances; a failed
phase raises and the script exits non-zero without a result line. The card's
name and power limit come first, and the last line is the device as JAX
reports it. It refuses any platform but the GPU.

  python chip_smoke.py            # one card
  python chip_smoke.py --mesh4    # four cards
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import threading
import time

import jax
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# Grid sizes by phase; the tests shrink them to rehearse on the CPU.
SIZES = {
    "kernel": [("maze", 50), ("umass", 100), ((4096, 4096), 100),
               ((16384, 16384), 100)],
    "solve_cap": {(4096, 4096): 10_001},
    "volume": (96, 96, 96),
    "mesh2d": (8192, 8192),
    "mesh3d": (256, 256, 256),
    "mesh_cap": 10_001,
}


def require_gpu(devices, count: int = 1) -> None:
    """Exit unless JAX's default devices are ``count`` or more GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_phases(phases) -> None:
    """Run each (name, fn) in order and print its numbers. No failure is
    caught: the first one ends the run."""
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        print(json.dumps({"phase": name, "s": round(time.perf_counter() - t0, 3),
                          **info}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# -- fixtures -------------------------------------------------------------------


def golden(name: str):
    return np.load(ROOT / "tests" / "goldens" / f"{name}.npz")


def grid_np(spec, seed: int = 1):
    """(u, locked) of a golden fixture, or of a random-obstacle grid with a
    centre goal."""
    from epic_tpu import grid

    if isinstance(spec, str):
        st = grid.from_occupancy_image(golden(spec)["img"])
        return np.asarray(st.u), np.asarray(st.locked)
    h, w = spec
    rng = np.random.default_rng(seed)
    locked = rng.random((h, w)) < 0.1
    locked[0], locked[-1], locked[:, 0], locked[:, -1] = True, True, True, True
    u = np.full((h, w), -1e6, np.float32)
    u[h // 2, w // 2] = 0.0
    locked[h // 2, w // 2] = True
    return u, locked


def fresh(u, locked, eps=1e-3, device=None):
    from epic_tpu import grid

    st = grid.make_state(u, locked, eps)
    if device is not None:
        st = jax.device_put(st, device)
    return jax.block_until_ready(st)


def field_diff(a, b) -> dict:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return {"max_abs": float(d.max()),
            "max_rel": float((d / np.maximum(np.abs(b), 1.0)).max())}


# -- phases on one card ------------------------------------------------------------

# The kernel and XLA both evaluate the update with libdevice's expf/logf in
# the same operation order, so equal fields are expected; the bound leaves
# room for one rounding difference per cell at |u| up to 1e6.
KERNEL_RTOL = 1e-6
# The reference binary subtracts a double log(2n) where this code uses the
# f32 constant: about one ulp of drift per sweep (tests/test_goldens.py).
BOUNDED_ATOL = 1e-3
# A converged field may stop one stagger cycle apart from the binary's; at
# most 100 sweeps each moving a cell by less than epsilon = 1e-3.
CONVERGED_ATOL = 0.1
# Streamline endpoints: the walks run on fields that differ by the drift
# above, so a goal-reaching walk may end in a neighbouring goal cell.
ENDPOINT_ATOL = 2.0


def phase_kernel():
    from epic_tpu import solver
    from epic_tpu.solver import cuda_sweep

    t0 = time.perf_counter()
    cuda_sweep.build()
    rows = {"build_s": round(time.perf_counter() - t0, 3), "tol_rel": KERNEL_RTOL,
            "tol_set_by": "same libdevice expf/logf and operation order"}
    for spec, n in SIZES["kernel"]:
        u, locked = grid_np(spec)
        name = spec if isinstance(spec, str) else f"{spec[0]}x{spec[1]}"
        ref = solver.update_grid(fresh(u, locked), n, backend="xla")
        out = solver.update_grid(fresh(u, locked), n, backend="cuda")
        diff = field_diff(out.u, ref.u)
        row = {**diff, "sweeps": n, "delta_cuda": float(out.delta),
               "delta_xla": float(ref.delta)}
        check(diff["max_rel"] <= KERNEL_RTOL, f"kernel vs XLA at {name}: {diff}")
        check(abs(row["delta_cuda"] - row["delta_xla"])
              <= KERNEL_RTOL * max(1.0, abs(row["delta_xla"])),
              f"first-sweep delta at {name}: {row}")
        cap = SIZES["solve_cap"].get(spec)
        if cap is not None:
            a = solver.solve_grid(fresh(u, locked), max_iterations=cap, backend="xla")
            b = solver.solve_grid(fresh(u, locked), max_iterations=cap, backend="cuda")
            row["solve_iters"] = [int(a.iteration), int(b.iteration)]
            row["solve_diff"] = field_diff(b.u, a.u)
            check(row["solve_iters"][0] == row["solve_iters"][1],
                  f"solve iterations at {name}: {row['solve_iters']}")
            check(row["solve_diff"]["max_rel"] <= KERNEL_RTOL,
                  f"solve field at {name}: {row['solve_diff']}")
        if u.size >= 1 << 28:
            stats = jax.devices()[0].memory_stats() or {}
            row["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
            abstract = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), out)
            mem = jax.jit(lambda s: solver.update_grid(s, n, backend="cuda")
                          ).lower(abstract).compile().memory_analysis()
            row["step_temp_bytes"] = getattr(mem, "temp_size_in_bytes", None)
            row["step_argument_bytes"] = getattr(mem, "argument_size_in_bytes", None)
        del ref, out
        rows[name] = row
    return rows


def phase_bounded():
    from epic_tpu.planner import Planner, PlannerConfig

    rows = {"tol_abs": BOUNDED_ATOL,
            "tol_set_by": "binary's double log(2n): ~1 ulp drift per sweep"}
    for name in ("maze", "umass"):
        u, locked = grid_np(name)
        pl = Planner(PlannerConfig(epsilon=1e-3))
        pl.state = fresh(u, locked)
        pl.update(300)
        diff = field_diff(pl.state.u, golden(name)["ref_u300"])
        check(diff["max_abs"] <= BOUNDED_ATOL, f"300 sweeps on {name}: {diff}")
        rows[name] = {**diff, "path": pl._kernel_module().__name__}
    return rows


def _serve(node):
    from epic_tpu.services.server import EpicServiceServer

    server = EpicServiceServer(node, port=0)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            server.spin_once()

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    return server, stop, thread


def _wait_ticks(cli, n, timeout=120.0):
    t_end = time.time() + timeout
    while time.time() < t_end:
        snap = cli.call("metrics")
        if snap["counters"].get("ticks", 0) >= n:
            return snap
        time.sleep(0.01)
    raise AssertionError(f"server did not reach {n} ticks")


def service_session(name: str, steps: int) -> dict:
    """One navigation session over the socket, on the golden map."""
    from epic_tpu import constants as C
    from epic_tpu import grid, path
    from epic_tpu.planner import PlannerConfig
    from epic_tpu.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu.services.server import EpicClient

    g = golden(name)
    img = g["img"]
    h, w = img.shape
    node = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-3,
                                                steps_per_update=steps))
    server, stop, thread = _serve(node)
    row = {"sweeps_per_tick": steps}
    try:
        cli = EpicClient(port=server.port, timeout=600.0)
        # Ingest with ticks paused, so the state can be checked as loaded.
        check(cli.call("set_status", paused=True)["success"], "pause")
        occ = np.where(img == 0, 100, 0).astype(np.int8)
        check(cli.call("occupancy_grid", width=w, height=h,
                       data=occ.ravel().tolist())["success"], "occupancy_grid")
        gy, gx = np.nonzero(img == 255)
        v = np.stack([gx, gy], axis=1).ravel().tolist()
        check(cli.call("set_cells", v=v, types=[C.CELL_TYPE_GOAL] * len(gx))
              ["success"], "set_cells goals")
        ref_state = grid.from_occupancy_image(img)
        st = node.planner.state
        check(np.array_equal(np.asarray(st.locked), np.asarray(ref_state.locked))
              and np.array_equal(np.asarray(st.u), np.asarray(ref_state.u)),
              "service ingest differs from from_occupancy_image")
        check(cli.call("set_status", paused=False)["success"], "resume")

        t0 = cli.call("metrics")["counters"].get("ticks", 0)
        snap = _wait_ticks(cli, t0 + 40)
        lat = snap["latencies"].get("tick.update", {})
        row["tick_update_ms"] = {k[:-2]: round(1e3 * v, 4) for k, v in lat.items()
                                 if k in ("mean_s", "min_s", "max_s")}
        row["ticks"] = lat.get("count")
        fy, fx = map(int, np.argwhere(~np.asarray(ref_state.locked))[0])
        r = cli.call("get_cell", x=fx, y=fy)
        check(r["success"] and r["value"] <= 0.0, f"get_cell {r}")

        # The blocking solve (the nav_core makePlan path), with ticks paused,
        # from the cold field the binary solved from (reset_free_cells).
        check(cli.call("set_status", paused=True)["success"], "pause")
        check(cli.call("reset_free_cells")["success"], "reset_free_cells")
        check(np.array_equal(np.asarray(node.planner.state.u),
                             np.asarray(ref_state.u)), "reset to the cold field")
        t = time.perf_counter()
        node.planner.solve()
        jax.block_until_ready(node.planner.state.u)
        row["solve_s"] = round(time.perf_counter() - t, 4)
        st = node.planner.state
        iters, ref_iters = int(st.iteration), int(g["ref_iters"])
        row["iterations"] = [iters, ref_iters]
        check(bool(st.converged), "solve did not converge")
        check(abs(iters - ref_iters) <= C.DEFAULT_STAGGER
              and (iters - ref_iters) % C.DEFAULT_STAGGER == 0,
              f"iterations {iters} vs binary {ref_iters}")
        diff = field_diff(st.u, g["ref_u"])
        row["converged_diff"] = diff
        check(diff["max_abs"] <= CONVERGED_ATOL, f"converged field {diff}")

        u_np, locked_np = np.asarray(st.u), np.asarray(st.locked)
        verdicts, ends = [], []
        off = 0
        for (x, y), n in zip(g["starts"], g["path_lens"]):
            ref_path = g["paths_concat"][off:off + n] if n else None
            off += int(n)
            r = cli.call("compute_path", x=float(x), y=float(y),
                         step_size=0.2, precision=0.4)
            ours = (np.asarray(r["path"], np.float64)[:, :2]
                    if r["success"] and r["path"] else None)
            ref_ok = (ref_path is not None
                      and path.path_reaches_goal(g["ref_u"], locked_np, ref_path))
            our_ok = (ours is not None
                      and path.path_reaches_goal(u_np, locked_np, ours))
            verdicts.append([bool(our_ok), bool(ref_ok)])
            if ours is not None and ref_path is not None:
                ends.append(float(np.abs(ours[-1] - ref_path[-1]).max()))
        row["goal_reach_ours_ref"] = verdicts
        row["endpoint_max_abs"] = ends
        row["endpoint_tol"] = ENDPOINT_ATOL
        check(all(a == b for a, b in verdicts), f"goal-reach verdicts {verdicts}")
        check(all(e <= ENDPOINT_ATOL for e in ends), f"endpoints {ends}")

        # Edits on the live session: a goal added and removed, an obstacle
        # block, then anytime ticks and a fresh path.
        check(cli.call("set_status", paused=False)["success"], "resume")
        check(cli.call("add_goals", goals=[[fx, fy]])["success"], "add_goals")
        check(cli.call("get_cell", x=fx, y=fy)["value"] == 0.0, "goal cell")
        check(cli.call("remove_goals", goals=[[fx, fy]])["success"], "remove_goals")
        free = np.argwhere(~locked_np)
        blk = free[len(free) // 2]
        v = [int(blk[1]), int(blk[0])]
        check(cli.call("set_cells", v=v, types=[C.CELL_TYPE_OBSTACLE])["success"],
              "set_cells obstacle")
        t0 = cli.call("metrics")["counters"]["ticks"]
        _wait_ticks(cli, t0 + 10)
        sx, sy = g["starts"][0]
        r = cli.call("compute_path", x=float(sx), y=float(sy), step_size=0.2,
                     precision=0.4)
        check(r["success"] and len(r["path"]) > 2, "compute_path after edits")
        row["path"] = node.planner._kernel_module().__name__
        cli.close()
    finally:
        stop.set()
        thread.join(timeout=600)
    check(not thread.is_alive(), "server thread did not stop")
    return row


def phase_service():
    return {"tol_converged_abs": CONVERGED_ATOL,
            "tol_converged_set_by": "one stagger cycle of epsilon-sized steps",
            "maze": service_session("maze", 50),
            "umass": service_session("umass", 100)}


def phase_volume():
    """A 3D session on the card vs the same sweeps on the CPU device."""
    from epic_tpu import constants as C
    from epic_tpu.planner3d import VolumePlanner, VolumePlannerConfig
    from epic_tpu.solver import core

    d, h, w = SIZES["volume"]
    rng = np.random.default_rng(3)
    occ = np.where(rng.random((d, h, w)) < 0.1, 100, 0).astype(np.int8)
    goal = (d // 2, h // 2, w // 2)
    occ[goal] = 0
    pl = VolumePlanner(VolumePlannerConfig(epsilon=1e-3, steps_per_update=50))
    pl.update_occupancy(occ)
    check(pl.add_goals([(goal[2], goal[1], goal[0])]), "add_goals 3d")
    start = pl.state
    cpu = jax.devices("cpu")[0]
    ref = jax.device_put(jax.tree.map(np.asarray, start), cpu)
    pl.update()
    pl.set_cells([(3, 3, 3)], [C.CELL_TYPE_OBSTACLE])
    pl.update(37)
    ref = core.update_n(ref, 50)
    from epic_tpu import grid

    ref = grid.set_cells_3d(ref, [(3, 3, 3)], [C.CELL_TYPE_OBSTACLE])
    ref = core.update_n(ref, 37)
    check(next(iter(ref.u.devices())).platform == "cpu", "reference not on CPU")
    diff = field_diff(pl.state.u, ref.u)
    # GPU and CPU exp/log may differ by an ulp per evaluation.
    check(diff["max_rel"] <= 1e-5, f"3D session vs CPU: {diff}")
    check(int(pl.state.iteration) == int(ref.iteration) == 87, "3D iterations")
    # Walk from a free voxel the 87 sweeps have reached (the median of the
    # reached potentials), so the streamline has a gradient to follow.
    u_np = np.asarray(pl.state.u)
    reached = np.argwhere(~np.asarray(pl.state.locked) & (u_np > -1e5))
    check(len(reached) > 0, "no voxel reached after 87 sweeps")
    vals = u_np[tuple(reached.T)]
    z, y, x = reached[np.argsort(vals)[len(vals) // 2]]
    poses = pl.compute_path((float(x), float(y), float(z)), step_size=0.2,
                            cd_precision=0.4)
    check(len(poses) >= 2, "3D path")
    return {**diff, "tol_rel": 1e-5,
            "tol_set_by": "GPU vs CPU libm exp/log, ulp-level per sweep",
            "shape": [d, h, w], "path": pl._kernel_module().__name__,
            "path_points": len(poses)}


# -- four cards ----------------------------------------------------------------------


def phase_mesh2d():
    from epic_tpu import constants as C
    from epic_tpu.parallel import make_mesh
    from epic_tpu.planner import PlannerConfig
    from epic_tpu.planner_mesh import MeshPlanner

    h, w = SIZES["mesh2d"]
    u, locked = grid_np((h, w), seed=5)
    runs = {}
    for n_dev in (4, 1):
        devs = np.asarray(jax.devices()[:n_dev])
        mesh = make_mesh((2, 2) if n_dev == 4 else (1, 1), devices=devs)
        mp = MeshPlanner(PlannerConfig(epsilon=1e-3, steps_per_update=100),
                         mesh=mesh)
        mp.state = fresh(u, locked)
        times = {}
        t = time.perf_counter()
        mp.update()
        mp.update()
        jax.block_until_ready(mp._sh.u)
        times["ticks_s"] = time.perf_counter() - t
        mp.set_cells([(w // 4, h // 4), (w // 4 + 1, h // 4)],
                     [C.CELL_TYPE_OBSTACLE] * 2)
        mp.update()
        t = time.perf_counter()
        mp.solve(max_iterations=SIZES["mesh_cap"])
        jax.block_until_ready(mp._sh.u)
        times["solve_s"] = time.perf_counter() - t
        st = mp.state
        runs[n_dev] = (np.asarray(st.u), int(st.iteration), bool(st.converged),
                       {k: round(v, 4) for k, v in times.items()})
        del mp
    (u4, it4, c4, t4), (u1, it1, c1, t1) = runs[4], runs[1]
    diff = field_diff(u4, u1)
    check(it4 == it1 and c4 == c1, f"mesh 2D iterations {it4} vs {it1}")
    check(diff["max_abs"] == 0.0, f"mesh 2D field 4 vs 1 card: {diff}")
    return {"shape": [h, w], "iterations": [it4, it1], "converged": c4,
            **diff, "tol_abs": 0.0, "times_4": t4, "times_1": t1}


def phase_mesh3d():
    from epic_tpu import constants as C
    from epic_tpu.parallel.sharded3d import make_mesh3d
    from epic_tpu.planner3d import VolumePlannerConfig
    from epic_tpu.planner_mesh import MeshVolumePlanner
    from epic_tpu import grid

    d, h, w = SIZES["mesh3d"]
    rng = np.random.default_rng(7)
    locked = rng.random((d, h, w)) < 0.08
    u = np.full((d, h, w), -1e6, np.float32)
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    runs = {}
    for n_dev in (4, 1):
        mesh = make_mesh3d((n_dev, 1, 1), devices=np.asarray(jax.devices()[:n_dev]))
        mp = MeshVolumePlanner(VolumePlannerConfig(epsilon=1e-3,
                                                   steps_per_update=50), mesh=mesh)
        mp.state = grid.make_state(u, locked, 1e-3)
        t = time.perf_counter()
        mp.update()
        mp.set_cells([(3, 3, 3)], [C.CELL_TYPE_OBSTACLE])
        mp.update()
        mp.solve(max_iterations=SIZES["mesh_cap"])
        jax.block_until_ready(mp._sv.u)
        st = mp.state
        runs[n_dev] = (np.asarray(st.u), int(st.iteration), bool(st.converged),
                       round(time.perf_counter() - t, 4))
        del mp
    (u4, it4, c4, t4), (u1, it1, c1, t1) = runs[4], runs[1]
    diff = field_diff(u4, u1)
    check(it4 == it1 and c4 == c1, f"mesh 3D iterations {it4} vs {it1}")
    check(diff["max_abs"] == 0.0, f"mesh 3D field 4 vs 1 card: {diff}")
    return {"shape": [d, h, w], "iterations": [it4, it1], "converged": c4,
            **diff, "tol_abs": 0.0, "session_s_4": t4, "session_s_1": t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card mesh paths and their "
                         "one-card comparisons")
    args = ap.parse_args(argv)
    devices = jax.devices()
    require_gpu(devices, 4 if args.mesh4 else 1)
    sys.path.insert(0, str(ROOT))
    print(card_line(), flush=True)
    if args.mesh4:
        phases = [("mesh2d", phase_mesh2d), ("mesh3d", phase_mesh3d)]
    else:
        phases = [("kernel", phase_kernel), ("bounded", phase_bounded),
                  ("service", phase_service), ("volume", phase_volume)]
    run_phases(phases)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
