#!/usr/bin/env python
"""Service-plane load test: concurrent replanning clients against the JSON/TCP
server, client-observed latency percentiles per verb.

The reference's service plane is a ROS node ticking at 33 ms
(launch/epic_navigation_node_umass.launch:11-12) with one synchronous client;
this harness measures what the epic_tpu server sustains: N concurrent clients
interleaving compute_path / get_cell / set_cells against a live anytime
relaxation loop.

By default it spins an in-process server on the platform JAX finds; pass
--port to drive an already-running
`python -m epic_tpu.services.server` instead.

Prints one JSON line: requests/s plus per-verb p50/p95/p99/max milliseconds.
"""

import argparse
import json
import pathlib
import sys
import threading
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _percentiles(samples_ms):
    arr = np.asarray(samples_ms)
    return {
        "n": int(arr.size),
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p95_ms": round(float(np.percentile(arr, 95)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def client_session(port, img, rounds, seed, latencies, lock, errors):
    from epic_tpu.services.server import EpicClient

    rng = np.random.default_rng(seed)
    free = np.argwhere(img > 0)
    cli = EpicClient(port=port, timeout=120.0)
    local = {}
    try:
        for r in range(rounds):
            sy, sx = free[rng.integers(len(free))]
            ops = [
                ("compute_path", dict(x=float(sx) * 0.05, y=float(sy) * 0.05,
                                      step_size=0.2, precision=0.4)),
                ("get_cell", dict(x=int(sx), y=int(sy))),
            ]
            if r % 7 == 3:  # occasional map edit, as a live costmap would
                ey, ex = free[rng.integers(len(free))]
                ops.append(("set_cells", dict(v=[int(ex), int(ey)], types=[0])))
            for srv, args in ops:
                t0 = time.perf_counter()
                resp = cli.call(srv, **args)
                dt_ms = (time.perf_counter() - t0) * 1e3
                local.setdefault(srv, []).append(dt_ms)
                if "error" in resp and srv != "compute_path":
                    errors.append((srv, resp["error"]))
                # compute_path may legitimately fail from a bad start; only
                # protocol-level errors count.
                if "error" in resp and srv == "compute_path" and \
                        "unknown" in str(resp.get("error", "")):
                    errors.append((srv, resp["error"]))
    finally:
        cli.close()
    with lock:
        for k, v in local.items():
            latencies.setdefault(k, []).extend(v)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--port", type=int, default=None,
                    help="drive an external server instead of in-process")
    ap.add_argument("--backend", default="auto", choices=["auto", "xla", "cuda"],
                    help="compute path (solver.route); cuda needs a GPU")
    ap.add_argument("--steps-per-update", type=int, default=50)
    args = ap.parse_args()

    from epic_tpu import maps
    from epic_tpu.planner import PlannerConfig
    from epic_tpu.services.server import EpicClient, EpicServiceServer
    from epic_tpu.services.navigation_node import EpicNavigationNodeRviz

    img = maps.recursive_maze(args.size, args.size, seed=11)
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100

    stop = threading.Event()
    port = args.port
    server = None
    if port is None:
        node = EpicNavigationNodeRviz(
            PlannerConfig(epsilon=1e-3, backend=args.backend,
                          steps_per_update=args.steps_per_update))
        server = EpicServiceServer(node, port=0)
        port = server.port

        def spin():
            while not stop.is_set():
                server.spin_once()

        threading.Thread(target=spin, daemon=True).start()

    # Seed: map + one goal, then a full solve so paths are meaningful.
    seed_cli = EpicClient(port=port, timeout=600.0)
    h, w = img.shape
    assert seed_cli.call("occupancy_grid", width=w, height=h,
                         resolution=0.05, origin_x=0.0, origin_y=0.0,
                         data=occ.reshape(-1).tolist()).get("success")
    gy, gx = np.argwhere(img == 255)[0]
    assert seed_cli.call("add_goals",
                         goals=[[float(gx) * 0.05, float(gy) * 0.05]]
                         ).get("success")
    # Warm the relaxation: anytime ticks run in spin_once; block until the
    # field is usable by asking for a path from a known-free cell.
    deadline = time.time() + 600
    free = np.argwhere(img > 0)
    while time.time() < deadline:
        sy, sx = free[len(free) // 3]
        r = seed_cli.call("compute_path", x=float(sx) * 0.05,
                          y=float(sy) * 0.05, step_size=0.2, precision=0.4)
        if r.get("path"):
            break
        time.sleep(0.2)
    seed_cli.close()

    latencies, errors, lock = {}, [], threading.Lock()
    threads = [
        threading.Thread(target=client_session,
                         args=(port, img, args.rounds, 100 + i, latencies,
                               lock, errors))
        for i in range(args.clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    stop.set()
    if server is not None:
        time.sleep(0.1)
        server.close()

    total = sum(len(v) for v in latencies.values())
    print(json.dumps({
        "metric": "server_requests_per_s",
        "value": round(total / wall, 1),
        "unit": "req/s",
        "detail": {
            "clients": args.clients,
            "rounds": args.rounds,
            "grid": f"{args.size}x{args.size}",
            "backend": args.backend,
            "wall_s": round(wall, 2),
            "protocol_errors": len(errors),
            "verbs": {k: _percentiles(v) for k, v in sorted(latencies.items())},
        },
    }))
    if errors:
        print(f"# first errors: {errors[:3]}", file=sys.stderr)


if __name__ == "__main__":
    main()
