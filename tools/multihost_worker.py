#!/usr/bin/env python
"""Cross-process worker for the multi-host validation test.

Launched N times (one per simulated host) by tests/test_multihost.py or by
hand; each process owns a disjoint set of virtual CPU devices and they form
ONE global mesh through jax.distributed — the wiring several GPU hosts use,
with gloo carrying the cross-process collectives. Process 0 writes the
gathered result to --out as an .npz; the launcher compares it against the
single-process solve.

Usage:
  python tools/multihost_worker.py --coordinator localhost:PORT \
      --num-processes 2 --process-id K --local-devices 4 \
      --out /tmp/result.npz [--mode solve|update|solve3d|solve_resident|
                             solve_resident_z]
"""

from __future__ import annotations

import argparse
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", default="solve",
                    choices=["solve", "update", "solve3d", "solve_resident",
                             "solve_resident_z"])
    ap.add_argument("--size", type=int, default=48)
    args = ap.parse_args()

    # Per-process virtual CPU devices; must be set before JAX backend init.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Cross-process collectives on the CPU backend ride gloo.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from epic_tpu import grid as G
    from epic_tpu.parallel import multihost, sharded

    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert multihost.is_multi_process() == (args.num_processes > 1)

    import numpy as np

    from epic_tpu import constants as C

    n = args.size
    if args.mode in ("solve3d", "solve_resident_z"):
        d = max(4, n // 4)
        rng = np.random.default_rng(7)
        obstacle = np.zeros((d, n, n), dtype=bool)
        obstacle[rng.random((d, n, n)) < 0.1] = True
        goal = np.zeros((d, n, n), dtype=bool)
        goal[d // 2, n // 2, n // 2] = True
        obstacle[d // 2, n // 2, n // 2] = False
        for ax in range(3):
            sl = [slice(None)] * 3
            for edge in (0, -1):
                sl[ax] = edge
                obstacle[tuple(sl)] = True
    else:
        # A wide grid for the mesh-resident solve (48 x 512 -> 24 x 128
        # local blocks on the 2x4 mesh).
        w = 512 if args.mode == "solve_resident" else n
        rng = np.random.default_rng(7)
        obstacle = np.zeros((n, w), dtype=bool)
        obstacle[rng.random((n, w)) < 0.15] = True
        goal = np.zeros((n, w), dtype=bool)
        goal[n // 2, w // 2] = True
        obstacle[n // 2, w // 2] = False
        obstacle[0, :] = obstacle[-1, :] = True
        obstacle[:, 0] = obstacle[:, -1] = True

    u = np.where(goal, C.LOG_SPACE_GOAL, C.LOG_SPACE_FREE).astype(np.float32)
    locked = goal | obstacle
    state = G.make_state(u, locked, epsilon=1e-3)

    mesh = sharded.make_mesh()  # all devices across all processes
    total = args.num_processes * args.local_devices
    assert mesh.devices.size == total, (mesh.devices.size, total)

    if args.mode == "solve":
        out = sharded.solve(state, mesh)
    elif args.mode == "solve_resident":
        # The MeshPlanner's solve on mesh-resident buffers: halo ppermutes
        # cross the process boundary here.
        sh, conv = sharded.solve_resident(sharded.shard_state(state, mesh),
                                          mesh)
        out = G.GridState(u=sh.u, locked=sh.frozen, iteration=sh.iteration,
                          delta=sh.delta, converged=conv, epsilon=sh.epsilon)
    elif args.mode == "solve3d":
        from epic_tpu.parallel import sharded3d

        out = sharded3d.solve(state, mesh)
    elif args.mode == "solve_resident_z":
        # The MeshVolumePlanner's solve on a z mesh: z-slab ppermutes cross
        # the process boundary here.
        from epic_tpu.parallel import sharded3d

        mesh_z = sharded3d.make_mesh3d((total, 1, 1))
        sv, conv = sharded3d.solve_resident3d(
            sharded3d.shard_state3d(state, mesh_z), mesh_z)
        out = G.GridState(u=sv.u, locked=sv.frozen, iteration=sv.iteration,
                          delta=sv.delta, converged=conv, epsilon=sv.epsilon)
    else:
        out = sharded.update_n(state, 137, mesh)

    # Gather the globally-sharded field to every host, then process 0
    # records the result.
    from jax.experimental import multihost_utils

    u_full = multihost_utils.process_allgather(out.u, tiled=True)
    # Mesh-resident buffers carry the mesh padding; crop to the grid.
    u_full = np.asarray(u_full)[tuple(slice(0, s) for s in state.u.shape)]
    if args.process_id == 0:
        np.savez(
            args.out,
            u=u_full,
            iteration=int(out.iteration),
            delta=float(out.delta),
            converged=bool(out.converged),
            process_count=jax.process_count(),
        )
    multihost_utils.sync_global_devices("epic_tpu_multihost_done")


if __name__ == "__main__":
    main()
