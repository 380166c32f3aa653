#!/usr/bin/env python
"""Scaling harness: sweeps/s of the halo-exchange solver vs mesh size.

Measures the sharded program (ppermute halos + pmax residual,
epic_tpu.parallel.sharded) on the devices JAX finds: the GPUs of one host,
or a virtual CPU mesh when run as

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py --devices 1 2 4 8

Virtual CPU devices share the host's cores, so there efficiency_vs_first
(N-device rate over N times the 1-device rate) is the wrong normalization;
throughput_vs_1dev (N-device over 1-device throughput at the same size)
shows whether the sharded program adds overhead. On GPUs the compute grows
with N and efficiency_vs_first is the scaling efficiency.

Usage: python tools/scaling_bench.py [--sizes 1024 4096] [--sweeps 200]
       [--devices 1 2 4] [--csv out.csv] [--assert-efficiency 0.8]

With --assert-efficiency the script exits nonzero if any >=2-device row on
a GPU falls below the bound (it is skipped on the CPU). Asking for more
devices than are present is an error.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024])
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--chunk-depth", type=int, default=16)
    ap.add_argument("--csv", default=None,
                    help="append rows to this CSV (written with header if new)")
    ap.add_argument("--assert-efficiency", type=float, default=None,
                    help="on GPUs, exit nonzero if any >=2-device row's "
                         "efficiency_vs_first is below this bound")
    args = ap.parse_args()

    import jax
    import numpy as np

    import epic_tpu
    from epic_tpu import maps
    from epic_tpu.parallel import make_mesh, sharded

    if max(args.devices) > len(jax.devices()):
        sys.exit(f"scaling_bench: {max(args.devices)} devices asked for, "
                 f"{len(jax.devices())} {jax.default_backend()} devices present")

    rows = []
    for size in args.sizes:
        img = maps.random_obstacles(size, size, density=0.1, seed=0)
        base = None
        print(f"grid {size}^2, {args.sweeps} sweeps per measurement, "
              f"backend={jax.default_backend()}")
        print("devices  mesh      sweeps/s   cell-updates/s   eff/dev  vs-1dev")
        for n in args.devices:
            my = int(np.floor(np.sqrt(n)))
            while n % my:
                my -= 1
            mesh = make_mesh((my, n // my),
                             devices=np.asarray(jax.devices()[:n]))
            st = epic_tpu.from_occupancy_image(img, epsilon=1e-6)
            # Warm-up/compile.
            out = sharded.update_n(st, args.sweeps, mesh,
                                   chunk_depth=args.chunk_depth)
            _ = float(out.delta)
            st2 = epic_tpu.from_occupancy_image(img, epsilon=1e-6)
            t0 = time.perf_counter()
            out = sharded.update_n(st2, args.sweeps, mesh,
                                   chunk_depth=args.chunk_depth)
            _ = np.asarray(out.u).sum()  # full D2H barrier
            dt = time.perf_counter() - t0
            sps = args.sweeps / dt
            cups = (size - 2) ** 2 / 2 * sps
            if base is None:
                base = (sps, n)
            eff = sps / (base[0] * n / base[1])
            gain = sps / base[0]
            print(f"{n:7d}  ({my},{n//my})   {sps:9.1f}  {cups:13.3e}   "
                  f"{eff:6.2f}  x{gain:5.2f}")
            rows.append(dict(
                backend=jax.default_backend(),
                size=size, devices=n, mesh=f"{my}x{n//my}",
                sweeps=args.sweeps, chunk_depth=args.chunk_depth,
                sweeps_per_s=round(sps, 2), cell_updates_per_s=round(cups),
                efficiency_vs_first=round(eff, 3),
                throughput_vs_1dev=round(gain, 3),
                caveat=("virtual-cpu-devices-share-host-cores"
                        if jax.default_backend() == "cpu" else ""),
            ))

    if args.csv:
        import csv

        path = pathlib.Path(args.csv)
        new = not path.exists()
        with path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if new:
                w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows -> {path}")

    if args.assert_efficiency is not None:
        if jax.default_backend() == "cpu":
            print("efficiency assertion skipped: virtual-CPU platform "
                  "(shared physical cores)")
        else:
            bad = [r for r in rows
                   if r["devices"] >= 2
                   and r["efficiency_vs_first"] < args.assert_efficiency]
            if bad:
                print(f"FAIL: {len(bad)} rows below efficiency bound "
                      f"{args.assert_efficiency}: "
                      + ", ".join(f"{r['devices']}dev@{r['size']}="
                                  f"{r['efficiency_vs_first']}" for r in bad))
                sys.exit(1)
            print(f"scaling efficiency >= {args.assert_efficiency} on all "
                  f">=2-device rows")


if __name__ == "__main__":
    main()
