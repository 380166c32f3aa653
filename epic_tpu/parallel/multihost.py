"""Multi-host bring-up for solves over several hosts' devices.

The reference has no distributed transport at all (single GPU, cudaMemcpy
only — SURVEY §5). Here, scaling past one host is configuration, not new
solver code: initialise the JAX distributed runtime, build the global 2D
mesh over every device, and the halo-exchange solver
(:mod:`epic_tpu.parallel.sharded`) runs unchanged — `ppermute` neighbours
inside a host ride NVLink, across hosts the network, and the staggered
`pmax` residual is a global collective.

Typical driver (same script on every host):

    from epic_tpu.parallel import multihost, make_mesh, sharded
    multihost.initialize("host0:1234", 2, rank)   # coordinator, count, id
    mesh = make_mesh()                      # all devices across all hosts
    state = ...                             # identical on every host
    out = sharded.solve(state, mesh)

This module is exercised on a virtual multi-device mesh in CI; real
multi-host runs need only the environment variables JAX's distributed
runtime documents (coordinator_address etc.).
"""

from __future__ import annotations


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialise jax.distributed (no-op if already initialised or running
    single-process). Pass the coordinator address, process count and this
    process's id; nothing detects a cluster by itself."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Already initialised, or single-process context without coordinator
        # configuration — both fine for local use.
        if "already initialized" not in str(e).lower() and num_processes not in (None, 1):
            raise


def is_multi_process() -> bool:
    import jax

    return jax.process_count() > 1
