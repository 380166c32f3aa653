"""Device-side padded-layout construction for the sharded paths.

:func:`box_mask` builds an axis-aligned interior box from
``broadcasted_iota`` on the device, so padding a grid for a mesh is one
jitted program with no host mask upload.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def box_mask(shape, lo, hi):
    """True where lo[d] <= index_d < hi[d] on every axis (trace-time)."""
    m = None
    for ax, (l, h) in enumerate(zip(lo, hi)):
        i = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        t = (i >= l) & (i < h)
        m = t if m is None else m & t
    return m
