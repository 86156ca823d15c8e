"""Device (JAX) filter masks — the accelerator path of the cascade.

Same predicates as gci_tpu.filters.cascade (GCI.py:156,165) evaluated
elementwise on device in float32.  The bit-parity pipeline uses the host
float64 masks; this path exists for on-device end-to-end throughput where
the packed columns are already device-resident.
"""
from __future__ import annotations

import jax.numpy as jnp

FLAG_EXCLUDE = 4 | 256 | 2048  # unmapped | secondary | supplementary


def bam_filter_mask_device(
    flag, mapq, m, i, d, s, eq, x, nm,
    map_qual: int = 30,
    clip_percent: float = 0.1,
    iden_percent: float = 0.9,
):
    base = ((flag & FLAG_EXCLUDE) == 0) & (mapq >= map_qual)
    mf = m.astype(jnp.float32)
    if_ = i.astype(jnp.float32)
    df = d.astype(jnp.float32)
    sf = s.astype(jnp.float32)
    mex = mf + eq.astype(jnp.float32) + x.astype(jnp.float32)
    mm = nm.astype(jnp.float32) - (if_ + df)
    clip_ok = sf <= clip_percent * (mex + if_ + sf)
    iden_ok = (mex - mm) >= iden_percent * (mex + if_ + df)
    return base & clip_ok & iden_ok
