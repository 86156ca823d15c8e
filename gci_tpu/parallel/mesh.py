"""Device mesh helpers.

The engine's parallel axes (SURVEY.md §2.3 mapping):

* ``dp`` — data parallelism over the *reads* axis: each device scatter-adds
  its read shard's depth deltas; partials merge with an all-reduce
  (replaces the reference's multiprocessing.Pool over genome windows).
* ``gp`` — genome-coordinate parallelism (the moral equivalent of sequence
  parallelism here): the concatenated per-base axis is sharded for the
  prefix-sum / interval scans, with collective stitching at shard borders.

The cards of one host are joined all to all (NVLink on an H100 host), so
the mesh follows the algorithm alone and XLA hands the collectives to NCCL.
Across hosts, ``dp`` is laid out over hosts (each host packs a disjoint
read shard; the network between hosts only carries the all-reduce) and
``gp`` stays within a host.
"""
from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None, dp: int | None = None):
    """Build a (dp, gp) mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    n = n_devices or devices.size
    devices = devices[:n]
    if dp is None:
        # favor genome-axis parallelism; dp absorbs the rest
        gp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                gp = max(gp, n // cand)
        dp = n // gp
    else:
        gp = n // dp
    return Mesh(devices.reshape(dp, gp), axis_names=("dp", "gp"))


def pad_to_multiple(x: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = np.full((rem,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)
