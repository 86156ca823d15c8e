"""Compiled-kernel checks for the GPU: each Triton scan kernel against its
plain XLA reference, exact, on device-generated inputs.  Run by the
``gpu``-marked test in tests/test_pallas_scan.py and by chip_smoke.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gci_tpu.depth import scan


def packed_word(n: int, seed: int = 0):
    """A packed event-word axis built on the device: overlapping read
    intervals (depth up to tens), disjoint gap intervals, one valid span."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    n_reads = max(n // 2000, 8)
    s = jax.random.randint(k1, (n_reads,), 0, n - n // 8)
    ln = jax.random.randint(k2, (n_reads,), 1, max(n // 16, 2))
    w = jnp.zeros(n, jnp.int32).at[s].add(4).at[s + ln].add(-4)
    n_gaps = 64
    stride = n // n_gaps
    g = jnp.arange(n_gaps) * stride + jax.random.randint(k3, (n_gaps,), 0, stride // 2)
    w = w.at[g].add(2).at[g + stride // 4].add(-2)
    return w.at[1].add(1).at[n - 2].add(-1)


def check_compiled_scans(sizes) -> None:
    """Assert kernel == XLA reference for both scans at each axis size
    (each a multiple of ``scan.BLOCK``), on jax's default device."""
    assert jax.devices()[0].platform == "gpu", jax.devices()
    for n in sizes:
        assert scan.use_kernel("gpu", n), n
        w = packed_word(n)
        for lo, hi in ((-1, 0), (-1, 5)):
            got = scan.packed_scan_kernel(w, lo, hi)
            want = jax.jit(scan.fused_depth_scan_packed_xla)(w, lo, hi)
            for g, r in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        # large-magnitude deltas: int32 wraparound must match jnp.cumsum
        x = jax.random.randint(
            jax.random.PRNGKey(1), (n,), -(2**23), 2**23, jnp.int32
        )
        np.testing.assert_array_equal(
            np.asarray(scan.prefix_sum_kernel(x)),
            np.asarray(jax.jit(jnp.cumsum)(x)),
        )
