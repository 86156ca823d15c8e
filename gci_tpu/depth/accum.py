"""Per-base depth accumulation over the concatenated genome axis.

The reference walks reads one at a time doing
``depths[target][start+flank : end-flank+1] += 1`` (GCI.py:302-306).  We
reformulate as a difference array: +1 at the clamped interval start, −1 at
its exclusive stop, then a single prefix sum.  Laying every target out on one
concatenated axis with one sentinel slot per target (so a stop at position
L_t stays inside the target's slots) makes the prefix sum *global*: within
each target the deltas cancel, so the running sum re-zeroes at every target
boundary and one cumsum yields all per-base depths.  This is the
scan-friendly formulation that shards across devices (per-shard scan +
exclusive scan of shard totals; see gci_tpu.depth.device).

Clamp semantics replicate numpy/python slice arithmetic on the reference's
``[start+flank : end-flank+1]`` — including the negative-stop wraparound for
alignments shorter than the flank (a documented reference quirk).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# the resident axis is indexed by int32 slot numbers
INT32_SLOTS = 2**31 - 1
# peak device bytes per genome slot of a resident run: measured 29.0 (peak
# bytes in use over slots of a dual-type 396M-slot run on an H100; the
# construction's packed word, depth, flags and compaction ranks), plus
# headroom
RESIDENT_BYTES_PER_SLOT = 32


def stream_slot_limit() -> int:
    """Largest genome axis the resident single-device path takes; the
    ``device`` backend streams larger ones in chunks
    (gci_tpu.depth.streamed).  The smaller of the int32 index bound and
    what the device allocator's ``bytes_limit`` holds at
    ``RESIDENT_BYTES_PER_SLOT``."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        return INT32_SLOTS
    return min(INT32_SLOTS, int(stats["bytes_limit"]) // RESIDENT_BYTES_PER_SLOT)


@dataclass(frozen=True)
class GenomeLayout:
    """Concatenated coordinate axis: one slot span of L_t + 1 per target."""

    names: tuple[str, ...]
    lengths: np.ndarray  # int64, per target
    offsets: np.ndarray  # int64, size n_targets + 1; stride = length + 1

    @classmethod
    def from_targets(cls, targets_length: dict[str, int]) -> "GenomeLayout":
        names = tuple(targets_length.keys())
        lengths = np.array(list(targets_length.values()), dtype=np.int64)
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum(lengths + 1, out=offsets[1:])
        return cls(names, lengths, offsets)

    @property
    def total_slots(self) -> int:
        return int(self.offsets[-1])


def clamp_read_intervals(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Python-slice-exact [s, e) bounds per read, in local target coordinates.

    Replicates ``a[start+flank : end-flank+1] += 1`` slice clamping:
    negative stop wraps by +L (then clamps at 0), and both bounds clamp to
    [0, L].
    """
    L = layout.lengths[target_id]
    s = start.astype(np.int64) + flank_len
    e = end.astype(np.int64) - flank_len + 1
    e = np.where(e < 0, e + L, e)
    e = np.clip(e, 0, L)
    s = np.clip(s, 0, L)
    return s, e


def accumulate_depth_numpy(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
) -> np.ndarray:
    """Flat per-slot depth (int32) over the concatenated axis (host path)."""
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    live = e > s
    base = layout.offsets[target_id]
    gs = (base + s)[live]
    ge = (base + e)[live]
    total = layout.total_slots
    delta = np.bincount(gs, minlength=total).astype(np.int64)
    delta -= np.bincount(ge, minlength=total + 1)[:total]
    return np.cumsum(delta).astype(np.int32)


def accumulate_depth(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    backend: str = "auto",
) -> np.ndarray:
    """Flat per-slot depth; device scan or host numpy backend.

    backend: "auto" uses the device when jax's default backend is not the
    cpu; "device" forces it; "numpy" forces the host path.  Both produce
    identical int32 results (tests assert equality).
    """
    if backend == "auto":
        import jax

        backend = "numpy" if jax.default_backend() == "cpu" else "device"
    if backend != "device":
        return accumulate_depth_numpy(layout, target_id, start, end, flank_len)

    if layout.total_slots > stream_slot_limit():
        from gci_tpu.depth.streamed import accumulate_depth_streamed

        return accumulate_depth_streamed(
            layout, target_id, start, end, flank_len
        )

    import jax.numpy as jnp

    from gci_tpu.depth.scan import pad_to_block, prefix_sum

    total = layout.total_slots
    gs, ge, live = _pack_deltas(layout, target_id, start, end, flank_len)
    delta = jnp.zeros(pad_to_block(total), jnp.int32)
    delta = delta.at[jnp.asarray(gs)].add(jnp.asarray(live), mode="drop")
    delta = delta.at[jnp.asarray(ge)].add(-jnp.asarray(live), mode="drop")
    depth = prefix_sum(delta)
    return np.asarray(depth[:total])


def _pack_deltas(layout, target_id, start, end, flank_len):
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    return (
        (base + s).astype(np.int32),
        (base + e).astype(np.int32),
        (e > s).astype(np.int32),
    )


def depth_dict_from_flat(layout: GenomeLayout, flat: np.ndarray) -> dict[str, np.ndarray]:
    """Slice the concatenated axis back into per-target arrays (no sentinel)."""
    out: dict[str, np.ndarray] = {}
    for k, name in enumerate(layout.names):
        o = layout.offsets[k]
        out[name] = flat[o : o + layout.lengths[k]]
    return out
