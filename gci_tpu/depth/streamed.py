"""Streamed depth accumulation for genomes larger than device memory.

A genome whose resident axis would not fit beside its workspaces in device
memory, or would exceed int32 slot indexing (``accum.stream_slot_limit``),
is processed in fixed-size chunks of the concatenated genome axis:

* read events (start:+1, stop:-1 slots) are host-sorted once (int64); each
  chunk's event slice is found with two searchsorted calls;
* the chunk carry (depth just before the chunk) is exact:
  ``#starts < a  −  #stops < a`` — no sequential dependency between chunks
  beyond two binary searches, so chunks could even run on different devices;
* per chunk the device scatters its events and runs the prefix-sum scan
  (gci_tpu.depth.scan.prefix_sum), the host pulls the finished chunk.

Device memory is O(chunk), independent of genome size.  Two consumers:

* ``accumulate_depth_streamed`` — the flat per-base array (oracle/tests and
  hosts with per-base room);
* ``events_from_reads_streamed`` — run-length events per target
  (O(runs) host memory): each chunk's run boundaries are compacted ON
  device (count + static-size flatnonzero) with the carry seeding the
  cross-chunk boundary, so a >HBM genome flows through depth, gap masking,
  two-type max, interval calling and the checkpoint writer without EVER
  materializing a per-base array anywhere (host or device).
"""
from __future__ import annotations

import functools

import numpy as np

from gci_tpu.depth.accum import GenomeLayout, clamp_read_intervals


def _sorted_events(layout, target_id, start, end, flank_len):
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    live = e > s
    base = layout.offsets[target_id]
    gs = np.sort((base + s)[live].astype(np.int64))
    ge = np.sort((base + e)[live].astype(np.int64))
    return gs, ge


def _chunk_plan(total, gs, ge, chunk_slots):
    n_chunks = -(-total // chunk_slots)
    bounds = np.arange(n_chunks + 1, dtype=np.int64) * chunk_slots
    gs_lo = np.searchsorted(gs, bounds[:-1])
    gs_hi = np.searchsorted(gs, np.minimum(bounds[1:], total))
    ge_lo = np.searchsorted(ge, bounds[:-1])
    ge_hi = np.searchsorted(ge, np.minimum(bounds[1:], total))
    max_ev = max(1, int(max((gs_hi - gs_lo).max(), (ge_hi - ge_lo).max(), 0)))
    return n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi, max_ev


CHUNK_SLOTS = 256 * 1024 * 1024


def resident_chunk_slots(total: int, chunk_slots: int = CHUNK_SLOTS) -> int:
    """The chunk size the streamed scan uses: a whole number of scan blocks,
    no larger than the block-padded genome.  The overlap accumulators shape
    their device deltas with the same value; a padded tail carries zero
    deltas."""
    from gci_tpu.depth.scan import BLOCK, pad_to_block

    chunk_slots = min(chunk_slots, pad_to_block(total))
    return max(BLOCK, chunk_slots - chunk_slots % BLOCK)


def _iter_depth_chunks(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    chunk_slots: int,
):
    """Yield (a, b, depth_chunk_device, carry) over the concatenated axis."""
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum as scan

    total = layout.total_slots
    chunk_slots = resident_chunk_slots(total, chunk_slots)
    gs, ge = _sorted_events(layout, target_id, start, end, flank_len)
    n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi, max_ev = _chunk_plan(
        total, gs, ge, chunk_slots
    )

    @jax.jit
    def chunk_step(gs_sel, ge_sel, carry):
        delta = jnp.zeros(chunk_slots, jnp.int32)
        delta = delta.at[gs_sel].add(jnp.where(gs_sel < chunk_slots, 1, 0), mode="drop")
        delta = delta.at[ge_sel].add(jnp.where(ge_sel < chunk_slots, -1, 0), mode="drop")
        return scan(delta) + carry

    for c in range(n_chunks):
        a = int(bounds[c])
        b = min(a + chunk_slots, total)
        gsel = gs[gs_lo[c] : gs_hi[c]] - a
        gesel = ge[ge_lo[c] : ge_hi[c]] - a
        # pad with out-of-range sentinels (dropped by the scatter); static
        # pad so one compiled program serves every chunk
        gsel = np.pad(gsel, (0, max_ev - gsel.shape[0]), constant_values=chunk_slots)
        gesel = np.pad(gesel, (0, max_ev - gesel.shape[0]), constant_values=chunk_slots)
        carry = np.int32(gs_lo[c] - ge_lo[c])
        depth_chunk = chunk_step(
            jnp.asarray(gsel.astype(np.int32)),
            jnp.asarray(gesel.astype(np.int32)),
            carry,
        )
        yield a, b, depth_chunk, int(carry)


def accumulate_depth_streamed(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    chunk_slots: int = CHUNK_SLOTS,
) -> np.ndarray:
    """Flat per-slot int32 depth, computed chunk-by-chunk on device."""
    out = np.empty(layout.total_slots, dtype=np.int32)
    for a, b, depth_chunk, _ in _iter_depth_chunks(
        layout, target_id, start, end, flank_len, chunk_slots,
    ):
        out[a:b] = np.asarray(depth_chunk[: b - a])
    return out


@functools.lru_cache(maxsize=64)
def _compact_gather_fn(size: int):
    """Sort-free compaction + value gather (see fused._compact_fn: a
    flatnonzero would sort the whole chunk)."""
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum

    def f(depth, change):
        pos = prefix_sum((change != 0).astype(jnp.int32))
        k = jnp.arange(1, size + 1, dtype=pos.dtype)
        idx = jnp.searchsorted(pos, k)
        idx = jnp.where(k <= pos[-1], idx, -1)
        vals = jnp.take(depth, jnp.clip(idx, 0, None))
        return idx, vals

    return jax.jit(f)


def events_from_delta2d_streamed(
    layout: GenomeLayout,
    delta2d,
    chunk_slots: int = CHUNK_SLOTS,
):
    """{target: DepthEvents} from a device-resident (n_chunks, chunk_slots)
    delta (the pack<->scatter overlap path).

    Chunk carries come from one device pass over the resident delta
    (per-chunk sums, host cumsum) instead of the sorted-event counts;
    everything downstream is the same 2-calls-per-chunk economy as
    ``events_from_reads_streamed``.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.base import events_from_change_indices
    from gci_tpu.depth.scan import prefix_sum as scan

    total = layout.total_slots
    n_chunks, cs = delta2d.shape
    assert cs == resident_chunk_slots(total, chunk_slots), (
        "resident delta chunking must match the scan plan"
    )

    sums = np.asarray(
        jax.jit(lambda d: jnp.sum(d, axis=1, dtype=jnp.int32))(delta2d)
    ).astype(np.int64)
    carries = np.concatenate([[0], np.cumsum(sums)[:-1]])

    @jax.jit
    def chunk_step(delta, carry, prev0):
        depth = scan(delta) + carry
        prev = jnp.concatenate([prev0[None].astype(depth.dtype), depth[:-1]])
        change = (depth != prev).astype(jnp.int8)
        return depth, change, jnp.sum(change, dtype=jnp.int32)

    all_idx: list[np.ndarray] = []
    all_vals: list[np.ndarray] = []
    for c in range(n_chunks):
        a = c * cs
        if a >= total:
            break
        b = min(a + cs, total)
        carry = np.int32(carries[c])
        prev0 = np.int32(carry if a > 0 else -1)
        depth_chunk, change, n = chunk_step(
            delta2d[c], carry, jnp.asarray(prev0)
        )
        n = int(n)
        if n == 0:
            continue
        size = 1 << (n - 1).bit_length()
        idx_d, vals_d = _compact_gather_fn(size)(depth_chunk, change)
        idx = np.asarray(idx_d)[:n].astype(np.int64)
        vals = np.asarray(vals_d)[:n].astype(np.int64)
        keep = idx < (b - a)
        idx, vals = idx[keep], vals[keep]
        if idx.shape[0] == 0:
            continue
        all_idx.append(idx + a)
        all_vals.append(vals)

    idx = np.concatenate(all_idx) if all_idx else np.zeros(1, np.int64)
    vals = np.concatenate(all_vals) if all_vals else np.zeros(1, np.int64)

    def gather(query: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(idx, query, side="right") - 1
        return vals[np.clip(pos, 0, None)]

    return events_from_change_indices(layout, idx, gather)


def events_from_reads_streamed(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    chunk_slots: int = CHUNK_SLOTS,
):
    """{target: DepthEvents} for a streamed genome — O(runs) everywhere.

    Per chunk: run-boundary bitmap on device (seeded with the exact carry,
    so runs spanning chunk borders produce no spurious boundary), device
    compaction, one O(runs-in-chunk) value gather.  Downstream gap masking /
    two-type max / interval calling run in event space, so the whole
    pipeline — including the issue BED (GCI.py:356-390) and the checkpoint
    writer (GCI.py:99-143) — never touches a per-base array.

    Two device calls per chunk: scan+change+count with a scalar readback,
    then a static-size compaction+gather.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.base import events_from_change_indices
    from gci_tpu.depth.scan import prefix_sum as scan

    total = layout.total_slots
    chunk_slots = resident_chunk_slots(total, chunk_slots)
    gs, ge = _sorted_events(layout, target_id, start, end, flank_len)
    n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi, max_ev = _chunk_plan(
        total, gs, ge, chunk_slots
    )

    @jax.jit
    def chunk_step(gs_sel, ge_sel, carry, prev0):
        delta = jnp.zeros(chunk_slots, jnp.int32)
        delta = delta.at[gs_sel].add(
            jnp.where(gs_sel < chunk_slots, 1, 0), mode="drop"
        )
        delta = delta.at[ge_sel].add(
            jnp.where(ge_sel < chunk_slots, -1, 0), mode="drop"
        )
        depth = scan(delta) + carry
        prev = jnp.concatenate([prev0[None].astype(depth.dtype), depth[:-1]])
        change = (depth != prev).astype(jnp.int8)
        return depth, change, jnp.sum(change, dtype=jnp.int32)

    all_idx: list[np.ndarray] = []
    all_vals: list[np.ndarray] = []
    for c in range(n_chunks):
        a = int(bounds[c])
        b = min(a + chunk_slots, total)
        gsel = gs[gs_lo[c] : gs_hi[c]] - a
        gesel = ge[ge_lo[c] : ge_hi[c]] - a
        gsel = np.pad(gsel, (0, max_ev - gsel.shape[0]), constant_values=chunk_slots)
        gesel = np.pad(gesel, (0, max_ev - gesel.shape[0]), constant_values=chunk_slots)
        carry = np.int32(gs_lo[c] - ge_lo[c])
        # chunk 0: force a boundary at position 0 (carry is 0 there; -1
        # differs from any real depth)
        prev0 = np.int32(carry if a > 0 else -1)
        depth_chunk, change, n = chunk_step(
            jnp.asarray(gsel.astype(np.int32)),
            jnp.asarray(gesel.astype(np.int32)),
            carry,
            jnp.asarray(prev0),
        )
        n = int(n)
        if n == 0:
            continue
        size = 1 << (n - 1).bit_length()
        idx_d, vals_d = _compact_gather_fn(size)(depth_chunk, change)
        idx = np.asarray(idx_d)[:n].astype(np.int64)
        vals = np.asarray(vals_d)[:n].astype(np.int64)
        keep = idx < (b - a)
        idx, vals = idx[keep], vals[keep]
        if idx.shape[0] == 0:
            continue
        all_idx.append(idx + a)
        all_vals.append(vals)

    idx = np.concatenate(all_idx) if all_idx else np.zeros(1, np.int64)
    vals = np.concatenate(all_vals) if all_vals else np.zeros(1, np.int64)

    def gather(query: np.ndarray) -> np.ndarray:
        # value of the run containing each queried slot (forced target
        # starts may fall inside a run)
        pos = np.searchsorted(idx, query, side="right") - 1
        return vals[np.clip(pos, 0, None)]

    return events_from_change_indices(layout, idx, gather)
