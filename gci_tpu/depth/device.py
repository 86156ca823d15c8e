"""Device depth pipeline: scatter + prefix-sum + interval masks.

The per-base genome axis is where the reference burns its time in serial
Python loops (GCI.py:302-306, 315-353, 356-390).  Here it is laid out as one
concatenated int32 axis (gci_tpu.depth.accum.GenomeLayout) and every per-base
stage is an elementwise/scan op XLA can fuse and tile:

* depth       — difference-array scatter (``.at[].add``) + ``jnp.cumsum``
* gap masking — boolean mask multiply (gap intervals -> same diff/scan trick)
* two-type    — ``jnp.maximum``
* intervals   — in-range compare + shifted-XOR edge flags; host compacts the
  (rare) edges into interval lists with the exact reference quirks applied

The sharded version runs over a (dp, gp) mesh via shard_map: each device
scatter-adds its *read shard* into its *genome shard* (dp = data parallel
over reads), partial deltas merge with an all-reduce (psum over dp), and
the prefix sum is a local scan + exclusive scan of per-shard totals
(all_gather over gp) — the collective formulation of the genome-coordinate
axis ("sequence parallel" here).  Interval edges stitch across shard borders
with a ppermute of each shard's last mask element.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gci_tpu.depth.accum import GenomeLayout, clamp_read_intervals


# ---------------------------------------------------------------------------
# read packing (host -> device operands)
# ---------------------------------------------------------------------------

_INT32_MAX = np.iinfo(np.int32).max


def pack_read_deltas(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global (start_slot, stop_slot, live) arrays with slice-exact clamping.

    int32 slot indices — only valid for single-chip layouts below 2^31 slots.
    Larger genomes must use the streamed path (int64 host arithmetic) or the
    sharded path (``pack_read_deltas_sharded``: shard-local int32 offsets
    derived from int64 bases, no global-int32 anywhere).
    """
    if layout.total_slots > _INT32_MAX:
        raise OverflowError(
            f"{layout.total_slots} slots exceed int32 global indexing; use "
            "pack_read_deltas_sharded (sharded backend) or the streamed path"
        )
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    gs = (base + s).astype(np.int32)
    ge = (base + e).astype(np.int32)
    live = (e > s).astype(np.int32)
    if pad_to is not None and gs.shape[0] < pad_to:
        padn = pad_to - gs.shape[0]
        gs = np.concatenate([gs, np.zeros(padn, np.int32)])
        ge = np.concatenate([ge, np.zeros(padn, np.int32)])
        live = np.concatenate([live, np.zeros(padn, np.int32)])
    return gs, ge, live


def pack_read_deltas_sharded(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    shard_slots: int,
    pad_to: int | None = None,
) -> tuple[np.ndarray, ...]:
    """(gs_shard, gs_off, ge_shard, ge_off, live), all int32.

    Global slot arithmetic stays int64 on host; each event is addressed as
    (genome-shard index, shard-local offset), so a >2^31-slot layout (e.g.
    3.1 Gbp x multi-hap sharded across a mesh) never touches int32 global
    indices.  Padding rows carry shard index -1 (matches no device).
    """
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    gs = base + s
    ge = base + e
    live = (e > s).astype(np.int32)
    out = (
        (gs // shard_slots).astype(np.int32),
        (gs % shard_slots).astype(np.int32),
        (ge // shard_slots).astype(np.int32),
        (ge % shard_slots).astype(np.int32),
        live,
    )
    if pad_to is not None and gs.shape[0] < pad_to:
        padn = pad_to - gs.shape[0]
        fills = (-1, 0, -1, 0, 0)
        out = tuple(
            np.concatenate([a, np.full(padn, f, np.int32)])
            for a, f in zip(out, fills)
        )
    return out


# ---------------------------------------------------------------------------
# single-device path
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("total_slots",))
def depth_single(gs, ge, live, total_slots: int):
    """Per-slot depth from packed read deltas (one device)."""
    delta = jnp.zeros(total_slots, dtype=jnp.int32)
    delta = delta.at[gs].add(live, mode="drop")
    delta = delta.at[ge].add(-live, mode="drop")
    return jnp.cumsum(delta)


@jax.jit
def two_type_max(hifi_depth, nano_depth):
    """Per-base max of two read types (GCI.py:332-353 on device)."""
    return jnp.maximum(hifi_depth, nano_depth)


@functools.partial(jax.jit, static_argnames=())
def interval_edges(depth, valid, leftmost, rightmost):
    """In-range mask edges over the concatenated axis.

    Returns (mask, rise, fall): ``rise[i]`` marks a run start at i,
    ``fall[i]`` marks the first out-of-range position after a run.  ``valid``
    excludes sentinel slots and out-of-scan-window positions so runs can not
    leak across target boundaries.
    """
    m = (depth > leftmost) & (depth <= rightmost) & valid
    prev = jnp.concatenate([jnp.zeros(1, dtype=bool), m[:-1]])
    rise = m & ~prev
    fall = ~m & prev
    return m, rise, fall


# ---------------------------------------------------------------------------
# sharded (dp, gp) path
# ---------------------------------------------------------------------------

def make_sharded_depth_fn(mesh: Mesh, total_slots: int):
    """Build the pjit-ted sharded depth step for a (dp, gp) mesh.

    Input read-event arrays — (gs_shard, gs_off, ge_shard, ge_off, live) from
    ``pack_read_deltas_sharded`` — are sharded over ``dp`` (each device holds
    a read shard, replicated over gp); the returned depth is sharded over
    ``gp``.  ``total_slots`` must be a multiple of the gp axis size.
    """
    from jax import shard_map

    from gci_tpu.depth.scan import prefix_sum

    gp = mesh.shape["gp"]
    assert total_slots % gp == 0, "pad the genome axis to the gp shard count"
    shard = total_slots // gp

    def step(gs_sh, gs_off, ge_sh, ge_off, live):
        gp_idx = jax.lax.axis_index("gp")
        # local scatter of this device's read shard into its genome shard
        delta = jnp.zeros(shard, dtype=jnp.int32)
        in1 = gs_sh == gp_idx
        in2 = ge_sh == gp_idx
        delta = delta.at[jnp.where(in1, gs_off, shard)].add(
            jnp.where(in1, live, 0), mode="drop"
        )
        delta = delta.at[jnp.where(in2, ge_off, shard)].add(
            jnp.where(in2, -live, 0), mode="drop"
        )
        # merge read-parallel partials: all-reduce over dp
        delta = jax.lax.psum(delta, "dp")
        # distributed prefix sum over the genome axis
        local = prefix_sum(delta)
        totals = jax.lax.all_gather(local[-1], "gp")  # (gp,)
        offset = jnp.sum(jnp.where(jnp.arange(gp) < gp_idx, totals, 0))
        return local + offset

    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
            out_specs=P("gp"),
        )
    )


def make_sharded_interval_fn(mesh: Mesh, total_slots: int):
    """Sharded in-range mask + edge flags with ppermute boundary stitching."""
    from jax import shard_map

    gp = mesh.shape["gp"]
    assert total_slots % gp == 0

    def step(depth, valid, leftmost, rightmost):
        m = (depth > leftmost[0]) & (depth <= rightmost[0]) & (valid > 0)
        gp_idx = jax.lax.axis_index("gp")
        # previous shard's last element (False for shard 0)
        last = m[-1:]
        perm = [(i, i + 1) for i in range(gp - 1)]
        prev_last = jax.lax.ppermute(last, "gp", perm)
        prev_last = jnp.where(gp_idx == 0, False, prev_last[0])
        prev = jnp.concatenate([prev_last[None], m[:-1]])
        rise = m & ~prev
        fall = ~m & prev
        # the in-range mask itself is never read back (edges compact
        # per-shard) — not writing it saves an O(genome) HBM stream
        return rise, fall

    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P("gp"), P("gp"), P(), P()),
            out_specs=(P("gp"), P("gp")),
        )
    )


def make_sharded_change_fn(mesh: Mesh, total_slots: int):
    """Sharded run-boundary detector: change[i] = depth[i] != depth[i-1].

    ppermute carries each shard's last depth to its right neighbor; global
    position 0 is forced to a change (run start).  The int8 bitmap is the
    device->host handoff for RLE extraction (checkpoint write, event-space
    views) — 1 byte/slot instead of 4 for the full depth.
    """
    from jax import shard_map

    gp = mesh.shape["gp"]
    assert total_slots % gp == 0

    def step(depth):
        gp_idx = jax.lax.axis_index("gp")
        last = depth[-1:]
        perm = [(i, i + 1) for i in range(gp - 1)]
        prev_last = jax.lax.ppermute(last, "gp", perm)
        # force a run boundary at global position 0
        prev_last = jnp.where(gp_idx == 0, depth[0] - 1, prev_last[0])
        prev = jnp.concatenate([prev_last[None], depth[:-1]])
        return (depth != prev).astype(jnp.int8)

    return jax.jit(
        shard_map(step, mesh=mesh, in_specs=(P("gp"),), out_specs=P("gp"))
    )


def make_sharded_count_fn(mesh: Mesh, n_bitmaps: int):
    """Per-gp-shard nonzero counts for ``n_bitmaps`` sharded int8 bitmaps.

    Output: one (gp,) int32 array per bitmap — the tiny readback that sizes
    the per-shard compaction below.
    """
    from jax import shard_map

    def step(*bitmaps):
        return tuple(
            jnp.sum(b != 0, dtype=jnp.int32)[None] for b in bitmaps
        )

    return jax.jit(
        shard_map(
            step, mesh=mesh,
            in_specs=tuple(P("gp") for _ in range(n_bitmaps)),
            out_specs=tuple(P("gp") for _ in range(n_bitmaps)),
        )
    )


def make_sharded_compact_gather_fn(mesh: Mesh, size: int, k_off: int):
    """Per-shard bitmap compaction + value gather under shard_map.

    Each gp shard compacts its LOCAL bitmap into ``size`` sorted local
    indices (-1 padded) and gathers ``values`` at those indices plus at
    ``k_off`` extra per-shard local offsets — so the host readback is
    O(edges + offsets) instead of the O(genome) bitmap, with only int32
    shard-local indexing (valid at any genome size).  This sidesteps both
    XLA's SPMD partitioner on sharded flatnonzero (minutes) and multi-GB
    bitmap pulls to the host.
    """
    from jax import shard_map

    from gci_tpu.depth.scan import prefix_sum

    def step(bitmap, values, loff):
        pos = prefix_sum((bitmap != 0).astype(jnp.int32))
        kk = jnp.arange(1, size + 1, dtype=pos.dtype)
        idx = jnp.where(
            kk <= pos[-1], jnp.searchsorted(pos, kk), -1
        ).astype(jnp.int32)
        vals = jnp.take(values, jnp.clip(idx, 0, None))
        ovals = jnp.take(values, jnp.clip(loff[0], 0, None))
        return idx[None], vals[None], ovals[None]

    return jax.jit(
        shard_map(
            step, mesh=mesh,
            in_specs=(P("gp"), P("gp"), P("gp", None)),
            out_specs=(P("gp", None), P("gp", None), P("gp", None)),
        )
    )


# ---------------------------------------------------------------------------
# host-side interval compaction (shared by single and sharded paths)
# ---------------------------------------------------------------------------

def build_scan_valid(layout: GenomeLayout, flank_len: int, pad_to: int | None = None) -> np.ndarray:
    """Boolean per-slot mask of positions inside each target's scan window.

    Scan window = [flank, L-flank) per target (empty when L <= 2*flank),
    matching the slice the reference iterates (GCI.py:374).
    """
    total = layout.total_slots
    valid = np.zeros(pad_to or total, dtype=bool)
    for k in range(len(layout.names)):
        L = int(layout.lengths[k])
        if L - 2 * flank_len <= 0:
            continue
        o = int(layout.offsets[k])
        valid[o + flank_len : o + L - flank_len] = True
    return valid


def edges_to_intervals(
    layout: GenomeLayout,
    rise: np.ndarray,
    fall: np.ndarray,
    mask_last_valid: np.ndarray,
    flank_len: int,
    start_pos: int = 0,
) -> dict[str, list[tuple[int, int]]]:
    """Compact device edge bitmaps into reference-exact interval dicts.

    Applies the reference emission quirks (drop when the run terminates at a
    scan index <= flank_len; final-position closure).
    """
    return edge_indices_to_intervals(
        layout, np.flatnonzero(rise), np.flatnonzero(fall), flank_len, start_pos
    )


def edge_indices_to_intervals(
    layout: GenomeLayout,
    rise_idx: np.ndarray,
    fall_idx: np.ndarray,
    flank_len: int,
    start_pos: int = 0,
) -> dict[str, list[tuple[int, int]]]:
    """Same compaction from already-extracted edge *indices* (sorted, global
    concatenated-axis coordinates) — the O(edges) device->host handoff."""
    from gci_tpu.intervals.collapse import runs_to_intervals

    out: dict[str, list[tuple[int, int]]] = {}
    for k, name in enumerate(layout.names):
        L = int(layout.lengths[k])
        o = int(layout.offsets[k])
        n_scan = L - 2 * flank_len
        if n_scan <= 0:
            out[name] = []
            continue
        w_lo = o + flank_len
        w_hi = o + L - flank_len  # exclusive end of scan window
        r = rise_idx[(rise_idx >= w_lo) & (rise_idx < w_hi)] - w_lo
        f = fall_idx[(fall_idx >= w_lo) & (fall_idx <= w_hi)] - w_lo
        # a run still open at the final scanned position has no fall edge
        # inside the window (the next slot is invalid -> mask False there,
        # but fall at w_hi may appear; normalize to n_scan)
        if r.shape[0] > f.shape[0]:
            f = np.concatenate([f, [n_scan]])
        elif f.shape[0] > r.shape[0]:  # defensive; cannot happen with valid masks
            f = f[: r.shape[0]]
        f = np.minimum(f, n_scan)
        out[name] = runs_to_intervals(r, f, n_scan, flank_len, start_pos)
    return out
