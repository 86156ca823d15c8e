"""Single-device resident depth: the production construction.

``depth_backend="device"`` routes ``run_gci`` through this module.  One
packed-word scan (gci_tpu.depth.scan.packed_scan; the unpacked flags scan
remains for inputs past ``PACKED_DEPTH_LIMIT`` reads) replaces the
reference's four hot per-base loops —
depth accumulation (GCI.py:302-306), gap masking (GCI.py:315-329), the issue
interval scan (GCI.py:356-390) and the run boundaries behind the checkpoint
writer (GCI.py:99-143) — with a single pass over device memory on the
concatenated genome axis.  Everything that leaves the device is
O(reads + runs + edges):

* the checkpoint writer reads run boundaries (compacted ON device with a
  count + static-size ``flatnonzero``, so the transfer is O(runs) indices,
  not an O(genome) bitmap) plus one value gather;
* the issue BED reads edge indices (same compaction);
* the per-base axis itself never crosses to host.

On the GPU the scans are the Triton kernels of gci_tpu.depth.scan; on the
CPU their XLA references run.  Both are asserted equal to the numpy oracle.
"""
from __future__ import annotations

import functools

import numpy as np

from gci_tpu.depth.accum import GenomeLayout
from gci_tpu.depth.base import ResidentDepth, events_from_change_indices


# ---------------------------------------------------------------------------
# jitted building blocks (cached so repeated pipeline stages share programs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _mask_fn(gap_bit: int):
    """Gap-zeroing select, parameterized on which flag bit marks a gap
    (bit0 in `_flags_fn`-built marks, bit3 in the packed scan's output
    flag byte)."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda d, marks: jnp.where((marks & gap_bit) != 0, 0, d))


@functools.lru_cache(maxsize=1)
def _elementwise_fns():
    import jax
    import jax.numpy as jnp

    # marks are flag bytes: bit0 = in-gap, bit1 = scan-window-valid
    mask = _mask_fn(1)
    vmax = jax.jit(jnp.maximum)

    def _change(x):
        prev = jnp.concatenate([x[:1] - 1, x[:-1]])  # forces change at 0
        return (x != prev).astype(jnp.int8)

    def _edges(depth, valid, lo, hi):
        m = (depth > lo[0]) & (depth <= hi[0]) & ((valid & 2) != 0)
        prev = jnp.concatenate([jnp.zeros(1, bool), m[:-1]])
        return (m & ~prev).astype(jnp.int8), (~m & prev).astype(jnp.int8)

    return mask, vmax, jax.jit(_change), jax.jit(_edges)


@functools.lru_cache(maxsize=64)
def _compact_fn(size: int):
    """Sort-free static-size bitmap compaction: prefix sum + searchsorted.

    ``jnp.flatnonzero(size=...)`` lowers through a full-length sort, while
    the k-th set index is just ``searchsorted(cumsum(bitmap), k)``: one
    prefix-sum pass plus an O(k log n) binary search batch.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum

    def f(bitmap):
        pos = prefix_sum((bitmap != 0).astype(jnp.int32))
        k = jnp.arange(1, size + 1, dtype=pos.dtype)
        idx = jnp.searchsorted(pos, k)
        return jnp.where(k <= pos[-1], idx, -1)

    return jax.jit(f)


@functools.lru_cache(maxsize=4)
def _counts_fn(n: int):
    """One program summing n bitmaps -> (n,) int32 counts (one readback)."""
    import jax
    import jax.numpy as jnp

    def f(*bitmaps):
        return jnp.stack([jnp.sum(b != 0, dtype=jnp.int32) for b in bitmaps])

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _compact_pack_fn(sizes: tuple, gather_stream: int):
    """One program compacting several bitmaps (static padded sizes) and
    gathering `values` at stream ``gather_stream``'s indices plus at the
    given offsets; everything returns as ONE packed int32 array.

    The edge/change readback is counts (1 dispatch) + this (1) + a single
    packed transfer, whatever the number of bitmaps.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum

    def f(values, offsets, *bitmaps):
        parts = []
        gathered = None
        for k, (b, size) in enumerate(zip(bitmaps, sizes)):
            if size == 0:
                idx = jnp.full((0,), -1, jnp.int32)
            else:
                pos = prefix_sum((b != 0).astype(jnp.int32))
                kk = jnp.arange(1, size + 1, dtype=pos.dtype)
                idx = jnp.where(
                    kk <= pos[-1], jnp.searchsorted(pos, kk), -1
                ).astype(jnp.int32)
            parts.append(idx)
            if k == gather_stream:
                gathered = jnp.take(values, jnp.clip(idx, 0, None))
        parts.append(gathered)
        parts.append(jnp.take(values, offsets))
        return jnp.concatenate(parts)

    return jax.jit(f)


@functools.lru_cache(maxsize=8)
def _flag_counts_fn(masks: tuple):
    """One program counting set bits per mask of a flag array."""
    import jax
    import jax.numpy as jnp

    def f(flags):
        return jnp.stack(
            [jnp.sum((flags & m) != 0, dtype=jnp.int32) for m in masks]
        )

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _flag_compact_pack_fn(sizes: tuple, masks: tuple, gather_stream: int):
    """Flag-array analogue of ``_compact_pack_fn``: each mask's bit-stream
    compacts to its static padded size in the same program."""
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum

    def f(values, offsets, flags):
        parts = []
        gathered = None
        for k, (m, size) in enumerate(zip(masks, sizes)):
            if size == 0:
                idx = jnp.full((0,), -1, jnp.int32)
            else:
                pos = prefix_sum(((flags & m) != 0).astype(jnp.int32))
                kk = jnp.arange(1, size + 1, dtype=pos.dtype)
                idx = jnp.where(
                    kk <= pos[-1], jnp.searchsorted(pos, kk), -1
                ).astype(jnp.int32)
            parts.append(idx)
            if k == gather_stream:
                gathered = jnp.take(values, jnp.clip(idx, 0, None))
        parts.append(gathered)
        parts.append(jnp.take(values, offsets))
        return jnp.concatenate(parts)

    return jax.jit(f)


def _batched_flags_readback(array, layout: GenomeLayout, flags, masks: tuple,
                            gather_stream: int):
    """Like ``_batched_edge_readback`` but over bit-masks of one packed
    flag array (the scan's rise/fall/change output)."""
    import jax.numpy as jnp

    counts = [int(c) for c in np.asarray(_flag_counts_fn(masks)(flags))]
    sizes = tuple(0 if c == 0 else 1 << (c - 1).bit_length() for c in counts)
    offsets = jnp.asarray(np.asarray(layout.offsets[:-1], np.int32))
    packed = np.asarray(
        _flag_compact_pack_fn(sizes, masks, gather_stream)(
            array, offsets, flags
        )
    )
    out_idx = []
    cursor = 0
    for c, s in zip(counts, sizes):
        out_idx.append(packed[cursor : cursor + c].astype(np.int64))
        cursor += s
    g_size = sizes[gather_stream]
    g_count = counts[gather_stream]
    gathered = packed[cursor : cursor + g_count].astype(np.int64)
    cursor += g_size
    offset_vals = packed[cursor:].astype(np.int64)
    return out_idx, gathered, offset_vals


def _batched_edge_readback(array, layout: GenomeLayout, bitmaps,
                           gather_stream: int):
    """Compact every bitmap and read values at the gather stream's indices
    and at all target offsets — 2 dispatches + 1 packed transfer total.

    Returns (list of int64 index arrays per bitmap, gathered values,
    values at layout.offsets).
    """
    import jax.numpy as jnp

    counts = [int(c) for c in np.asarray(_counts_fn(len(bitmaps))(*bitmaps))]
    sizes = tuple(
        0 if c == 0 else 1 << (c - 1).bit_length() for c in counts
    )
    offsets = jnp.asarray(np.asarray(layout.offsets[:-1], np.int32))
    packed = np.asarray(
        _compact_pack_fn(sizes, gather_stream)(array, offsets, *bitmaps)
    )
    out_idx = []
    cursor = 0
    for c, s in zip(counts, sizes):
        out_idx.append(packed[cursor : cursor + c].astype(np.int64))
        cursor += s
    g_size = sizes[gather_stream]
    g_count = counts[gather_stream]
    gathered = packed[cursor : cursor + g_count].astype(np.int64)
    cursor += g_size
    offset_vals = packed[cursor:].astype(np.int64)
    return out_idx, gathered, offset_vals


def compact_indices(bitmap) -> np.ndarray:
    """Device-side compaction of a nonzero bitmap into sorted int64 indices.

    Count first (scalar readback), then a static-size compaction padded
    to the next power of two (bounds recompiles to log2 sizes).  Transfers
    O(k) indices instead of the O(genome) bitmap — this is what keeps the
    device->host hop cheap on narrow host links.
    """
    import jax.numpy as jnp

    # int32 count is safe: resident axes are int32-indexed (< 2^31 slots)
    n = int(jnp.sum(bitmap != 0))
    if n == 0:
        return np.empty(0, np.int64)
    size = 1 << (n - 1).bit_length()
    idx = _compact_fn(size)(bitmap)
    # transfer the padded O(k) result and slice on host: a device-side
    # `idx[:n]` would dispatch an eager gather, which on a mesh-sharded
    # bitmap is pathologically slow
    return np.asarray(idx)[:n].astype(np.int64)


@functools.lru_cache(maxsize=16)
def _flags_fn(pad_total: int):
    """Flag-byte builder: gap intervals (bit0) + valid intervals (bit1) in
    ONE program — O(intervals) scatters + two device prefix sums; the host
    never materializes (or transfers) a per-base indicator array.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import prefix_sum

    def f(gap_s, gap_e, val_s, val_e):
        gd = jnp.zeros(pad_total, jnp.int32)
        gd = gd.at[gap_s].add(1, mode="drop")
        gd = gd.at[gap_e].add(-1, mode="drop")
        vd = jnp.zeros(pad_total, jnp.int32)
        vd = vd.at[val_s].add(1, mode="drop")
        vd = vd.at[val_e].add(-1, mode="drop")
        return (
            (prefix_sum(gd) > 0).astype(jnp.int8)
            + (prefix_sum(vd) > 0).astype(jnp.int8) * 2
        )

    return jax.jit(f)


def _valid_intervals(layout: GenomeLayout, flank_len: int):
    """[flank, L-flank) scan-window intervals per target (GCI.py:374)."""
    starts: list[int] = []
    stops: list[int] = []
    for k in range(len(layout.names)):
        L = int(layout.lengths[k])
        if L - 2 * flank_len <= 0:
            continue
        o = int(layout.offsets[k])
        starts.append(o + flank_len)
        stops.append(o + L - flank_len)
    return starts, stops


def flags_for(layout: GenomeLayout, gaps, flank_len: int, pad_total: int):
    """Device int8 flag bytes: bit0 = in-N-gap, bit1 = scan-window valid."""
    import jax.numpy as jnp

    from gci_tpu.depth.base import gap_interval_events

    gap_s, gap_e = gap_interval_events(layout, gaps)
    val_s, val_e = _valid_intervals(layout, flank_len)
    return _flags_fn(pad_total)(
        jnp.asarray(np.asarray(gap_s, np.int32)),
        jnp.asarray(np.asarray(gap_e, np.int32)),
        jnp.asarray(np.asarray(val_s, np.int32)),
        jnp.asarray(np.asarray(val_e, np.int32)),
    )


def valid_marks_for(layout: GenomeLayout, flank_len: int, pad_total: int):
    """Device int8 flag bytes with only the valid bit (bit1) populated."""
    return flags_for(layout, None, flank_len, pad_total)


@functools.lru_cache(maxsize=16)
def _fused_fn(pad_total: int):
    """Scatter + unpacked flags scan as one compiled program (static genome
    size).  Takes the combined flag bytes (bit0 gap, bit1 valid); returns
    (raw_depth, out_flags with bit0 rise, bit1 fall, bit2 change)."""
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import fused_depth_scan_flags_xla

    def step(gs, ge, live, flags, lo, hi):
        delta = jnp.zeros(pad_total, jnp.int32)
        delta = delta.at[gs].add(live, mode="drop")
        delta = delta.at[ge].add(-live, mode="drop")
        return fused_depth_scan_flags_xla(delta, flags, lo, hi)

    return jax.jit(step)


# depth-field bound of the packed event word (read_delta<<2): the packed
# scan is exact iff depth < 2^29 at every position — depth is bounded by
# the candidate read count, so the builders guard on that and take the
# unpacked flags scan beyond it (no realistic input gets there)
PACKED_DEPTH_LIMIT = 1 << 29


@functools.lru_cache(maxsize=16)
def _packed_events_fn(pad_total: int):
    """Read-delta + gap/valid interval events -> packed word -> packed scan,
    all one compiled program (the production single-device construction).

    ``word = read_delta<<2 | gap_event<<1 | valid_event``; returns
    (raw_depth, out_flags with bit0 rise, bit1 fall, bit2 change,
    bit3 in-gap).  The word is built by the same scatter that accumulates
    read deltas, so no separate flag-building pass runs.
    """
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.scan import packed_scan as scan

    def step(gs, ge, live4, gap_s, gap_e, val_s, val_e, lo, hi):
        w = jnp.zeros(pad_total, jnp.int32)
        w = w.at[gs].add(live4, mode="drop")
        w = w.at[ge].add(-live4, mode="drop")
        w = w.at[gap_s].add(2, mode="drop")
        w = w.at[gap_e].add(-2, mode="drop")
        w = w.at[val_s].add(1, mode="drop")
        w = w.at[val_e].add(-1, mode="drop")
        return scan(w, lo, hi)

    return jax.jit(step)


@functools.lru_cache(maxsize=16)
def _packed_from_delta_fn(pad_total: int):
    """Like ``_packed_events_fn`` but starting from an already-accumulated
    plain delta array (the pack<->scatter overlap path): the <<2 shift and
    the O(intervals) event adds fuse into the scan program's prologue."""
    import jax

    from gci_tpu.depth.scan import packed_scan as scan

    def step(delta, gap_s, gap_e, val_s, val_e, lo, hi):
        w = jax.lax.shift_left(delta, 2)
        w = w.at[gap_s].add(2, mode="drop")
        w = w.at[gap_e].add(-2, mode="drop")
        w = w.at[val_s].add(1, mode="drop")
        w = w.at[val_e].add(-1, mode="drop")
        return scan(w, lo, hi)

    return jax.jit(step)


# ---------------------------------------------------------------------------
# the resident-depth value
# ---------------------------------------------------------------------------

class DeviceDepth(ResidentDepth):
    """One read-type's whole-genome depth resident on a single device.

    Drop-in value for the pipeline's depth dictionaries (same dispatch
    surface as ``ShardedDepth``): gap masking, two-type max, interval
    collapse and checkpoint serialization stay on device; issue intervals
    for the run's threshold come pre-extracted from the construction scan.
    """

    def __init__(self, layout: GenomeLayout, array, pad_total: int,
                 gap_marks=None, gaps_src=None, edge_cache=None,
                 change_idx: np.ndarray | None = None, gap_bit: int = 1):
        self.layout = layout
        self.array = array          # jax int32 (pad_total,) — current depth
        self.pad_total = pad_total
        self.gap_marks = gap_marks  # jax int8 gap indicator, shared per run
        self.gap_bit = gap_bit      # which bit of gap_marks means "in gap"
        self._gaps_src = gaps_src   # the gaps dict gap_marks was built from
        self._edge_cache: dict = dict(edge_cache or {})
        self._change_idx = change_idx  # run boundaries of self.array
        self._pending_masked_edges = None  # (key, intervals) valid post-mask
        self._events = None
        # host value lookup for to_events: sorted positions + values at
        # (change indices union target offsets), filled by the batched
        # readback so to_events needs no further device round-trips
        self._gather_pos: np.ndarray | None = None
        self._gather_vals: np.ndarray | None = None

    def _set_gather_map(self, change_idx, change_vals, offset_vals) -> None:
        pos = np.concatenate(
            [change_idx, np.asarray(self.layout.offsets[:-1], np.int64)]
        )
        vals = np.concatenate([change_vals, offset_vals])
        order = np.argsort(pos, kind="stable")
        self._gather_pos = pos[order]
        self._gather_vals = vals[order]

    # ------------------------------------------------------------ construct
    @staticmethod
    def pad_total_for(total: int) -> int:
        """Padded genome-axis size: a whole number of scan-kernel blocks.
        Padded tail slots carry zero deltas and are never valid."""
        from gci_tpu.depth.scan import pad_to_block

        return pad_to_block(total)

    @staticmethod
    def gap_marks_for(layout: GenomeLayout, gaps, pad_total: int):
        """Device int8 flag bytes with only the gap bit (bit0) populated
        (None if no gaps) — built on device from O(gaps) scatter events."""
        import jax.numpy as jnp

        from gci_tpu.depth.base import gap_interval_events

        starts, stops = gap_interval_events(layout, gaps)
        if starts.shape[0] == 0:
            return None
        empty = jnp.zeros(0, jnp.int32)
        return _flags_fn(pad_total)(
            jnp.asarray(starts.astype(np.int32)),
            jnp.asarray(stops.astype(np.int32)),
            empty, empty,
        )

    @classmethod
    def from_reads(
        cls,
        layout: GenomeLayout,
        target_id: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        flank_len: int,
        gaps=None,
        issue_range: tuple[int, int] = (-1, 0),
    ) -> "DeviceDepth":
        """One fused pass: depth + checkpoint run boundaries + issue edges.

        ``issue_range=(leftmost, rightmost]`` is the run's issue threshold;
        the edges the scan extracts are of the *gap-masked* depth, so the
        resulting intervals become this object's cached issue BED once
        ``mask_gaps`` is applied (they are immediately valid when there are
        no gaps).
        """
        import jax.numpy as jnp

        from gci_tpu.depth.base import gap_interval_events
        from gci_tpu.depth.device import pack_read_deltas

        pad_total = cls.pad_total_for(layout.total_slots)
        gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
        gap_s, gap_e = gap_interval_events(layout, gaps)
        has_gaps = gap_s.shape[0] > 0
        lo, hi = issue_range
        if start.shape[0] < PACKED_DEPTH_LIMIT:
            # production: packed-word scan, flags scattered into the same
            # word (no separate flag-build prefix sums)
            val_s, val_e = _valid_intervals(layout, flank_len)
            raw, out_flags = _packed_events_fn(pad_total)(
                jnp.asarray(gs), jnp.asarray(ge),
                jnp.asarray(live.astype(np.int32) << 2),
                jnp.asarray(gap_s.astype(np.int32)),
                jnp.asarray(gap_e.astype(np.int32)),
                jnp.asarray(np.asarray(val_s, np.int32)),
                jnp.asarray(np.asarray(val_e, np.int32)),
                jnp.int32(lo), jnp.int32(hi),
            )
            return cls._from_kernel_outputs(
                layout, pad_total, raw, out_flags,
                out_flags if has_gaps else None, gaps, flank_len, lo, hi,
                gap_bit=8,
            )
        # beyond the packed word's depth-field bound: unpacked flags scan
        flags = flags_for(layout, gaps, flank_len, pad_total)
        raw, out_flags = _fused_fn(pad_total)(
            jnp.asarray(gs), jnp.asarray(ge), jnp.asarray(live),
            flags, jnp.int32(lo), jnp.int32(hi),
        )
        return cls._from_kernel_outputs(
            layout, pad_total, raw, out_flags,
            flags if has_gaps else None, gaps, flank_len, lo, hi,
        )

    @classmethod
    def from_delta(
        cls,
        layout: GenomeLayout,
        delta,
        flank_len: int,
        gaps=None,
        issue_range: tuple[int, int] = (-1, 0),
    ) -> "DeviceDepth":
        """Like ``from_reads`` but on an already-accumulated device delta
        array (the pack<->scatter overlap path: deltas were scattered
        incrementally while the BAM inflated)."""
        import jax.numpy as jnp

        from gci_tpu.depth.base import gap_interval_events

        pad_total = int(delta.shape[0])
        assert pad_total == cls.pad_total_for(layout.total_slots)
        gap_s, gap_e = gap_interval_events(layout, gaps)
        has_gaps = gap_s.shape[0] > 0
        val_s, val_e = _valid_intervals(layout, flank_len)
        lo, hi = issue_range
        raw, out_flags = _packed_from_delta_fn(pad_total)(
            delta,
            jnp.asarray(gap_s.astype(np.int32)),
            jnp.asarray(gap_e.astype(np.int32)),
            jnp.asarray(np.asarray(val_s, np.int32)),
            jnp.asarray(np.asarray(val_e, np.int32)),
            jnp.int32(lo), jnp.int32(hi),
        )
        return cls._from_kernel_outputs(
            layout, pad_total, raw, out_flags,
            out_flags if has_gaps else None, gaps, flank_len, lo, hi,
            gap_bit=8,
        )

    @classmethod
    def _from_kernel_outputs(cls, layout, pad_total, raw, out_flags,
                             gap_marks, gaps, flank_len, lo, hi,
                             gap_bit: int = 1):
        from gci_tpu.depth.device import edge_indices_to_intervals

        # one batched readback for all three edge bit-streams + run values
        # at the change indices and target offsets (2 dispatches total)
        (rise_idx, fall_idx, change_idx), change_vals, offset_vals = (
            _batched_flags_readback(raw, layout, out_flags, (1, 2, 4), 2)
        )
        intervals = edge_indices_to_intervals(
            layout, rise_idx, fall_idx, flank_len
        )
        dd = cls(layout, raw, pad_total, gap_marks, gaps_src=gaps,
                 change_idx=change_idx, gap_bit=gap_bit)
        dd._set_gather_map(change_idx, change_vals, offset_vals)
        key = (float(lo), float(hi), int(flank_len))
        dd._pending_masked_edges = (key, intervals)
        if gap_marks is None:
            dd._edge_cache[key] = intervals
        return dd

    # ------------------------------------------------------------------ ops
    def mask_gaps(self, gaps) -> "DeviceDepth":
        """Zero depth over N-gap intervals, on device (GCI.py:315-329)."""
        if not gaps:
            return self
        marks = self.gap_marks
        gap_bit = self.gap_bit
        pending = self._pending_masked_edges
        if marks is None or gaps is not self._gaps_src:
            marks = self.gap_marks_for(self.layout, gaps, self.pad_total)
            gap_bit = 1
            if marks is None:
                return self
            pending = None  # scan edges were computed under different gaps
        arr = _mask_fn(gap_bit)(self.array, marks)
        cache = {pending[0]: pending[1]} if pending is not None else {}
        return DeviceDepth(self.layout, arr, self.pad_total, marks,
                           gaps_src=gaps, edge_cache=cache, gap_bit=gap_bit)

    def maximum(self, other: "DeviceDepth") -> "DeviceDepth":
        """Per-base two-type max, on device (GCI.py:332-353)."""
        assert self.pad_total == other.pad_total
        _, vmax, *_ = _elementwise_fns()
        return DeviceDepth(
            self.layout, vmax(self.array, other.array), self.pad_total,
            self.gap_marks, gaps_src=self._gaps_src, gap_bit=self.gap_bit,
        )

    def collapse_dict(
        self,
        leftmost: float = -1,
        rightmost: float = 0,
        flank_len: int = 15,
        start_pos: int = 0,
    ) -> dict[str, list[tuple[int, int]]]:
        """Issue intervals (GCI.py:356-390): cached from the construction
        scan when the query matches the run threshold, else one fused XLA
        edge pass + O(edges) compaction."""
        key = (float(leftmost), float(rightmost), int(flank_len))
        if start_pos == 0 and key in self._edge_cache:
            return self._edge_cache[key]
        import jax.numpy as jnp

        from gci_tpu.depth.device import edge_indices_to_intervals

        valid = valid_marks_for(self.layout, flank_len, self.pad_total)
        *_, edges_fn = _elementwise_fns()
        rise, fall = edges_fn(
            self.array,
            valid,
            jnp.asarray([leftmost], jnp.int32),
            jnp.asarray([rightmost], jnp.int32),
        )
        (rise_idx, fall_idx), _, _ = _batched_edge_readback(
            self.array, self.layout, (rise, fall), 0
        )
        out = edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos,
        )
        if start_pos == 0:
            self._edge_cache[key] = out
        return out

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents} (checkpoint, regions,
        plotting).  Run boundaries come straight from the construction scan
        when available; values from one device gather."""
        if self._events is not None:
            return self._events
        if self._change_idx is None or self._gather_pos is None:
            # masked/merged objects: recompute run boundaries with the same
            # batched 2-dispatch readback the construction path uses
            _, _, change_fn, _ = _elementwise_fns()
            change = change_fn(self.array)
            (self._change_idx,), change_vals, offset_vals = (
                _batched_edge_readback(self.array, self.layout, (change,), 0)
            )
            self._set_gather_map(self._change_idx, change_vals, offset_vals)

        def gather(all_idx: np.ndarray) -> np.ndarray:
            # all_idx ⊆ change indices ∪ target offsets — both already on
            # host from the packed readback; no device round-trip
            j = np.searchsorted(self._gather_pos, all_idx)
            return self._gather_vals[j]

        self._events = events_from_change_indices(
            self.layout, self._change_idx, gather
        )
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        from gci_tpu.depth.accum import depth_dict_from_flat

        flat = np.asarray(self.array)[: self.layout.total_slots]
        return depth_dict_from_flat(self.layout, flat)
