"""Pack <-> device-scatter overlap for the single-BAM, no-PAF pipeline shape.

The reference streams (target, window) fetch tasks while accumulating depth
(GCI.py:146-169); our streaming packer instead finished the whole file before
the depth backend started, serialized by the last-wins name dedup.  For the
common single-BAM no-PAF case (e.g. the CHM13 rehearsal shape) the dedup CAN
fold incrementally: a record whose name already appeared retracts the stored
record's interval (scatter -1) and adds its own (+1) — the running sum equals
the scatter of the final last-wins survivor set exactly, because integer
scatter-adds commute.  Each packed chunk's deltas therefore dispatch to the
device (asynchronously) while the native producer inflates the next chunk.

Two consumers:

* ``DeviceDepth.from_delta``  — the single-device resident path;
* ``events_from_delta2d_streamed`` — the streamed path; the resident delta
  lives as a (n_chunks, chunk_slots) int32 array so scatter indices stay
  int32 (global slots can exceed 2^31).
"""
from __future__ import annotations

import functools

import numpy as np

from gci_tpu.depth.accum import GenomeLayout, clamp_read_intervals


class LastWinsFold:
    """Incremental last-wins name dedup across packed chunks.

    Chunks arrive in file order, already deduped *within* the chunk.  For
    each chunk, returns the rows that a record in this chunk replaces (the
    currently-live record of the same name from an earlier chunk); those
    rows' intervals are retracted from the device delta.  Membership tests
    run against per-chunk sorted "pockets" (no global re-sort per chunk).
    """

    def __init__(self) -> None:
        # per pocket: (sorted void16 keys, rows (n, 3) int64, alive mask)
        self._pockets: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def fold(
        self, kv: np.ndarray, tid: np.ndarray, start: np.ndarray,
        end: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fold one chunk; returns (tid, start, end) rows to retract.

        ``kv`` is the chunk's void16 key view (unique within the chunk).
        """
        retract: list[np.ndarray] = []
        if kv.shape[0]:
            for keys, rows, alive in self._pockets:
                pos = np.searchsorted(keys, kv)
                posc = np.minimum(pos, keys.shape[0] - 1)
                hit = (keys[posc] == kv) & alive[posc]
                if hit.any():
                    h = posc[hit]
                    retract.append(rows[h])
                    alive[h] = False
            order = np.argsort(kv)
            rows = np.stack(
                [tid.astype(np.int64), start.astype(np.int64),
                 end.astype(np.int64)], axis=1,
            )[order]
            self._pockets.append(
                (kv[order], rows, np.ones(kv.shape[0], dtype=bool))
            )
        if retract:
            r = np.concatenate(retract)
            return r[:, 0], r[:, 1], r[:, 2]
        e = np.empty(0, np.int64)
        return e, e, e


@functools.lru_cache(maxsize=8)
def _scatter2d_fn(n_rows: int, n_cols: int):
    """Signed scatter of interval events into the resident 2-D delta.

    Out-of-range rows (sentinel ``n_rows``) drop; the delta buffer is
    donated so repeated chunk scatters never copy the multi-GB array.
    """
    import jax
    import jax.numpy as jnp

    def f(delta2d, rs, cs, re_, ce, val):
        delta2d = delta2d.at[(rs, cs)].add(val, mode="drop")
        delta2d = delta2d.at[(re_, ce)].add(-val, mode="drop")
        return delta2d

    return jax.jit(f, donate_argnums=(0,))


class DeltaAccumulator:
    """Device-resident (n_chunks, chunk_slots) int32 delta, fed chunk by
    chunk during pack.  Dispatches are asynchronous: the host returns to
    inflating/filtering the next BAM chunk while the device scatters.
    """

    def __init__(self, layout: GenomeLayout, flank_len: int, chunk_slots: int):
        import jax.numpy as jnp

        self.layout = layout
        self.flank_len = flank_len
        self.chunk_slots = int(chunk_slots)
        self.n_chunks = -(-layout.total_slots // self.chunk_slots)
        self.delta2d = jnp.zeros(
            (self.n_chunks, self.chunk_slots), jnp.int32
        )
        self._fold = LastWinsFold()

    def _coords(self, g: np.ndarray, live: np.ndarray):
        rows = np.where(live, g // self.chunk_slots, self.n_chunks)
        cols = g % self.chunk_slots
        return rows.astype(np.int32), cols.astype(np.int32)

    def _scatter(self, tid, start, end, sign: int) -> None:
        import jax.numpy as jnp

        if tid.shape[0] == 0:
            return
        s, e = clamp_read_intervals(self.layout, tid, start, end, self.flank_len)
        base = self.layout.offsets[tid]
        live = e > s
        # pad to a power of two so one compiled program serves all chunks
        n = tid.shape[0]
        padded = 1 << (n - 1).bit_length()
        gs = np.pad(base + s, (0, padded - n))
        ge = np.pad(base + e, (0, padded - n))
        live = np.pad(live, (0, padded - n))
        rs, cs = self._coords(gs, live)
        re_, ce = self._coords(ge, live)
        val = np.where(live, np.int32(sign), 0).astype(np.int32)
        self.delta2d = _scatter2d_fn(self.n_chunks, self.chunk_slots)(
            self.delta2d, jnp.asarray(rs), jnp.asarray(cs),
            jnp.asarray(re_), jnp.asarray(ce), jnp.asarray(val),
        )

    def add_chunk(self, kv, tid, start, end) -> None:
        """Fold one packed chunk (unique names within the chunk) into the
        resident delta: retract replaced records, add the new ones."""
        rt, rstart, rend = self._fold.fold(kv, tid, start, end)
        self._scatter(rt, rstart, rend, -1)
        self._scatter(tid, start, end, +1)

    def delta_flat(self):
        """The accumulated delta as a flat (n_chunks*chunk_slots,) view."""
        return self.delta2d.reshape(-1)


def _adjust_range(idx: np.ndarray, vals: np.ndarray, a: int, b: int,
                  dv: int, insert_a: bool, val_at_a: int,
                  insert_b: bool, val_at_b: int):
    """Event-space fixup: depth += ``dv`` over [a, b) applied to one
    finalized chunk's (global idx, vals) run-boundary lists.

    Runs with boundaries in [a, b) shift by ``dv``.  ``insert_a`` adds a
    boundary at ``a`` (value ``val_at_a + dv``) — needed only for the
    range START's chunk (continuation chunks inherit the shifted value
    from the previous chunk's last event).  ``insert_b`` adds a boundary
    at ``b`` (original value ``val_at_b``) — needed only when the range
    ends strictly inside this chunk.  Both prevailing values are resolved
    by the caller BEFORE any modification.  Retro fixups are rare, so
    per-call O(runs-in-chunk) is fine.
    """
    lo = np.searchsorted(idx, a, side="left")
    hi = np.searchsorted(idx, b, side="left")
    new_idx = [idx[:lo]]
    new_vals = [vals[:lo]]
    if insert_a and (lo == idx.shape[0] or idx[lo] != a):
        new_idx.append(np.asarray([a], np.int64))
        new_vals.append(np.asarray([val_at_a + dv], np.int64))
    new_idx.append(idx[lo:hi])
    new_vals.append(vals[lo:hi] + dv)
    if insert_b and (hi == idx.shape[0] or idx[hi] != b):
        new_idx.append(np.asarray([b], np.int64))
        new_vals.append(np.asarray([val_at_b], np.int64))
    new_idx.append(idx[hi:])
    new_vals.append(vals[hi:])
    return np.concatenate(new_idx), np.concatenate(new_vals)


class SweepAccumulator:
    """Coordinate-sweep pack<->scan overlap for the streamed backend.

    A coordinate-sorted BAM visits the concatenated genome axis
    monotonically, so only the genome chunks near the read frontier need a
    live device delta buffer: once every future read starts past a chunk's
    end, the chunk is *final* — its scan + run-boundary compaction dispatch
    immediately (while the native producer inflates the next BAM chunk) and
    its buffer frees.  Peak device memory is O(live chunks), independent of
    genome size: no whole-genome resident delta ever exists.

    Last-wins retraction: a re-appearing read name retracts the stored
    record as a -1 range update, split at the finalization frontier —
    the live part scatters like any delta, the (rare) finalized part is an
    exact event-space fixup on the already-compacted runs.  An unsorted
    input simply never finalizes early (correct, memory-heavier).
    """

    mode = "sweep"

    def __init__(self, layout: GenomeLayout, flank_len: int,
                 chunk_slots: int):
        from gci_tpu.depth.streamed import resident_chunk_slots

        self.layout = layout
        self.flank_len = flank_len
        self.chunk_slots = resident_chunk_slots(layout.total_slots, chunk_slots)
        self.total = layout.total_slots
        self.n_chunks = -(-self.total // self.chunk_slots)
        self._live: dict[int, object] = {}  # chunk -> device delta or None
        self._chunk_events: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.frontier = 0  # first non-finalized chunk
        self._carry = 0    # running sum of finalized deltas (int32 domain)
        self._fold = LastWinsFold()
        self._max_seen_start = -1
        self._unsorted = False
        self._step_fn = None

    # ------------------------------------------------------------- internals
    def _chunk_buf(self, c: int):
        import jax.numpy as jnp

        buf = self._live.get(c)
        if buf is None:
            buf = jnp.zeros(self.chunk_slots, jnp.int32)
            self._live[c] = buf
        return buf

    @functools.cached_property
    def _scatter_fn(self):
        import jax

        def f(delta, pos, val):
            return delta.at[pos].add(val, mode="drop")

        return jax.jit(f, donate_argnums=(0,))

    def _scatter_points(self, pos: np.ndarray, val: np.ndarray) -> None:
        """Scatter point deltas (global positions) into live chunk buffers."""
        import jax.numpy as jnp

        if pos.shape[0] == 0:
            return
        c_of = pos // self.chunk_slots
        order = np.argsort(c_of, kind="stable")
        pos, val, c_of = pos[order], val[order], c_of[order]
        starts = np.flatnonzero(
            np.concatenate(([True], c_of[1:] != c_of[:-1]))
        )
        bounds = np.append(starts, pos.shape[0])
        for k, s0 in enumerate(starts):
            c = int(c_of[s0])
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            n = hi - lo
            padded = 1 << (n - 1).bit_length() if n else 1
            p = np.full(padded, self.chunk_slots, np.int64)  # dropped
            v = np.zeros(padded, np.int32)
            p[:n] = pos[lo:hi] - c * self.chunk_slots
            v[:n] = val[lo:hi]
            self._live[c] = self._scatter_fn(
                self._chunk_buf(c),
                jnp.asarray(p.astype(np.int32)), jnp.asarray(v),
            )

    def _range_update(self, gs: np.ndarray, ge: np.ndarray, sign: int) -> None:
        """Apply depth ``sign`` over [gs, ge) per row, split at the
        finalization frontier."""
        live_from = self.frontier * self.chunk_slots
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        if gs.shape[0] == 0:
            return
        # finalized portion (retraction rows — or, on an unsorted input,
        # a late-arriving add — reaching behind the frontier)
        back = gs < live_from
        for s, e in zip(gs[back].tolist(), np.minimum(ge[back], live_from).tolist()):
            self._fixup_finalized(s, e, sign)
        # live portion: ordinary point deltas, clipped at the frontier
        ls = np.maximum(gs, live_from)
        le = ge
        live_rows = le > ls
        pos = np.concatenate([ls[live_rows], le[live_rows]])
        val = np.concatenate([
            np.full(int(live_rows.sum()), sign, np.int32),
            np.full(int(live_rows.sum()), -sign, np.int32),
        ])
        inside = pos < self.total  # drop deltas at/after the total axis end
        self._scatter_points(pos[inside], val[inside])

    def _value_at(self, p: int) -> int:
        """Prevailing finalized depth value at global slot ``p`` (the last
        run boundary at or before ``p``, searching back through chunks)."""
        c = int(p // self.chunk_slots)
        while c >= 0:
            ev = self._chunk_events.get(c)
            if ev is not None and ev[0].shape[0]:
                idx, vals = ev
                j = np.searchsorted(idx, p, side="right") - 1
                if j >= 0:
                    return int(vals[j])
            c -= 1
        return 0  # before the forced boundary at slot 0 (cannot happen)

    def _fixup_finalized(self, a: int, b: int, sign: int) -> None:
        """Depth += ``sign`` over the finalized range [a, b).

        The live continuation of the range (>= frontier) is handled by the
        caller's scatter (its boundary delta sits at the frontier), so the
        carry needs NO adjustment here.  Prevailing values at both
        endpoints are resolved BEFORE any event list is modified.
        """
        val_at_a = self._value_at(a)
        val_at_b = self._value_at(b)  # original value where the range ends
        c0 = a // self.chunk_slots
        c1 = min((b - 1) // self.chunk_slots, self.frontier - 1)
        for c in range(int(c0), int(c1) + 1):
            clo = c * self.chunk_slots
            chi = min(clo + self.chunk_slots, self.total)
            ra, rb = max(a, clo), min(b, chi)
            if rb <= ra:
                continue
            idx, vals = self._chunk_events.get(
                c, (np.empty(0, np.int64), np.empty(0, np.int64))
            )
            idx, vals = _adjust_range(
                idx, vals, ra, rb, sign,
                insert_a=(ra == a), val_at_a=val_at_a,
                insert_b=(rb == b and rb < chi), val_at_b=val_at_b,
            )
            self._chunk_events[c] = (idx, vals)

    def _finalize_through(self, min_future_start: int) -> None:
        """Finalize every chunk wholly before ``min_future_start``."""
        while (
            self.frontier < self.n_chunks
            and (self.frontier + 1) * self.chunk_slots <= min_future_start
        ):
            self._finalize_one()

    def _finalize_one(self) -> None:
        import jax
        import jax.numpy as jnp

        from gci_tpu.depth.scan import prefix_sum as scan
        from gci_tpu.depth.streamed import _compact_gather_fn

        c = self.frontier
        a = c * self.chunk_slots
        b = min(a + self.chunk_slots, self.total)
        delta = self._live.pop(c, None)
        if delta is None:
            delta = jnp.zeros(self.chunk_slots, jnp.int32)
        if self._step_fn is None:

            @jax.jit
            def step(delta, carry, prev0):
                depth = scan(delta) + carry
                prev = jnp.concatenate(
                    [prev0[None].astype(depth.dtype), depth[:-1]]
                )
                change = (depth != prev).astype(jnp.int8)
                return (
                    depth, change,
                    jnp.sum(change, dtype=jnp.int32),
                    jnp.sum(delta, dtype=jnp.int32),
                )

            self._step_fn = step
        carry = np.int32(self._carry)
        prev0 = np.int32(carry if a > 0 else -1)
        depth_chunk, change, n, dsum = self._step_fn(
            delta, carry, jnp.asarray(prev0)
        )
        n = int(n)
        self._carry = int(np.int32(self._carry + int(dsum)))
        if n:
            size = 1 << (n - 1).bit_length()
            idx_d, vals_d = _compact_gather_fn(size)(depth_chunk, change)
            idx = np.asarray(idx_d)[:n].astype(np.int64)
            vals = np.asarray(vals_d)[:n].astype(np.int64)
            keep = idx < (b - a)
            idx, vals = idx[keep] + a, vals[keep]
            if idx.shape[0]:
                self._chunk_events[c] = (idx, vals)
        self.frontier += 1

    # ------------------------------------------------------------------ API
    def add_chunk(self, kv, tid, start, end) -> None:
        """Fold one packed chunk (unique names within the chunk), scatter
        its deltas, finalize+scan every chunk the sweep has passed."""
        rt, rstart, rend = self._fold.fold(kv, tid, start, end)
        if rt.shape[0]:
            s, e = clamp_read_intervals(
                self.layout, rt, rstart, rend, self.flank_len
            )
            base = self.layout.offsets[rt]
            self._range_update(base + s, base + e, -1)
        s, e = clamp_read_intervals(self.layout, tid, start, end, self.flank_len)
        base = self.layout.offsets[tid]
        gs, ge = base + s, base + e
        self._range_update(gs, ge, +1)
        live = ge > gs
        if live.any():
            batch_min = int(gs[live].min())
            if batch_min < self._max_seen_start:
                # unsorted input: stop finalizing early, permanently — every
                # chunk stays live until finish() (correct, memory-heavier)
                self._unsorted = True
            self._max_seen_start = max(self._max_seen_start, batch_min)
            if not self._unsorted:
                self._finalize_through(batch_min)

    def finish(self):
        """Finalize the tail and assemble {target: DepthEvents}."""
        from gci_tpu.depth.base import events_from_change_indices

        while self.frontier < self.n_chunks:
            self._finalize_one()
        parts = [
            self._chunk_events[c]
            for c in sorted(self._chunk_events)
        ]
        idx = (
            np.concatenate([p[0] for p in parts]) if parts
            else np.zeros(1, np.int64)
        )
        vals = (
            np.concatenate([p[1] for p in parts]) if parts
            else np.zeros(1, np.int64)
        )

        def gather(query: np.ndarray) -> np.ndarray:
            pos = np.searchsorted(idx, query, side="right") - 1
            return vals[np.clip(pos, 0, None)]

        return events_from_change_indices(self.layout, idx, gather)
