"""Sharded whole-pipeline depth: one read-type's genome axis resident on a
(dp, gp) device mesh end-to-end.

This is the user-reachable multi-chip path (``depth_backend="sharded"`` /
``gci --mesh dp,gp``): reads are packed once on host, scattered data-parallel
over ``dp``, the per-base genome axis lives gp-sharded on device through
depth accumulation (GCI.py:302-306), gap masking (GCI.py:315-329), two-type
max (GCI.py:332-353) and issue-interval extraction (GCI.py:356-390).  Only
interval lists (tiny) and run-length boundaries (O(runs)) ever come back to
host; the per-base axis is never materialized host-side.

Collectives: psum over dp merges read-parallel delta partials; the genome
prefix sum is a per-shard scan + all_gather of shard totals; interval edges
and run boundaries stitch across shards with ppermute (gci_tpu.depth.device).
All device paths are asserted byte-identical to the host oracle by
tests/test_sharded_pipeline.py.
"""
from __future__ import annotations

import functools

import numpy as np

from gci_tpu.depth.accum import GenomeLayout
from gci_tpu.depth.base import ResidentDepth, events_from_change_indices

_INT32_MAX = np.iinfo(np.int32).max


@functools.lru_cache(maxsize=32)
def _depth_fn(mesh, pad_total):
    from gci_tpu.depth.device import make_sharded_depth_fn

    return make_sharded_depth_fn(mesh, pad_total)


@functools.lru_cache(maxsize=32)
def _interval_fn(mesh, pad_total):
    from gci_tpu.depth.device import make_sharded_interval_fn

    return make_sharded_interval_fn(mesh, pad_total)


@functools.lru_cache(maxsize=32)
def _change_fn(mesh, pad_total):
    from gci_tpu.depth.device import make_sharded_change_fn

    return make_sharded_change_fn(mesh, pad_total)


@functools.lru_cache(maxsize=32)
def _count_fn(mesh, n_bitmaps):
    from gci_tpu.depth.device import make_sharded_count_fn

    return make_sharded_count_fn(mesh, n_bitmaps)


@functools.lru_cache(maxsize=64)
def _compact_gather_fn(mesh, size, k_off):
    from gci_tpu.depth.device import make_sharded_compact_gather_fn

    return make_sharded_compact_gather_fn(mesh, size, k_off)


def _shard_compact(mesh, bitmap, values, pad_total, counts,
                   offsets: np.ndarray):
    """Host assembly of the per-shard compaction: returns (global sorted
    int64 indices, values at those indices, values at ``offsets``)."""
    import jax.numpy as jnp

    gp = mesh.shape["gp"]
    shard = pad_total // gp
    size = max(1, 1 << (int(counts.max()) - 1).bit_length()) if counts.max() else 1
    # per-shard local offset table (k_off columns, -1 padded)
    o_shard = (offsets // shard).astype(np.int64)
    o_loc = (offsets % shard).astype(np.int32)
    k_off = max(1, int(np.bincount(o_shard, minlength=gp).max()) if offsets.size else 1)
    loff = np.full((gp, k_off), -1, np.int32)
    slot = np.zeros(gp, np.int64)
    for j in range(offsets.shape[0]):
        g = int(o_shard[j])
        loff[g, slot[g]] = o_loc[j]
        slot[g] += 1
    idx2d, vals2d, ovals2d = _compact_gather_fn(mesh, size, k_off)(
        bitmap, values, _replicated_global(mesh, loff)
    )
    idx2d = _host_all(idx2d)
    vals2d = _host_all(vals2d)
    ovals2d = _host_all(ovals2d)
    g_idx: list[np.ndarray] = []
    g_vals: list[np.ndarray] = []
    for g in range(gp):
        keep = idx2d[g] >= 0
        g_idx.append(idx2d[g][keep].astype(np.int64) + g * shard)
        g_vals.append(vals2d[g][keep].astype(np.int64))
    offset_vals = np.empty(offsets.shape[0], np.int64)
    slot = np.zeros(gp, np.int64)
    for j in range(offsets.shape[0]):
        g = int(o_shard[j])
        offset_vals[j] = ovals2d[g, slot[g]]
        slot[g] += 1
    return np.concatenate(g_idx), np.concatenate(g_vals), offset_vals


@functools.lru_cache(maxsize=8)
def _mask_max_fns():
    import jax
    import jax.numpy as jnp

    mask = jax.jit(lambda depth, marks: jnp.where(marks > 0, 0, depth))
    vmax = jax.jit(jnp.maximum)
    return mask, vmax


@functools.lru_cache(maxsize=1)
def _indicator_fn():
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda marks: (marks > 0).astype(jnp.int8))


def _to_global(mesh, packed: tuple[np.ndarray, ...]):
    """dp-sharded global device arrays from host arrays (multi-process aware).

    Single-process: plain transfers.  Multi-process: every host holds the
    full packed arrays; each contributes only the dp chunks its addressable
    devices own (``jax.make_array_from_process_local_data``), so the device
    feed is per-host input sharding and the dp-psum that merges the partial
    depth deltas is the DCN-crossing collective.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return tuple(jnp.asarray(a) for a in packed)
    sharding = NamedSharding(mesh, P("dp"))
    dp = mesh.shape["dp"]
    me = jax.process_index()
    owned = sorted({
        int(pos[0])
        for pos, dev in np.ndenumerate(mesh.devices)
        if dev.process_index == me
    })
    out = []
    for a in packed:
        chunk = a.shape[0] // dp
        local = (
            np.concatenate([a[d * chunk : (d + 1) * chunk] for d in owned])
            if owned
            else a[:0]
        )
        out.append(
            jax.make_array_from_process_local_data(sharding, local, a.shape)
        )
    return tuple(out)


def _gp_global(mesh, a: np.ndarray):
    """gp-sharded global device array from identical full host arrays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return jnp.asarray(a)
    sharding = NamedSharding(mesh, P("gp"))
    gp = mesh.shape["gp"]
    me = jax.process_index()
    owned = sorted({
        int(pos[1])
        for pos, dev in np.ndenumerate(mesh.devices)
        if dev.process_index == me
    })
    chunk = a.shape[0] // gp
    local = (
        np.concatenate([a[g * chunk : (g + 1) * chunk] for g in owned])
        if owned
        else a[:0]
    )
    return jax.make_array_from_process_local_data(sharding, local, a.shape)


def _replicated_global(mesh, a: np.ndarray):
    """Fully-replicated global device array from identical host data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return jnp.asarray(a)
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), a, a.shape
    )


def _host_all(x) -> np.ndarray:
    """Full host copy of a (possibly gp-sharded) global array, every process."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def parse_mesh_spec(spec: str | None = None, n_devices: int | None = None):
    """'dp,gp' | 'auto' | None -> a (dp, gp) jax Mesh over local devices."""
    from gci_tpu.parallel.mesh import make_mesh

    if spec in (None, "", "auto"):
        return make_mesh(n_devices)
    try:
        parts = [int(p) for p in str(spec).split(",")]
        if len(parts) == 1:
            return make_mesh(parts[0])
        dp, gp = parts
    except ValueError:
        import sys

        sys.exit(
            f'ERROR!!! Invalid mesh spec "{spec}"\n'
            "Expected 'dp,gp' (e.g. --mesh 2,4) or 'auto'"
        )
    return make_mesh(dp * gp, dp=dp)


class ShardedDepth(ResidentDepth):
    """One read-type's whole-genome depth, gp-sharded on a device mesh.

    Drop-in value for the pipeline's depth dictionaries: gap masking,
    two-type max, interval collapse and checkpoint serialization all
    dispatch on this type and stay on device.
    """

    def __init__(self, mesh, layout: GenomeLayout, array, pad_total: int):
        self._valid_cache: dict[int, object] = {}
        self.mesh = mesh
        self.layout = layout
        self.array = array  # jax int32, (pad_total,), sharded over gp
        self.pad_total = pad_total
        self._events = None  # lazy host event-space view

    # ------------------------------------------------------------ construct
    @staticmethod
    def _pad_total(mesh, total: int) -> int:
        """Padded genome axis: each gp shard a whole number of scan blocks."""
        from gci_tpu.depth.scan import pad_to_block

        gp = mesh.shape["gp"]
        return pad_to_block(-(-total // gp)) * gp

    @classmethod
    def from_reads(
        cls,
        mesh,
        layout: GenomeLayout,
        target_id: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        flank_len: int,
    ) -> "ShardedDepth":
        import jax
        import jax.numpy as jnp

        from gci_tpu.depth.device import pack_read_deltas_sharded

        dp = mesh.shape["dp"]
        pad_total = cls._pad_total(mesh, layout.total_slots)
        shard = pad_total // mesh.shape["gp"]
        n = target_id.shape[0]
        n_padded = n + ((-n) % dp)
        if jax.process_count() > 1:
            # per-host input shard: pack only the rows whose dp chunks live
            # on this process's devices (gci_tpu.parallel.distributed)
            from jax.sharding import NamedSharding, PartitionSpec as P

            from gci_tpu.parallel.distributed import owned_dp_rows

            lo, hi = owned_dp_rows(mesh, n_padded)
            sl = slice(lo, min(hi, n))
            packed = pack_read_deltas_sharded(
                layout, target_id[sl], start[sl], end[sl], flank_len, shard,
                pad_to=hi - lo,
            )
            sharding = NamedSharding(mesh, P("dp"))
            arrs = tuple(
                jax.make_array_from_process_local_data(sharding, a, (n_padded,))
                for a in packed
            )
        else:
            packed = pack_read_deltas_sharded(
                layout, target_id, start, end, flank_len, shard,
                pad_to=n_padded,
            )
            arrs = tuple(jnp.asarray(a) for a in packed)
        fn = _depth_fn(mesh, pad_total)
        with mesh:
            arr = fn(*arrs)
        return cls(mesh, layout, arr, pad_total)

    # ------------------------------------------------------------------ ops
    def mask_gaps(self, gaps: dict[str, list[tuple[int, int]]]) -> "ShardedDepth":
        """Zero depth over N-gap intervals, on device (GCI.py:315-329)."""
        import jax.numpy as jnp

        from gci_tpu.parallel.mesh import pad_to_multiple

        from gci_tpu.depth.base import gap_interval_events

        gs, ge = gap_interval_events(self.layout, gaps)
        if gs.shape[0] == 0:
            return self
        shard = self.pad_total // self.mesh.shape["gp"]
        packed = (
            (gs // shard).astype(np.int32),
            (gs % shard).astype(np.int32),
            (ge // shard).astype(np.int32),
            (ge % shard).astype(np.int32),
            np.ones(gs.shape[0], np.int32),
        )
        dp = self.mesh.shape["dp"]
        packed = tuple(pad_to_multiple(a, dp, fill=f)
                       for a, f in zip(packed, (-1, 0, -1, 0, 0)))
        fn = _depth_fn(self.mesh, self.pad_total)
        mask_fn, _ = _mask_max_fns()
        with self.mesh:
            marks = fn(*_to_global(self.mesh, packed))
            arr = mask_fn(self.array, marks)
        return ShardedDepth(self.mesh, self.layout, arr, self.pad_total)

    def maximum(self, other: "ShardedDepth") -> "ShardedDepth":
        """Per-base two-type max, on device (GCI.py:332-353)."""
        assert self.pad_total == other.pad_total
        _, max_fn = _mask_max_fns()
        with self.mesh:
            arr = max_fn(self.array, other.array)
        return ShardedDepth(self.mesh, self.layout, arr, self.pad_total)

    def _valid_marks(self, flank_len: int):
        """Device int8 scan-window indicator, built ON device from
        O(targets) interval events via the sharded depth accumulator — a
        host-built per-base mask would be an O(genome) upload per call."""
        cached = self._valid_cache.get(flank_len)
        if cached is not None:
            return cached
        from gci_tpu.depth.fused import _valid_intervals
        from gci_tpu.parallel.mesh import pad_to_multiple

        vs_l, ve_l = _valid_intervals(self.layout, flank_len)
        vs = np.asarray(vs_l, np.int64)
        ve = np.asarray(ve_l, np.int64)
        shard = self.pad_total // self.mesh.shape["gp"]
        packed = (
            (vs // shard).astype(np.int32),
            (vs % shard).astype(np.int32),
            (ve // shard).astype(np.int32),
            (ve % shard).astype(np.int32),
            np.ones(vs.shape[0], np.int32),
        )
        dp = self.mesh.shape["dp"]
        packed = tuple(pad_to_multiple(a, dp, fill=f)
                       for a, f in zip(packed, (-1, 0, -1, 0, 0)))
        fn = _depth_fn(self.mesh, self.pad_total)
        with self.mesh:
            # cached per object: int8 keeps it a quarter of a depth array
            marks = _indicator_fn()(fn(*_to_global(self.mesh, packed)))
        self._valid_cache[flank_len] = marks
        return marks

    def collapse_dict(
        self,
        leftmost: float = -1,
        rightmost: float = 0,
        flank_len: int = 15,
        start_pos: int = 0,
    ) -> dict[str, list[tuple[int, int]]]:
        """Issue intervals via the sharded edge extraction (GCI.py:356-390)."""
        fn = _interval_fn(self.mesh, self.pad_total)
        valid = self._valid_marks(flank_len)
        with self.mesh:
            rise, fall = fn(
                self.array,
                valid,
                _replicated_global(self.mesh, np.asarray([leftmost], np.int32)),
                _replicated_global(self.mesh, np.asarray([rightmost], np.int32)),
            )
        # NOTE: index compaction directly on the MESH-SHARDED bitmaps is
        # deliberately avoided — XLA's SPMD partitioner handles flatnonzero
        # on sharded inputs pathologically (minutes for ~10M slots) — and
        # so is pulling the whole O(genome) bitmaps to host.  Instead each
        # gp shard compacts its LOCAL bitmap under shard_map (int32
        # shard-local indices, valid at any genome size) and the host reads
        # O(edges).
        from gci_tpu.depth.device import edge_indices_to_intervals

        no_off = np.empty(0, np.int64)
        counts_r, counts_f = (
            _host_all(c) for c in _count_fn(self.mesh, 2)(rise, fall)
        )
        rise_idx, _, _ = _shard_compact(
            self.mesh, rise, rise, self.pad_total, counts_r, no_off
        )
        fall_idx, _, _ = _shard_compact(
            self.mesh, fall, fall, self.pad_total, counts_f, no_off
        )
        return edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos
        )

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents}.

        Run boundaries come from the sharded change-detect collective (int8
        bitmap transfer); boundary values from one device gather.  Used for
        the checkpoint writer, regions re-collapse and plotting — the only
        host-side representations the pipeline needs.
        """
        if self._events is not None:
            return self._events
        import jax.numpy as jnp

        import jax

        fn = _change_fn(self.mesh, self.pad_total)
        with self.mesh:
            change = fn(self.array)
        # per-shard compaction + value gather (see collapse_dict NOTE):
        # O(runs + targets) host transfer at any genome size and process
        # count — shard-local int32 indexing never wraps
        (counts,) = (_host_all(c) for c in _count_fn(self.mesh, 1)(change))
        offsets = np.asarray(self.layout.offsets[:-1], np.int64)
        idx, vals, offset_vals = _shard_compact(
            self.mesh, change, self.array, self.pad_total, counts, offsets
        )
        pos = np.concatenate([idx, offsets])
        allv = np.concatenate([vals, offset_vals])
        order = np.argsort(pos, kind="stable")
        pos, allv = pos[order], allv[order]

        def gather(all_idx: np.ndarray) -> np.ndarray:
            return allv[np.searchsorted(pos, all_idx)]

        self._events = events_from_change_indices(self.layout, idx, gather)
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        flat = np.asarray(self.array)[: self.layout.total_slots]
        from gci_tpu.depth.accum import depth_dict_from_flat

        return depth_dict_from_flat(self.layout, flat)
