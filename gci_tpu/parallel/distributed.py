"""Multi-host runtime helpers.

On a multi-host cluster each host packs a disjoint shard of the alignment
data (reads are embarrassingly parallel), devices accumulate partial depth
deltas, and the dp-axis psum merges them — the network between hosts only
carries the all-reduce when dp spans hosts.  The reference has no distributed anything (SURVEY.md §2.3);
this module is the native cluster entry.

Testable pieces (shard assignment, record-range splitting) are pure; the
``initialize`` wrapper is a thin veneer over ``jax.distributed``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op on single-process runs).

    With no arguments, relies on the cluster environment (e.g.
    JAX_COORDINATOR_ADDRESS) exactly like ``jax.distributed.initialize``.
    """
    import jax

    if num_processes in (None, 1) and coordinator_address is None and (
        "JAX_COORDINATOR_ADDRESS" not in os.environ
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclass(frozen=True)
class HostShard:
    """This process's slice of the input work."""

    process_index: int
    process_count: int

    def files(self, paths: list[str]) -> list[str]:
        """Round-robin file assignment (whole files stay on one host)."""
        return [p for i, p in enumerate(paths) if i % self.process_count == self.process_index]

    def record_range(self, n_records: int) -> tuple[int, int]:
        """Contiguous [start, stop) record range for one shared file."""
        per = -(-n_records // self.process_count)
        start = min(self.process_index * per, n_records)
        return start, min(start + per, n_records)


def current_host_shard() -> HostShard:
    import jax

    return HostShard(jax.process_index(), jax.process_count())


def owned_dp_rows(mesh, n_rows: int) -> tuple[int, int]:
    """Contiguous [lo, hi) range of a dp-sharded axis owned by this process.

    This is the per-host input shard: on a cluster each host packs only the
    read records whose dp chunks live on its own devices; the dp-psum that
    merges the partial depth deltas is then the only cross-host traffic.
    ``n_rows`` must be a multiple of the mesh's dp size.
    """
    import jax
    import numpy as np

    dp = mesh.shape["dp"]
    chunk = n_rows // dp
    me = jax.process_index()
    owned = sorted({
        int(pos[0])
        for pos, dev in np.ndenumerate(mesh.devices)
        if dev.process_index == me
    })
    if not owned:
        return (0, 0)
    assert owned == list(range(owned[0], owned[-1] + 1)), (
        "dp rows owned by one process must be contiguous"
    )
    return owned[0] * chunk, (owned[-1] + 1) * chunk


def _multiprocess_active() -> bool:
    """True only when jax.distributed was initialized (multi-host run).

    ``jax.process_index()/process_count()`` initialize the device backend,
    which host-only tools that just need "am I the single writer?" should
    not pay for (and which would reserve most of a GPU's memory).
    Without a distributed client the answer is always single-process.
    """
    try:
        from jax._src import distributed

        gs = distributed.global_state
        return gs.client is not None or gs.coordinator_address is not None
    except Exception:
        import jax

        return jax.process_count() > 1


def process_count() -> int:
    if not _multiprocess_active():
        return 1
    import jax

    return jax.process_count()


def input_comp_range(path: str) -> tuple[int, int]:
    """This process's compressed byte range of a shared BAM file.

    The per-host input shard (SURVEY.md §2.3 row 1, generalizing the
    reference's (target, window) task split GCI.py:260-270 across hosts):
    the file's compressed bytes are cut into ``process_count`` equal
    ranges; ``BamStream(comp_range=...)`` turns a range into exactly the
    records whose first byte lies in a BGZF block starting inside it, so
    the ranges partition the record stream with no overlap or loss and
    each host inflates+parses only ~1/H of the file.
    """
    import os

    import jax

    fsize = os.path.getsize(path)
    h, H = jax.process_index(), jax.process_count()
    lo = fsize * h // H
    hi = fsize * (h + 1) // H if h < H - 1 else fsize
    return lo, hi


def allgather_concat(arrays: list):
    """Concatenate per-process row arrays across processes in process order.

    Host-side variable-length allgather (pad to the global max, gather,
    trim): used to reconcile each host's packed-record shard into the
    file-ordered global candidate list before name-keyed dedup/curation.
    Every process must call this with the same number of arrays.
    """
    import numpy as np
    from jax.experimental import multihost_utils

    n_local = int(arrays[0].shape[0])
    lens = np.asarray(
        multihost_utils.process_allgather(
            np.asarray([n_local], dtype=np.int32)
        )
    ).reshape(-1)
    m = int(lens.max()) if lens.size else 0
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        trailing = a.shape[1:]
        if m == 0:
            out.append(a[:0])
            continue
        # gather raw bytes: JAX would silently downcast 64-bit dtypes with
        # x64 disabled, corrupting hash keys/coordinates
        row_bytes = a.dtype.itemsize * int(np.prod(trailing, dtype=np.int64))
        b = a.view(np.uint8).reshape(n_local, row_bytes)
        if m > n_local:
            b = np.concatenate(
                [b, np.zeros((m - n_local, row_bytes), dtype=np.uint8)]
            )
        g = np.asarray(multihost_utils.process_allgather(b))
        cat = np.concatenate(
            [g[h, : lens[h]] for h in range(lens.shape[0])]
        )
        out.append(
            np.ascontiguousarray(cat).view(a.dtype).reshape((-1,) + trailing)
        )
    return out


def is_primary_host() -> bool:
    """True on the process that owns file writes (process 0).

    On a multi-host run every process executes the full pipeline (the
    collectives are SPMD — all processes must participate), but exactly one
    writes the output files; the reference's single-writer file semantics
    (GCI.py:99-143 etc.) are preserved verbatim.  Always True single-process.
    """
    if not _multiprocess_active():
        return True
    import jax

    return jax.process_index() == 0
