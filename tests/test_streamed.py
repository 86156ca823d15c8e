"""Streamed depth: chunked scan, event extraction, big-genome layout.

Covers the block-aligned streamed chunk path, the stream_slot_limit
auto-switch, run-length event extraction with cross-chunk carries (so a
streamed genome yields BEDs without per-base arrays), and the int64-safe
sharded packing of a simulated 3.1 Gbp x 2-type layout.
"""
import gzip
import os

import numpy as np
import pytest

from gci_tpu.depth.accum import (
    GenomeLayout,
    accumulate_depth_numpy,
    depth_dict_from_flat,
)
from gci_tpu.depth.eventspace import events_dict_from_reads
from gci_tpu.depth.streamed import (
    accumulate_depth_streamed,
    events_from_reads_streamed,
)

TARGETS = {"a": 9000, "b": 7000, "c": 150}


def _random_reads(rng, n):
    names = list(TARGETS)
    lens = np.array([TARGETS[t] for t in names])
    tid = rng.integers(0, len(names), n)
    start = (rng.random(n) * np.maximum(lens[tid] - 30, 1)).astype(np.int64)
    end = start + (rng.random(n) * 4000).astype(np.int64) + 5
    return tid.astype(np.int64), start, end


def test_streamed_pallas_tile_path(rng):
    # chunks are whole scan blocks: 1024 requested -> one 2048-slot block
    # per chunk -> 8 chunks, runs straddling chunk borders
    from gci_tpu.depth.scan import BLOCK
    from gci_tpu.depth.streamed import resident_chunk_slots

    layout = GenomeLayout.from_targets(TARGETS)
    assert resident_chunk_slots(layout.total_slots, 1024) == BLOCK
    tid, start, end = _random_reads(rng, 300)
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    got = accumulate_depth_streamed(layout, tid, start, end, 15, chunk_slots=1024)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_slots", [2048, 6144, 1 << 20])
def test_streamed_events_match_oracle(rng, chunk_slots):
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 500)
    got = events_from_reads_streamed(
        layout, tid, start, end, 15, chunk_slots=chunk_slots,
    )
    want = events_dict_from_reads(layout, tid, start, end, 15)
    for t in TARGETS:
        np.testing.assert_array_equal(got[t].materialize(), want[t].materialize())


def test_streamed_events_bed_parity(rng):
    # full event-space flow from streamed chunks: mask -> collapse == oracle
    from gci_tpu.intervals.collapse import collapse_depth_runs

    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 120)  # sparse -> zero-depth issues
    ev = events_from_reads_streamed(layout, tid, start, end, 15, chunk_slots=2000)
    gaps = {"a": [(100, 300)], "b": [(6900, 7000)]}
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    want_arrays = depth_dict_from_flat(layout, flat)
    for t, segs in gaps.items():
        arr = want_arrays[t].copy()
        for s, e in segs:
            arr[s:e] = 0
        want_arrays[t] = arr
    for t in TARGETS:
        masked = ev[t].mask_intervals(gaps.get(t, []))
        assert masked.collapse(-1, 0, 15) == collapse_depth_runs(
            want_arrays[t], -1, 0, 15
        ), t


def test_auto_switch_to_streamed(rng, monkeypatch):
    # force the limit low and verify accumulate_depth(device) routes
    # through the streamed path
    import gci_tpu.depth.accum as accum
    import gci_tpu.depth.streamed as streamed

    called = {}
    real = streamed.accumulate_depth_streamed

    def spy(*args, **kwargs):
        called["yes"] = True
        return real(*args, **kwargs, chunk_slots=4000)

    monkeypatch.setattr(accum, "stream_slot_limit", lambda: 10_000)
    monkeypatch.setattr(streamed, "accumulate_depth_streamed", spy)
    layout = GenomeLayout.from_targets(TARGETS)  # 16,153 slots > 10,000
    tid, start, end = _random_reads(rng, 200)
    got = accum.accumulate_depth(layout, tid, start, end, 15, backend="device")
    assert called.get("yes")
    np.testing.assert_array_equal(
        got, accumulate_depth_numpy(layout, tid, start, end, 15)
    )


def test_pack_sharded_past_int32(rng):
    # simulated 3.1 Gbp x 2 haplotypes: 6.2G slots (> 2^31); the sharded
    # packer must produce exact (shard, offset) int32 pairs from int64 bases
    from gci_tpu.depth.device import pack_read_deltas, pack_read_deltas_sharded

    big = {f"chr{i}": 310_000_000 for i in range(20)}  # 6.2G slots
    layout = GenomeLayout.from_targets(big)
    assert layout.total_slots > 2**31
    n = 5000
    tid = rng.integers(0, 20, n).astype(np.int64)
    start = (rng.random(n) * 309_000_000).astype(np.int64)
    end = start + (rng.random(n) * 30_000).astype(np.int64) + 40
    shard_slots = 97_000_000  # uneven shard size: offsets exercise modulo
    gs_sh, gs_off, ge_sh, ge_off, live = pack_read_deltas_sharded(
        layout, tid, start, end, 15, shard_slots
    )
    from gci_tpu.depth.accum import clamp_read_intervals

    s, e = clamp_read_intervals(layout, tid, start, end, 15)
    base = layout.offsets[tid]
    want_gs = base + s
    want_ge = base + e
    np.testing.assert_array_equal(
        gs_sh.astype(np.int64) * shard_slots + gs_off, want_gs
    )
    np.testing.assert_array_equal(
        ge_sh.astype(np.int64) * shard_slots + ge_off, want_ge
    )
    assert gs_off.dtype == np.int32 and (gs_off >= 0).all()
    np.testing.assert_array_equal(live, (e > s).astype(np.int32))

    # the global-int32 single-chip packer must refuse this layout
    with pytest.raises(OverflowError):
        pack_read_deltas(layout, tid, start, end, 15)


def test_run_gci_streamed_backend_matches_events(tmp_path):
    # user-reachable: depth_backend="streamed" through the whole pipeline
    from gci_tpu.pipeline import run_gci
    from tests.fixtures import make_bam, make_fasta, random_reads

    rng = np.random.default_rng(0x57E)
    refs, lens = ["chrA", "chrB"], [20000, 12000]
    recs = []
    for r, L in zip(refs, lens):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if r == "chrA":
            seq = seq[:4000] + "N" * 200 + seq[4200:]
        recs.append((r, seq))
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, recs)
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, refs, lens, random_reads(rng, refs, lens, 500, name_prefix="h"))
    d_ev, d_st = str(tmp_path / "ev"), str(tmp_path / "st")
    run_gci(hifi=[bam], reference=ref, directory=d_ev, prefix="S",
            depth_backend="events")
    run_gci(hifi=[bam], reference=ref, directory=d_st, prefix="S",
            depth_backend="streamed")
    for name in ["S.depth.gz", "S.0.depth.bed", "S.gci", "S.gaps.bed"]:
        p1, p2 = os.path.join(d_ev, name), os.path.join(d_st, name)
        if name.endswith(".gz"):
            with gzip.open(p1, "rb") as a, gzip.open(p2, "rb") as b:
                assert a.read() == b.read(), name
        else:
            with open(p1, "rb") as a, open(p2, "rb") as b:
                assert a.read() == b.read(), name


def test_overlap_accumulator_matches_events_with_duplicates(rng):
    """Pack<->scatter overlap: incremental last-wins
    fold + retraction over multiple chunks equals the batch dedup exactly,
    including names replaced across chunks (and replaced twice)."""
    from gci_tpu.depth.eventspace import events_dict_from_reads
    from gci_tpu.depth.overlap import DeltaAccumulator
    from gci_tpu.depth.streamed import events_from_delta2d_streamed
    from gci_tpu.filters.cascade import dedup_last_wins
    from gci_tpu.io.names import hash_names, keys_view

    lens = {"c1": 5000, "c2": 3000}
    layout = GenomeLayout.from_targets(lens)
    n = 600
    names = [f"r{int(rng.integers(0, 250))}".encode() for _ in range(n)]
    keys = hash_names(names)
    tid = rng.integers(0, 2, n).astype(np.int32)
    L = np.array([5000, 3000])[tid]
    start = (L * rng.random(n) * 0.8).astype(np.int64)
    end = np.minimum(start + rng.integers(30, 900, n), L)

    # batch oracle: global last-wins then events
    surv = dedup_last_wins(keys, np.ones(n, bool))
    want = events_dict_from_reads(
        layout, tid[surv], start[surv], end[surv], flank_len=15
    )

    # incremental: 7 chunks in file order, each deduped within-chunk
    from gci_tpu.depth.streamed import resident_chunk_slots

    cs = resident_chunk_slots(layout.total_slots, chunk_slots=4096)
    acc = DeltaAccumulator(layout, 15, cs)
    bounds = np.linspace(0, n, 8).astype(int)
    for k in range(7):
        lo, hi = bounds[k], bounds[k + 1]
        csurv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        acc.add_chunk(
            keys_view(keys[csurv]), tid[csurv], start[csurv], end[csurv]
        )
    got = events_from_delta2d_streamed(layout, acc.delta2d, chunk_slots=4096)
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_array_equal(
            got[t].materialize(), want[t].materialize(), err_msg=t
        )


def test_run_gci_overlap_multi_chunk_matches_events(tmp_path, rng, monkeypatch):
    """Whole-pipeline overlap path with multiple BAM chunks (small
    GCI_BAM_CHUNK_BYTES) stays byte-identical to the events backend."""
    import subprocess  # noqa: F401  (documentation parity with sibling test)

    from gci_tpu.pipeline import run_gci
    from tests.fixtures import make_bam, make_fasta, random_reads

    refs = ["cA", "cB"]
    lens = [30000, 20000]
    seqs = []
    for r, L in zip(refs, lens):
        s = "".join(rng.choice(list("ACGT"), size=L))
        if r == "cA":
            s = s[:4000] + "N" * 120 + s[4120:]
        seqs.append((r, s))
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, seqs)
    bam = str(tmp_path / "r.bam")
    # duplicate names across the file so cross-chunk retraction fires
    make_bam(bam, refs, lens, random_reads(rng, refs, lens, 800, name_prefix="d"))

    d_ev = str(tmp_path / "ev")
    run_gci(hifi=[bam], reference=ref, directory=d_ev, prefix="S",
            depth_backend="events")

    monkeypatch.setenv("GCI_BAM_CHUNK_BYTES", str(8 * 1024))
    d_ov = str(tmp_path / "ov")
    run_gci(hifi=[bam], reference=ref, directory=d_ov, prefix="S",
            depth_backend="streamed")

    for f in ("S.depth.gz", "S.0.depth.bed", "S.gci", "S.gaps.bed"):
        with open(f"{d_ev}/{f}", "rb") as a, open(f"{d_ov}/{f}", "rb") as b:
            assert a.read() == b.read(), f


def test_sweep_accumulator_matches_events_with_retro_retraction(rng):
    """Coordinate-sweep overlap (finalize chunks as sorted reads pass):
    batch parity including retro-retractions that reach back into already
    finalized+scanned chunks (event-space fixup path)."""
    from gci_tpu.depth.eventspace import events_dict_from_reads
    from gci_tpu.depth.overlap import SweepAccumulator
    from gci_tpu.filters.cascade import dedup_last_wins
    from gci_tpu.io.names import hash_names, keys_view

    lens = {"c1": 60000, "c2": 40000}
    layout = GenomeLayout.from_targets(lens)
    n = 900
    # sorted-by-coordinate read stream with duplicate names sprinkled so
    # retractions reach back across chunk boundaries
    tid = np.sort(rng.integers(0, 2, n)).astype(np.int32)
    L = np.array([60000, 40000])[tid]
    start = np.sort((L * rng.random(n) * 0.9).astype(np.int64) + tid * 0)
    # global-sort: sort by (tid, start) like a coordinate-sorted BAM
    order = np.lexsort((start, tid))
    tid, start = tid[order], start[order]
    L = np.array([60000, 40000])[tid]
    end = np.minimum(start + rng.integers(40, 3000, n), L)
    names = []
    for k in range(n):
        if k > 50 and rng.random() < 0.08:
            # re-use a much earlier name -> retraction into finalized chunks
            names.append(f"r{int(rng.integers(0, max(k - 50, 1)))}".encode())
        else:
            names.append(f"r{k}".encode())
    keys = hash_names(names)

    surv = dedup_last_wins(keys, np.ones(n, bool))
    want = events_dict_from_reads(
        layout, tid[surv], start[surv], end[surv], flank_len=15
    )

    acc = SweepAccumulator(layout, 15, chunk_slots=8192)
    bounds = np.linspace(0, n, 10).astype(int)
    for k in range(9):
        lo, hi = bounds[k], bounds[k + 1]
        csurv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        acc.add_chunk(
            keys_view(keys[csurv]), tid[csurv], start[csurv], end[csurv]
        )
    assert acc.frontier > 0, "sweep never finalized a chunk during pack"
    got = acc.finish()
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_array_equal(
            got[t].materialize(), want[t].materialize(), err_msg=t
        )


def test_sweep_accumulator_unsorted_input_stays_correct(rng):
    """Unsorted reads disable early finalization but the result still
    matches the batch oracle."""
    from gci_tpu.depth.eventspace import events_dict_from_reads
    from gci_tpu.depth.overlap import SweepAccumulator
    from gci_tpu.filters.cascade import dedup_last_wins
    from gci_tpu.io.names import hash_names, keys_view

    lens = {"c1": 30000}
    layout = GenomeLayout.from_targets(lens)
    n = 400
    tid = np.zeros(n, np.int32)
    start = rng.integers(0, 29000, n).astype(np.int64)  # NOT sorted
    end = np.minimum(start + rng.integers(40, 2000, n), 30000)
    names = [f"r{int(rng.integers(0, 150))}".encode() for _ in range(n)]
    keys = hash_names(names)
    surv = dedup_last_wins(keys, np.ones(n, bool))
    want = events_dict_from_reads(
        layout, tid[surv], start[surv], end[surv], flank_len=15
    )
    acc = SweepAccumulator(layout, 15, chunk_slots=4096)
    bounds = np.linspace(0, n, 6).astype(int)
    for k in range(5):
        lo, hi = bounds[k], bounds[k + 1]
        csurv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        acc.add_chunk(
            keys_view(keys[csurv]), tid[csurv], start[csurv], end[csurv]
        )
    got = acc.finish()
    for t in want:
        np.testing.assert_array_equal(
            got[t].materialize(), want[t].materialize(), err_msg=t
        )


def test_sweep_accumulator_retro_add_after_finalization():
    """An out-of-order ADD behind the finalization frontier (unsorted
    input detected late) applies the +1 event-space fixup — the signed
    counterpart of the retraction path."""
    from gci_tpu.depth.eventspace import events_dict_from_reads
    from gci_tpu.depth.overlap import SweepAccumulator
    from gci_tpu.filters.cascade import dedup_last_wins
    from gci_tpu.io.names import hash_names, keys_view

    layout = GenomeLayout.from_targets({"c": 40000})
    batches = [
        (np.sort(np.linspace(0, 8000, 40).astype(np.int64)), "a"),
        (np.sort(np.linspace(30000, 36000, 40).astype(np.int64)), "b"),
        (np.array([100, 36500], np.int64), "z"),  # 100 is behind the frontier
    ]
    acc = SweepAccumulator(layout, 15, chunk_slots=4096)
    all_tid, all_s, all_e, all_names = [], [], [], []
    for si, (s, pfx) in enumerate(batches):
        n = s.shape[0]
        tid = np.zeros(n, np.int32)
        e = np.minimum(s + 800, 40000)
        names = [f"{pfx}{k}".encode() for k in range(n)]
        keys = hash_names(names)
        sv = dedup_last_wins(keys, np.ones(n, bool))
        acc.add_chunk(keys_view(keys[sv]), tid[sv], s[sv], e[sv])
        if si == 1:
            assert acc.frontier > 0
        all_tid.append(tid)
        all_s.append(s)
        all_e.append(e)
        all_names += names
    got = acc.finish()
    tid = np.concatenate(all_tid)
    s = np.concatenate(all_s)
    e = np.concatenate(all_e)
    keys = hash_names(all_names)
    sv = dedup_last_wins(keys, np.ones(len(all_names), bool))
    want = events_dict_from_reads(layout, tid[sv], s[sv], e[sv], flank_len=15)
    np.testing.assert_array_equal(
        got["c"].materialize(), want["c"].materialize()
    )
