"""Single-device resident backend: scan parity + run_gci byte parity.

The production ``depth_backend="device"`` path (gci_tpu.depth.fused) must
produce byte-identical outputs to the events backend (itself golden-pinned
against the reference), and the packed-word scan (Triton kernel in
interpret mode, and its XLA reference) must match the numpy oracle of the
gap-masked issue scan exactly.
"""
import gzip
import os

import numpy as np
import pytest

from gci_tpu.depth.accum import GenomeLayout
from gci_tpu.depth.fused import DeviceDepth, compact_indices
from gci_tpu.depth.scan import fused_depth_scan_packed_xla, packed_scan_kernel
from gci_tpu.pipeline import run_gci
from tests.fixtures import make_bam, make_fasta, random_reads

REFS = ["chrA", "chrB", "chrC"]
LENS = [30000, 20000, 4096]


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def _oracle(delta, gap, valid, lo, hi):
    raw = np.cumsum(delta).astype(np.int32)
    masked = np.where(gap != 0, 0, raw)
    m = (masked > lo) & (masked <= hi) & (valid != 0)
    prev = np.concatenate(([False], m[:-1]))
    rise = m & ~prev
    fall = ~m & prev
    change = np.concatenate(([True], raw[1:] != raw[:-1]))
    return raw, rise, fall, change


def _events(mask):
    """+1/-1 interval events whose prefix sum is the 0/1 ``mask``."""
    m = mask.astype(np.int32)
    return m - np.concatenate(([0], m[:-1]))


def _packed_scans(delta, gap, valid, block):
    """Both packed-word scans of (delta, gap mask, valid mask), decoded into
    (raw, rise, fall, change) like ``_oracle``."""
    word = (delta << 2) + 2 * _events(gap) + _events(valid)
    for raw, flags in (
        packed_scan_kernel(word, -1, 0, block=block, interpret=True),
        fused_depth_scan_packed_xla(word, -1, 0),
    ):
        f = np.asarray(flags)
        yield np.asarray(raw), f & 1, f & 2, f & 4


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_masked_kernel_matches_oracle(rng, block, n_chunks):
    total = n_chunks * block
    delta = np.zeros(total, np.int32)
    idx = rng.integers(0, total, total // 8)
    np.add.at(delta, idx, 1)
    np.add.at(delta, np.minimum(idx + rng.integers(1, 40, idx.shape[0]), total - 1), -1)
    gap = (rng.random(total) < 0.15).astype(np.int8)
    valid = (rng.random(total) < 0.8).astype(np.int8)
    want = _oracle(delta, gap, valid, -1, 0)
    for got in _packed_scans(delta, gap, valid, block):
        np.testing.assert_array_equal(got[0], want[0])
        for j in (1, 2, 3):
            np.testing.assert_array_equal(got[j] != 0, want[j])


def test_masked_kernel_gap_at_chunk_boundary(rng):
    # gap covering the last slot of block 0 and first of block 1: the
    # block carry must make the block-1 edge flags exact
    block = 128
    total = 2 * block
    delta = np.zeros(total, np.int32)
    delta[0] = 3  # depth 3 everywhere
    gap = np.zeros(total, np.int8)
    gap[block - 4 : block + 4] = 1  # masked depth dips to 0 across boundary
    valid = np.ones(total, np.int8)
    want = _oracle(delta, gap, valid, -1, 0)
    for got in _packed_scans(delta, gap, valid, block):
        for j in (1, 2, 3):
            np.testing.assert_array_equal(got[j] != 0, want[j])


def test_compact_indices_roundtrip(rng):
    bitmap = (rng.random(5000) < 0.01).astype(np.int8)
    import jax.numpy as jnp

    idx = compact_indices(jnp.asarray(bitmap))
    np.testing.assert_array_equal(idx, np.flatnonzero(bitmap))
    assert compact_indices(jnp.zeros(64, jnp.int8)).shape == (0,)


# ---------------------------------------------------------------------------
# DeviceDepth unit behavior
# ---------------------------------------------------------------------------

def test_device_depth_matches_numpy_oracle(rng):
    from gci_tpu.depth.accum import accumulate_depth_numpy, depth_dict_from_flat

    layout = GenomeLayout.from_targets({"a": 5000, "b": 3000})
    n = 400
    tid = rng.integers(0, 2, n).astype(np.int32)
    start = rng.integers(0, 2500, n).astype(np.int64)
    end = start + rng.integers(40, 900, n)
    gaps = {"a": [(100, 220), (4000, 4100)], "b": [(0, 64)]}

    dd = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    want_raw = depth_dict_from_flat(layout, flat)
    # raw depth (checkpoint content) is pre-mask
    got = dd.materialize_dict()
    for t in want_raw:
        np.testing.assert_array_equal(got[t], want_raw[t])
    ev = dd.to_events()
    for t in want_raw:
        np.testing.assert_array_equal(ev[t].materialize(), want_raw[t])

    # masked object: intervals from the kernel cache == oracle collapse
    from gci_tpu.intervals.collapse import collapse_depth_runs

    masked = dd.mask_gaps(gaps)
    key = (float(-1), float(0), 15)
    assert key in masked._edge_cache  # scan-extracted, no extra pass
    want_masked = {t: a.copy() for t, a in want_raw.items()}
    for t, segs in gaps.items():
        for s, e in segs:
            want_masked[t][s:e] = 0
    for t in want_masked:
        assert masked.collapse_dict(-1, 0, 15)[t] == collapse_depth_runs(
            want_masked[t], -1, 0, 15
        )
        # non-cached query takes the XLA edge path
        assert masked.collapse_dict(-1, 2, 15)[t] == collapse_depth_runs(
            want_masked[t], -1, 2, 15
        )
    # two-type max
    merged = masked.maximum(masked)
    for t in want_masked:
        np.testing.assert_array_equal(merged.materialize_dict()[t], want_masked[t])


# ---------------------------------------------------------------------------
# run_gci end-to-end byte parity vs the events backend
# ---------------------------------------------------------------------------

def _make_ref(path, rng, gap_at=None):
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if gap_at and r in gap_at:
            s, e = gap_at[r]
            seq = seq[:s] + "N" * (e - s) + seq[e:]
        recs.append((r, seq))
    make_fasta(path, recs)


def _diff_outputs(d1, d2, names):
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".gz"):
            with gzip.open(p1, "rb") as a, gzip.open(p2, "rb") as b:
                assert a.read() == b.read(), name
        else:
            with open(p1, "rb") as a, open(p2, "rb") as b:
                assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0xF5D)
    d = tmp_path_factory.mktemp("fused_inputs")
    ref = str(d / "ref.fa")
    _make_ref(ref, rng, gap_at={"chrA": (12000, 12400), "chrC": (0, 64)})
    hifi_bam = str(d / "hifi.bam")
    nano_bam = str(d / "nano.bam")
    make_bam(hifi_bam, REFS, LENS, random_reads(rng, REFS, LENS, 900, name_prefix="h"))
    make_bam(nano_bam, REFS, LENS, random_reads(rng, REFS, LENS, 700, name_prefix="n"))
    regions = str(d / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t1000\t15000\nchrB\t0\t20000\n")
    return ref, hifi_bam, nano_bam, regions


def test_device_single_type_matches_events(inputs, tmp_path):
    ref, hifi_bam, _, _ = inputs
    d_ev = str(tmp_path / "ev")
    d_dv = str(tmp_path / "dv")
    run_gci(hifi=[hifi_bam], reference=ref, directory=d_ev, prefix="F",
            depth_backend="events")
    run_gci(hifi=[hifi_bam], reference=ref, directory=d_dv, prefix="F",
            depth_backend="device")
    _diff_outputs(d_ev, d_dv, ["F.depth.gz", "F.0.depth.bed", "F.gci", "F.gaps.bed"])


def test_device_dual_type_regions_matches_events(inputs, tmp_path):
    ref, hifi_bam, nano_bam, regions = inputs
    d_ev = str(tmp_path / "ev")
    d_dv = str(tmp_path / "dv")
    for d, backend in ((d_ev, "events"), (d_dv, "device")):
        run_gci(hifi=[hifi_bam], nano=[nano_bam], reference=ref, directory=d,
                prefix="F", regions=regions, threshold=1, depth_backend=backend)
    _diff_outputs(
        d_ev, d_dv,
        ["F_hifi.depth.gz", "F_nano.depth.gz", "F_two_type.depth.gz",
         "F_hifi.1.depth.bed", "F_nano.1.depth.bed", "F_two_type.1.depth.bed",
         "F.gci", "F.regions.gci", "F.gaps.bed"],
    )


def test_device_chrs_and_paf_curation_matches_events(inputs, tmp_path):
    """--chrs restriction + multi-file PAF curation upstream of the fused
    device depth — outputs byte-identical to events."""
    from tests.fixtures import make_paf

    ref, hifi_bam, _, _ = inputs
    rng = np.random.default_rng(0xFAF)
    rows = []
    for k in range(300):
        ri = int(rng.integers(0, len(REFS)))
        L = LENS[ri]
        s = int(rng.integers(0, L - 100))
        e = int(s + rng.integers(50, min(L - s, 5000)))
        qlen = int((e - s) * rng.uniform(1.0, 1.3))
        nm = int((e - s) * rng.uniform(0.85, 1.0))
        rows.append(
            (f"h{k}", qlen, 0, e - s, "+", REFS[ri], L, s, e, nm, e - s,
             int(rng.choice([0, 30, 60])))
        )
    paf = str(tmp_path / "hifi.paf")
    make_paf(paf, rows)

    d_ev = str(tmp_path / "ev")
    d_dv = str(tmp_path / "dv")
    kw = dict(hifi=[hifi_bam, paf], reference=ref, prefix="C",
              chrs="chrA,chrC")
    run_gci(directory=d_ev, depth_backend="events", **kw)
    run_gci(directory=d_dv, depth_backend="device", **kw)
    _diff_outputs(d_ev, d_dv, ["C.depth.gz", "C.0.depth.bed", "C.gci"])


def test_fallback_flags_kernel_path_equals_packed(rng, monkeypatch):
    """The >2^29-reads guard routes from_reads onto the unpacked flags scan
    (gci_tpu.depth.fused._fused_fn) — force it with a tiny limit and assert
    it produces the same depth/edges/events as the packed production path."""
    import gci_tpu.depth.fused as fused

    layout = GenomeLayout.from_targets({"a": 5000, "b": 3000})
    n = 300
    tid = rng.integers(0, 2, n).astype(np.int32)
    start = rng.integers(0, 2500, n).astype(np.int64)
    end = start + rng.integers(40, 900, n)
    gaps = {"a": [(100, 220)], "b": [(0, 64)]}

    packed = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)
    fallback = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps)
    assert fallback.gap_bit == 1 and packed.gap_bit == 8

    for t, a in packed.materialize_dict().items():
        np.testing.assert_array_equal(a, fallback.materialize_dict()[t])
    assert packed.collapse_dict(-1, 0, 15) == fallback.collapse_dict(-1, 0, 15)
    pm, fm = packed.mask_gaps(gaps), fallback.mask_gaps(gaps)
    assert pm.collapse_dict(-1, 0, 15) == fm.collapse_dict(-1, 0, 15)
    for t, ev in pm.to_events().items():
        np.testing.assert_array_equal(
            ev.materialize(), fm.to_events()[t].materialize()
        )


def test_from_delta_matches_from_reads(rng):
    """The overlap path's entry (an already-accumulated delta array) must
    construct the identical resident object as from_reads: same depth,
    same kernel-cached issue intervals, same events."""
    import jax.numpy as jnp

    from gci_tpu.depth.device import pack_read_deltas

    layout = GenomeLayout.from_targets({"a": 6000, "b": 2000})
    n = 350
    tid = rng.integers(0, 2, n).astype(np.int32)
    start = rng.integers(0, 1500, n).astype(np.int64)
    end = start + rng.integers(40, 400, n)
    gaps = {"a": [(500, 700)]}

    dd1 = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps)
    gs, ge, live = pack_read_deltas(layout, tid, start, end, 15)
    pad_total = DeviceDepth.pad_total_for(layout.total_slots)
    delta = np.zeros(pad_total, np.int32)
    np.add.at(delta, gs, live)
    np.add.at(delta, ge, -live)
    dd2 = DeviceDepth.from_delta(layout, jnp.asarray(delta), 15, gaps=gaps)

    for t, a in dd1.materialize_dict().items():
        np.testing.assert_array_equal(a, dd2.materialize_dict()[t])
    m1, m2 = dd1.mask_gaps(gaps), dd2.mask_gaps(gaps)
    assert m1.collapse_dict(-1, 0, 15) == m2.collapse_dict(-1, 0, 15)
    for t, ev in dd1.to_events().items():
        np.testing.assert_array_equal(
            ev.materialize(), dd2.to_events()[t].materialize()
        )
