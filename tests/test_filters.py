"""Vectorized cascade vs the per-record oracle on randomized inputs."""
import os

import numpy as np
import pytest

from gci_tpu.depth import GenomeLayout, accumulate_depth_numpy, depth_dict_from_flat
from gci_tpu.filters import (
    CurationInput,
    bam_filter_mask,
    curate_files,
    dedup_last_wins,
    elect_primary_targets,
    paf_filter_mask,
)
from gci_tpu.filters.cascade import high_qual_keys
from gci_tpu.io.bam import read_bam
from gci_tpu.io.names import hash_names
from gci_tpu.io.paf import read_paf
from tests.fixtures import make_bam, make_paf, random_reads
from tests.oracle_gci import oracle_filter

REFS = ["chrA", "chrB", "chrC"]
LENS = [40000, 25000, 10000]
TARGETS = dict(zip(REFS, LENS))


def _vector_filter(pafs, bams, targets_length, flank_len=15, **kw):
    """Production path: masks + election + curation + depth (numpy)."""
    map_qual = kw.get("map_qual", 30)
    mq_cutoff = kw.get("mq_cutoff", 50)
    iden = kw.get("iden_percent", 0.9)
    clip = kw.get("clip_percent", 0.1)
    ovlp = kw.get("ovlp_percent", 0.9)
    target_ids = {t: i for i, t in enumerate(targets_length)}
    layout = GenomeLayout.from_targets(targets_length)
    hq_parts = []
    inputs = []
    paf_masked = []
    for paf in pafs:
        in_t = np.array(
            [t in target_ids for t in paf.target_names] or [False], dtype=bool
        )[paf.tid]
        mask = in_t & paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, map_qual, iden)
        paf_masked.append((paf, mask))
        hq_parts.append(high_qual_keys(paf.name_keys, mask, paf.mapq, mq_cutoff))
    for elected in elect_primary_targets(paf_masked):
        t2g = np.array(
            [target_ids[t] for t in elected.target_names] or [-1],
            dtype=np.int32,
        )
        inputs.append(
            CurationInput(
                elected.name_keys,
                t2g[elected.tid],
                elected.start,
                elected.end,
                elected.qlen,
            )
        )
    for bam in bams:
        l2g = np.full(len(bam.references) + 1, -1, dtype=np.int32)
        for k, name in enumerate(bam.references):
            if name in target_ids:
                l2g[k] = target_ids[name]
        rid = bam.columns["ref_id"]
        gtid = np.where(
            (rid >= 0) & (rid < len(bam.references)), l2g[np.clip(rid, 0, None)], -1
        )
        mask = (gtid >= 0) & bam_filter_mask(bam.columns, map_qual, clip, iden)
        hq_parts.append(high_qual_keys(bam.name_keys, mask, bam.columns["mapq"], mq_cutoff))
        surv = dedup_last_wins(bam.name_keys, mask)
        inputs.append(
            CurationInput(
                bam.name_keys[surv],
                gtid[surv],
                bam.columns["pos"][surv].astype(np.int64),
                bam.columns["ref_end"][surv].astype(np.int64),
                bam.columns["qlen"][surv].astype(np.int64),
            )
        )
    non_empty = [p for p in hq_parts if p.size]
    hq = (
        np.unique(np.concatenate(non_empty))
        if non_empty
        else np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
    )
    cur = curate_files(inputs, hq, ovlp)
    flat = accumulate_depth_numpy(layout, cur.target_id, cur.start, cur.end, flank_len)
    return depth_dict_from_flat(layout, flat)


def _compare(got, want):
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_array_equal(got[t], want[t], err_msg=t)


def test_single_bam_matches_oracle(tmp_path, rng):
    p = str(tmp_path / "a.bam")
    make_bam(p, REFS, LENS, random_reads(rng, REFS, LENS, 400))
    bam = read_bam(p)
    got = _vector_filter([], [bam], TARGETS)
    want = oracle_filter([], [bam], TARGETS)
    _compare(got, want)


def test_two_bams_matches_oracle(tmp_path, rng):
    p1, p2 = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    make_bam(p1, REFS, LENS, random_reads(rng, REFS, LENS, 300))
    make_bam(p2, REFS, LENS, random_reads(rng, REFS, LENS, 300))
    bams = [read_bam(p1), read_bam(p2)]
    got = _vector_filter([], bams, TARGETS)
    want = oracle_filter([], bams, TARGETS)
    _compare(got, want)


def _random_paf_rows(rng, n, name_space=120):
    rows = []
    for _ in range(n):
        t = REFS[int(rng.integers(0, len(REFS)))]
        tlen = TARGETS[t]
        qlen = int(rng.integers(500, 20000))
        qs = int(rng.integers(0, qlen // 2))
        qe = int(rng.integers(qs + 1, qlen + 1))
        ts = int(rng.integers(0, max(tlen - 100, 1)))
        te = min(ts + (qe - qs), tlen)
        alnlen = max(qe - qs, 1)
        nmatch = int(alnlen * rng.uniform(0.7, 1.0))
        mapq = int(rng.choice([0, 20, 30, 50, 60]))
        rows.append(
            (f"q{int(rng.integers(0, name_space))}", qlen, qs, qe, "+", t,
             tlen, ts, te, nmatch, alnlen, mapq)
        )
    return rows


def test_paf_plus_bam_matches_oracle(tmp_path, rng):
    pp1 = str(tmp_path / "x.paf")
    pp2 = str(tmp_path / "y.paf")
    bp = str(tmp_path / "a.bam")
    make_paf(pp1, _random_paf_rows(rng, 300))
    make_paf(pp2, _random_paf_rows(rng, 250))
    make_bam(bp, REFS, LENS, random_reads(rng, REFS, LENS, 300, name_prefix="q"))
    pafs = [read_paf(pp1), read_paf(pp2)]
    bam = read_bam(bp)
    got = _vector_filter(pafs, [bam], TARGETS)
    want = oracle_filter(pafs, [bam], TARGETS)
    _compare(got, want)


def test_flank_wrap_quirk(tmp_path):
    # alignment shorter than the flank: end-flank+1 goes negative and the
    # reference's slice wraps around to L+e (GCI.py:302-306)
    reads = [dict(name="tiny", ref="chrC", pos=2, mapq=60, cigar="10M", nm=0)]
    p = str(tmp_path / "t.bam")
    make_bam(p, REFS, LENS, reads)
    bam = read_bam(p)
    got = _vector_filter([], [bam], TARGETS)
    want = oracle_filter([], [bam], TARGETS)
    _compare(got, want)
    # the quirk produces a huge smeared increment, not a no-op
    assert got["chrC"].sum() > 0


def test_chrs_restriction_matches_oracle(tmp_path, rng):
    p = str(tmp_path / "a.bam")
    make_bam(p, REFS, LENS, random_reads(rng, REFS, LENS, 200))
    bam = read_bam(p)
    restricted = {"chrB": TARGETS["chrB"]}
    got = _vector_filter([], [bam], restricted)
    want = oracle_filter([], [bam], restricted)
    _compare(got, want)


def test_paf_plus_two_bams_matches_oracle(tmp_path, rng):
    """Three-file curation fold incl. drop-then-readopt via high-qual."""
    pp = str(tmp_path / "x.paf")
    b1 = str(tmp_path / "a.bam")
    b2 = str(tmp_path / "b.bam")
    make_paf(pp, _random_paf_rows(rng, 250, name_space=80))
    make_bam(b1, REFS, LENS, random_reads(rng, REFS, LENS, 250, name_prefix="q"))
    make_bam(b2, REFS, LENS, random_reads(rng, REFS, LENS, 250, name_prefix="q"))
    pafs = [read_paf(pp)]
    bams = [read_bam(b1), read_bam(b2)]
    got = _vector_filter(pafs, bams, TARGETS)
    want = oracle_filter(pafs, bams, TARGETS)
    _compare(got, want)


def test_ovlp_percent_sweep_matches_oracle(tmp_path, rng):
    b1 = str(tmp_path / "a.bam")
    b2 = str(tmp_path / "b.bam")
    make_bam(b1, REFS, LENS, random_reads(rng, REFS, LENS, 200, name_prefix="s"))
    make_bam(b2, REFS, LENS, random_reads(rng, REFS, LENS, 200, name_prefix="s"))
    bams = [read_bam(b1), read_bam(b2)]
    for op in (0.0, 0.5, 0.99):
        got = _vector_filter([], bams, TARGETS, ovlp_percent=op)
        want = oracle_filter([], bams, TARGETS, ovlp_percent=op)
        _compare(got, want)


# ---------------------------------------------------------------------------
# Vectorized election vs the per-query oracle loop (GCI.py:213-254)
# ---------------------------------------------------------------------------

def _election_paf_rows(rng, n, targets, n_queries, engineered_ties=False):
    """Random PAF rows; with engineered_ties, duplicate some query's rows
    onto a second target so (score, name) tie-break paths fire."""
    names = sorted(targets)
    rows = []
    for _ in range(n):
        q = int(rng.integers(0, n_queries))
        qlen = int(rng.integers(500, 20000))
        qs = int(rng.integers(0, qlen - 10))
        qe = int(rng.integers(qs + 1, qlen + 1))
        t = names[int(rng.integers(0, len(names)))]
        tl = targets[t]
        ts = int(rng.integers(0, tl - 10))
        te = int(rng.integers(ts + 1, tl + 1))
        alnlen = int(rng.integers(10, 30000))
        nmatch = int(rng.integers(0, alnlen + 1))
        mapq = int(rng.choice([0, 20, 30, 50, 60]))
        rows.append((f"q{q}", qlen, qs, qe, "+", t, tl, ts, te, nmatch, alnlen, mapq))
    if engineered_ties:
        # exact duplicate alignments under a different target name: scores
        # equal to the ULP, winner must be the lexicographically larger name
        extra = []
        for r in rows[:: max(len(rows) // 10, 1)]:
            for t2 in names:
                if t2 != r[5]:
                    extra.append(r[:5] + (t2,) + r[6:])
                    break
        rows += extra
    return rows


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True), (3, False)])
def test_election_matches_oracle_randomized(tmp_path, seed, ties):
    from tests.oracle_gci import oracle_paf_elections

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(3):  # 3 files -> cumulative re-election quirk
        rows = _election_paf_rows(
            rng, int(rng.integers(50, 400)), TARGETS, n_queries=40,
            engineered_ties=ties,
        )
        p = str(tmp_path / f"f{i}.paf")
        make_paf(p, rows)
        paths.append(p)
    pafs = [read_paf(p) for p in paths]

    oracle_lines, _ = oracle_paf_elections(pafs, TARGETS, 30, 0.9, 50)

    masked = []
    for paf in pafs:
        in_t = np.array(
            [t in TARGETS for t in paf.target_names] or [False], dtype=bool
        )[paf.tid]
        mask = in_t & paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, 30, 0.9)
        masked.append((paf, mask))

    for elected, odict in zip(elect_primary_targets(masked), oracle_lines):
        onames = list(odict.keys())
        ovals = list(odict.values())
        assert elected.name_keys.shape[0] == len(onames)
        np.testing.assert_array_equal(elected.name_keys, hash_names(onames))
        got_targets = [elected.target_names[t] for t in elected.tid.tolist()]
        assert got_targets == [v[0] for v in ovals]
        np.testing.assert_array_equal(elected.start, [v[1] for v in ovals])
        np.testing.assert_array_equal(elected.end, [v[2] for v in ovals])
        np.testing.assert_array_equal(elected.qlen, [v[3] for v in ovals])


def test_election_insertion_order_identity_sum(tmp_path):
    """avg identity is the sequential insertion-order sum (bit parity):
    a group with >8 alignments would differ under pairwise summation."""
    from tests.oracle_gci import oracle_paf_elections

    rng = np.random.default_rng(7)
    rows = []
    for k in range(40):  # one query, one target, 40 alignments
        alnlen = int(rng.integers(1000, 30000))
        nmatch = int(rng.integers(int(alnlen * 0.93), alnlen + 1))
        rows.append(
            ("q0", 10000, 100 + 7 * k, 400 + 7 * k, "+", "chrA", 40000,
             1000 + 11 * k, 2000 + 11 * k, nmatch, alnlen, 60)
        )
    p = str(tmp_path / "one.paf")
    make_paf(p, rows)
    paf = read_paf(p)
    mask = paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, 30, 0.9)
    oracle_lines, _ = oracle_paf_elections([paf], TARGETS, 30, 0.9, 50)
    (elected,) = elect_primary_targets([(paf, mask)])
    (oval,) = list(oracle_lines[0].values())
    assert elected.target_names[elected.tid[0]] == oval[0]
    assert (int(elected.start[0]), int(elected.end[0]), int(elected.qlen[0])) == (
        oval[1], oval[2], oval[3]
    )


def test_paf_byte_range_sharding_partitions_rows(tmp_path):
    """read_paf(byte_range=...) over 3 shards partitions the row stream
    exactly (no loss, no overlap, order preserved)."""
    rng = np.random.default_rng(11)
    rows = _election_paf_rows(rng, 500, TARGETS, n_queries=60)
    p = str(tmp_path / "shard.paf")
    make_paf(p, rows)
    full = read_paf(p)
    fsize = os.path.getsize(p)
    parts = []
    for h in range(3):
        lo = fsize * h // 3
        hi = fsize * (h + 1) // 3 if h < 2 else fsize
        parts.append(read_paf(p, byte_range=(lo, hi)))
    assert sum(s.n_records for s in parts) == full.n_records
    assert all(s.n_records > 0 for s in parts)
    np.testing.assert_array_equal(
        np.concatenate([s.name_keys for s in parts]), full.name_keys
    )
    got_targets = [t for s in parts for t in s.targets]
    assert got_targets == full.targets
    for col in ("qlen", "qstart", "qend", "tstart", "tend", "nmatch", "alnlen", "mapq"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(s, col) for s in parts]), getattr(full, col)
        )
    # python fallback parser slices identically
    py = [
        __import__("gci_tpu.io.paf", fromlist=["_read_paf_python"])._read_paf_python(
            p, (fsize * h // 3, fsize * (h + 1) // 3 if h < 2 else fsize)
        )
        for h in range(3)
    ]
    assert sum(s.n_records for s in py) == full.n_records
    np.testing.assert_array_equal(
        np.concatenate([s.name_keys for s in py]), full.name_keys
    )


def test_paf_shard_partitions_rows_plain_and_gz(tmp_path):
    """shard=(h, H) partitions the row stream exactly — plain AND gzipped
    (gz PAFs shard the tokenize over the uncompressed bytes; inflate is
    per-host but the expensive part splits)."""
    import gzip

    from gci_tpu.io.paf import _read_paf_python

    rows = [
        (f"q{i}", 100, 0, 100, "+", f"t{i % 5}", 9000, 0, 100, 95, 100, 60)
        for i in range(457)
    ]
    p = str(tmp_path / "s.paf")
    make_paf(p, rows)
    pgz = str(tmp_path / "s.paf.gz")
    with open(p, "rb") as f:
        with gzip.open(pgz, "wb") as g:
            g.write(f.read())
    for path in (p, pgz):
        full = read_paf(path)
        for H in (2, 3, 5):
            shards = [read_paf(path, shard=(h, H)) for h in range(H)]
            assert sum(s.n_records for s in shards) == 457
            names = [n for s in shards for n in s.names]
            assert names == full.names  # no loss, no overlap, order kept
            # the pure-python fallback partitions identically
            assert sum(
                _read_paf_python(path, shard=(h, H)).n_records
                for h in range(H)
            ) == 457
