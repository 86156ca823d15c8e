"""Boundary-value differential suite for the alignment-filter half.

Why: the BAM/PAF -> depth half was otherwise validated only against
``tests/oracle_gci.py`` — itself a transcription of the documented reference
semantics — so a shared misreading would pass every test.  Every case here
carries LITERAL hand-computed expected values written in the test (worked
out from the reference formulas by hand, see each comment), asserted against
BOTH the vectorized production path and the oracle, at exact float64
threshold ties:

* identity == iden_percent exactly (BAM GCI.py:165 and PAF GCI.py:231-232)
* clip == clip_percent exactly (GCI.py:165)
* mapq == map_qual and mapq == mq_cutoff exactly (GCI.py:156, 167)
* ovlp/qlen == ovlp_percent exactly (GCI.py:285-295)
* pathological cigars: hard clips, =/X-only, NM < I+D, all-soft-clip
  (where the reference's ``and`` short-circuit dodges its own
  ZeroDivisionError)
* cross-file curation re-adoption chains through the high-qual set
  (GCI.py:297-299), including re-adoption driven by a LATER file's mapq
* the multi-PAF synteny-accumulation quirk (GCI.py:215/241)
"""
import numpy as np
import pytest

from gci_tpu.filters import bam_filter_mask, elect_primary_targets, paf_filter_mask
from gci_tpu.filters.cascade import high_qual_keys
from gci_tpu.io.bam import read_bam
from gci_tpu.io.paf import read_paf
from tests.fixtures import make_bam, make_paf
from tests.oracle_gci import oracle_bam_dict, oracle_filter, oracle_paf_elections
from tests.test_filters import _compare, _vector_filter

REFS = ["chrA", "chrB"]
LENS = [3000, 2000]
TARGETS = dict(zip(REFS, LENS))


def _bam(tmp_path, name, reads):
    p = str(tmp_path / name)
    make_bam(p, REFS, LENS, reads)
    return read_bam(p)


# ---------------------------------------------------------------------------
# BAM mask thresholds at exact float64 ties
# ---------------------------------------------------------------------------

def test_bam_threshold_exact_ties(tmp_path):
    reads = [
        # identity = (M+eq+X-mm)/(M+eq+X+I+D), mm = NM-(I+D)
        # 9M1D NM=1: mm=0, identity = 9/10 = 0.9 == iden_percent -> KEEP (>=)
        dict(name="iden_eq", ref="chrA", pos=500, mapq=60, cigar="9M1D", nm=1),
        # 89M11D NM=11: mm=0, identity = 89/100 = 0.89 < 0.9 -> DROP
        dict(name="iden_lo", ref="chrA", pos=500, mapq=60, cigar="89M11D", nm=11),
        # clip = S/(M+eq+X+I+S): 1S9M -> 1/10 = 0.1 == clip_percent -> KEEP (<=)
        dict(name="clip_eq", ref="chrA", pos=500, mapq=60, cigar="1S9M", nm=0),
        # 11S89M -> 11/100 = 0.11 > 0.1 -> DROP
        dict(name="clip_hi", ref="chrA", pos=500, mapq=60, cigar="11S89M", nm=0),
        # mapq == map_qual exactly -> KEEP (>=)
        dict(name="mapq_eq", ref="chrA", pos=500, mapq=30, cigar="100M", nm=0),
        # mapq = map_qual - 1 -> DROP
        dict(name="mapq_lo", ref="chrA", pos=500, mapq=29, cigar="100M", nm=0),
    ]
    bam = _bam(tmp_path, "ties.bam", reads)
    mask = bam_filter_mask(bam.columns, map_qual=30, clip_percent=0.1,
                           iden_percent=0.9)
    by_name = dict(zip(bam.names, mask.tolist()))
    # literal expectations, worked by hand above
    assert by_name == {
        b"iden_eq": True,
        b"iden_lo": False,
        b"clip_eq": True,
        b"clip_hi": False,
        b"mapq_eq": True,
        b"mapq_lo": False,
    }
    # the oracle (independent transcription) must agree
    d, _ = oracle_bam_dict(bam, TARGETS, 30, 0.1, 0.9, 50)
    assert set(d) == {b"iden_eq", b"clip_eq", b"mapq_eq"}


def test_bam_pathological_cigars(tmp_path):
    reads = [
        # hard clips consume neither query nor S: clip = 0/9, identity =
        # 9/10 = 0.9 -> KEEP (pysam cigar stats index 5 (H) is never used)
        dict(name="hardclip", ref="chrA", pos=500, mapq=60,
             cigar="50H9M1D50H", nm=1),
        # =/X-only (no M): identity = (45+5-5)/50 = 0.9 exactly -> KEEP
        dict(name="eqx_only", ref="chrA", pos=500, mapq=60, cigar="45=5X", nm=5),
        # NM < I+D: mm = 0-(5+5) = -10 negative, identity =
        # (90-(-10))/(90+5+5) = 100/100 = 1.0 -> KEEP
        dict(name="neg_mm", ref="chrA", pos=500, mapq=60, cigar="90M5I5D", nm=0),
        # all-soft-clip: clip = 100/100 = 1 > 0.1 -> DROP.  The reference's
        # `and` SHORT-CIRCUITS here, dodging the ZeroDivisionError its
        # identity denominator (M+eq+X+I+D == 0) would raise; the vectorized
        # 0/0 -> nan >= 0.9 comparison is False either way.
        dict(name="all_soft", ref="chrA", pos=500, mapq=60, cigar="100S", nm=0),
        # zero query length entirely (deletion-only): both denominators 0;
        # 0/0 clip -> nan <= 0.1 is False -> DROP (the reference would
        # raise ZeroDivisionError on clip first; dropping is the only
        # non-crashing behavior, documented divergence)
        dict(name="del_only", ref="chrA", pos=500, mapq=60, cigar="10D",
             nm=10, seq_len=0),
    ]
    bam = _bam(tmp_path, "pathological.bam", reads)
    mask = bam_filter_mask(bam.columns, 30, 0.1, 0.9)
    by_name = dict(zip(bam.names, mask.tolist()))
    assert by_name == {
        b"hardclip": True,
        b"eqx_only": True,
        b"neg_mm": True,
        b"all_soft": False,
        b"del_only": False,
    }
    # the oracle (like the reference) CRASHES on the deletion-only record
    # (clip denominator M+eq+X+I+S == 0) — the divergence is deliberate
    with pytest.raises(ZeroDivisionError):
        oracle_bam_dict(bam, TARGETS, 30, 0.1, 0.9, 50)
    bam_ok = _bam(tmp_path, "pathological_no_crash.bam",
                  [r for r in reads if r["name"] != "del_only"])
    d, _ = oracle_bam_dict(bam_ok, TARGETS, 30, 0.1, 0.9, 50)
    assert set(d) == {b"hardclip", b"eqx_only", b"neg_mm"}
    # the hard-clipped record's coordinates: query length counts only
    # M/I/S/=/X (= 9 here), reference span M+D = 10
    assert d[b"hardclip"] == ("chrA", 500, 510, 9)


def test_mq_cutoff_exact_boundary(tmp_path):
    reads = [
        dict(name="hq_eq", ref="chrA", pos=100, mapq=50, cigar="100M", nm=0),
        dict(name="hq_lo", ref="chrA", pos=100, mapq=49, cigar="100M", nm=0),
    ]
    bam = _bam(tmp_path, "mq.bam", reads)
    mask = bam_filter_mask(bam.columns, 30, 0.1, 0.9)
    assert mask.tolist() == [True, True]
    hq = high_qual_keys(bam.name_keys, mask, bam.columns["mapq"], 50)
    # literal: exactly the mapq==50 read is high-qual (>= mq_cutoff)
    names = dict(zip([tuple(k) for k in bam.name_keys], bam.names))
    assert [names[(k["a"], k["b"])] for k in hq] == [b"hq_eq"]


# ---------------------------------------------------------------------------
# PAF mask thresholds at exact float64 ties
# ---------------------------------------------------------------------------

def test_paf_threshold_exact_ties(tmp_path):
    rows = [
        # identity = nmatch/alnlen = 9/10 = 0.9 == iden_percent -> KEEP
        ("q_iden_eq", 100, 0, 100, "+", "chrA", 3000, 0, 100, 9, 10, 60),
        # 8999/10000 = 0.8999 -> DROP
        ("q_iden_lo", 100, 0, 100, "+", "chrA", 3000, 0, 100, 8999, 10000, 60),
        # mapq == map_qual -> KEEP
        ("q_mapq_eq", 100, 0, 100, "+", "chrA", 3000, 0, 100, 10, 10, 30),
        # mapq == map_qual - 1 -> DROP
        ("q_mapq_lo", 100, 0, 100, "+", "chrA", 3000, 0, 100, 10, 10, 29),
    ]
    p = str(tmp_path / "ties.paf")
    make_paf(p, rows)
    paf = read_paf(p)
    mask = paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, 30, 0.9)
    by_name = dict(zip(paf.names, mask.tolist()))
    assert by_name == {
        b"q_iden_eq": True,
        b"q_iden_lo": False,
        b"q_mapq_eq": True,
        b"q_mapq_lo": False,
    }
    # mq_cutoff boundary on the PAF side: only the mapq-60 row
    hq = high_qual_keys(paf.name_keys, mask, paf.mapq, 50)
    assert hq.shape[0] == 1
    paf_lines, hq_names = oracle_paf_elections([paf], TARGETS, 30, 0.9, 50)
    assert set(paf_lines[0]) == {b"q_iden_eq", b"q_mapq_eq"}
    assert hq_names == {b"q_iden_eq"}


# ---------------------------------------------------------------------------
# cross-file curation at the exact ovlp tie
# ---------------------------------------------------------------------------

def _depth_expect(intervals, flank=15):
    """Literal depth dict from (target, start, end) curated intervals
    (GCI.py:303-306: depths[t][start+flank : end-flank+1] += 1)."""
    want = {t: np.zeros(l, dtype=np.int64) for t, l in TARGETS.items()}
    for t, s, e in intervals:
        want[t][s + flank : e - flank + 1] += 1
    return want


def test_ovlp_exact_tie(tmp_path):
    # query q: (100,200) vs (110,210): ovlp = min(200,210)-max(100,110) = 90,
    #   90/qlen2 = 90/100 = 0.9 == ovlp_percent -> KEEP (only `<` deletes),
    #   curated interval = (max starts, min ends) = (110, 200)
    # query p: (300,400) vs (311,411): ovlp = 89 -> 0.89 < 0.9 -> DELETE
    # query n: (600,700) vs (900,1000): ovlp = -200 < 0.9 -> DELETE
    bam1 = _bam(tmp_path, "o1.bam", [
        dict(name="q", ref="chrA", pos=100, mapq=30, cigar="100M", nm=0),
        dict(name="p", ref="chrA", pos=300, mapq=30, cigar="100M", nm=0),
        dict(name="n", ref="chrA", pos=600, mapq=30, cigar="100M", nm=0),
    ])
    bam2 = _bam(tmp_path, "o2.bam", [
        dict(name="q", ref="chrA", pos=110, mapq=30, cigar="100M", nm=0),
        dict(name="p", ref="chrA", pos=311, mapq=30, cigar="100M", nm=0),
        dict(name="n", ref="chrA", pos=900, mapq=30, cigar="100M", nm=0),
    ])
    got = _vector_filter([], [bam1, bam2], TARGETS)
    want = _depth_expect([("chrA", 110, 200)])
    _compare(got, want)
    _compare(oracle_filter([], [bam1, bam2], TARGETS), want)


def test_ovlp_different_target_deletes(tmp_path):
    bam1 = _bam(tmp_path, "d1.bam", [
        dict(name="q", ref="chrA", pos=100, mapq=30, cigar="100M", nm=0),
    ])
    bam2 = _bam(tmp_path, "d2.bam", [
        dict(name="q", ref="chrB", pos=100, mapq=30, cigar="100M", nm=0),
    ])
    got = _vector_filter([], [bam1, bam2], TARGETS)
    want = _depth_expect([])  # deleted: same name, different primary target
    _compare(got, want)
    _compare(oracle_filter([], [bam1, bam2], TARGETS), want)


def test_high_qual_readoption_chain(tmp_path):
    """Re-adoption (GCI.py:297-299) chained across three files, where the
    high-qual membership that re-adopts q at the file-2 fold step comes from
    q's mapq in file THREE (the set is computed before the fold)."""
    bam1 = _bam(tmp_path, "c1.bam", [
        dict(name="x", ref="chrA", pos=100, mapq=60, cigar="100M", nm=0),
    ])
    bam2 = _bam(tmp_path, "c2.bam", [
        dict(name="q", ref="chrA", pos=100, mapq=30, cigar="100M", nm=0),
        dict(name="x", ref="chrA", pos=100, mapq=60, cigar="100M", nm=0),
    ])
    bam3 = _bam(tmp_path, "c3.bam", [
        dict(name="q", ref="chrA", pos=110, mapq=60, cigar="100M", nm=0),
        dict(name="x", ref="chrA", pos=100, mapq=60, cigar="100M", nm=0),
    ])
    # by hand: comm = {x}; hq = {x, q} (q via file3's mapq=60).
    # fold file2: q not in file1 but in hq -> re-adopted as (chrA,100,200);
    #            x: ovlp 100/100 = 1.0 -> intersect, stays (100,200).
    # fold file3: q: ovlp = min(200,210)-max(100,110) = 90 -> 0.9 -> keep,
    #            intersect -> (110,200); x stays (100,200).
    got = _vector_filter([], [bam1, bam2, bam3], TARGETS)
    want = _depth_expect([("chrA", 100, 200), ("chrA", 110, 200)])
    _compare(got, want)
    _compare(oracle_filter([], [bam1, bam2, bam3], TARGETS), want)


def test_readoption_absent_without_high_qual(tmp_path):
    """Same shape as the chain test but q never reaches mq_cutoff: it is
    re-adopted nowhere (not in comm either) -> only x contributes."""
    bam1 = _bam(tmp_path, "a1.bam", [
        dict(name="x", ref="chrA", pos=100, mapq=60, cigar="100M", nm=0),
    ])
    bam2 = _bam(tmp_path, "a2.bam", [
        dict(name="q", ref="chrA", pos=100, mapq=30, cigar="100M", nm=0),
        dict(name="x", ref="chrA", pos=100, mapq=60, cigar="100M", nm=0),
    ])
    got = _vector_filter([], [bam1, bam2], TARGETS)
    want = _depth_expect([("chrA", 100, 200)])
    _compare(got, want)
    _compare(oracle_filter([], [bam1, bam2], TARGETS), want)


# ---------------------------------------------------------------------------
# election tie-break + multi-PAF accumulation quirk
# ---------------------------------------------------------------------------

def test_election_score_tie_larger_name_wins(tmp_path):
    # identical alignments to tgA and tgB: equal scores; the reference's
    # sorted(key=(score, name), reverse=True)[0] picks the lexicographically
    # LARGER target name -> tgB
    rows = [
        ("q", 100, 0, 100, "+", "tgA", 3000, 40, 140, 95, 100, 60),
        ("q", 100, 0, 100, "+", "tgB", 3000, 40, 140, 95, 100, 60),
    ]
    p = str(tmp_path / "tie.paf")
    make_paf(p, rows)
    paf = read_paf(p)
    mask = np.ones(paf.n_records, dtype=bool)
    (elected,) = elect_primary_targets([(paf, mask)])
    assert elected.name_keys.shape[0] == 1
    assert elected.target_names[elected.tid[0]] == "tgB"
    assert (int(elected.start[0]), int(elected.end[0])) == (40, 140)
    assert int(elected.qlen[0]) == 100


def test_multi_paf_synteny_accumulation(tmp_path):
    """GCI.py:215/241: `synteny` persists across PAF files, so file i's
    election sees alignments from files 0..i.  q maps to tgA in file 1 and
    (better) to tgB in file 2: file 1 elects tgA, file 2 elects tgB."""
    p1, p2 = str(tmp_path / "s1.paf"), str(tmp_path / "s2.paf")
    make_paf(p1, [("q", 100, 0, 100, "+", "tgA", 3000, 0, 100, 95, 100, 60)])
    make_paf(p2, [("q", 100, 0, 100, "+", "tgB", 3000, 0, 100, 99, 100, 60)])
    pafs = [read_paf(p1), read_paf(p2)]
    masked = [(pf, np.ones(pf.n_records, dtype=bool)) for pf in pafs]
    e1, e2 = elect_primary_targets(masked)
    assert e1.target_names[e1.tid[0]] == "tgA"  # file 1: only tgA seen yet
    assert e2.target_names[e2.tid[0]] == "tgB"  # file 2: 0.99 > 0.95
    # the oracle agrees
    paf_lines, _ = oracle_paf_elections(pafs, {"tgA": 3000, "tgB": 3000}, 30, 0.9, 50)
    assert paf_lines[0][b"q"][0] == "tgA"
    assert paf_lines[1][b"q"][0] == "tgB"


def test_legacy_filter_bam_mask_exact_ties(tmp_path):
    """gci-filter-bam's legacy formulas (reference filter_bam.py:152-159:
    clip = S/(M+I+S), identity = (M-mm)/(M+I+D), NO =/X terms) at exact
    float64 ties, with literal expectations."""
    from gci_tpu.tools.filter_bam import legacy_bam_filter_mask

    reads = [
        # clip = 1/10 = 0.1 == clip_percent -> KEEP; identity = 9/9 = 1
        dict(name="clip_eq", ref="chrA", pos=10, mapq=60, cigar="1S9M", nm=0),
        # clip = 11/100 = 0.11 -> DROP
        dict(name="clip_hi", ref="chrA", pos=10, mapq=60, cigar="11S89M", nm=0),
        # identity = (9-0)/10 = 0.9 == iden_percent -> KEEP (9M1D NM=1)
        dict(name="iden_eq", ref="chrA", pos=10, mapq=60, cigar="9M1D", nm=1),
        # identity = 89/100 = 0.89 -> DROP
        dict(name="iden_lo", ref="chrA", pos=10, mapq=60, cigar="89M11D", nm=11),
        # the LEGACY divergence: =/X are invisible, so a 45=5X read has
        # M = 0 -> clip 0/0 nan <= 0.1 is False -> DROP (the main-pipeline
        # mask KEEPS it; the reference's legacy tool would ZeroDivisionError)
        dict(name="eqx_only", ref="chrA", pos=10, mapq=60, cigar="45=5X", nm=5),
        dict(name="mapq_lo", ref="chrA", pos=10, mapq=29, cigar="100M", nm=0),
    ]
    bam = _bam(tmp_path, "legacy.bam", reads)
    mask = legacy_bam_filter_mask(bam.columns, 30, 0.1, 0.9)
    assert dict(zip(bam.names, mask.tolist())) == {
        b"clip_eq": True,
        b"clip_hi": False,
        b"iden_eq": True,
        b"iden_lo": False,
        b"eqx_only": False,
        b"mapq_lo": False,
    }
