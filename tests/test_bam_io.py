import numpy as np
import pytest

from gci_tpu.io.bam import read_bam, read_bam_header, _read_bam_python
from tests.fixtures import make_bam, random_reads


REFS = ["chr1", "chr2"]
LENS = [5000, 3000]


def _sample_reads():
    return [
        dict(name="a", ref="chr1", pos=10, mapq=60, cigar="100M", nm=2),
        dict(name="b", ref="chr1", pos=200, mapq=30, cigar="5S90M5I3D", nm=10),
        dict(name="c", ref="chr2", pos=0, mapq=50, cigar="50=10X40M", nm=10),
        dict(name="d", ref="chr2", pos=2900, mapq=60, cigar="99M", nm=0),
        dict(name="sec", ref="chr1", pos=400, mapq=60, cigar="80M", flag=256),
        dict(name="sup", ref="chr1", pos=500, mapq=60, cigar="30M70H", flag=2048),
        dict(name="unm", ref="chr1", pos=600, mapq=0, cigar="100M", flag=4),
    ]


@pytest.fixture()
def bam_path(tmp_path):
    p = str(tmp_path / "t.bam")
    make_bam(p, REFS, LENS, _sample_reads())
    return p


def test_header(bam_path):
    refs, lens = read_bam_header(bam_path)
    assert refs == REFS and lens == LENS


def test_native_parse_columns(bam_path):
    bam = read_bam(bam_path)
    assert bam.references == REFS and bam.lengths == LENS
    assert bam.n_records == 7
    by_name = {bam.names[k]: k for k in range(bam.n_records)}
    a = by_name[b"a"]
    assert bam.columns["pos"][a] == 10
    assert bam.columns["ref_end"][a] == 110
    assert bam.columns["m"][a] == 100
    assert bam.columns["nm"][a] == 2
    assert bam.columns["qlen"][a] == 100
    b = by_name[b"b"]
    assert bam.columns["s"][b] == 5
    assert bam.columns["i"][b] == 5
    assert bam.columns["d"][b] == 3
    assert bam.columns["ref_end"][b] == 200 + 90 + 3
    assert bam.columns["qlen"][b] == 100
    c = by_name[b"c"]
    assert bam.columns["eq"][c] == 50 and bam.columns["x"][c] == 10
    sup = by_name[b"sup"]
    assert bam.columns["qlen"][sup] == 30  # hard clip consumes no query
    assert bam.columns["flag"][sup] == 2048


def test_python_fallback_matches_native(bam_path):
    native = read_bam(bam_path)
    py = _read_bam_python(bam_path, keep_names=True, keep_raw=False)
    assert native.references == py.references
    assert native.names == py.names
    for k in native.columns:
        np.testing.assert_array_equal(native.columns[k], py.columns[k], err_msg=k)
    np.testing.assert_array_equal(native.name_keys, py.name_keys)


def test_keep_raw_roundtrip(bam_path, tmp_path):
    bam = read_bam(bam_path, keep_raw=True)
    assert bam.body is not None and bam.record_offsets is not None
    # re-emit records verbatim into a new bam; parse must agree
    import struct

    from gci_tpu.io.bam_writer import write_bam

    blobs = []
    for off in bam.record_offsets:
        (size,) = struct.unpack_from("<I", bam.body, off)
        blobs.append(bam.body[off : off + 4 + size])
    p2 = str(tmp_path / "copy.bam")
    write_bam(p2, bam.references, bam.lengths, blobs)
    bam2 = read_bam(p2)
    assert bam2.names == bam.names
    for k in bam.columns:
        np.testing.assert_array_equal(bam.columns[k], bam2.columns[k])


def test_gzip_module_can_read_our_bgzf(bam_path):
    import gzip

    with gzip.open(bam_path, "rb") as f:
        assert f.read(4) == b"BAM\x01"


def test_native_paf_matches_python(tmp_path):
    from gci_tpu.io.paf import _read_paf_python, read_paf
    from tests.fixtures import make_paf

    rows = [
        ("q1", 1000, 0, 900, "+", "tA", 5000, 100, 1000, 850, 900, 60),
        ("q2", 800, 10, 700, "-", "tB", 3000, 0, 690, 600, 690, 30),
        ("weird read name", 10, 0, 5, "+", "tA", 5000, 0, 5, 5, 5, 0),
    ]
    p = str(tmp_path / "t.paf")
    make_paf(p, rows)
    a = read_paf(p)
    b = _read_paf_python(p)
    assert a.names == b.names and a.targets == b.targets
    for f in ("qlen", "qstart", "qend", "tstart", "tend", "nmatch", "alnlen", "mapq"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.name_keys, b.name_keys)


# ---------------------------------------------------------------------------
# streaming reader
# ---------------------------------------------------------------------------


def _concat_chunks(chunks):
    import numpy as np

    cols = {
        k: np.concatenate([c.columns[k] for c in chunks])
        if chunks
        else np.empty(0, dtype=np.int32)
        for k in (
            "ref_id", "pos", "ref_end", "qlen", "mapq", "flag",
            "m", "i", "d", "s", "eq", "x", "nm",
        )
    }
    keys = (
        np.concatenate([c.name_keys for c in chunks])
        if chunks
        else np.empty((0, 2), dtype=np.uint64)
    )
    names = [n for c in chunks for n in (c.names or [])]
    return cols, keys, names


@pytest.fixture(scope="module")
def big_bam(tmp_path_factory):
    from tests.fixtures import random_reads

    p = str(tmp_path_factory.mktemp("stream") / "big.bam")
    rng = np.random.default_rng(11)
    refs = ["c1", "c2", "c3"]
    lens = [40000, 25000, 15000]
    reads = random_reads(rng, refs, lens, 3000, name_prefix="s")
    # duplicate some names so last-wins dedup crosses chunk borders
    for k in range(0, 3000, 97):
        reads[k]["name"] = f"dup{k % 13}"
    make_bam(p, refs, lens, reads)
    return p


def test_stream_matches_whole_file(big_bam):
    from gci_tpu.io.bam import BamStream

    whole = read_bam(big_bam, keep_names=True)
    with BamStream(big_bam, threads=2, keep_names=True, chunk_bytes=1 << 14) as st:
        assert st.references == whole.references
        assert st.lengths == whole.lengths
        assert st.header_text == whole.header_text
        chunks = list(st)
    assert len(chunks) > 3  # really streamed
    cols, keys, names = _concat_chunks(chunks)
    for k in whole.columns:
        np.testing.assert_array_equal(cols[k], whole.columns[k], err_msg=k)
    np.testing.assert_array_equal(keys, whole.name_keys)
    assert names == whole.names


@pytest.mark.parametrize("n_shards,seed", [(2, 0), (3, 1), (5, 2)])
def test_stream_comp_range_shards_partition(big_bam, n_shards, seed):
    """Byte-range shards partition the record stream exactly (the per-host
    input shard invariant): arbitrary split offsets, incl. mid-block and
    mid-record, never lose or duplicate a record."""
    import os

    from gci_tpu.io.bam import BamStream

    whole = read_bam(big_bam, keep_names=True)
    fsize = os.path.getsize(big_bam)
    rng = np.random.default_rng(seed)
    cuts = sorted(int(rng.integers(1, fsize)) for _ in range(n_shards - 1))
    bounds = [0] + cuts + [fsize]
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        with BamStream(
            big_bam, threads=2, keep_names=True, comp_range=(lo, hi),
            chunk_bytes=1 << 15,
        ) as st:
            parts.extend(list(st))
    cols, keys, names = _concat_chunks(parts)
    for k in whole.columns:
        np.testing.assert_array_equal(cols[k], whole.columns[k], err_msg=k)
    assert names == whole.names


def test_stream_truncated_file_errors(big_bam, tmp_path):
    from gci_tpu.io.bam import BamStream

    data = open(big_bam, "rb").read()
    # cut inside the record stream: drop the BGZF EOF marker + some payload
    p = str(tmp_path / "cut.bam")
    with open(p, "wb") as f:
        f.write(data[: len(data) - 100])
    with pytest.raises(ValueError):
        with BamStream(p, threads=2, chunk_bytes=1 << 15) as st:
            list(st)


def test_run_filter_chunked_matches_whole(big_bam, tmp_path, monkeypatch):
    """The chunked filter path (tiny chunks -> cross-border dedup) produces
    the same depths as one-shot whole-file filtering (GCI.py:166 dict
    semantics)."""
    from gci_tpu.pipeline import run_filter

    out1 = tmp_path / "whole"
    out2 = tmp_path / "chunked"
    out1.mkdir()
    out2.mkdir()
    depths1, tl1 = run_filter(
        [], [big_bam], "t", directory=str(out1), force=True,
        depth_backend="numpy", log_reads_type="HiFi",
    )
    monkeypatch.setenv("GCI_BAM_CHUNK_BYTES", str(1 << 14))
    depths2, tl2 = run_filter(
        [], [big_bam], "t", directory=str(out2), force=True,
        depth_backend="numpy", log_reads_type="HiFi",
    )
    assert tl1 == tl2
    assert set(depths1) == set(depths2)
    for t in depths1:
        np.testing.assert_array_equal(depths1[t], depths2[t])
    assert (out1 / "t.depth.gz").read_bytes() == (out2 / "t.depth.gz").read_bytes()


def test_stream_keep_raw_blob_parity(big_bam):
    """keep_raw chunks carry raw record bytes identical to the whole-file
    reader's body slices (the streaming filtered-BAM export contract)."""
    import struct

    from gci_tpu.io.bam import BamStream

    whole = read_bam(big_bam, keep_names=False, keep_raw=True)
    blobs_whole = []
    for o in whole.record_offsets:
        (size,) = struct.unpack_from("<I", whole.body, int(o))
        blobs_whole.append(whole.body[int(o): int(o) + 4 + size])
    blobs_stream = []
    with BamStream(big_bam, threads=2, keep_raw=True, chunk_bytes=1 << 15) as st:
        for c in st:
            assert c.body is not None and c.record_offsets is not None
            for o in c.record_offsets:
                (size,) = struct.unpack_from("<I", c.body, int(o))
                blobs_stream.append(c.body[int(o): int(o) + 4 + size])
    assert blobs_stream == blobs_whole


def test_stream_empty_bam(tmp_path):
    from gci_tpu.io.bam import BamStream

    p = str(tmp_path / "empty.bam")
    make_bam(p, REFS, LENS, [])
    with BamStream(p, threads=2) as st:
        assert st.references == REFS
        chunks = list(st)
    assert sum(c.n_records for c in chunks) == 0
    bam = read_bam(p)
    assert bam.n_records == 0


def test_stream_range_inside_header(big_bam):
    """A shard whose byte range covers only header blocks yields 0 records
    (and does not steal records from the neighbouring shard)."""
    import os

    from gci_tpu.io.bam import BamStream

    fsize = os.path.getsize(big_bam)
    with BamStream(big_bam, threads=2, comp_range=(0, 100)) as st:
        n0 = sum(c.n_records for c in st)
    with BamStream(big_bam, threads=2, comp_range=(100, fsize)) as st:
        n1 = sum(c.n_records for c in st)
    whole = read_bam(big_bam)
    assert n0 + n1 == whole.n_records


def test_stream_corrupt_bgzf_errors(big_bam, tmp_path):
    from gci_tpu.io.bam import BamStream

    data = bytearray(open(big_bam, "rb").read())
    # wreck a BGZF header magic in the middle of the record stream
    data[len(data) // 2] ^= 0xFF
    p = str(tmp_path / "corrupt.bam")
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        with BamStream(p, threads=2, chunk_bytes=1 << 15) as st:
            list(st)


def test_uncompressed_bam_streams_via_whole_file_fallback(tmp_path, rng):
    """Plain (non-BGZF) BAM: BamStream detects the distinct native error
    and falls back to the whole-file reader."""
    import gzip as _gzip

    from gci_tpu.io.bam import BamStream

    p = str(tmp_path / "c.bam")
    make_bam(p, REFS, LENS, random_reads(rng, REFS, LENS, 120))
    plain = str(tmp_path / "c_plain.bam")
    with open(plain, "wb") as f:
        f.write(_gzip.open(p, "rb").read())
    want = read_bam(p)
    with BamStream(plain, keep_names=False) as st:
        assert st.references == want.references
        chunks = list(st)
    keys = np.concatenate([c.name_keys for c in chunks])
    np.testing.assert_array_equal(keys, want.name_keys)
    # range-sharding a plain BAM must fail loudly, not misparse
    with pytest.raises(ValueError):
        BamStream(plain, comp_range=(0, 100))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_header_dominated_range_partitions(tmp_path, seed):
    """Partition invariant when the BAM is mostly HEADER: random cuts land
    inside the header block chain, so the first shard's record walk starts
    from header-spillover carry whose block may belong to a LATER shard —
    the exact shape of an earlier ownership-leak bug (records double-packed
    when stop_block_coff was only set at EOF)."""
    import os

    from gci_tpu.io.bam import BamStream, read_bam
    from tests.fixtures import make_bam

    rng = np.random.default_rng(0xBAD0 + seed)
    refs = [f"tig{i:04d}" for i in range(800)]
    lens = [1000] * len(refs)
    reads = [
        dict(name=f"q{i}", ref=refs[-1 - (i % 5)], pos=int(rng.integers(0, 800)),
             mapq=60, cigar="100M", nm=0)
        for i in range(int(rng.integers(3, 30)))
    ]
    bam = str(tmp_path / "hdr.bam")
    make_bam(bam, refs, lens, reads)

    whole = read_bam(bam, keep_names=True)
    fsize = os.path.getsize(bam)
    n_shards = int(rng.integers(2, 7))
    cuts = sorted(int(rng.integers(1, fsize)) for _ in range(n_shards - 1))
    bounds = [0] + cuts + [fsize]
    names = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if lo >= hi:
            continue
        with BamStream(
            bam, threads=2, keep_names=True, comp_range=(lo, hi),
            chunk_bytes=1 << 14,
        ) as st:
            for ch in st:
                names.extend(ch.names or [])
    assert names == whole.names, (seed, n_shards, cuts)
