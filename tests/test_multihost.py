"""Multi-process (multi-host) sharded run: N=2 jax.distributed processes.

Spawns two real OS processes, each owning 4 virtual CPU devices, joined via a
jax.distributed coordinator — the CPU stand-in for a 2-host cluster
(SURVEY.md §4: "multi-chip tests via JAX's multi-process simulation").  Both
processes execute the full ``gci`` CLI with the sharded backend over a (2, 4)
mesh: each host packs only its dp-chunk of read events
(gci_tpu.parallel.distributed.owned_dp_rows), the depth-delta psum crosses the
process boundary, and only process 0 writes output files — which must be
byte-identical to a single-process events-backend run.
"""
import gzip
import os
import socket
import subprocess
import sys

import numpy as np

from gci_tpu.pipeline import run_gci
from tests.fixtures import make_bam, make_fasta, random_reads

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = ["chrA", "chrB"]
LENS = [24000, 16000]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _diff(d1, d2, names):
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".gz"):
            with gzip.open(p1, "rb") as a, gzip.open(p2, "rb") as b:
                assert a.read() == b.read(), name
        else:
            with open(p1, "rb") as a, open(p2, "rb") as b:
                assert a.read() == b.read(), name


def test_two_process_sharded_cli_matches_single_process(tmp_path):
    rng = np.random.default_rng(0xD157)
    ref = str(tmp_path / "ref.fa")
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if r == "chrA":
            seq = seq[:5000] + "N" * 300 + seq[5300:]
        recs.append((r, seq))
    make_fasta(ref, recs)
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 800, name_prefix="h"))
    regions = str(tmp_path / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t1000\t20000\n")

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
            regions=regions, depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M",
            "-R", regions, "--profile",
            "--device", "sharded", "--mesh", "2,4",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]

    _diff(d_ref, d_mh, [
        "M.depth.gz", "M.0.depth.bed", "M.gci", "M.regions.gci", "M.gaps.bed",
    ])

    # per-host input sharding: each process packs only its byte-range shard
    # of the BAM, and the shards partition the record stream exactly
    import json

    packed = []
    for out in outs:
        items = [
            json.loads(line)["items"]
            for line in out.splitlines()
            if line.startswith("{") and "bam_pack" in line
        ]
        assert len(items) == 1, out[-2000:]
        packed.append(items[0])
    assert sum(packed) == 800, packed
    assert all(0 < n < 800 for n in packed), packed


def test_two_process_overwrite_block_exits_everywhere(tmp_path):
    """Existing output without --force: the primary's decision broadcasts and
    BOTH processes exit (a primary-only sys.exit would leave the other
    process hung in the next collective)."""
    rng = np.random.default_rng(0xD158)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(REFS, LENS)])
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 120, name_prefix="h"))
    d_mh = str(tmp_path / "multi")
    os.makedirs(d_mh)
    with open(os.path.join(d_mh, "M.depth.gz"), "wb") as f:
        f.write(b"preexisting")

    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M",
            "--device", "sharded", "--mesh", "2,4",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    for p in procs:
        out, _ = p.communicate(timeout=300)  # a deadlock would hit this
        assert p.returncode != 0
        assert b"exists" in out and b"--force" in out, out[-2000:]


import pytest


@pytest.mark.parametrize("gz_paf", [False, True])
def test_two_process_dual_type_with_paf_matches_single_process(tmp_path, gz_paf):
    """Dual-type (HiFi BAM+PAF curation, ONT BAM) under 2 processes with
    per-host input sharding: all checkpoint/report files byte-identical to
    a single-process events run.  With gz_paf the
    shared PAF is GZIPPED: each host inflates whole but tokenizes only its
    line shard."""
    rng = np.random.default_rng(0xD159)
    ref = str(tmp_path / "ref.fa")
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if r == "chrB":
            seq = seq[:2000] + "N" * 150 + seq[2150:]
        recs.append((r, seq))
    make_fasta(ref, recs)
    lens_map = dict(zip(REFS, LENS))

    hifi_reads = random_reads(rng, REFS, LENS, 600, name_prefix="h")
    nano_reads = random_reads(rng, REFS, LENS, 500, name_prefix="n")
    hifi_bam = str(tmp_path / "hifi.bam")
    nano_bam = str(tmp_path / "nano.bam")
    make_bam(hifi_bam, REFS, LENS, hifi_reads)
    make_bam(nano_bam, REFS, LENS, nano_reads)

    # PAF for the HiFi reads: mixed identity/mapq so election + curation
    # (ovlp intersect / high-qual adoption) all fire
    from tests.fixtures import make_paf

    rows = []
    for rd in hifi_reads[:400]:
        L = lens_map[rd["ref"]]
        ts = min(rd.get("pos", 0), L - 1)
        te = min(ts + 900, L)
        nmatch = int(rng.integers(780, 900))
        mapq = int(rng.choice([20, 40, 60]))
        rows.append(
            (rd["name"], 1000, 0, 900, "+", rd["ref"], L, ts, te, nmatch, 900, mapq)
        )
    paf = str(tmp_path / "hifi.paf")
    make_paf(paf, rows)
    if gz_paf:
        import gzip as _gzip

        pgz = str(tmp_path / "hifi.paf.gz")
        with open(paf, "rb") as f_in, _gzip.open(pgz, "wb") as f_out:
            f_out.write(f_in.read())
        paf = pgz

    regions = str(tmp_path / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t500\t20000\nchrB\t100\t9000\n")

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[hifi_bam, paf], nano=[nano_bam], reference=ref,
            directory=d_ref, prefix="M", regions=regions,
            depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", hifi_bam, paf, "--nano", nano_bam,
            "-d", d_mh, "-o", "M", "-R", regions,
            "--device", "sharded", "--mesh", "2,4",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
            "--profile",
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]

    _diff(d_ref, d_mh, [
        "M_hifi.depth.gz", "M_nano.depth.gz", "M_two_type.depth.gz",
        "M_hifi.0.depth.bed", "M_nano.0.depth.bed", "M_two_type.0.depth.bed",
        "M.gci", "M.regions.gci", "M.gaps.bed",
    ])

    # per-host PAF input sharding: each process parses only its byte-range
    # shard of the shared PAF, and the shards partition the row stream
    import json

    parsed = []
    for out in outs:
        items = [
            json.loads(line)["items"]
            for line in out.splitlines()
            if line.startswith("{") and "paf_parse" in line
        ]
        assert len(items) == 1, out[-2000:]
        parsed.append(items[0])
    assert sum(parsed) == len(rows), parsed
    assert all(0 < n < len(rows) for n in parsed), parsed


def test_three_process_sharded_cli_matches_single_process(tmp_path):
    """3 hosts: the MIDDLE input shard resyncs records on both sides of its
    byte range, and the allgather reconciliation runs with 3 ranks."""
    rng = np.random.default_rng(0xD15A)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(REFS, LENS)])
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 900, name_prefix="h"))

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
            depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(3):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M", "--profile",
            "--device", "sharded", "--mesh", "3,4",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "3", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]

    _diff(d_ref, d_mh, ["M.depth.gz", "M.0.depth.bed", "M.gci"])

    import json

    packed = []
    for out in outs:
        items = [
            json.loads(line)["items"]
            for line in out.splitlines()
            if line.startswith("{") and "bam_pack" in line
        ]
        assert len(items) == 1, out[-2000:]
        packed.append(items[0])
    assert sum(packed) == 900, packed
    assert all(n > 0 for n in packed), packed


def test_two_process_distributed_depth_writer_byte_identical(tmp_path):
    """write_depth_gz on a 2-process run (every host compresses a disjoint
    BGZF block range, primary concatenates) produces the EXACT single-
    writer file — raw compressed bytes, not just content."""
    import json

    rng = np.random.default_rng(0xD15C)
    # mixed shapes: long runs (cache + range-boundary phases), dense runs,
    # an empty target, and a multi-digit-value target
    script = tmp_path / "write.py"
    datagen = (
        "import numpy as np\n"
        "rng = np.random.default_rng(0xD15C)\n"
        "depths = {\n"
        "    'long': np.repeat(rng.integers(0, 4, 40), "
        "rng.integers(1, 200_000, 40)).astype(np.int64),\n"
        "    'dense': rng.integers(0, 9, 300_000).astype(np.int64),\n"
        "    'void': np.zeros(0, np.int64),\n"
        "    'big': np.repeat(rng.integers(10_000, 99_999, 50), "
        "rng.integers(1, 5_000, 50)).astype(np.int64),\n"
        "}\n"
    )
    single = str(tmp_path / "single.depth.gz")
    subprocess.run(
        [sys.executable, "-c",
         datagen +
         "from gci_tpu.io.depth_file import write_depth_gz\n"
         f"write_depth_gz({single!r}, depths)\n"],
        check=True, cwd=REPO_ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT),
    )

    port = _free_port()
    multi = str(tmp_path / "multi.depth.gz")
    script.write_text(
        "import sys\n"
        "import jax\n"
        "jax.distributed.initialize(\n"
        f"    coordinator_address='127.0.0.1:{port}',\n"
        "    num_processes=2, process_id=int(sys.argv[1]))\n"
        + datagen +
        "from gci_tpu.io.depth_file import write_depth_gz\n"
        f"write_depth_gz({multi!r}, depths)\n"
    )
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO_ROOT,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)], env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]

    with open(single, "rb") as a, open(multi, "rb") as b:
        assert a.read() == b.read()


def test_four_process_uneven_shards(tmp_path):
    """4 hosts x 2 devices, mesh 4,2: odd record
    count (901), a BAM whose header-heavy first byte range packs ZERO
    records on one host, BGZF shard boundaries falling mid-record (the
    resync path on both sides of two middle shards) — byte parity against
    a single-process events run."""
    rng = np.random.default_rng(0xD15E)
    # many references -> a large BAM header: the first compressed byte
    # range is mostly header, so host 0 packs few or zero records
    refs = [f"ctg{i:03d}" for i in range(120)]
    lens = [4000] * len(refs)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(refs, lens)])
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, refs, lens, random_reads(rng, refs, lens, 901, name_prefix="h"))

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
            depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(4):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M", "--profile",
            "--device", "sharded", "--mesh", "4,2",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "4", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]

    _diff(d_ref, d_mh, ["M.depth.gz", "M.0.depth.bed", "M.gci"])

    import json

    packed = []
    for out in outs:
        items = [
            json.loads(line)["items"]
            for line in out.splitlines()
            if line.startswith("{") and "bam_pack" in line
        ]
        assert len(items) == 1, out[-2000:]
        packed.append(items[0])
    # shards partition the 901 records exactly (odd count: every equal
    # byte-range boundary falls mid-record, so each shard resyncs)
    assert sum(packed) == 901, packed
    assert all(n > 0 for n in packed), packed


def test_four_process_zero_record_shard(tmp_path):
    """A header-dominated BAM (1500 references, 12 records at the tail):
    the first byte ranges contain no record starts, so those hosts pack
    ZERO records and own only padding dp rows — the empty-shard edge of
    owned_dp_rows/allgather_concat.  Byte parity still holds."""
    rng = np.random.default_rng(0xD160)
    refs = [f"scaffold_{i:05d}" for i in range(1500)]
    lens = [2000] * len(refs)
    ref = str(tmp_path / "ref.fa")
    # FASTA only for the references the reads touch is not allowed: the
    # pipeline scans the whole reference; keep it small per target
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=200)))
                     for r in refs])
    lens = [200] * len(refs)
    bam = str(tmp_path / "hifi.bam")
    reads = [
        dict(name=f"h{i}", ref=refs[-1 - (i % 3)], pos=10, mapq=60,
             cigar="150M", nm=0)
        for i in range(12)
    ]
    make_bam(bam, refs, lens, reads)

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
            depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(4):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M", "--profile",
            "--device", "sharded", "--mesh", "4,2",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "4", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]

    _diff(d_ref, d_mh, ["M.depth.gz", "M.0.depth.bed", "M.gci"])

    import json

    packed = []
    for out in outs:
        items = [
            json.loads(line)["items"]
            for line in out.splitlines()
            if line.startswith("{") and "bam_pack" in line
        ]
        assert len(items) == 1, out[-2000:]
        packed.append(items[0])
    assert sum(packed) == 12, packed
    assert 0 in packed, packed  # at least one header-only shard


def test_four_process_replicated_dp_rows(tmp_path):
    """4 hosts x 2 devices, mesh 2,4: TWO processes share each dp row, so
    the dp-sharded read arrays are cross-host REPLICATED shards (both
    owners must scatter identical rows) — a regime the 2-/3-process tests
    never hit.  Byte parity against a single-process events run."""
    rng = np.random.default_rng(0xD15F)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(REFS, LENS)])
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 501, name_prefix="h"))

    d_ref = str(tmp_path / "single")
    run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
            depth_backend="events")

    d_mh = str(tmp_path / "multi")
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO_ROOT,
    )
    boot = str(tmp_path / "boot.py")
    with open(boot, "w") as f:
        f.write(
            "import sys\n"
            "from gci_tpu.cli import main\n"
            "main(sys.argv[1:])\n"
        )
    procs = []
    for pid in range(4):
        cmd = [
            sys.executable, boot,
            "-r", ref, "--hifi", bam, "-d", d_mh, "-o", "M",
            "--device", "sharded", "--mesh", "2,4",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "4", "--process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        )
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-4000:]

    _diff(d_ref, d_mh, ["M.depth.gz", "M.0.depth.bed", "M.gci"])
