"""Benchmark: device pipeline throughput and file-to-file e2e.

Measurements (BASELINE.json metric: "CHM13 HiFi+ONT reads/s
filtered+depth-binned per chip"; the reference ships no speed harness):

1. device-only — a jitted filter -> clamp -> production packed-word
   construction (gci_tpu.depth.fused._packed_events_fn) on a synthetic
   1 Gbp / 4M-read workload, one device;
2. e2e file-to-file — a real `gci -r ref.fa --hifi x.bam` run (synthetic
   500 Mbp genome / 250k-read BAM with real seq/qual bytes, generated once
   and cached) through run_gci for both the events (host) and device
   backends, with the per-stage breakdown (pack / curation / depth / bed /
   checkpoint write);
3. whole-genome rehearsals at 3.1 Gbp (single and dual type), PAF
   election, BAM pack and plotting.

The baseline comparator stays the faithful reference-style implementation
(per-read numpy slice increments + per-base Python scans, GCI.py:302-390)
timed on a subsample and scaled linearly (its cost is linear in reads/bases).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

GENOME_BP = 1_000_000_000  # 1 Gbp synthetic assembly (8 targets)
N_READS = 4_000_000        # ~typical HiFi read count at this scale
N_TARGETS = 8
FLANK = 15
READ_LEN_MEAN = 18_000

BASELINE_SAMPLE_READS = 40_000
BASELINE_SAMPLE_BP = 40_000_000

# e2e workload (cached on disk; override via env for quick runs).  Records
# carry real seq/qual bytes (~9x coverage of 18 kb reads), so the pack stage
# pays the genuine BGZF-inflate cost a real HiFi BAM has.
E2E_BP = int(os.environ.get("GCI_BENCH_E2E_BP", 500_000_000))
E2E_READS = int(os.environ.get("GCI_BENCH_E2E_READS", 250_000))
E2E_DIR = os.environ.get(
    "GCI_BENCH_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "bench"),
)


def synth_columns(rng, n_reads, target_len, n_targets):
    """Synthetic packed BAM columns with realistic filter pass rates."""
    tid = rng.integers(0, n_targets, size=n_reads, dtype=np.int32)
    start = rng.integers(0, target_len - READ_LEN_MEAN - 1, size=n_reads, dtype=np.int32)
    span = rng.integers(READ_LEN_MEAN // 2, READ_LEN_MEAN * 2, size=n_reads).astype(np.int32)
    end = np.minimum(start + span, target_len)
    m = span
    i = rng.integers(0, 50, size=n_reads, dtype=np.int32)
    d = rng.integers(0, 50, size=n_reads, dtype=np.int32)
    s = (span * rng.beta(1, 30, size=n_reads)).astype(np.int32)
    nm = i + d + (span * rng.beta(1, 60, size=n_reads)).astype(np.int32)
    mapq = rng.choice(np.array([0, 10, 30, 50, 60], dtype=np.int32), size=n_reads)
    flag = rng.choice(np.array([0, 0, 0, 0, 16, 256, 2048], dtype=np.int32), size=n_reads)
    qlen = span + s
    return dict(
        tid=tid, start=start, end=end, m=m, i=i, d=d, s=s,
        eq=np.zeros(n_reads, np.int32), x=np.zeros(n_reads, np.int32),
        nm=nm, mapq=mapq, flag=flag, qlen=qlen,
    )


# ---------------------------------------------------------------------------
# 1. device-only throughput (the production construction program)
# ---------------------------------------------------------------------------

def device_pipeline(total_padded, offsets_dev, lengths_dev):
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.fused import _packed_events_fn
    from gci_tpu.filters.device import bam_filter_mask_device

    construct = _packed_events_fn(total_padded)

    def step(c, val_s, val_e, leftmost, rightmost):
        keep = bam_filter_mask_device(
            c["flag"], c["mapq"], c["m"], c["i"], c["d"], c["s"],
            c["eq"], c["x"], c["nm"],
        )
        L = lengths_dev[c["tid"]]
        s = c["start"].astype(jnp.int32) + FLANK
        e = c["end"].astype(jnp.int32) - FLANK + 1
        e = jnp.where(e < 0, e + L, e)
        e = jnp.clip(e, 0, L)
        s = jnp.minimum(s, L)
        live = (keep & (e > s)).astype(jnp.int32)
        base = offsets_dev[c["tid"]]
        no_gaps = jnp.zeros(0, jnp.int32)
        depth, flags = construct(
            base + s, base + e, live << 2, no_gaps, no_gaps, val_s, val_e,
            leftmost, rightmost,
        )
        # tiny reductions force full materialization without a 4GB readback
        return (depth[-1], jnp.sum(flags & 1), jnp.sum((flags & 2) != 0),
                keep.sum())

    return jax.jit(step)


def run_device(cols, targets_length):
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth.accum import GenomeLayout
    from gci_tpu.depth.fused import DeviceDepth, _valid_intervals

    layout = GenomeLayout.from_targets(targets_length)
    total_padded = DeviceDepth.pad_total_for(layout.total_slots)
    val_s, val_e = (
        jnp.asarray(np.asarray(v, np.int32))
        for v in _valid_intervals(layout, FLANK)
    )
    step = device_pipeline(
        total_padded,
        jnp.asarray(layout.offsets[:-1].astype(np.int32)),
        jnp.asarray(layout.lengths.astype(np.int32)),
    )
    c_dev = {k: jnp.asarray(v) for k, v in cols.items()}
    lo, hi = jnp.int32(-1), jnp.int32(0)
    # warmup/compile
    out = step(c_dev, val_s, val_e, lo, hi)
    res = [int(np.asarray(x)) for x in out]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(c_dev, val_s, val_e, lo, hi)
        res = [int(np.asarray(x)) for x in out]
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), res


# ---------------------------------------------------------------------------
# 2. e2e file-to-file (real BAM/FASTA through run_gci)
# ---------------------------------------------------------------------------

def _write_random_fasta(path, names, length, rng, n_gaps=0):
    """Fast random FASTA writer (vectorized 60-col wrapping); ``n_gaps``
    N-blocks of 1-50 kbp per target, at random disjoint positions."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for name in names:
            f.write(b">" + name.encode() + b"\n")
            seq = alphabet[rng.integers(0, 4, size=length, dtype=np.uint8)]
            if n_gaps:
                stride = length // n_gaps
                for k in range(n_gaps):
                    g_len = int(rng.integers(1_000, 50_000))
                    g_at = k * stride + int(rng.integers(0, stride - g_len))
                    seq[g_at : g_at + g_len] = ord("N")
            n_full = length // 60
            body = np.empty((n_full, 61), np.uint8)
            body[:, :60] = seq[: n_full * 60].reshape(n_full, 60)
            body[:, 60] = 10
            f.write(body.tobytes())
            tail = seq[n_full * 60 :]
            if tail.shape[0]:
                f.write(tail.tobytes() + b"\n")


def ensure_e2e_inputs(bp=None, n_reads=None, n_targets=None, seed=0xE2E,
                      kind="hifi", name_prefix="r", directory=None,
                      n_gaps=0):
    """Generate (once) and cache a synthetic workload: ref.fa + <kind>.bam
    in ``directory`` (default ``E2E_DIR``)."""
    bp = E2E_BP if bp is None else bp
    n_reads = E2E_READS if n_reads is None else n_reads
    n_targets = N_TARGETS if n_targets is None else n_targets
    directory = E2E_DIR if directory is None else directory
    os.makedirs(directory, exist_ok=True)
    tag = f"{bp}_{n_reads}"
    ref = os.path.join(directory, f"ref_{tag}.fa")
    bam = os.path.join(directory, f"{kind}_{tag}.bam")
    if os.path.exists(ref) and os.path.exists(bam):
        return ref, bam
    rng = np.random.default_rng(seed)
    target_len = bp // n_targets
    names = [f"chr{i}" for i in range(n_targets)]
    if not os.path.exists(ref):
        _write_random_fasta(ref, names, target_len, rng, n_gaps)

    cols = synth_columns(rng, n_reads, target_len, n_targets)
    from gci_tpu.io.bam_writer import build_record, write_bam_stream

    order = np.lexsort((cols["start"], cols["tid"]))

    def records():
        # lazy: each record carries ~2.5x its read length in seq/qual bytes,
        # so a list of them would be tens of GB — stream straight into
        # batched BGZF members instead
        for k in order.tolist():
            m, i, d, s = (int(cols[x][k]) for x in ("m", "i", "d", "s"))
            cigar = (f"{s}S" if s else "") + f"{m}M" + (
                f"{i}I" if i else "") + (f"{d}D" if d else "")
            yield build_record(
                f"{name_prefix}{k}", int(cols["tid"][k]), int(cols["start"][k]),
                int(cols["mapq"][k]), cigar, flag=int(cols["flag"][k]),
                nm=int(cols["nm"][k]),
            )

    write_bam_stream(bam, names, [target_len] * n_targets, records(), level=1,
                     threads=os.cpu_count() or 1)
    return ref, bam


def ensure_dual_paf(bam_path, path, seed):
    """A PAF whose query names AND intervals derive from the actual BAM
    (read back via the packer): 1-3 alignments per covered read with mixed
    mapq/identity so election, high-qual adoption and the ovlp
    intersect/drop curation paths all fire with realistic overlap rates."""
    if os.path.exists(path):
        return path
    from gci_tpu.io.bam import read_bam

    bam = read_bam(bam_path, threads=os.cpu_count() or 1, keep_names=True)
    c = bam.columns
    tlen = {r: l for r, l in zip(bam.references, bam.lengths)}
    prng = np.random.default_rng(seed)
    n = bam.n_records
    covered = prng.random(n) < 0.7  # 70% of reads appear in the PAF
    with open(path, "w") as f:
        for k in np.flatnonzero(covered).tolist():
            rid = int(c["ref_id"][k])
            if rid < 0:
                continue
            tname = bam.references[rid]
            L = tlen[tname]
            qlen = int(c["qlen"][k])
            if qlen <= 4:
                continue
            name = bam.names[k].decode()
            for _ in range(int(prng.integers(1, 4))):
                qs = int(prng.integers(0, max(qlen // 4, 1)))
                qe = int(qlen - prng.integers(0, max(qlen // 4, 1)))
                ts = min(int(c["pos"][k]) + qs, L - 1)
                te = min(ts + max(qe - qs, 1), L)
                alnlen = max(qe - qs, 1)
                nmatch = int(alnlen * prng.uniform(0.85, 1.0))
                mapq = int(prng.choice([20, 40, 60]))
                f.write(
                    f"{name}\t{qlen}\t{qs}\t{qe}\t+\t{tname}"
                    f"\t{L}\t{ts}\t{te}\t{nmatch}\t{alnlen}\t{mapq}\n"
                )
    return path


# ---------------------------------------------------------------------------
# CHM13-scale streamed rehearsal
# ---------------------------------------------------------------------------

CHM13_BP = int(os.environ.get("GCI_BENCH_CHM13_BP", 3_100_000_000))
CHM13_READS = int(os.environ.get("GCI_BENCH_CHM13_READS", 160_000))
CHM13_TARGETS = 24


def run_chm13_child():
    """Whole-human-scale rehearsal: 3.1 Gbp through --device streamed plus a
    gci-score resume from the checkpoint, in a fresh process so peak RSS is
    the rehearsal's own (the O(runs) claim: no per-base array anywhere —
    a per-base int64 depth dict alone would be ~25 GB).

    Prints one line ``CHM13::{json}`` consumed by the parent bench.
    """
    import resource

    from gci_tpu.pipeline import run_gci
    from gci_tpu.utils.metrics import get_metrics

    ref, bam = ensure_e2e_inputs(
        CHM13_BP, CHM13_READS, CHM13_TARGETS, seed=0xC13
    )
    outdir = os.path.join(E2E_DIR, "out_chm13")

    def one_run():
        get_metrics().reset()
        t0 = time.perf_counter()
        run_gci(
            hifi=[bam], reference=ref, directory=outdir, prefix="C",
            force=True, threads=os.cpu_count() or 1, depth_backend="streamed",
        )
        return time.perf_counter() - t0

    # run twice: the first pass pays the compiles; the steady-state second
    # pass is the measured one, the cold wall is reported alongside
    cold_wall = one_run()
    wall = one_run()
    stages = {r.name: round(r.seconds, 3) for r in get_metrics().records}
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    # whole-genome hardware parity: the streamed (device) outputs must be
    # byte-identical to an independent host events-backend run
    ev_dir = os.path.join(E2E_DIR, "out_chm13_events")
    run_gci(
        hifi=[bam], reference=ref, directory=ev_dir, prefix="C", force=True,
        threads=os.cpu_count() or 1, depth_backend="events",
    )
    streamed_parity = all(
        open(os.path.join(outdir, f), "rb").read()
        == open(os.path.join(ev_dir, f), "rb").read()
        for f in ("C.depth.gz", "C.0.depth.bed", "C.gci")
    )

    # resume from the checkpoint: O(runs) run-space decode, byte-equal .gci
    t0 = time.perf_counter()
    from gci_tpu.tools.score_only import main as score_main

    resume_dir = os.path.join(E2E_DIR, "out_chm13_resume")
    os.makedirs(resume_dir, exist_ok=True)
    score_main([
        "-r", ref, "--hifi", os.path.join(outdir, "C.depth.gz"),
        "-d", resume_dir, "-o", "C", "-f",
    ])
    resume_wall = time.perf_counter() - t0
    with open(os.path.join(outdir, "C.gci"), "rb") as a:
        run_gci_bytes = a.read()
    with open(os.path.join(resume_dir, "C.gci"), "rb") as b:
        resume_match = run_gci_bytes == b.read()
    rss_after_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    pack_s = sum(v for k, v in stages.items() if "bam_pack" in k)
    depth_s = sum(v for k, v in stages.items() if "depth_accumulate" in k)
    write_s = sum(v for k, v in stages.items() if "write_depth_gz" in k)
    other_s = max(wall - pack_s - depth_s - write_s, 0.0)
    result = {
        "bp": CHM13_BP,
        "reads": CHM13_READS,
        "wall_s": round(wall, 1),
        "cold_wall_s": round(cold_wall, 1),
        "stages": {
            "bam_pack": round(pack_s, 1),
            "depth_streamed": round(depth_s, 1),
            "write_depth_gz": round(write_s, 1),
            "other": round(other_s, 1),
        },
        "peak_rss_gb": round(rss_gb, 2),
        "rss_o_runs_ok": rss_gb < 10.0,  # per-base would need >= 25 GB
        "streamed_vs_events_parity": streamed_parity,
        "resume_wall_s": round(resume_wall, 1),
        "resume_gci_match": resume_match,
        "peak_rss_after_resume_gb": round(rss_after_gb, 2),
    }
    print("CHM13::" + json.dumps(result))


def run_chm13_dual_child():
    """The reference's FLAGSHIP branch (GCI.py:1007-1026) at whole-human
    scale on real hardware: HiFi BAM+PAF *and* ONT
    BAM+PAF at 3.1 Gbp through --device streamed — election -> curation ->
    two depth passes -> two-type max -> three issue BEDs -> three-block
    .gci — with every output byte-compared against an independent host
    events-backend run.

    Prints one line ``CHM13DUAL::{json}`` consumed by the parent bench.
    """
    import resource

    from gci_tpu.pipeline import run_gci
    from gci_tpu.utils.metrics import get_metrics

    ref, hifi_bam = ensure_e2e_inputs(
        CHM13_BP, CHM13_READS, CHM13_TARGETS, seed=0xC13
    )
    _, nano_bam = ensure_e2e_inputs(
        CHM13_BP, CHM13_READS, CHM13_TARGETS, seed=0xC14,
        kind="nano", name_prefix="n",
    )
    hifi_paf = ensure_dual_paf(
        hifi_bam, os.path.join(E2E_DIR, "hifi_chm13.paf"), seed=0xDA1
    )
    nano_paf = ensure_dual_paf(
        nano_bam, os.path.join(E2E_DIR, "nano_chm13.paf"), seed=0xDA2
    )
    outdir = os.path.join(E2E_DIR, "out_chm13_dual")

    def one_run():
        get_metrics().reset()
        t0 = time.perf_counter()
        run_gci(
            hifi=[hifi_bam, hifi_paf], nano=[nano_bam, nano_paf],
            reference=ref, directory=outdir, prefix="D", force=True,
            threads=os.cpu_count() or 1, depth_backend="streamed",
        )
        return time.perf_counter() - t0

    cold_wall = one_run()
    wall = one_run()
    stages = {r.name: round(r.seconds, 3) for r in get_metrics().records}
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    ev_dir = os.path.join(E2E_DIR, "out_chm13_dual_events")
    run_gci(
        hifi=[hifi_bam, hifi_paf], nano=[nano_bam, nano_paf],
        reference=ref, directory=ev_dir, prefix="D", force=True,
        threads=os.cpu_count() or 1, depth_backend="events",
    )
    files = (
        "D_hifi.depth.gz", "D_nano.depth.gz", "D_two_type.depth.gz",
        "D_hifi.0.depth.bed", "D_nano.0.depth.bed", "D_two_type.0.depth.bed",
        "D.gci",
    )
    mismatched = [
        f for f in files
        if open(os.path.join(outdir, f), "rb").read()
        != open(os.path.join(ev_dir, f), "rb").read()
    ]
    # resume-from-checkpoint across all three depth files (the score
    # tool's hifi+nano+two_type branch) must reproduce the run's .gci
    from gci_tpu.tools.score_only import main as score_main

    resume_dir = os.path.join(E2E_DIR, "out_chm13_dual_resume")
    os.makedirs(resume_dir, exist_ok=True)
    t0 = time.perf_counter()
    score_main([
        "-r", ref,
        "--hifi", os.path.join(outdir, "D_hifi.depth.gz"),
        "--nano", os.path.join(outdir, "D_nano.depth.gz"),
        "--two-type", os.path.join(outdir, "D_two_type.depth.gz"),
        "-d", resume_dir, "-o", "D", "-f",
    ])
    resume_wall = time.perf_counter() - t0
    with open(os.path.join(outdir, "D.gci"), "rb") as a, open(
        os.path.join(resume_dir, "D.gci"), "rb"
    ) as b:
        resume_match = a.read() == b.read()

    agg = {}
    for k, v in stages.items():
        key = k.split(":", 1)[-1] if ":" in k else k
        agg[key] = round(agg.get(key, 0.0) + v, 2)
    result = {
        "bp": CHM13_BP,
        "reads_per_type": CHM13_READS,
        "paf_rows": {
            "hifi": sum(1 for _ in open(hifi_paf, "rb")),
            "nano": sum(1 for _ in open(nano_paf, "rb")),
        },
        "wall_s": round(wall, 1),
        "cold_wall_s": round(cold_wall, 1),
        "stages_s": agg,
        "peak_rss_gb": round(rss_gb, 2),
        "resume_wall_s": round(resume_wall, 1),
        "resume_gci_match": resume_match,
        "parity": not mismatched,
        "parity_files": len(files),
    }
    if mismatched:
        result["mismatched"] = mismatched
    print("CHM13DUAL::" + json.dumps(result))


def _run_child(flag: str, tag: str):
    """Run one rehearsal in a child process.  The parent must not have
    initialized jax's backend yet: a process reserves most of the card's
    memory when it first uses it, so the child would run out."""
    import subprocess
    import sys

    from jax._src import xla_bridge

    assert not xla_bridge.backends_are_initialized(), (
        "rehearsal children run before the parent touches the device"
    )

    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag],
        capture_output=True, timeout=3600,
    )
    for line in r.stdout.decode(errors="replace").splitlines():
        if line.startswith(tag):
            return json.loads(line[len(tag):])
    return {
        "error": "child failed",
        "tail": r.stdout.decode(errors="replace")[-500:]
        + r.stderr.decode(errors="replace")[-1500:],
    }


def run_chm13_rehearsal():
    """Run the rehearsal in a subprocess; None when skipped/failed."""
    if os.environ.get("GCI_BENCH_SKIP_CHM13"):
        return None
    return _run_child("--chm13-child", "CHM13::")


def run_chm13_dual_rehearsal():
    if os.environ.get("GCI_BENCH_SKIP_CHM13"):
        return None
    return _run_child("--chm13-dual-child", "CHM13DUAL::")


def run_e2e(backend: str, ref: str, bam: str, mesh: str | None = None):
    from gci_tpu.pipeline import run_gci
    from gci_tpu.utils.metrics import get_metrics

    outdir = os.path.join(E2E_DIR, f"out_{backend}")
    get_metrics().reset()
    t0 = time.perf_counter()
    run_gci(
        hifi=[bam], reference=ref, directory=outdir, prefix="B", force=True,
        threads=os.cpu_count() or 1, depth_backend=backend, mesh=mesh,
    )
    wall = time.perf_counter() - t0
    stages = {r.name: round(r.seconds, 3) for r in get_metrics().records}
    checkpoint_s = sum(v for k, v in stages.items() if "write_depth_gz" in k)
    # the stages that actually differ between depth backends (pack/curation
    # are identical host work and this host's wall-clock is very noisy)
    backend_s = sum(
        v for k, v in stages.items()
        if any(t in k for t in (
            "depth_accumulate", "checkpoint_readback", "write_depth_gz",
            "issue_bed",
        ))
    )
    return {
        "wall_s": round(wall, 2),
        "compute_s": round(wall - checkpoint_s, 2),
        "backend_stages_s": round(backend_s, 2),
        "stages": stages,
    }


# ---------------------------------------------------------------------------
# PAF parse + election (vectorized vs the reference's dict-of-dicts loop)
# ---------------------------------------------------------------------------

PAF_ROWS = int(os.environ.get("GCI_BENCH_PAF_ROWS", 2_000_000))


def ensure_paf_input(n_rows=None, n_targets=8, seed=0xAF):
    """Generate (once) and cache a multi-million-row synthetic PAF."""
    n_rows = PAF_ROWS if n_rows is None else n_rows
    os.makedirs(E2E_DIR, exist_ok=True)
    path = os.path.join(E2E_DIR, f"elect_{n_rows}.paf")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    tl = 100_000_000
    n_queries = n_rows // 3  # ~3 alignments per query on average
    q = rng.integers(0, n_queries, n_rows)
    qlen = rng.integers(5_000, 25_000, n_rows)
    qs = (qlen * rng.random(n_rows) * 0.5).astype(np.int64)
    qe = qs + ((qlen - qs) * rng.random(n_rows)).astype(np.int64) + 1
    tid = rng.integers(0, n_targets, n_rows)
    ts = rng.integers(0, tl - 30_000, n_rows)
    te = ts + (qe - qs)
    alnlen = (qe - qs) + rng.integers(0, 500, n_rows)
    nmatch = (alnlen * rng.uniform(0.85, 1.0, n_rows)).astype(np.int64)
    mapq = rng.choice([0, 20, 30, 50, 60], n_rows)
    with open(path, "w") as f:
        for k in range(n_rows):
            f.write(
                f"q{q[k]}\t{qlen[k]}\t{qs[k]}\t{qe[k]}\t+\tchr{tid[k]}\t{tl}"
                f"\t{ts[k]}\t{te[k]}\t{nmatch[k]}\t{alnlen[k]}\t{mapq[k]}\n"
            )
    return path


def run_bam_pack_bench():
    """Pack-stage attribution: wall + producer phase split + the file's
    measured decompression floor."""
    from gci_tpu.native import NativeBamStream, bgzf_inflate_floor

    ref, bam = ensure_e2e_inputs()
    T = os.cpu_count() or 1
    floor_s, inflated = bgzf_inflate_floor(bam, T)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        st = NativeBamStream(bam, nthreads=T, keep_names=False)
        n = 0
        for ch in st:
            n += ch.n_records
        phases = st.phase_seconds()
        st.close()
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, n, phases)
    wall, n, phases = best
    return {
        "records": n,
        "wall_s": round(wall, 2),
        "records_per_s": int(n / wall),
        "inflated_gb": round(inflated / 1e9, 2),
        "inflate_cache_floor_s": round(floor_s, 2),
        "producer_phases_s": {k: round(v, 2) for k, v in phases.items()},
    }


def run_whole_genome_plot_bench():
    """BASELINE config #4's plotting surface (-p -ws 50000) at the e2e
    scale (500 Mbp, ~9x coverage — realistic zero-density; the 3.1 Gbp
    dual rehearsal inputs are ~1x coverage, where the reference's
    point-per-zero-base window-averaging semantics make whole-genome
    figures carry tens of millions of points — faithful but pathological,
    so plotting is exercised here instead)."""
    from gci_tpu.pipeline import run_gci

    ref, bam = ensure_e2e_inputs()
    outdir = os.path.join(E2E_DIR, "out_events_plot")
    t0 = time.perf_counter()
    run_gci(
        hifi=[bam], reference=ref, directory=outdir, prefix="P", force=True,
        threads=os.cpu_count() or 1, depth_backend="events",
        plot=True, window_size=50_000,
    )
    wall = time.perf_counter() - t0
    import glob

    images = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(outdir, "images", "P.*"))
    )
    return {
        "bp": E2E_BP,
        "wall_s": round(wall, 1),
        "images": len(images),
    }


def run_paf_election_bench():
    """Parse + mask + elect a multi-million-row PAF; baseline = the
    reference's per-row dict-of-dicts loop (GCI.py:213-254) on a subsample,
    scaled linearly (its cost is linear in rows)."""
    from gci_tpu.filters.cascade import paf_filter_mask
    from gci_tpu.filters.election import elect_primary_targets
    from gci_tpu.io.paf import read_paf

    path = ensure_paf_input()
    t0 = time.perf_counter()
    paf = read_paf(path, threads=os.cpu_count() or 1)
    parse_cold_s = time.perf_counter() - t0  # may include disk/page-cache miss
    parse_s = 1e9
    for _ in range(3):  # steady state, best-of-3 (shared-host noise)
        t0 = time.perf_counter()
        paf = read_paf(path, threads=os.cpu_count() or 1)
        parse_s = min(parse_s, time.perf_counter() - t0)
    mask = paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, 30, 0.9)
    elect_s = 1e9
    for _ in range(3):  # best-of-3: this shared host's clock is very noisy
        t0 = time.perf_counter()
        (elected,) = elect_primary_targets([(paf, mask)])
        elect_s = min(elect_s, time.perf_counter() - t0)

    # baseline: the r3 per-query dict-of-dicts interpreter loop (same shape
    # as the reference's GCI.py:213-254), run for real on a 500k-row slice
    # and scaled linearly — a LOWER bound: at full size its dicts blow past
    # this host's memory locality (page faults ~15us each)
    n_sub = min(500_000, paf.n_records)
    t0 = time.perf_counter()
    names_all = paf.names  # the loop keys its dicts by per-row name bytes
    synteny = {}
    nm_, al_, ql_, qs_, qe_, ts_, te_, mq_ = (
        paf.nmatch, paf.alnlen, paf.qlen, paf.qstart, paf.qend,
        paf.tstart, paf.tend, paf.mapq,
    )
    tnames = paf.target_names
    tid_ = paf.tid
    for k in range(n_sub):
        identity = int(nm_[k]) / int(al_[k])
        if int(mq_[k]) < 30 or identity < 0.9:
            continue
        synteny.setdefault(names_all[k], {}).setdefault(
            tnames[tid_[k]], []
        ).append(
            (int(ql_[k]), int(qs_[k]), int(qe_[k]), int(ts_[k]), int(te_[k]), identity)
        )

    def union_blocks(pairs):
        srt = sorted(pairs)
        blocks = []
        total = 0
        lo, hi = srt[0]
        for s, e in srt[1:]:
            if hi >= s:
                if e > hi:
                    hi = e
            else:
                blocks.append((hi - lo, lo, hi))
                total += hi - lo
                lo, hi = s, e
        blocks.append((hi - lo, lo, hi))
        total += hi - lo
        return total, blocks

    for per_target in synteny.values():
        best_key = None
        for target, alns in per_target.items():
            mapped, _ = union_blocks([(a[1], a[2]) for a in alns])
            score = (sum(a[5] for a in alns) / len(alns)) * (mapped / alns[0][0])
            key = (score, target)
            if best_key is None or key > best_key:
                _, tblocks = union_blocks([(a[3], a[4]) for a in alns])
                best_blk = max(range(len(tblocks)), key=lambda j: (tblocks[j][0], -j))
                best_key = key
    del best_blk
    loop_sub_s = time.perf_counter() - t0
    loop_full_s = loop_sub_s * (paf.n_records / n_sub)
    return {
        "rows": paf.n_records,
        "parse_s": round(parse_s, 2),
        "parse_cold_s": round(parse_cold_s, 2),
        "elect_s": round(elect_s, 2),
        "elected_queries": int(elected.name_keys.shape[0]),
        "r3_loop_s_lower_bound": round(loop_full_s, 1),
        "speedup_vs_loop": round(loop_full_s / max(elect_s, 1e-9), 1),
    }


# ---------------------------------------------------------------------------
# baseline: faithful reference-style loops on a subsample, scaled
# ---------------------------------------------------------------------------

def run_reference_style(cols, targets_length, n_sample, bp_sample):
    """Reference-equivalent host implementation on a subsample, scaled."""
    names = list(targets_length)
    sub = {k: v[:n_sample] for k, v in cols.items()}
    L = bp_sample // len(names)
    depths = {t: np.zeros(L, dtype=np.int64) for t in names}
    t0 = time.perf_counter()
    # per-read python loop with the reference's filter conditionals
    for k in range(n_sample):
        flag = int(sub["flag"][k])
        if flag & (4 | 256 | 2048) or int(sub["mapq"][k]) < 30:
            continue
        M, I, D, S = (int(sub[x][k]) for x in ("m", "i", "d", "s"))
        eq, X, NM = (int(sub[x][k]) for x in ("eq", "x", "nm"))
        mm = NM - (I + D)
        denom1 = M + eq + X + I + S
        denom2 = M + eq + X + I + D
        if denom1 == 0 or denom2 == 0:
            continue
        if S / denom1 > 0.1 or (M + eq + X - mm) / denom2 < 0.9:
            continue
        t = names[int(sub["tid"][k]) % len(names)]
        s0 = min(int(sub["start"][k]), L)
        e0 = min(int(sub["end"][k]), L)
        depths[t][s0 + FLANK : e0 - FLANK + 1] += 1
    read_time = time.perf_counter() - t0
    # per-base python interval scan (the reference's collapse loop)
    t0 = time.perf_counter()
    for t in names:
        dl = depths[t]
        start_flag, end_flag = 0, 1
        chr_len = len(dl)
        for i2, depth in enumerate(dl[FLANK : chr_len - FLANK]):
            if -1 < depth <= 0:
                if start_flag == 0:
                    start_flag, end_flag = 1, 0
                if i2 == (chr_len - FLANK * 2 - 1):
                    pass
            else:
                if end_flag == 0:
                    end_flag, start_flag = 1, 0
    scan_time = time.perf_counter() - t0
    per_read = read_time / n_sample
    per_base = scan_time / bp_sample
    return per_read, per_base


def main():
    # run the whole-genome rehearsal CHILDREN before this parent process
    # touches the device: the rehearsals must see an otherwise-idle card
    chm13 = run_chm13_rehearsal()
    chm13_dual = run_chm13_dual_rehearsal()

    rng = np.random.default_rng(0xBEEF)
    target_len = GENOME_BP // N_TARGETS
    targets_length = {f"chr{i}": target_len for i in range(N_TARGETS)}
    cols = synth_columns(rng, N_READS, target_len, N_TARGETS)

    dev_time, checks = run_device(cols, targets_length)
    reads_per_s = N_READS / dev_time

    per_read, per_base = run_reference_style(
        cols, targets_length, BASELINE_SAMPLE_READS, BASELINE_SAMPLE_BP
    )
    ref_time_full = per_read * N_READS + per_base * GENOME_BP
    ref_reads_per_s = N_READS / ref_time_full

    ref, bam = ensure_e2e_inputs()
    e2e = {
        "bp": E2E_BP,
        "reads": E2E_READS,
        "events": run_e2e("events", ref, bam),
        "device_cold": run_e2e("device", ref, bam),
        # steady-state: compiles cached, kernels warm
        "device": run_e2e("device", ref, bam),
    }
    # device parity: the device backend must produce the SAME bytes as the
    # host events backend (the writer is deterministic, so any kernel
    # divergence shows up here, on the device, every run).
    # A missing output counts as a mismatch rather than aborting the bench.
    def _read_or_none(p):
        try:
            with open(p, "rb") as f:
                return f.read()
        except OSError:
            return None

    mismatched = []
    for f in ("B.depth.gz", "B.0.depth.bed", "B.gci"):
        a = _read_or_none(os.path.join(E2E_DIR, "out_events", f))
        b = _read_or_none(os.path.join(E2E_DIR, "out_device", f))
        if a is None or b is None or a != b:
            mismatched.append(f)
    e2e["device_output_parity"] = not mismatched
    if mismatched:
        e2e["device_output_mismatches"] = mismatched

    # the sharded code path on one device: a mesh-resident (1,1) sharded
    # run, byte-compared to the events outputs
    try:
        e2e["sharded_1x1_cold"] = run_e2e("sharded", ref, bam, mesh="1,1")
        e2e["sharded_1x1"] = run_e2e("sharded", ref, bam, mesh="1,1")
        sharded_mismatch = [
            f
            for f in ("B.depth.gz", "B.0.depth.bed", "B.gci")
            if _read_or_none(os.path.join(E2E_DIR, "out_events", f))
            != _read_or_none(os.path.join(E2E_DIR, "out_sharded", f))
        ]
        e2e["sharded_output_parity"] = not sharded_mismatch
        if sharded_mismatch:
            e2e["sharded_output_mismatches"] = sharded_mismatch
    except Exception as exc:  # report, never sink the whole bench
        e2e["sharded_1x1"] = {"error": repr(exc)[:300]}
        e2e["sharded_output_parity"] = False
    # reference-style wall-clock for THIS workload (scaled), for an e2e ratio.
    # NOTE: this EXCLUDES the reference's pysam BGZF-inflate cost (our
    # bam_pack stage pays the real one), so the ratio is a lower bound.
    ref_e2e_s = per_read * E2E_READS + per_base * E2E_BP
    e2e["reference_style_s"] = round(ref_e2e_s, 1)
    e2e["vs_reference_events"] = round(ref_e2e_s / e2e["events"]["wall_s"], 1)
    e2e["vs_reference_device"] = round(ref_e2e_s / e2e["device"]["wall_s"], 1)
    # what the production rule (gci_tpu.depth.resolve_auto_backend) picks
    from gci_tpu.depth import resolve_auto_backend

    e2e["auto_resolved"] = resolve_auto_backend()

    paf_bench = run_paf_election_bench()

    pack_bench = run_bam_pack_bench()

    plots_bench = run_whole_genome_plot_bench()

    out = {
        "metric": "synthetic 1Gbp/4M-read filtered+depth-binned+interval-scanned reads/s per chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / ref_reads_per_s, 2),
        "e2e": e2e,
    }
    out["paf_election"] = paf_bench
    out["bam_pack"] = pack_bench
    out["whole_genome_plots"] = plots_bench
    if chm13 is not None:
        out["chm13_rehearsal"] = chm13
    if chm13_dual is not None:
        out["chm13_dual"] = chm13_dual
    print(json.dumps(out))


if __name__ == "__main__":
    import sys

    from gci_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    if "--chm13-child" in sys.argv:
        run_chm13_child()
    elif "--chm13-dual-child" in sys.argv:
        run_chm13_dual_child()
    else:
        main()
