"""Smoke run of gci's main path on one NVIDIA GPU.

Drives the ``gci`` CLI (``gci_tpu.cli.main`` -> ``pipeline.run_gci``) with
``--device auto`` on generated inputs at published assembly sizes, and holds
every output byte for byte to a ``--device events`` run (the host oracle):

* assembly A, T2T-human scale (CHM13, BASELINE.md): 3.1 Gbp in 24 targets
  with N-gap blocks, HiFi BAM + PAF and ONT BAM + PAF.  3.1 G slots exceed
  the resident axis's int32 index, so the device backend streams it in
  chunks.  Run again with ``-ts 5 -R regions.bed``.
* assembly B, rice scale (the reference's MH63 example): ~396 Mbp in 12
  targets at ~10x HiFi, resident on the card: once with the BAM alone (the
  pack<->scatter overlap path) and once with BAM + PAF (election and
  curation upstream of the resident construction).

Then every Triton scan kernel is compared with its XLA reference at real
widths and timed against it, in turns, beside a plain device copy of the
same bytes.  Reads are generated from ``--seed`` by bench.py's generators
into ``<out>/inputs``; the read count per type is cut from the ~9M reads of
58x HiFi coverage to ``--reads`` so that the default run ends well inside
its time limit.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs: assembly A on --mesh 2,2

With ``--multi`` only the four-card phase runs: assembly A through
``--device sharded --mesh 2,2`` (psum over dp, all_gather/ppermute over gp,
NCCL between the cards) against the events run.

Every line names the card; the last line of standard output is one JSON
object.  Any failed phase raises, and the script exits non-zero without
that line.  Plotting (``-p``) is off the device path and not run.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

import bench
from gci_tpu.cli import main as gci_main
from gci_tpu.utils.metrics import get_metrics

MBP = 1_000_000
ASSEMBLY_A = dict(bp=3_100 * MBP, n_targets=24, n_gaps=4)
ASSEMBLY_B = dict(bp=396 * MBP, n_targets=12, n_gaps=2)
FULL_COVERAGE_READS = 9_000_000  # ~58x HiFi of CHM13 at ~18-20 kbp reads


class Smoke:
    def __init__(self, out: str, seed: int, threads: int):
        self.out = os.path.abspath(out)
        self.inputs = os.path.join(self.out, "inputs")
        self.seed = seed
        self.threads = threads
        self.card = "?"

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)

    # ------------------------------------------------------------- inputs
    def assembly(self, spec: dict, n_reads: int, kinds, with_paf: bool):
        """(ref, {kind: [bam, (paf)]}) generated into ``self.inputs``."""
        t0 = time.perf_counter()
        files = {}
        ref = None
        for k, kind in enumerate(kinds):
            ref, bam = bench.ensure_e2e_inputs(
                spec["bp"], n_reads, spec["n_targets"], seed=self.seed + k,
                kind=kind, name_prefix=kind[0], directory=self.inputs,
                n_gaps=spec["n_gaps"],
            )
            files[kind] = [bam]
            if with_paf:
                paf = os.path.join(
                    self.inputs, f"{kind}_{spec['bp']}_{n_reads}.paf"
                )
                files[kind].append(
                    bench.ensure_dual_paf(bam, paf, seed=self.seed + 100 + k)
                )
        self.say(f"inputs {spec['bp']} bp, {'+'.join(kinds)} x {n_reads} "
                 f"reads{' + PAF' if with_paf else ''}: generated in "
                 f"{time.perf_counter() - t0:.1f} s (set-up)")
        return ref, files

    def regions_bed(self, ref: str) -> str:
        from gci_tpu.io.fasta import scan_fasta

        lengths, _ = scan_fasta(ref)
        names = list(lengths)
        path = os.path.join(self.inputs, "regions.bed")
        with open(path, "w") as f:
            for name in (names[0], names[len(names) // 2], names[-1]):
                L = lengths[name]
                f.write(f"{name}\t{L // 10}\t{L - L // 7}\n")
        return path

    # --------------------------------------------------------------- runs
    def gci(self, tag: str, ref: str, files: dict, device: str,
            extra=(), want_backend: str | None = None) -> tuple[str, float]:
        """One CLI run into ``<out>/<tag>``; returns (directory, wall s)."""
        directory = os.path.join(self.out, tag)
        argv = ["-r", ref, "-d", directory, "-o", "S", "-f",
                "-t", str(self.threads), "--device", device, *extra]
        for kind, paths in files.items():
            argv += [f"--{kind}", *paths]
        get_metrics().reset()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            gci_main(argv)
        wall = time.perf_counter() - t0
        sys.stderr.write(err.getvalue())
        backends = {
            line.split(": ", 1)[1]
            for line in err.getvalue().splitlines()
            if line.startswith("depth backend: ")
        }
        if want_backend is not None and backends != {want_backend}:
            raise AssertionError(
                f"{tag}: --device {device} ran depth backends {backends}, "
                f"expected {want_backend}"
            )
        return directory, wall

    def stages(self, tag: str) -> None:
        agg: dict[str, float] = {}
        for r in get_metrics().records:
            key = r.name.split(":/")[0]
            agg[key] = agg.get(key, 0.0) + r.seconds
        self.say(f"{tag} stages_s " + json.dumps(agg))

    def peak_bytes(self) -> int:
        import jax

        return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])

    def parity(self, tag: str, oracle: str, got: str, must_have) -> None:
        names = sorted(os.listdir(oracle))
        if sorted(os.listdir(got)) != names:
            raise AssertionError(
                f"{tag}: output files differ: {names} vs {sorted(os.listdir(got))}"
            )
        missing = [m for m in must_have if m not in names]
        if missing:
            raise AssertionError(f"{tag}: missing outputs {missing}")
        for name in names:
            with open(os.path.join(oracle, name), "rb") as a, \
                    open(os.path.join(got, name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{tag}: {name} differs from events")
        self.say(f"{tag} parity: {len(names)} files byte-identical to "
                 f"--device events ({', '.join(names)})")

    def case(self, tag: str, ref: str, files: dict, must_have, extra=(),
             device: str = "auto", want_backend: str = "device",
             warm: bool = True, device_extra=()) -> None:
        """Cold (set-up, compiles included) and warm runs of ``device``,
        then the events oracle and the byte comparison.  ``extra`` goes to
        every run, ``device_extra`` only to the device runs."""
        dev_args = (*extra, *device_extra)
        d, cold = self.gci(f"{tag}_cold", ref, files, device, dev_args,
                           want_backend)
        line = f"{tag} --device {device} -> {want_backend}: cold (set-up) {cold:.3f} s"
        if warm:
            d, wall = self.gci(tag, ref, files, device, dev_args, want_backend)
            line += f", warm {wall:.3f} s"
        self.say(line + f", peak_bytes_in_use so far {self.peak_bytes()}")
        self.stages(tag)
        ev, ev_wall = self.gci(f"{tag}_events", ref, files, "events", extra,
                               "events")
        self.say(f"{tag} --device events (host oracle): {ev_wall:.3f} s")
        self.parity(tag, ev, d, must_have)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def dual_outputs(ts: int, regions: bool):
    names = [f"S_{t}.{ts}.depth.bed" for t in ("hifi", "nano", "two_type")]
    names += [f"S_{t}.depth.gz" for t in ("hifi", "nano", "two_type")]
    names += ["S.gci", "S.gaps.bed"] + (["S.regions.gci"] if regions else [])
    return names


SINGLE_OUTPUTS = ["S.depth.gz", "S.0.depth.bed", "S.gci", "S.gaps.bed"]


def phase_assembly_a(sm: Smoke, n_reads: int) -> None:
    ref, files = sm.assembly(ASSEMBLY_A, n_reads, ("hifi", "nano"), True)
    sm.case("A", ref, files, dual_outputs(0, False))
    regions = sm.regions_bed(ref)
    sm.case("A_regions", ref, files, dual_outputs(5, True),
            extra=("-ts", "5", "-R", regions), warm=False)


def phase_assembly_b(sm: Smoke, n_reads: int) -> None:
    ref, files = sm.assembly(ASSEMBLY_B, n_reads, ("hifi",), True)
    bam_only = {"hifi": files["hifi"][:1]}
    sm.case("B_bam", ref, bam_only, SINGLE_OUTPUTS)
    sm.case("B_bam_paf", ref, files, SINGLE_OUTPUTS)


def phase_multi(sm: Smoke, n_reads: int) -> None:
    ref, files = sm.assembly(ASSEMBLY_A, n_reads, ("hifi", "nano"), True)
    sm.case("A_sharded_2x2", ref, files, dual_outputs(0, False),
            device_extra=("--mesh", "2,2"), device="sharded",
            want_backend="sharded", warm=False)


def timed_in_turns(fns: dict, args: tuple, rounds: int = 5) -> dict:
    """Median seconds per function, each called in turns (a, b, b, a, ...)
    after one warm-up call apiece."""
    import jax

    names = list(fns)
    for n in names:
        jax.block_until_ready(fns[n](*args))
    times = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[n](*args))
            times[n].append(time.perf_counter() - t0)
    return {n: float(np.median(t)) for n, t in times.items()}


def phase_kernels(sm: Smoke) -> None:
    """Each Triton scan == its XLA reference at real widths, then timed
    against it and against a copy of the same bytes."""
    import jax
    import jax.numpy as jnp

    from gci_tpu.depth import scan
    from gci_tpu.depth.accum import GenomeLayout
    from tests.scan_checks import check_compiled_scans, packed_word

    b_axis = scan.pad_to_block(GenomeLayout.from_targets(
        {f"c{i}": ASSEMBLY_B["bp"] // ASSEMBLY_B["n_targets"]
         for i in range(ASSEMBLY_B["n_targets"])}
    ).total_slots)
    resident = {"B resident axis": b_axis, "1.2G-slot axis": 1200 * 2**20}
    chunk = 256 * 2**20
    check_compiled_scans([b_axis, resident["1.2G-slot axis"], chunk])
    sm.say(f"kernels == XLA references (exact) at {b_axis}, "
           f"{resident['1.2G-slot axis']} and {chunk} slots")

    packed_fns = {
        "triton": scan.packed_scan_kernel,
        "xla": jax.jit(scan.fused_depth_scan_packed_xla),
        "copy": jax.jit(lambda w, lo, hi: (w + 1, w.astype(jnp.int8))),
    }
    for label, n in resident.items():
        w = packed_word(n)
        t = timed_in_turns(packed_fns, (w, jnp.int32(-1), jnp.int32(0)))
        sm.say(f"packed scan, {label} ({n} slots): "
               + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in t.items())
               + f"; copy moves 9 B/slot = {9 * n / t['copy'] / 1e9:.0f} GB/s")
        del w
    prefix_fns = {
        "triton": scan.prefix_sum_kernel,
        "xla": jax.jit(jnp.cumsum),
        "copy": jax.jit(lambda x: x + 1),
    }
    x = packed_word(chunk) & 7
    t = timed_in_turns(prefix_fns, (x,))
    sm.say(f"prefix sum, streamed chunk ({chunk} slots): "
           + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in t.items())
           + f"; copy moves 8 B/slot = {8 * chunk / t['copy'] / 1e9:.0f} GB/s")


# ---------------------------------------------------------------------------

def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def host_codec() -> str:
    """The native host codec must have built; says which deflate it uses."""
    from gci_tpu import native

    native.get_lib()  # builds on first use; raises if it cannot
    return "native, libdeflate" if native._has_libdeflate() else "native, zlib"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--seed", type=int, default=0xC13)
    ap.add_argument("--reads", type=int, default=1_500_000,
                    help="reads per type for assembly A [1500000]")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke"))
    args = ap.parse_args(argv)

    import jax

    from gci_tpu.utils.jaxcache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: jax's default devices are {devices}")
    if args.multi and len(devices) < 4:
        raise SystemExit(f"--multi needs four GPUs, found {len(devices)}")
    enable_compile_cache()

    card_csv = card_line()
    sm = Smoke(args.out, args.seed, os.cpu_count() or 1)
    sm.card = card_csv.splitlines()[0]
    print(card_csv, flush=True)
    sm.say(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    sm.say(f"host codec: {host_codec()}")
    b_reads = ASSEMBLY_B["bp"] * 10 // bench.READ_LEN_MEAN  # ~10x HiFi
    sm.say(f"reads per type: assembly A {args.reads} (cut from "
           f"~{FULL_COVERAGE_READS} reads of 58x HiFi, i.e. "
           f"{args.reads * bench.READ_LEN_MEAN / ASSEMBLY_A['bp']:.2f}x), "
           f"assembly B {b_reads} (~10x)")

    t0 = time.perf_counter()
    if args.multi:
        phase_multi(sm, args.reads)
    else:
        phase_assembly_b(sm, b_reads)
        phase_assembly_a(sm, args.reads)
        phase_kernels(sm)
    sm.say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
