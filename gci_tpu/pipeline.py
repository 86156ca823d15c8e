"""End-to-end pipeline orchestration.

``run_filter``   — reference GCI.py:172-312 ``filter()``: ingest + filter +
                   curate + depth-accumulate one read-type's alignment files,
                   write the ``.depth.gz`` checkpoint.
``run_gci``      — reference GCI.py:897-1028 ``GCI()``: the whole run
                   (gap scan, per-type filter, gap masking, two-type merge,
                   issue BEDs, scoring, optional plots).

Ingestion and filtering are vectorized host work (numpy float64 masks for
bit-exact threshold parity); per-base genome-axis work (depth prefix-sum,
interval masks, two-type max) runs on the accelerator when one is available
(gci_tpu.depth.device), with the host paths (events, numpy) as oracles.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from gci_tpu.depth import GenomeLayout, accumulate_depth, depth_dict_from_flat
from gci_tpu.utils import stage
from gci_tpu.filters import (
    CurationInput,
    bam_filter_mask,
    curate_files,
    dedup_last_wins,
    elect_primary_targets,
    paf_filter_mask,
)
from gci_tpu.filters.cascade import high_qual_keys
from gci_tpu.io.depth_file import write_depth_gz
from gci_tpu.io.fasta import mask_gaps_in_depths, scan_fasta
from gci_tpu.io.names import keys_view
from gci_tpu.io.paf import read_paf
from gci_tpu.reports import emit_gaps_bed, emit_issue_bed
from gci_tpu.score.report import compute_continuity_report


def _require_writable(path: str, force: bool) -> None:
    from gci_tpu.utils.files import require_writable

    require_writable(path, force)


def _make_overlap_accumulator(
    depth_backend, paf_files, bam_files, multihost, layout, flank_len
):
    """Pack<->scatter overlap accumulator, when semantics allow it.

    Only the single-BAM no-PAF single-process shape qualifies: curation is
    an identity fold there, so last-wins dedup can fold incrementally and
    each chunk's deltas scatter asynchronously during pack (reference
    analogue: the GCI.py:146-169 window streaming).  Multi-file or PAF runs
    need the full cross-file curation before any depth math.
    """
    if paf_files or len(bam_files) != 1 or multihost:
        return None
    if depth_backend not in ("device", "streamed"):
        return None
    from gci_tpu.depth.accum import stream_slot_limit
    from gci_tpu.depth.overlap import DeltaAccumulator

    total = layout.total_slots
    if depth_backend == "device" and total <= stream_slot_limit():
        from gci_tpu.depth.fused import DeviceDepth

        a = DeltaAccumulator(
            layout, flank_len, DeviceDepth.pad_total_for(total)
        )
        a.mode = "device"
        return a
    # streamed genomes: coordinate-sweep accumulator — only the chunks near
    # the read frontier hold live device buffers, each finalized chunk scans
    # while the producer inflates the next BAM chunk, so device memory is
    # O(live chunks) at any genome size
    from gci_tpu.depth.overlap import SweepAccumulator

    return SweepAccumulator(
        layout, flank_len,
        chunk_slots=int(os.environ.get("GCI_STREAM_CHUNK_SLOTS", 256 * 1024 * 1024)),
    )


def run_filter(
    paf_files: list[str],
    bam_files: list[str],
    prefix: str = "GCI",
    map_qual: int = 30,
    mq_cutoff: int = 50,
    iden_percent: float = 0.9,
    clip_percent: float = 0.1,
    ovlp_percent: float = 0.9,
    flank_len: int = 15,
    directory: str = ".",
    force: bool = False,
    log_reads_type: str = "",
    chrs_list: list[str] = (),
    threads: int = 4,
    depth_backend: str = "auto",
    mesh=None,
    gaps=None,
    threshold: int = 0,
    comp_ranges: dict[str, tuple[int, int]] | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """Filter alignments of one read type into per-base depth (GCI.py:172-312).

    ``gaps``/``threshold`` feed the fused device backend so one kernel pass
    can pre-extract the run's issue edges; other backends ignore them (gap
    masking stays a separate pipeline stage, exactly as in the reference).
    ``comp_ranges`` maps a BAM path to this host's compressed byte range —
    the per-host input shard on multi-host runs (records parsed only once
    cluster-wide; survivors are reconciled by an allgather before curation).
    """
    _require_writable(f"{directory}/{prefix}.depth.gz", force)
    if depth_backend == "auto":
        from gci_tpu.depth import resolve_auto_backend

        depth_backend = resolve_auto_backend()
    # stdout follows the reference's narration; the backend goes to stderr
    print(f"depth backend: {depth_backend}", file=sys.stderr)
    print(f"Filtering {log_reads_type} alignment files ...")

    from gci_tpu.io.bam import BamStream
    from gci_tpu.parallel.distributed import (
        allgather_concat,
        input_comp_range,
        process_count,
    )

    # multi-host: each process inflates/parses only its compressed byte
    # range of every shared BAM; the tiny packed survivors are reconciled
    # below by a host allgather, so the dominant pack stage scales ~1/H
    multihost = process_count() > 1
    if comp_ranges is None and multihost:
        comp_ranges = {path: input_comp_range(path) for path in bam_files}

    chunk_bytes = int(os.environ.get("GCI_BAM_CHUNK_BYTES", 64 << 20))

    def open_stream(path: str) -> BamStream:
        return BamStream(
            path, threads=threads, keep_names=False,
            comp_range=comp_ranges.get(path) if comp_ranges else None,
            chunk_bytes=chunk_bytes,
        )

    # only the first stream opens up-front (it provides the target table);
    # the rest open lazily in the per-file loop — eagerly constructing all
    # of them would start every file's producer prefetch (or, in the pure-
    # Python fallback, load every file whole) before its turn
    stream0 = open_stream(bam_files[0])
    if chrs_list:
        targets_length = {
            r: l
            for r, l in zip(stream0.references, stream0.lengths)
            if r in chrs_list
        }
    else:
        targets_length = stream0.targets_length()
    target_ids = {name: k for k, name in enumerate(targets_length)}
    layout = GenomeLayout.from_targets(targets_length)

    hq_parts: list[np.ndarray] = []
    curation_inputs: list[CurationInput] = []

    # --- PAF branch (GCI.py:213-254): cumulative election across files.
    # Multi-host: each process tokenizes only its 1/H line range of every
    # shared PAF — for .paf.gz every host still inflates the whole stream
    # (gzip has no random access; libdeflate inflates at GB/s) but the
    # tokenize, the expensive part, splits H ways over the uncompressed
    # bytes.  The masked candidate columns are tiny and reconcile by
    # allgather in process order == file row order, so the cumulative
    # first-inserted election semantics are exactly the single-process ones.
    if paf_files:
        from gci_tpu.io.paf import PafData

        global_target_names = list(targets_length)
        paf_masked = []
        for path in paf_files:
            with stage(f"{log_reads_type}:paf_parse:{path}") as paf_stage:
                shard = None
                if multihost:
                    import jax

                    shard = (jax.process_index(), jax.process_count())
                paf = read_paf(path, threads=threads, shard=shard)
                paf_stage.items = paf.n_records
                paf_stage.unit = "rows"
                # map this file's target table onto the pipeline's; unknown
                # targets drop here (reference target-membership check)
                t2g = np.array(
                    [target_ids.get(t, -1) for t in paf.target_names]
                    or [-1],
                    dtype=np.int32,
                )
                gtid = t2g[paf.tid]
                mask = (gtid >= 0) & paf_filter_mask(
                    paf.mapq, paf.nmatch, paf.alnlen, map_qual, iden_percent
                )
                idx = np.flatnonzero(mask)
                cols = [
                    np.ascontiguousarray(paf.name_keys[idx]),
                    gtid[idx].astype(np.int32),
                    paf.qlen[idx], paf.qstart[idx], paf.qend[idx],
                    paf.tstart[idx], paf.tend[idx],
                    paf.nmatch[idx], paf.alnlen[idx], paf.mapq[idx],
                ]
                if shard is not None:
                    cols = allgather_concat(cols)
                keys, gtid_m, qlen, qs, qe, ts, te, nmatch, alnlen, mapq = cols
                cand = PafData(
                    _names=None, name_keys=keys, tid=gtid_m,
                    target_names=global_target_names,
                    qlen=qlen, qstart=qs, qend=qe, tstart=ts, tend=te,
                    nmatch=nmatch, alnlen=alnlen, mapq=mapq,
                )
                paf_masked.append(
                    (cand, np.ones(keys.shape[0], dtype=bool))
                )
                hq_parts.append(
                    high_qual_keys(
                        keys, np.ones(keys.shape[0], dtype=bool), mapq,
                        mq_cutoff,
                    )
                )
        with stage(f"{log_reads_type}:paf_election"):
            for elected in elect_primary_targets(paf_masked):
                # elected.target_names is the pipeline table; tid is global
                curation_inputs.append(
                    CurationInput(
                        name_keys=elected.name_keys,
                        target_id=elected.tid,
                        start=elected.start,
                        end=elected.end,
                        qlen=elected.qlen,
                    )
                )

    # --- BAM branch (GCI.py:257-270): streamed scan, vectorized cascade.
    # Each chunk is filtered + compacted while the native producer inflates
    # the next one (pack <-> filter overlap); the last-wins name dedup runs
    # over the concatenated per-chunk survivors, which preserves file order
    # across chunk borders and so matches the reference's whole-file dict
    # semantics (GCI.py:166).
    #
    # Single-BAM no-PAF device/streamed runs additionally overlap pack with
    # the DEVICE scatter: curation is an identity fold there, so each
    # chunk's last-wins survivors scatter (with retraction of replaced
    # records) into a resident delta while the producer inflates the next
    # chunk; the final scan starts with the delta already accumulated.
    acc = _make_overlap_accumulator(
        depth_backend, paf_files, bam_files, multihost, layout, flank_len
    )
    empty_hq = np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
    for file_no, path in enumerate(bam_files):
        stream = stream0 if file_no == 0 else open_stream(path)
        hq_file_parts: list[np.ndarray] = []
        with stage(f"{log_reads_type}:bam_pack:{path}") as pack_stage, stream:
            # map this file's ref ids onto the (possibly chrs-restricted) table
            local_to_global = np.full(
                len(stream.references) + 1, -1, dtype=np.int32
            )
            for k, name in enumerate(stream.references):
                if name in target_ids:
                    local_to_global[k] = target_ids[name]
            cand_parts: list[tuple[np.ndarray, ...]] = []
            n_packed = 0
            for chunk in stream:
                n_packed += chunk.n_records
                ref_id = chunk.columns["ref_id"]
                valid_ref = (ref_id >= 0) & (ref_id < len(stream.references))
                gtid = np.where(
                    valid_ref, local_to_global[np.clip(ref_id, 0, None)], -1
                )
                mask = (gtid >= 0) & bam_filter_mask(
                    chunk.columns, map_qual, clip_percent, iden_percent
                )
                hq_file_parts.append(
                    high_qual_keys(
                        chunk.name_keys, mask, chunk.columns["mapq"], mq_cutoff
                    )
                )
                if acc is not None:
                    surv = dedup_last_wins(chunk.name_keys, mask)
                    if surv.size:
                        acc.add_chunk(
                            keys_view(chunk.name_keys[surv]),
                            gtid[surv].astype(np.int32),
                            chunk.columns["pos"][surv].astype(np.int64),
                            chunk.columns["ref_end"][surv].astype(np.int64),
                        )
                # candidate rows are collected on the overlap path too
                # (O(reads) host memory): they back the curation bookkeeping
                idx = np.flatnonzero(mask)
                if idx.size:
                    cand_parts.append((
                        chunk.name_keys[idx],
                        gtid[idx].astype(np.int32),
                        chunk.columns["pos"][idx].astype(np.int64),
                        chunk.columns["ref_end"][idx].astype(np.int64),
                        chunk.columns["qlen"][idx].astype(np.int64),
                    ))
            pack_stage.items = n_packed
            pack_stage.unit = "records"
        if cand_parts:
            keys = np.concatenate([p[0] for p in cand_parts])
            tid = np.concatenate([p[1] for p in cand_parts])
            start = np.concatenate([p[2] for p in cand_parts])
            end = np.concatenate([p[3] for p in cand_parts])
            qlen = np.concatenate([p[4] for p in cand_parts])
        else:
            keys = np.empty((0, 2), dtype=np.uint64)
            tid = np.empty(0, dtype=np.int32)
            start = end = qlen = np.empty(0, dtype=np.int64)
        nonempty_hq = [p for p in hq_file_parts if p.size]
        hq_file = (
            np.unique(np.concatenate(nonempty_hq)) if nonempty_hq else empty_hq
        )
        if multihost:
            # reconcile the host shards: process order == file order, so the
            # gathered concatenation reproduces the whole-file record order
            # and the last-wins dedup below stays exact (GCI.py:166)
            keys, tid, start, end, qlen = allgather_concat(
                [keys, tid, start, end, qlen]
            )
            (hq_gathered,) = allgather_concat(
                [np.ascontiguousarray(hq_file).view(np.uint64).reshape(-1, 2)]
            )
            hq_file = np.unique(keys_view(hq_gathered)) if hq_gathered.size else empty_hq
        hq_parts.append(hq_file)
        survivors = dedup_last_wins(keys, np.ones(keys.shape[0], dtype=bool))
        curation_inputs.append(
            CurationInput(
                name_keys=keys[survivors],
                target_id=tid[survivors],
                start=start[survivors],
                end=end[survivors],
                qlen=qlen[survivors],
            )
        )

    if hq_parts:
        non_empty = [p for p in hq_parts if p.size]
        high_qual = (
            np.unique(np.concatenate(non_empty))
            if non_empty
            else np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
        )
    else:
        high_qual = np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])

    with stage(f"{log_reads_type}:curation"):
        curated = curate_files(curation_inputs, high_qual, ovlp_percent)

    with stage(
        f"{log_reads_type}:depth_accumulate", items=int(curated.start.shape[0]), unit="reads"
    ):
        # "auto" resolved above (gci_tpu.depth.resolve_auto_backend):
        # device on an accelerator, events on the CPU.  "events" is the
        # O(reads) event-space form (no per-base arrays); "device"/
        # "sharded"/"streamed" force the accelerator paths; "numpy" is the
        # host oracle.
        if acc is not None:
            # overlap path: the delta already accumulated during pack
            if acc.mode == "device":
                from gci_tpu.depth.fused import DeviceDepth

                depths = DeviceDepth.from_delta(
                    layout, acc.delta_flat(), flank_len, gaps=gaps,
                    issue_range=(-1, threshold),
                )
            else:  # "sweep": most chunks already scanned during pack
                depths = acc.finish()
        elif depth_backend == "events":
            from gci_tpu.depth.eventspace import events_dict_from_reads

            depths = events_dict_from_reads(
                layout, curated.target_id, curated.start, curated.end, flank_len
            )
        elif depth_backend in ("device", "streamed"):
            from gci_tpu.depth.accum import stream_slot_limit

            if (depth_backend == "streamed"
                    or layout.total_slots > stream_slot_limit()):
                # chunked device scan -> run-length events; O(runs) host
                # memory, never a per-base array
                from gci_tpu.depth.streamed import events_from_reads_streamed

                depths = events_from_reads_streamed(
                    layout, curated.target_id, curated.start, curated.end,
                    flank_len,
                )
            else:
                # single-device production path: scatter + ONE packed scan
                # (depth, gap-masked issue edges, checkpoint run
                # boundaries); depth stays device-resident for the run
                from gci_tpu.depth.fused import DeviceDepth

                depths = DeviceDepth.from_reads(
                    layout, curated.target_id, curated.start, curated.end,
                    flank_len, gaps=gaps, issue_range=(-1, threshold),
                )
        elif depth_backend == "sharded":
            # multi-chip path: genome axis gp-sharded on the mesh, reads
            # scattered dp-parallel; depth stays device-resident through
            # gap-mask/two-type/interval extraction (gci_tpu.depth.sharded)
            from gci_tpu.depth.sharded import ShardedDepth, parse_mesh_spec

            mesh_obj = mesh if hasattr(mesh, "shape") else parse_mesh_spec(mesh)
            depths = ShardedDepth.from_reads(
                mesh_obj, layout, curated.target_id, curated.start,
                curated.end, flank_len,
            )
        else:
            flat = accumulate_depth(
                layout, curated.target_id, curated.start, curated.end, flank_len,
                backend=depth_backend,
            )
            depths = depth_dict_from_flat(layout, flat)

    print(f"Filtering {log_reads_type} alignment files done!!!")
    print(f'Writing depths into "{directory}/{prefix}.depth.gz" ...')
    from gci_tpu.depth.base import ResidentDepth

    if isinstance(depths, ResidentDepth):
        # device->host run-boundary readback under its own stage: the first
        # call compiles the compaction programs, which would otherwise show
        # up as a slow cold "write" — the writer itself is host RLE
        # encoding and is cold/warm-stable
        with stage(f"{log_reads_type}:checkpoint_readback"):
            depths.to_events()  # cached on the object; write reuses it
    with stage(f"{log_reads_type}:write_depth_gz"):
        write_depth_gz(f"{directory}/{prefix}.depth.gz", depths)
    print("Writing depths done!!!\n\n")
    return depths, targets_length


def merge_two_type_depths(
    hifi_depths: dict[str, np.ndarray],
    nano_depths: dict[str, np.ndarray],
    prefix: str = "GCI_two_type",
    directory: str = ".",
    force: bool = False,
) -> dict[str, np.ndarray]:
    """Per-base max of the two read types (GCI.py:332-353) + checkpoint."""
    print("Merging HiFi and ONT depth file ...")
    _require_writable(f"{directory}/{prefix}.depth.gz", force)
    from gci_tpu.depth.base import ResidentDepth
    from gci_tpu.depth.eventspace import DepthEvents

    if isinstance(hifi_depths, ResidentDepth):
        merged = hifi_depths.maximum(nano_depths)
    else:
        merged = {
            t: d.maximum(nano_depths[t]) if isinstance(d, DepthEvents)
            else np.maximum(d, nano_depths[t])
            for t, d in hifi_depths.items()
        }
    write_depth_gz(f"{directory}/{prefix}.depth.gz", merged)
    print("Merging HiFi and ONT depth file done!!!\n\n")
    return merged


def run_gci(
    hifi: list[str] | None = None,
    nano: list[str] | None = None,
    directory: str = ".",
    prefix: str = "GCI",
    map_qual: int = 30,
    mq_cutoff: int = 50,
    iden_percent: float = 0.9,
    ovlp_percent: float = 0.9,
    clip_percent: float = 0.1,
    flank_len: int = 15,
    threshold: int = 0,
    plot: bool = False,
    depth_min: float = 0.1,
    depth_max: float = 4.0,
    window_size: int = 50000,
    image_type: str = "png",
    force: bool = False,
    dist_percent: float = 0.005,
    reference: str | None = None,
    regions: str | None = None,
    chrs: str | None = None,
    threads: int = 4,
    depth_backend: str = "auto",
    mesh: str | None = None,
    profile: bool = False,
    profile_trace: str | None = None,
) -> None:
    """Whole run: the reference's driver semantics (GCI.py:897-1028)."""
    from gci_tpu.utils.jaxcache import enable_compile_cache
    from gci_tpu.utils.metrics import get_metrics, maybe_jax_trace

    enable_compile_cache()

    with maybe_jax_trace(profile_trace):
        _run_gci_inner(
            hifi, nano, directory, prefix, map_qual, mq_cutoff, iden_percent,
            ovlp_percent, clip_percent, flank_len, threshold, plot, depth_min,
            depth_max, window_size, image_type, force, dist_percent, reference,
            regions, chrs, threads, depth_backend, mesh,
        )
    if profile:
        print("\n=== stage metrics ===")
        print(get_metrics().report())


def _host_view(depths):
    """Event-space host view of a depth mapping (regions re-collapse, plots).

    Device-resident depths convert lazily (one O(runs) boundary transfer);
    everything else passes through untouched.
    """
    from gci_tpu.depth.base import ResidentDepth

    return depths.to_events() if isinstance(depths, ResidentDepth) else depths


def _run_gci_inner(
    hifi, nano, directory, prefix, map_qual, mq_cutoff, iden_percent,
    ovlp_percent, clip_percent, flank_len, threshold, plot, depth_min,
    depth_max, window_size, image_type, force, dist_percent, reference,
    regions, chrs, threads, depth_backend, mesh=None,
) -> None:
    from gci_tpu.io.bed import read_bed_dict
    from gci_tpu.io.bam import read_bam_header

    if depth_backend == "sharded":
        # one Mesh for the whole run so hifi/nano/two-type share shardings
        # and compiled programs
        from gci_tpu.depth.sharded import parse_mesh_spec

        mesh = parse_mesh_spec(mesh)

    chrs_list = chrs.strip().split(",") if chrs is not None else []

    regions_bed: dict[str, list[tuple[int, int]]] = {}
    if regions is not None:
        if os.path.exists(regions) and os.access(regions, os.R_OK):
            regions_bed = read_bed_dict(regions)
        else:
            sys.exit(f'ERROR!!! "{regions}" is not an available file')

    if directory.endswith("/"):
        directory = "/".join(directory.split("/")[:-1])
    if os.path.exists(directory):
        if not os.access(directory, os.R_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to read')
        if not os.access(directory, os.W_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to write')
    else:
        os.makedirs(directory, exist_ok=True)  # multi-host: processes race here

    if prefix.endswith("/"):
        sys.exit(f'ERROR!!! The prefix "{prefix}" is not allowed')

    if plot:
        img_dir = f"{directory}/images"
        if os.path.exists(img_dir):
            if not os.access(img_dir, os.R_OK):
                sys.exit(f'ERROR!!! The path "{img_dir}" is unable to read')
            if not os.access(img_dir, os.W_OK):
                sys.exit(f'ERROR!!! The path "{img_dir}" is unable to write')
        else:
            os.makedirs(img_dir, exist_ok=True)
        image_type = image_type.lower()

    # ONE pass over the reference: record ids (consistency checks,
    # GCI.py:939-941) AND the N-gap scan (GCI.py:983-988) together
    with stage("fasta_scan"):
        ref_lengths, gaps = scan_fasta(reference)
    ref_refs = list(ref_lengths.keys())
    for i in chrs_list:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--chrs` is not in the reference')
    for i in regions_bed:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--regions` is not in the reference')
    if chrs_list and regions_bed:
        if not all(i in chrs_list for i in regions_bed):
            sys.exit(
                "ERROR!!! Chromosomes in the regions bed file are inconsistent with "
                'the provided list of chromosomes\nPlease read the help message use "-h" or "--help"'
            )

    def split_files(files):
        bams = [f for f in files if f.endswith(".bam")]
        pafs = [f for f in files if not f.endswith(".bam")]
        return bams, pafs

    hifi_bam: list[str] = []
    hifi_paf: list[str] = []
    nano_bam: list[str] = []
    nano_paf: list[str] = []
    hifi_refs_lengths: dict[str, int] = {}
    nano_refs_lengths: dict[str, int] = {}
    if hifi is not None:
        hifi_bam, hifi_paf = split_files(hifi)
        for f in hifi_bam:
            refs, lens = read_bam_header(f)
            hifi_refs_lengths = dict(zip(refs, lens))
        if set(hifi_refs_lengths) != set(ref_refs):
            sys.exit(
                "ERROR!!! The targets in hifi alignment files are inconsistent with "
                "the reference file\nPlease check both hifi alignment files and the reference"
            )
    if nano is not None:
        nano_bam, nano_paf = split_files(nano)
        for f in nano_bam:
            refs, lens = read_bam_header(f)
            nano_refs_lengths = dict(zip(refs, lens))
        if set(nano_refs_lengths) != set(ref_refs):
            sys.exit(
                "ERROR!!! The targets in ont alignment files are inconsistent with "
                "the reference file\nPlease check both ont alignment files and the reference"
            )

    print("Finding gaps ...")
    gaps_path = emit_gaps_bed(gaps, prefix, directory, force)
    if gaps_path is not None:
        print(f"Finding gaps done!!! The gaps are in {gaps_path}\n\n")
    else:
        print("Finding gaps done!!! Awesome! No gaps were found!\n\n")

    common = dict(
        map_qual=map_qual,
        mq_cutoff=mq_cutoff,
        iden_percent=iden_percent,
        clip_percent=clip_percent,
        ovlp_percent=ovlp_percent,
        flank_len=flank_len,
        directory=directory,
        force=force,
        chrs_list=chrs_list,
        threads=threads,
        depth_backend=depth_backend,
        mesh=mesh,
        gaps=gaps,
        threshold=threshold,
    )

    if nano is None or hifi is None:
        files_bam = hifi_bam if nano is None else nano_bam
        files_paf = hifi_paf if nano is None else nano_paf
        rt = "HiFi" if nano is None else "ONT"
        type_label = "HiFi" if nano is None else "Nano"
        depths, targets_length = run_filter(
            files_paf, files_bam, prefix, log_reads_type=rt, **common
        )
        depths = mask_gaps_in_depths(depths, gaps)
        merged_bed = emit_issue_bed(
            depths, prefix, threshold, flank_len, directory, force, rt
        )
        compute_continuity_report(
            targets_length, prefix, directory, force, [merged_bed], [type_label],
            flank_len, dist_percent, regions_bed,
            [_host_view(depths) if regions_bed else depths], threshold, chrs_list,
        )
        if plot:
            from gci_tpu.parallel.distributed import is_primary_host
            from gci_tpu.viz.plot import plot_depth_files

            # host views first: the to_events readback is a collective every
            # process must join; only the primary host renders files
            host_depths = [_host_view(depths)]
            if is_primary_host():
                plot_depth_files(
                    host_depths, depth_min, depth_max, window_size,
                    image_type, directory, prefix, force, targets_length,
                    dist_percent, regions_bed, threshold,
                )
    else:
        if set(hifi_refs_lengths) != set(nano_refs_lengths):
            sys.exit(
                "ERROR!!! The targets in hifi and nano alignment files are "
                "inconsistent\nPlease check the reference used in mapping both hifi and ont reads"
            )
        for target, length in hifi_refs_lengths.items():
            if length != nano_refs_lengths[target]:
                sys.exit(
                    f'ERROR!!! The element "{target}:{length}" in hifi alignment files are '
                    f'inconsistent with that in ont alignment files which is '
                    f'"{target}:{nano_refs_lengths[target]}"\nPlease check the reference used '
                    "in mapping both hifi and ont reads"
                )
        hifi_depths, targets_length = run_filter(
            hifi_paf, hifi_bam, prefix + "_hifi", log_reads_type="HiFi", **common
        )
        hifi_depths = mask_gaps_in_depths(hifi_depths, gaps)
        nano_depths, targets_length = run_filter(
            nano_paf, nano_bam, prefix + "_nano", log_reads_type="ONT", **common
        )
        nano_depths = mask_gaps_in_depths(nano_depths, gaps)
        two_type = merge_two_type_depths(
            hifi_depths, nano_depths, prefix + "_two_type", directory, force
        )
        two_type = mask_gaps_in_depths(two_type, gaps)

        hifi_bed = emit_issue_bed(
            hifi_depths, prefix + "_hifi", threshold, flank_len, directory, force, "HiFi"
        )
        nano_bed = emit_issue_bed(
            nano_depths, prefix + "_nano", threshold, flank_len, directory, force, "ONT"
        )
        two_bed = emit_issue_bed(
            two_type, prefix + "_two_type", threshold, flank_len, directory, force, "two_types"
        )
        depths_for_report = (
            [_host_view(hifi_depths), _host_view(nano_depths), _host_view(two_type)]
            if regions_bed
            else [hifi_depths, nano_depths, two_type]
        )
        compute_continuity_report(
            targets_length, prefix, directory, force,
            [hifi_bed, nano_bed, two_bed], ["HiFi", "Nano", "HiFi + Nano"],
            flank_len, dist_percent, regions_bed,
            depths_for_report, threshold, chrs_list,
        )
        if plot:
            from gci_tpu.parallel.distributed import is_primary_host
            from gci_tpu.viz.plot import plot_depth_files

            host_depths = [_host_view(hifi_depths), _host_view(nano_depths)]
            if is_primary_host():
                plot_depth_files(
                    host_depths, depth_min, depth_max, window_size,
                    image_type, directory, prefix, force, targets_length,
                    dist_percent, regions_bed, threshold,
                )

    print("GCI finished!!!\nBye!!!")
