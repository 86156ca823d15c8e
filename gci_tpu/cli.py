"""Main CLI — flag surface of the reference driver (GCI.py:1031-1113).

Identical flags, defaults, validation messages and startup argument echo,
plus device extensions (``--device``, ``--threads`` meaning host packer
threads).
"""
from __future__ import annotations

import argparse
import os
import sys

VERSION = "GCI-TPU version 0.1.0 (gci_tpu)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=sys.argv[0],
        add_help=False,
        formatter_class=argparse.RawTextHelpFormatter,
        description="A GPU-accelerated program for assessing the T2T genome",
        epilog=(
            "Examples:\ngci -r ref.fa --hifi hifi.bam hifi.paf ... "
            "--nano nano.bam nano.paf ..."
        ),
    )
    group_io = parser.add_argument_group("Input/Output")
    group_io.add_argument("-r", "--reference", metavar="FILE", help="The reference file")
    group_io.add_argument(
        "--hifi", nargs="+", metavar="",
        help="PacBio HiFi reads alignment files (at least one bam file)",
    )
    group_io.add_argument(
        "--nano", nargs="+", metavar="",
        help="Oxford Nanopore long reads alignment files (at least one bam file)",
    )
    group_io.add_argument("--chrs", metavar="", help="A list of chromosomes separated by comma")
    group_io.add_argument(
        "-R", "--regions", metavar="FILE",
        help="Bed file containing regions\nBe cautious! If both specify `--chrs` and "
        "`--regions`, chromosomes in regions bed file should be included in the chromosomes list",
    )
    group_io.add_argument(
        "-ts", "--threshold", metavar="INT", type=int, default=0,
        help="The threshold of depth to be reported as issues [0]",
    )
    group_io.add_argument(
        "-dp", "--dist-percent", metavar="FLOAT", type=float, default=0.005,
        help="The distance between the candidate gap intervals for combining in "
        "chromosome units [0.005]",
    )
    group_io.add_argument(
        "-t", "--threads", metavar="INT", type=int, default=1,
        help="Number of host packer threads [1]",
    )
    group_io.add_argument(
        "-d", dest="directory", metavar="PATH", default=".",
        help="The directory of output files [.]",
    )
    group_io.add_argument(
        "-o", "--output", dest="prefix", metavar="STR", default="GCI",
        help="Prefix of output files [GCI]",
    )

    group_fo = parser.add_argument_group("Filter Options")
    group_fo.add_argument(
        "-mq", "--map-qual", metavar="INT", type=int, default=30,
        help="Minium mapping quality for alignments [30]",
    )
    group_fo.add_argument(
        "--mq-cutoff", metavar="INT", type=int, default=50,
        help="The cutoff of mapping quality for keeping the alignment [50]\n"
        "(only used when inputting more than one alignment files)",
    )
    group_fo.add_argument(
        "-ip", "--iden-percent", metavar="FLOAT", type=float, default=0.9,
        help="Minimum identity (num_match_res/len_aln) of alignments [0.9]",
    )
    group_fo.add_argument(
        "-op", "--ovlp-percent", metavar="FLOAT", type=float, default=0.9,
        help="Minimum overlapping percentage of the same read alignment if "
        "inputting more than one alignment files [0.9]",
    )
    group_fo.add_argument(
        "-cp", "--clip-percent", metavar="FLOAT", type=float, default=0.1,
        help="Maximum clipped percentage of the alignment [0.1]",
    )
    group_fo.add_argument(
        "-fl", "--flank-len", metavar="INT", type=int, default=15,
        help="The flanking length of the clipped bases [15]",
    )

    group_po = parser.add_argument_group("Plot Options")
    group_po.add_argument(
        "-p", "--plot", action="store_const", const=True, default=False,
        help="Visualize the finally filtered whole genome (and regions if "
        "providing the option `-R`) depth [False]",
    )
    group_po.add_argument(
        "-dmin", "--depth-min", metavar="FLOAT", type=float, default=0.1,
        help="Minimum depth in folds of mean coverage for plotting [0.1]",
    )
    group_po.add_argument(
        "-dmax", "--depth-max", metavar="FLOAT", type=float, default=4.0,
        help="Maximum depth in folds of mean coverage for plotting [4.0]",
    )
    group_po.add_argument(
        "-ws", "--window-size", metavar="INT", type=int, default=50000,
        help="The window size when plotting [50000]",
    )
    group_po.add_argument(
        "-it", "--image-type", metavar="STR", default="png",
        help="The format of the output images: png or pdf [png]",
    )

    group_dev = parser.add_argument_group("Device/Runtime Options")
    group_dev.add_argument(
        "--device", dest="depth_backend", metavar="STR",
        choices=["auto", "device", "numpy", "events", "sharded", "streamed"],
        default="auto",
        help="Per-base depth backend: auto (device on a GPU or other "
        "accelerator, else events), device (one GPU, fused scan kernel; "
        "streams in chunks past the card's memory), numpy, events "
        "(O(reads) event-space — no per-base arrays; host only, identical "
        "outputs), sharded (several GPUs: genome axis sharded over a device "
        "mesh), or streamed (chunked device scan) [auto]",
    )
    group_dev.add_argument(
        "--mesh", metavar="DP,GP", default=None,
        help="Device mesh for the sharded backend as 'dp,gp' (data-parallel "
        "reads x genome-axis shards), or 'auto' to span all local devices; "
        "implies --device sharded [None]",
    )
    group_dev.add_argument(
        "--coordinator", metavar="HOST:PORT", default=None,
        help="Multi-host runs: jax.distributed coordinator address (launch "
        "one process per host with --num-processes/--process-id; process 0 "
        "writes the outputs). Unset: single-process, or auto-detected from "
        "the cluster environment [None]",
    )
    group_dev.add_argument(
        "--num-processes", metavar="INT", type=int, default=None,
        help="Multi-host runs: total number of processes [None]",
    )
    group_dev.add_argument(
        "--process-id", metavar="INT", type=int, default=None,
        help="Multi-host runs: this process's index [None]",
    )
    group_dev.add_argument(
        "--profile", action="store_const", const=True, default=False,
        help="Print per-stage wall-clock/throughput metrics at the end [False]",
    )
    group_dev.add_argument(
        "--profile-trace", metavar="DIR", default=None,
        help="Write a JAX profiler trace of the run to DIR",
    )

    group_op = parser.add_argument_group("Other Options")
    group_op.add_argument(
        "-f", "--force", action="store_const", const=True, default=False,
        help="Force rewriting of existing files [False]",
    )
    group_op.add_argument("-h", "--help", action="help", help="Show this help message and exit")
    group_op.add_argument(
        "-v", "--version", action="version", version=VERSION,
        help="Show program's version number and exit",
    )
    return parser


def validate_args(args: dict) -> None:
    """Reference pre-run validation (GCI.py:1076-1110)."""
    if args["hifi"] is None and args["nano"] is None:
        sys.exit(
            "ERROR!!! Please input at least one type of TGS reads alignment files "
            "(PacBio HiFi and/or Oxford Nanopore long reads)\n"
            'Please read the help message use "-h" or "--help"'
        )
    for key, label in (("hifi", "PacBio HiFi reads"), ("nano", "Oxford Nanopore long reads")):
        if args[key] is not None:
            bam_num = 0
            for file in args[key]:
                if os.path.exists(file) and os.access(file, os.R_OK):
                    if file.endswith(".bam"):
                        bam_num += 1
                else:
                    sys.exit(f'ERROR!!! "{file}" is not an available file')
            if bam_num == 0:
                sys.exit(
                    f"ERROR!!! Please input at least one {label} bam file\n"
                    'Please read the help message use "-h" or "--help"'
                )
    if args["reference"] is None:
        sys.exit(
            "ERROR!!! Please input the reference file\n"
            'Please read the help message use "-h" or "--help"'
        )
    if not (os.path.exists(args["reference"]) and os.access(args["reference"], os.R_OK)):
        sys.exit(f'ERROR!!! "{args["reference"]}" is not an available file')
    if args["map_qual"] > args["mq_cutoff"]:
        print(
            f'WARNING!!! The minium mapping quality ({args["map_qual"]}) is higher '
            f'than the cutoff ({args["mq_cutoff"]}), which means that wouldn\'t '
            'filter any reads\nPlease read the help message use "-h" or "--help"',
            file=sys.stderr,
        )


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    if len(sys.argv) == 1 and argv is None:
        parser.print_help()
        sys.exit()
    validate_args(args)
    if args["mesh"] is not None and args["depth_backend"] != "sharded":
        args["depth_backend"] = "sharded"

    from gci_tpu.parallel.distributed import init_multihost

    init_multihost(
        coordinator_address=args.pop("coordinator"),
        num_processes=args.pop("num_processes"),
        process_id=args.pop("process_id"),
    )
    print(f"Used arguments:{args}")

    from gci_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()

    from gci_tpu.pipeline import run_gci

    run_gci(**args)


if __name__ == "__main__":
    main()
