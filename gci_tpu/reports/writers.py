"""Byte-compatible report emitters (issue BED, gaps BED).

* ``emit_issue_bed`` — reference GCI.py:393-419 ``merge_depth``: collapse
  depth <= threshold into intervals and write
  ``{prefix}.{threshold}.depth.bed``.
* ``emit_gaps_bed`` — reference GCI.py:37-44: write gap intervals when any.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from gci_tpu.intervals import collapse_depth_dict
from gci_tpu.io.bed import write_bed_dict


def _require_writable(path: str, force: bool) -> None:
    from gci_tpu.utils.files import require_writable

    require_writable(path, force)


def emit_issue_bed(
    depths: dict[str, np.ndarray],
    prefix: str = "GCI",
    threshold: int = 0,
    flank_len: int = 15,
    directory: str = ".",
    force: bool = False,
    log_reads_type: str = "",
    precomputed: dict[str, list[tuple[int, int]]] | None = None,
) -> dict[str, list[tuple[int, int]]]:
    """Write the issues BED and return the interval dict (GCI.py:393-419).

    ``precomputed`` lets the device pipeline hand over intervals that were
    already extracted on the device (identical semantics), skipping the host
    scan.
    """
    from gci_tpu.parallel.distributed import is_primary_host

    primary = is_primary_host()
    print(f"Getting {log_reads_type} issues bed file detected by GCI ...")
    path = f"{directory}/{prefix}.{threshold}.depth.bed"
    # all processes join (the check broadcasts the primary's decision)
    _require_writable(path, force)
    from gci_tpu.utils import stage

    with stage(f"issue_bed:{prefix}"):
        if precomputed is not None:
            merged = precomputed
        else:
            from gci_tpu.depth.base import ResidentDepth

            if isinstance(depths, ResidentDepth):
                # device path: in-range mask + edge extraction on device
                # (fused-kernel cache or sharded ppermute-stitched edges)
                merged = depths.collapse_dict(-1, threshold, flank_len, 0)
            else:
                merged = collapse_depth_dict(depths, -1, threshold, flank_len, 0)
        if primary:
            write_bed_dict(path, merged)
    print(f"Getting {log_reads_type} issues bed file done!!!\n\n")
    return merged


def emit_gaps_bed(
    gaps: dict[str, list[tuple[int, int]]] | None,
    prefix: str = "GCI",
    directory: str = ".",
    force: bool = False,
) -> str | None:
    """Write {prefix}.gaps.bed when gaps exist; return path or None (GCI.py:37-44)."""
    if not gaps:
        return None
    from gci_tpu.parallel.distributed import is_primary_host

    path = f"{directory}/{prefix}.gaps.bed"
    _require_writable(path, force)
    if is_primary_host():
        write_bed_dict(path, gaps)
    return path
