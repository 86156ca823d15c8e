"""gci_tpu — a genome continuity engine on JAX.

A from-scratch framework with the capabilities of GCI (Genome Continuity
Inspector; Chen et al., Bioinformatics 2024, reference repo yeeus/GCI):
long-read alignments (BAM/PAF) of HiFi / ONT reads mapped back to an assembly
are packed on host into fixed-width coordinate tensors, filtered with
vectorized masks, accumulated into per-base coverage on the GPU via a
difference-array scatter + sharded parallel prefix-sum, scanned for low/zero
depth issue intervals, and scored with the GCI continuity formula — with
byte-compatible ``.depth.gz`` / ``.depth.bed`` / ``.gci`` outputs.

Layout:
  io/        host ingestion + serialization (FASTA, BGZF/BAM, PAF, depth.gz, BED)
  native/    C++ host packer (BGZF inflate, BAM record packing, depth codec)
  filters/   read-level filter cascade, PAF primary-target election, curation
  depth/     device depth accumulation (diff-array scatter + cumsum, Pallas)
  intervals/ run-length interval extraction, distance merge, complement
  score/     N50 + GCI score formula
  parallel/  device mesh helpers, sharded genome-axis collectives
  reports/   byte-compatible report writers
  viz/       depth plotting
  tools/     side-car CLIs (score-only resume, plot-only, BAM filter/export,
             samtools-depth conversion)
"""

__version__ = "0.1.0"
