"""PyTorch / CUDA port of the turingassembler_tpu main path.

count canonical (k+1)-mers -> level-0 de Bruijn graph -> DP-verified
read->edge map, with the affine-gap alignment DP as a hand-written CUDA
kernel for Hopper (`ops/nw_align.py`, `csrc/nw_align.cu`); around it the
staged pipeline from FASTQ files to the level 0-2 graphs and on to the
barcode-sorted archive, the extended contigs, the per-contig barcode
sets and the scaffolds (`pipeline.py`, `cli.py`).  The layout and
function names follow `turingassembler_tpu`, which stays the reference
every output is held against.

Entry points (each takes `device=`, default "cuda"):
  cli.main, pipeline.assembly_basic / assembly_to_scaffolds
  barcode.builder.get_read_pair_counts / construct_aux_info
  kmer.coverage.recount_coverage_from_batches
  kmer.megasort.count_reads_device
  graph.device_build.build_graph_on_device
  mapper.minimizers.EdgeMinimizerIndex.build / map_reads
  ops.dp.affine_scores
"""
