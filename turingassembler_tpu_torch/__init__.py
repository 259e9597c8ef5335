"""PyTorch / CUDA port of the turingassembler_tpu main path.

count canonical (k+1)-mers -> level-0 de Bruijn graph -> DP-verified
read->edge map, with the affine-gap alignment DP as a hand-written CUDA
kernel for Hopper (`ops/nw_align.py`, `csrc/nw_align.cu`).  The layout
and function names follow `turingassembler_tpu`, which stays the
reference every output is held against.

Entry points (each takes `device=`, default "cuda"):
  kmer.megasort.count_reads_device
  graph.device_build.build_graph_on_device
  mapper.minimizers.EdgeMinimizerIndex.build / map_reads
  ops.dp.affine_scores
"""
