"""PyTorch / CUDA port of the turingassembler_tpu main path.

count canonical (k+1)-mers -> level-0 de Bruijn graph -> DP-verified
read->edge map, with the affine-gap alignment DP as a hand-written CUDA
kernel for Hopper (`ops/nw_align.py`, `csrc/nw_align.cu`); around it the
staged pipeline from FASTQ files to the level 0-2 graphs and on to the
barcode-sorted archive, the extended contigs, the per-contig barcode
sets, the scaffolds and the per-gap local assemblies that bridge them
into scaffold.full.fasta (`pipeline.py`, `cli.py`, `localasm/`), the
barcode levels 3 -> 4 -> 5 and the rest of the JAX CLI's commands
(`resolve/barcodes.py`, `resolve/big.py`, `io/fastg.py`), the
assembly's evaluation against a truth genome (`evaluate.py`), and the
secondary exact counters: the device sort and merge (`ops/sortops.py`,
`ops/merge.py`), the hash counter with its CUDA kernel
(`ops/devhash.py`, `csrc/devhash.cu`) behind the `engine=` choice of
`kmer/count.py` and the sharded `ShardedHashCounter`, the span k-mer
table of the 2-1-2 resolver, and KMC database interop (`io/kmc.py`).
The host C++ libraries under `native/` (built by `_build.build_host`)
read FASTQ (`io/native_loader.py`), sort the barcode archive
(`barcode/sort_read.py`), walk unitig chains and number first-seen
nodes (`graph/build.py`) and pack reads (`kmer/count.py`).  The layout
and function names follow `turingassembler_tpu`, which stays the
reference every output is held against.

Entry points (each takes `device=`, default "cuda"):
  cli.main, pipeline.assembly_basic / assembly_to_scaffolds / assembly3
  localasm.bridge.build_bridge / score_paths
  localasm.local.build_local_graph
  kmer.count.count_kedges_from_reads / count_kedges_from_batches
    (engine= "auto" | "megasort" | "hash" | "device" | "np")
  ops.devhash.DeviceHashCounter, parallel.sharded_count.ShardedHashCounter
  resolve.big.SpanKmerTable.build (then resolve_212_pair_kmer_all)
  barcode.builder.get_read_pair_counts / construct_aux_info
  kmer.coverage.recount_coverage_from_batches
  kmer.megasort.count_reads_device
  graph.device_build.build_graph_on_device
  mapper.minimizers.EdgeMinimizerIndex.build / map_reads
  ops.dp.affine_scores
  bench.main (`python -m turingassembler_tpu_torch.bench`, twin of
    bench.py), graft_entry.entry / dryrun_multichip (twin of
    __graft_entry__.py)
Host-only (no device): resolve.barcodes.resolve_n_m_simple /
  resolve_n_m_bridges / resolve_complex, resolve.big.resolve_212_by_cov,
  io.fastg.load_fastg, io.kmc.read_kmc_database / write_kmc_database /
  load_kedges_from_kmc
"""
