"""Multi-process and multi-shard scale-out (port of
turingassembler_tpu/parallel).

The upstream assembler is single-host pthreads; its k-mer-space
sharding pattern (per-thread KMC prefix ranges, src/KMC_reader.c:287-310)
becomes hash-partitioning the canonical k-mer space over the shards of a
mesh (parallel/mesh.py), exchanged with one all-to-all and counted per
shard with a local sort.  Across processes the exchange is
`torch.distributed.all_to_all_single`; a multi-process `assembly3`
(pipeline.py) stripes its full-library stages over the ranks and merges
their tables on rank 0 through files in the shared output directory.
"""
