"""Staged pipeline orchestration (port of turingassembler_tpu/pipeline.py:
graph levels 0-2, the linked-read stages up to the scaffold paths, and
the per-gap local assembly that closes the gaps; in one process or in
several, see below).

Every stage ends by writing `graph_k_<k>_<suffix>.{bin,gfa,fasta}` into
the output directory (upstream save_graph_info, process.c:516-532), so
any stage can be re-run standalone from its input file.

Stage map (upstream assembly3_process, process.c:585-701):
  build_0        FASTQ -> counted (k+1)-mers -> level_0 graph
  build_0_1      level_0 -> basic resolve fixpoint -> level_1
  build_1_2      level_1 -> simple+complex bulges -> level_2
  sort_read      barcode-sorted read archive + barcode.idx
  readpair_extend  read-pair counts -> greedy extension ->
                 graph_k_<k>_extend.fasta -> contig graph, k=31 recount
  build_barcode  map reads, attach per-edge barcode sets
  scaffolding    shared-barcode greedy paths -> scaffolds.fasta
  build_bridge   per-gap local assembly -> scaffold.full.fasta

Count and level-0 build run on `device`; the graph passes are host code
whose one device call is the align-bubble DP (resolve/basic.py).  The
read-pair and barcode stages map the whole sorted library on `device`
with DP verification, and the recount counts 31-mers there; sorting,
extension and scaffolding are host code.  The bridge stage is host code
whose device calls are the local graphs' bubble DP and the path scoring
(localasm/bridge.py); its parts' seconds are in
localasm.bridge.BRIDGE_PROF.  The other stages leave the seconds
of their parts in logging_utils.stage_walls(): "rp_count.*", "extend",
"recount.*", "aux.*".

Multi-process (parallel/distributed.py: the CLI's --dist-* flags or
torchrun's environment): every rank runs the same command on the same
shared out_dir.  The full-library stages stripe over the ranks, each
rank taking every n-th batch: the count (dist/count_rank<r>.npz), the
read-pair-count map (dist/rp_rank<r>.npz), the aux-info map
(dist/aux_rank<r>.npz) and the per-gap local graphs (their caches).
Rank 0 merges the tables in rank order and runs the graph passes, the
sort, the extension, the scaffolding and the bridging between barriers;
its level 0 is the host build with nodes numbered by first appearance,
as the JAX package's multi-process branch builds it.  The other ranks
return None (assembly_basic, build_0) or "" (assembly3).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np

from .barcode.sort_read import ReadPath
from .config import LIB_TYPE_10X, Config
from .graph.build import build_graph_from_kedges
from .graph.condense import asm_condense
from .graph.device_build import build_graph_on_device
from .graph.invariants import check_graph
from .graph.structs import AsmGraph
from .io import asmg
from .io.fasta import write_fasta, write_gfa
from .io.native_loader import read_fastq_batches_native
from .kmer.megasort import count_kedges_megasort_device
from .logging_utils import (add_stage_wall, get_logger, set_log_stage,
                            stage_walls, timed_iter)
from .parallel.distributed import barrier as _dist_barrier
from .parallel.distributed import dist_info as _dist_info


def graph_path(out_dir: str, k: int, suffix: str, ext: str = "bin") -> str:
    return os.path.join(out_dir, f"graph_k_{k}_{suffix}.{ext}")


def _striped(batches, pid: int, n: int):
    """Every n-th batch, from the pid-th: the rank's input stripe."""
    for i, b in enumerate(batches):
        if i % n == pid:
            yield b


def _pair_arrays(d: dict):
    """A dict of (a, b) -> count as arrays, in its order: keys (n, 2)
    int64, counts (n,) int64."""
    return (np.array([[a, b] for a, b in d.keys()], np.int64).reshape(-1, 2),
            np.array(list(d.values()), np.int64))


def _sum_pairs(into: dict, keys: np.ndarray, counts: np.ndarray) -> None:
    """Key-sum arrays of _pair_arrays into a dict, in their order."""
    for (a, b), v in zip(keys, counts):
        key = (int(a), int(b))
        into[key] = into.get(key, 0) + int(v)


def save_graph_info(g: AsmGraph, out_dir: str, suffix: str) -> None:
    """upstream save_graph_info (process.c:516-532): bin + gfa + fasta."""
    os.makedirs(out_dir, exist_ok=True)
    asmg.save_graph(g, graph_path(out_dir, g.ksize, suffix, "bin"))
    write_gfa(g, graph_path(out_dir, g.ksize, suffix, "gfa"))
    write_fasta(g, graph_path(out_dir, g.ksize, suffix, "fasta"))
    get_logger().info("saved graph level '%s': n_v=%d n_e=%d", suffix,
                      g.n_v, g.n_e)


def batch_width(lengths: np.ndarray, lo: int = 64) -> int:
    """A batch's max read length rounded up to a multiple of 8: a
    uniform library yields one width (150 bp -> 152)."""
    m = int(lengths.max()) if len(lengths) else lo
    return max(lo, -(-m // 8) * 8)


def _genomic_batches(cfg: Config, batch_size: int = 4096, pad_to: int = 256):
    """Yield (bases, lengths) batches over all genomic reads (R1 + R2),
    read by the host FASTQ reader (io/native_loader.py).

    10X libraries carry barcode+UMI in the first 23 bp of R1
    (upstream get_barcode_10x, src/sort_read.c:62-79) — trimmed here
    before counting."""
    for i, path in enumerate(list(cfg.files_1) + list(cfg.files_2)):
        is_r1 = i < len(cfg.files_1)
        for bases, lengths, _ in read_fastq_batches_native(
                path, batch_size=batch_size, pad_to=pad_to):
            if cfg.lib_type == LIB_TYPE_10X and is_r1:
                # trim, then re-pad so R1/R2 batch widths stay equal
                bases = np.concatenate(
                    [bases[:, 23:],
                     np.full((len(bases), 23), 255, np.uint8)], axis=1)
                lengths = np.maximum(lengths - 23, 0)
            if len(bases) < batch_size:
                pad = batch_size - len(bases)
                bases = np.concatenate(
                    [bases, np.full((pad, bases.shape[1]), 255, np.uint8)])
                lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
            yield np.ascontiguousarray(
                bases[:, : batch_width(lengths)]), lengths


def build_0(cfg: Config, out_dir: Optional[str] = None,
            device="cuda") -> AsmGraph:
    """FASTQ -> level-0 graph (upstream build_0_KMC process.c:47 ->
    build_initial_graph kmer_build.c:839): count on `device`, then the
    unitig build there too, or on the host when the count spilled."""
    out_dir = out_dir or cfg.out_dir
    k = cfg.k0
    if not (cfg.files_1 or cfg.files_2):
        raise SystemExit("build_0: no input reads (use -1/-2)")
    log = get_logger()
    pid, nproc = _dist_info()
    if nproc > 1:
        return _build_0_ranks(cfg, out_dir, pid, nproc, device)
    parse0 = stage_walls().get("build_0.parse", 0.0)
    t0 = time.perf_counter()
    # -sm drives the counting memory budget (upstream hands it to KMC,
    # src/main.c:234-236): beyond it host-resident count runs go to disk
    host_mb = cfg.device.sort_host_mb
    res = count_kedges_megasort_device(
        timed_iter(_genomic_batches(cfg), "build_0.parse"), k,
        min_count=cfg.device.min_kmer_count,
        device_lanes=cfg.device.sort_device_lanes,
        host_mb=cfg.mmem_gb * 1024 if host_mb is None else host_mb,
        spill_dir=os.path.join(out_dir, "spill"), device=device)
    t1 = time.perf_counter()
    if len(res) == 3:
        uniq_d, counts_d, n_u = res
        log.info("counted %d unique (k+1)-mers in %.1fs (device table)",
                 n_u, t1 - t0)
        g = build_graph_on_device(uniq_d, counts_d, n_u, k, device=device)
    else:                         # the budget forced the table to host
        kedges, counts = res
        log.info("counted %d unique (k+1)-mers in %.1fs (spilled)",
                 len(kedges), t1 - t0)
        # nodes numbered by first appearance, as the JAX package's host
        # build numbers them with its committed C++ library
        g = build_graph_from_kedges(kedges, counts, k, first_seen=True)
    t2 = time.perf_counter()
    log.info("level-0 build in %.1fs: n_v=%d n_e=%d", t2 - t1, g.n_v, g.n_e)
    check_graph(g, check_seq=False)
    save_graph_info(g, out_dir, "level_0")
    t3 = time.perf_counter()
    log.info("check+save in %.1fs", t3 - t2)
    # the count's own time: its wall less the time it waited on the parser
    parse = stage_walls().get("build_0.parse", 0.0) - parse0
    add_stage_wall("build_0.count", t1 - t0 - parse)
    add_stage_wall("build_0.build", t2 - t1)
    add_stage_wall("build_0.check_save", t3 - t2)
    return g


def _build_0_ranks(cfg: Config, out_dir: str, pid: int, nproc: int,
                   device) -> Optional[AsmGraph]:
    """build_0 of a multi-process run: each rank counts its batch stripe
    on its device; rank 0 key-sum merges the runs in rank order, applies
    the minimum count and builds level 0 on the host (None on the other
    ranks)."""
    from .kmer.count import count_kedges_from_batches
    from .ops.sortops import np_merge_count_runs
    log = get_logger()
    k = cfg.k0
    t0 = time.perf_counter()
    dist_dir = os.path.join(out_dir, "dist")
    os.makedirs(dist_dir, exist_ok=True)
    kedges, counts = count_kedges_from_batches(
        _striped(_genomic_batches(cfg), pid, nproc), k, min_count=1,
        device=device)
    np.savez(os.path.join(dist_dir, f"count_rank{pid}.npz"),
             kedges=kedges, counts=counts)
    log.info("rank %d/%d counted %d unique (k+1)-mers in %.1fs",
             pid, nproc, len(kedges), time.perf_counter() - t0)
    _dist_barrier("count_runs")
    if pid != 0:
        return None
    runs = []
    for r in range(nproc):
        z = np.load(os.path.join(dist_dir, f"count_rank{r}.npz"))
        runs.append((z["kedges"], z["counts"].astype(np.int64)))
    kedges, counts = np_merge_count_runs(runs)
    mc = cfg.device.min_kmer_count
    if mc > 1 and len(counts):
        keep = counts >= mc
        kedges, counts = kedges[keep], counts[keep]
    # nodes numbered by first appearance, as the JAX package's host build
    # numbers them with its committed C++ library
    g = build_graph_from_kedges(kedges, counts, k, first_seen=True)
    log.info("merged %d-rank count: %d unique; level-0 n_v=%d n_e=%d",
             nproc, len(kedges), g.n_v, g.n_e)
    check_graph(g, check_seq=False)
    save_graph_info(g, out_dir, "level_0")
    return g


def build_0_1(cfg: Config, g: Optional[AsmGraph] = None,
              out_dir: Optional[str] = None, device="cuda") -> AsmGraph:
    """level_0 -> level_1 via the basic-resolve fixpoint (upstream
    build_0_1 process.c:121 -> resolve_graph_operation)."""
    from .resolve import resolve_graph_operation
    out_dir = out_dir or cfg.out_dir
    if g is None:
        g = asmg.load_graph(graph_path(out_dir, cfg.k0, "level_0"))
    g = resolve_graph_operation(g, log=get_logger().info, device=device)
    check_graph(g, check_seq=False)
    save_graph_info(g, out_dir, "level_1")
    return g


def build_1_2(cfg: Config, g: Optional[AsmGraph] = None,
              out_dir: Optional[str] = None) -> AsmGraph:
    """level_1 -> level_2: simple bulges + complex bulges + condense
    (upstream resolve_local_process process.c:493).  Host code only."""
    from .resolve.bulges import (resolve_complex_bulges_ite,
                                 resolve_simple_bulges_ite)
    out_dir = out_dir or cfg.out_dir
    if g is None:
        g = asmg.load_graph(graph_path(out_dir, cfg.k0, "level_1"))
    g = resolve_simple_bulges_ite(g)
    g = resolve_complex_bulges_ite(g)
    g = asm_condense(g)
    check_graph(g, check_seq=False)
    save_graph_info(g, out_dir, "level_2")
    return g


def assembly_basic(cfg: Config, device="cuda") -> Optional[AsmGraph]:
    """Stages 0-2 (the graph-only part of assembly3).  Multi-process:
    the count stripes over the ranks (build_0); the graph passes run on
    rank 0 while the others wait at the level_2 barrier and return
    None."""
    set_log_stage("build_0")
    g = build_0(cfg, device=device)
    pid, nproc = _dist_info()
    if nproc > 1 and pid != 0:
        _dist_barrier("level_2")
        set_log_stage("done")
        return None
    set_log_stage("build_0_1")
    g = build_0_1(cfg, g, device=device)
    set_log_stage("build_1_2")
    g = build_1_2(cfg, g)
    if nproc > 1:
        _dist_barrier("level_2")
    set_log_stage("done")
    return g


def assembly_to_scaffolds(cfg: Config, extend: bool = True,
                          device="cuda") -> Tuple[AsmGraph, ReadPath, str]:
    """Graph levels 0-2, then the linked-read stages of upstream
    assembly3_process (process.c:585-701) up to the scaffold paths: read
    sort, read-pair counting + greedy extension into
    graph_k_<k>_extend.fasta, reload as a contig graph, k=31 coverage
    recount, barcode aux info (graph_k_<k>_added_barcode.bin),
    scaffolding (scaffolds.fasta, local_assembly_scaffold_path.txt).

    Returns (graph with aux info, sorted read archive, path of the
    scaffold path file): what the per-gap local assembly takes.  In a
    multi-process run the two maps stripe over the ranks and rank 0
    merges their tables; every rank returns the three, the other ranks
    reading rank 0's graph after the scaffolded barrier."""
    from .barcode.builder import (aux_tables_striped, construct_aux_info,
                                  get_read_pair_counts, merge_attach_tables)
    from .barcode.sort_read import sort_reads, verify_read_archive
    from .config import LIB_TYPE_SORTED
    from .parallel.sharded_aux import apply_aux_tables
    from .scaffold.scaffolding import scaffolding as scaffold_stage

    log = get_logger()
    out_dir = cfg.out_dir
    pid, nproc = _dist_info()
    dist_dir = os.path.join(out_dir, "dist")
    g = assembly_basic(cfg, device=device)

    set_log_stage("sort_read")
    if nproc > 1 and pid != 0:
        _dist_barrier("sorted")
        # the archive lives at fixed paths in the shared out_dir
        rpath = (ReadPath.from_sorted(cfg) if cfg.lib_type == LIB_TYPE_SORTED
                 else ReadPath(os.path.join(out_dir, "R1.sorted.fq"),
                               os.path.join(out_dir, "R2.sorted.fq"),
                               os.path.join(out_dir, "barcode.idx")))
        g = asmg.load_graph(graph_path(out_dir, cfg.k0, "level_2"))
    else:
        rpath = sort_reads(cfg)
        log.info("sorted read archive: %s", rpath.idx_path)
        # archive integrity invariant (upstream test_same_barcode,
        # src/barcode_resolve2.c:1554-1588): sampled post-sort check that
        # every indexed span is aligned FASTQ of exactly its barcode
        n_checked = verify_read_archive(rpath, max_barcodes=256)
        log.info("read archive integrity: %d barcodes verified", n_checked)
        if nproc > 1:
            _dist_barrier("sorted")

    if extend and int(g.alive_mask().sum()) > 2:
        from .graph.from_contigs import graph_from_contigs
        from .io.fasta import read_fasta
        from .kmer.coverage import recount_coverage_from_batches
        from .resolve.readpairs import get_long_contigs_by_readpairs

        set_log_stage("readpair_extend")
        if nproc > 1:
            # striped rp-count map, key-sum merged on rank 0 in rank order
            rp_local = get_read_pair_counts(cfg, g, rpath,
                                            stripe=(pid, nproc),
                                            device=device)
            os.makedirs(dist_dir, exist_ok=True)
            keys, vals = _pair_arrays(rp_local)
            np.savez(os.path.join(dist_dir, f"rp_rank{pid}.npz"),
                     k=keys, v=vals)
            _dist_barrier("rp_counts")
            rp_counts = {}
            if pid == 0:
                for r in range(nproc):
                    z = np.load(os.path.join(dist_dir, f"rp_rank{r}.npz"))
                    _sum_pairs(rp_counts, z["k"], z["v"])
        else:
            rp_counts = get_read_pair_counts(cfg, g, rpath, device=device)
        if pid == 0:
            ext_path = graph_path(out_dir, cfg.k0, "extend", "fasta")
            get_long_contigs_by_readpairs(g, rp_counts, ext_path)
            seqs = [s for _, s in read_fasta(ext_path)]
            if seqs:
                g = graph_from_contigs(seqs, cfg.k0)
                g = recount_coverage_from_batches(g, _genomic_batches(cfg),
                                                  device=device)
                check_graph(g, check_seq=False)
            if nproc > 1:
                save_graph_info(g, out_dir, "extend_graph")
        if nproc > 1:
            _dist_barrier("extended")
            if pid != 0:
                g = asmg.load_graph(graph_path(out_dir, cfg.k0,
                                               "extend_graph"))

    set_log_stage("build_barcode")
    if nproc > 1:
        table, cands = aux_tables_striped(cfg, g, rpath, (pid, nproc),
                                          device=device)
        os.makedirs(dist_dir, exist_ok=True)
        ck, cv = _pair_arrays(cands)
        np.savez(os.path.join(dist_dir, f"aux_rank{pid}.npz"),
                 s=table[0], e=table[1], b=table[2], c=table[3], ck=ck, cv=cv)
        _dist_barrier("aux_tables")
        if pid == 0:
            tables, cands_all = [], {}
            for r in range(nproc):
                z = np.load(os.path.join(dist_dir, f"aux_rank{r}.npz"))
                tables.append((z["s"], z["e"], z["b"], z["c"]))
                _sum_pairs(cands_all, z["ck"], z["cv"])
            apply_aux_tables(g, merge_attach_tables(tables), cands_all)
            log.info("aux info merged from %d ranks: %d candidate pairs",
                     nproc, len(cands_all))
    else:
        g = construct_aux_info(cfg, g, rpath, device=device)
    added = graph_path(out_dir, cfg.k0, "added_barcode")
    if pid == 0:
        asmg.save_graph(g, added)

    set_log_stage("scaffolding")
    if pid == 0:
        scaf_path = scaffold_stage(cfg, g, out_dir)
        log.info("scaffold paths: %s", scaf_path)
    else:
        scaf_path = os.path.join(out_dir, "local_assembly_scaffold_path.txt")
    if nproc > 1:
        _dist_barrier("scaffolded")
        if pid != 0:
            # the gaps are mapped on the graph with aux info
            g = asmg.load_graph(added)
    set_log_stage("done")
    return g, rpath, scaf_path


def assembly3(cfg: Config, extend: bool = True, device="cuda") -> str:
    """The whole pipeline (upstream assembly3_process, process.c:585-701):
    assembly_to_scaffolds, then the per-gap local assemblies that bridge
    the scaffold paths' gaps into scaffold.full.fasta.  Returns its path
    ("" on the ranks other than 0 of a multi-process run, which build
    their stripe of the local graphs into the shared caches first)."""
    from .localasm.bridge import build_bridge, prebuild_local_graphs_striped
    g, rpath, scaf_path = assembly_to_scaffolds(cfg, extend, device=device)
    set_log_stage("build_bridge")
    pid, nproc = _dist_info()
    if nproc > 1:
        n_built = prebuild_local_graphs_striped(
            cfg, g, rpath, scaf_path, cfg.out_dir, (pid, nproc),
            device=device)
        get_logger().info("rank %d built %d local gap graphs", pid, n_built)
        _dist_barrier("gaps_prebuilt")
        if pid != 0:
            set_log_stage("done")
            return ""
    final = build_bridge(cfg, g, rpath, scaf_path, device=device)
    get_logger().info("final assembly: %s", final)
    set_log_stage("done")
    return final
