"""Command-line interface of the port: the subcommands of
turingassembler_tpu/cli.py (upstream src/main.c:426-503), every one of
them, with their options and printed lines, plus `--device`.

    python -m turingassembler_tpu_torch basic -1 R1.fq -2 R2.fq -k0 45 \\
        -mc 2 -o out --device cuda
    python -m turingassembler_tpu_torch build_2_3 \\
        -i out/graph_k_45_level_2.bin -o out
    python -m turingassembler_tpu_torch build_barcode -l sorted \\
        -1 out/R1.sorted.fq -2 out/R2.sorted.fq -I out/barcode.idx \\
        -i out/graph_k_45_level_3.bin -o out
    python -m turingassembler_tpu_torch build_3_4 \\
        -i out/graph_k_45_added_barcode.bin -o out
    python -m turingassembler_tpu_torch build_4_5 \\
        -i out/graph_k_45_level_4.bin -o out
    python -m turingassembler_tpu_torch sort_read -1 R1.fq -2 R2.fq \\
        -I I1.fq -l ust -o out
    python -m turingassembler_tpu_torch debug_current -l sorted \\
        -1 out/R1.sorted.fq -2 out/R2.sorted.fq -I out/barcode.idx \\
        -i out/graph_k_45_level_2.bin -o out
    python -m turingassembler_tpu_torch assembly3 -1 R1.fq -2 R2.fq \\
        -I I1.fq -l ust -k0 45 -mc 2 -o out
    python -m turingassembler_tpu_torch evaluate \\
        -f out/scaffold.full.fasta -ref truth.fasta

Options: `-1/-2/-I` file lists, `-l` library type, `-k0` global k, `-lk`
local k, `-o` output dir, `-i` graph .bin, `-f` fasta, `-lc` scaffold
contig fasta, `-ref` truth fasta (`evaluate`), `-t` threads, `-sm`
sort memory GB, `-mc` minimum (k+1)-mer count, `-v` verbosity,
`-metagenomics`, `--dist-coordinator host:port --dist-nproc N
--dist-pid r` (one process of an N-process run; torchrun's environment
does the same without them).  `--device cuda` (the default) raises when
no GPU is visible; in an N-process run rank r takes cuda:{r % GPUs}.
The stage commands that read a sorted archive take it as `-l
sorted -1 R1.sorted.fq -2 R2.sorted.fq -I barcode.idx`; `local_assembly`
(alias `build_bridge`) reads local_assembly_scaffold_path.txt from `-o`.
The graph-file commands (`build_2_3`, `build_3_4`, `build_4_5`, the
`resolve_*` passes, `dirty`, `bin2text`) run on the host; `mm_index`,
`barcode_hit`, `build_barcode_fasta` and `build_barcode_fastg` build
the minimizer index or map reads on `--device`.
A command's return value, when it gives one, is the exit code.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import torch

from .config import LIB_TYPE_NAMES, Config
from .device import resolve_device
from .logging_utils import init_logger, set_log_stage
from .ops.hostmem import tune_host_malloc
from .parallel.distributed import init_distributed, rank_device


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-1", dest="files_1", nargs="+", default=[], help="forward reads")
    p.add_argument("-2", dest="files_2", nargs="+", default=[], help="reverse reads")
    p.add_argument("-I", dest="files_I", nargs="+", default=[], help="index (barcode) reads")
    p.add_argument("-l", dest="lib_type", choices=list(LIB_TYPE_NAMES), default="ust")
    p.add_argument("-k0", dest="k0", type=int, default=45)
    p.add_argument("-lk", dest="lk", type=int, default=31)
    p.add_argument("-o", dest="out_dir", default=".")
    p.add_argument("-i", dest="in_file", default=None, help="input graph .bin")
    p.add_argument("-f", dest="in_fasta", default=None, help="input fasta")
    p.add_argument("-lc", dest="in_contig_file", default=None,
                   help="scaffold contig fasta")
    p.add_argument("-ref", dest="ref_fasta", default=None,
                   help="truth genome fasta (evaluate)")
    p.add_argument("-t", dest="n_threads", type=int, default=4)
    p.add_argument("-sm", dest="mmem_gb", type=int, default=32)
    p.add_argument("-mc", dest="min_kmer_count", type=int, default=1,
                   help="drop (k+1)-mers below this count")
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("-metagenomics", dest="metagenomics", action="store_true")
    # multi-process launch: every rank runs the same command with its own
    # --dist-pid; the heavy stages stripe over the ranks and merge on
    # rank 0 (pipeline.py), which writes the final output
    p.add_argument("--dist-coordinator", dest="dist_coordinator",
                   default=None, help="host:port of rank 0")
    p.add_argument("--dist-nproc", dest="dist_nproc", type=int, default=None)
    p.add_argument("--dist-pid", dest="dist_pid", type=int, default=None)
    p.add_argument("--device", dest="device", default="cuda",
                   help="cuda (default) or cpu")


def _cfg_from_args(a) -> Config:
    cfg = Config(
        n_threads=a.n_threads, k0=a.k0, lk=a.lk, out_dir=a.out_dir,
        mmem_gb=a.mmem_gb, lib_type=LIB_TYPE_NAMES[a.lib_type],
        metagenomics=a.metagenomics,
        files_1=tuple(a.files_1), files_2=tuple(a.files_2),
        files_I=tuple(a.files_I), in_file=a.in_file, in_fasta=a.in_fasta,
        in_contig_file=a.in_contig_file, ref_fasta=a.ref_fasta)
    return cfg.replace(device=dataclasses.replace(
        cfg.device, min_kmer_count=a.min_kmer_count))


def cmd_assembly3(cfg: Config, device):
    """FASTQ files -> scaffold.full.fasta (pipeline.assembly3)."""
    from .pipeline import assembly3
    set_log_stage("assembly3")
    assembly3(cfg, device=device)


def cmd_local_assembly(cfg: Config, device):
    """Per-gap local assembly of the scaffold paths in -o
    (local_assembly_scaffold_path.txt) over the aux-info graph -i and
    the sorted archive -> scaffold.full.fasta."""
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .localasm.bridge import build_bridge
    set_log_stage("local_assembly")
    g = asmg.load_graph(cfg.in_file)
    scaf = os.path.join(cfg.out_dir, "local_assembly_scaffold_path.txt")
    print(build_bridge(cfg, g, ReadPath.from_sorted(cfg), scaf,
                       device=device))


def cmd_evaluate(cfg: Config, device):
    """QUAST-style quality report for an assembly against a known truth
    genome: NGA50, aligned blocks, misassemblies, genome fraction per
    truth record, mismatches and indels per 100 kbp (the metrics of
    upstream's published result).  Exit code 1 when there is a
    misassembly, 2 without -f and -ref."""
    from .evaluate import evaluate_assembly
    from .io.fasta import read_fasta
    if not cfg.in_fasta or not cfg.ref_fasta:
        print("evaluate needs -f assembly.fasta and -ref truth.fasta",
              file=sys.stderr)
        return 2
    contigs = [s for _, s in read_fasta(cfg.in_fasta)]
    total = sum(len(c) for c in contigs)
    print(f"assembly: {len(contigs)} contigs, {total:,} bp "
          f"(largest {max(map(len, contigs), default=0):,})")
    # one combined anchor index over ALL truth records: a contig joining
    # two records is a translocation and must count as a misassembly
    records = list(read_fasta(cfg.ref_fasta))
    res = evaluate_assembly(contigs, records)
    print(f"truth: {len(records)} records, "
          f"{sum(len(g) for _, g in records):,} bp")
    print(res)
    for name, frac in res.record_fraction:
        print(f"  {name}: fraction {frac:.3f}")
    return 0 if res.n_misassemblies == 0 else 1


def cmd_basic(cfg: Config, device):
    """Graph-only pipeline: build_0 + build_0_1 + build_1_2."""
    from .pipeline import assembly_basic
    set_log_stage("basic")
    assembly_basic(cfg, device=device)


def cmd_build_0(cfg: Config, device):
    from .pipeline import build_0
    set_log_stage("build_0")
    build_0(cfg, device=device)


def cmd_build_0_1(cfg: Config, device):
    from .pipeline import build_0_1
    set_log_stage("build_0_1")
    build_0_1(cfg, device=device)


def cmd_build_1_2(cfg: Config, device):
    from .pipeline import build_1_2
    set_log_stage("build_1_2")
    build_1_2(cfg)


def cmd_sort_read(cfg: Config, device):
    from .barcode.sort_read import sort_reads
    set_log_stage("sort_read")
    sort_reads(cfg)


def cmd_get_rp_count(cfg: Config, device):
    """Dump read-pair edge-pair counts (upstream get_rp_count cmd)."""
    from .barcode.builder import get_read_pair_counts
    from .barcode.sort_read import ReadPath
    from .io import asmg
    set_log_stage("get_rp_count")
    g = asmg.load_graph(cfg.in_file)
    counts = get_read_pair_counts(cfg, g, ReadPath.from_sorted(cfg),
                                  device=device)
    out = os.path.join(cfg.out_dir, "readpair_counts.txt")
    with open(out, "w") as fp:
        for (e1, e2), c in sorted(counts.items()):
            fp.write(f"{e1} {e2} {c}\n")
    print(out)


def cmd_debug_current(cfg: Config, device):
    """Read-pair greedy extension dump (upstream debug_current ->
    get_long_contigs_by_readpairs, src/read_pairs_resolve.c:298-393):
    counts read pairs over the graph, extends long well-covered edges,
    writes graph_k_<k>_extend.fasta."""
    from .barcode.builder import get_read_pair_counts
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .pipeline import graph_path
    from .resolve.readpairs import get_long_contigs_by_readpairs
    set_log_stage("debug_current")
    g = asmg.load_graph(cfg.in_file)
    rp_counts = get_read_pair_counts(cfg, g, ReadPath.from_sorted(cfg),
                                     device=device)
    out = graph_path(cfg.out_dir, g.ksize, "extend", "fasta")
    print(get_long_contigs_by_readpairs(g, rp_counts, out))


def cmd_build_coverage(cfg: Config, device):
    """k=31 coverage recount (upstream build_coverage_process)."""
    from .io import asmg
    from .kmer.coverage import recount_coverage_from_batches
    from .pipeline import _genomic_batches, graph_path
    set_log_stage("build_coverage")
    g = asmg.load_graph(cfg.in_file)
    g = recount_coverage_from_batches(g, _genomic_batches(cfg),
                                      device=device)
    asmg.save_graph(g, graph_path(cfg.out_dir, g.ksize, "recount"))


def cmd_build_barcode(cfg: Config, device):
    from .barcode.builder import construct_aux_info
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .pipeline import graph_path
    set_log_stage("build_barcode")
    g = asmg.load_graph(cfg.in_file)
    g = construct_aux_info(cfg, g, ReadPath.from_sorted(cfg), device=device)
    asmg.save_graph(g, graph_path(cfg.out_dir, g.ksize, "added_barcode"))


def cmd_build_barcode_coverage(cfg: Config, device):
    """k=31 coverage recount, then barcode aux info (upstream
    build_barcode_coverage -> build_barcode_read, src/process.c:256-264)."""
    from .barcode.builder import construct_aux_info
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .kmer.coverage import recount_coverage_from_batches
    from .pipeline import _genomic_batches, graph_path
    set_log_stage("build_barcode_coverage")
    g = asmg.load_graph(cfg.in_file)
    g = recount_coverage_from_batches(g, _genomic_batches(cfg),
                                      device=device)
    g = construct_aux_info(cfg, g, ReadPath.from_sorted(cfg), device=device)
    asmg.save_graph(g, graph_path(cfg.out_dir, g.ksize, "added_barcode"))


def cmd_scaffold(cfg: Config, device):
    from .io import asmg
    from .scaffold.scaffolding import scaffolding
    set_log_stage("scaffold")
    scaffolding(cfg, asmg.load_graph(cfg.in_file), cfg.out_dir)


def cmd_count_bx(cfg: Config, device):
    from .barcode.frequency import count_bx_freq
    set_log_stage("count_bx")
    print(count_bx_freq(cfg))


def cmd_reduce_reads(cfg: Config, device):
    from .barcode.frequency import reduce_reads
    from .graph.from_contigs import graph_from_contigs
    from .io.fasta import read_fasta
    set_log_stage("reduce_reads")
    contigs = graph_from_contigs([s for _, s in read_fasta(cfg.in_fasta)],
                                 cfg.k0)
    for o1, o2 in reduce_reads(cfg, contigs, device=device):
        print(o1, o2)


def cmd_minimizers_hit(cfg: Config, device):
    """All-barcode minimizer sweep -> barcode_hits.csv (upstream
    minimizers_hit -> mm_hit_all_barcodes, src/main.c:492-493)."""
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .scaffold.molecules import hit_all_barcodes
    set_log_stage("minimizers_hit")
    g = asmg.load_graph(cfg.in_file)
    bx_table, _ = hit_all_barcodes(cfg, g, ReadPath.from_sorted(cfg),
                                   device=device)
    out = os.path.join(cfg.out_dir, "barcode_hits.csv")
    with open(out, "w") as fp:
        for bc in sorted(bx_table):
            for e, c in sorted(bx_table[bc].items()):
                fp.write(f"{bc},{e},{c}\n")
    print(out)


def cmd_barcode_graph(cfg: Config, device):
    """Molecule analysis: barcode digraph -> molecules.fasta."""
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .scaffold.molecules import molecule_contigs
    set_log_stage("barcode_graph")
    g = asmg.load_graph(cfg.in_file)
    print(molecule_contigs(cfg, g, ReadPath.from_sorted(cfg), device=device))


def cmd_split_molecules(cfg: Config, device, wanted=None,
                        stage="split_molecules"):
    """Per-barcode molecule report: order each barcode's edge hits (of
    the barcodes in `wanted`, or all) into molecules (upstream
    split_molecules_process, process.c:271-365)."""
    from .barcode.sort_read import ReadPath
    from .io import asmg
    from .scaffold.molecules import hit_all_barcodes, order_molecule_edges
    set_log_stage(stage)
    g = asmg.load_graph(cfg.in_file)
    bx_table, _ = hit_all_barcodes(cfg, g, ReadPath.from_sorted(cfg),
                                   device=device)
    out = os.path.join(cfg.out_dir, "molecules_by_barcode.txt")
    with open(out, "w") as fp:
        for bc in sorted(bx_table if wanted is None
                         else wanted & set(bx_table)):
            for chain in order_molecule_edges(g, sorted(bx_table[bc])):
                fp.write(f"{bc}\n{' '.join(map(str, chain))}\n")
    print(out)


def cmd_debug_split_molecules(cfg: Config, device):
    """split_molecules for the barcodes listed in a frequency file
    (upstream split_molecules_wrapper, src/process.c:271-305: reads
    '<barcode>\\t<count>' lines from -f, caps at 50,000 barcodes)."""
    from .io.fastq import decode_barcode_seq
    wanted = set()
    with open(cfg.in_fasta) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            tok = parts[0]
            wanted.add(int(tok) if tok.isdigit()
                       else decode_barcode_seq(tok.encode()))
            if len(wanted) >= 50000:   # upstream cap, process.c:294
                break
    cmd_split_molecules(cfg, device, wanted, "debug_split_molecules")


def cmd_barcode_hit(cfg: Config, device):
    """One-barcode debug mapping: fetch the barcode's reads, map them
    (unverified) on `device`, report the edges hit (upstream
    smart_load.c:127-225 / barcode_hit cmd).  The barcode sequence is
    -f."""
    import numpy as np
    from .barcode.sort_read import (ReadPath, fetch_reads_by_barcodes,
                                    load_barcode_index, parse_fastq_blob)
    from .io import asmg
    from .io.fastq import NT4, decode_barcode_seq
    from .mapper.minimizers import EdgeMinimizerIndex, map_reads
    set_log_stage("barcode_hit")
    g = asmg.load_graph(cfg.in_file)
    rpath = ReadPath.from_sorted(cfg)
    index = load_barcode_index(rpath.idx_path)
    bc = decode_barcode_seq(cfg.in_fasta.encode())
    blob1, blob2 = fetch_reads_by_barcodes(rpath, index, [bc])
    mm = EdgeMinimizerIndex.build(g, device=device)
    for blob in (blob1, blob2):
        _, seqs, _, _ = parse_fastq_blob(blob)
        if not seqs:
            continue
        L = max(len(s) for s in seqs)
        bases = np.full((len(seqs), L), 255, np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            arr = NT4[np.frombuffer(s, np.uint8)]
            bases[i, : len(arr)] = arr
            lens[i] = len(arr)
        edges, _, _ = map_reads(mm, bases, lens, device=device)
        for e in sorted(set(int(x) for x in edges if x >= 0)):
            n = int((edges == e).sum())
            print(f"edge {e} ({int(g.edge_rc[e])}): {n} reads")


def cmd_mm_index(cfg: Config, device):
    """Minimizer-index statistics of a graph, the index built on `device`
    (upstream mm_index debug cmd; mm_singleton_stats minimizers.c:577)."""
    from .io import asmg
    from .mapper.minimizers import EdgeMinimizerIndex
    set_log_stage("mm_index")
    idx = EdgeMinimizerIndex.build(asmg.load_graph(cfg.in_file),
                                   device=device)
    n = len(idx.keys)
    singles = int((idx.count == 1).sum())
    print(f"minimizers: {n} distinct, {singles} singletons "
          f"({100.0 * singles / max(n, 1):.1f}%), k={idx.k} w={idx.w}")


def cmd_build_barcode_fasta(cfg: Config, device):
    """Build a contig graph from a FASTA and attach barcode aux info
    (upstream build_barcode_process_fasta, src/process.c:787-809:
    load_asm_graph_fasta + longest-edge report + construct_aux_info)."""
    import numpy as np
    from .barcode.builder import construct_aux_info
    from .barcode.sort_read import ReadPath
    from .graph.from_contigs import graph_from_contigs
    from .io import asmg
    from .io.fasta import read_fasta
    from .logging_utils import get_logger
    from .pipeline import graph_path, save_graph_info
    set_log_stage("build_barcode_fasta")
    g = graph_from_contigs([s for _, s in read_fasta(cfg.in_fasta)], cfg.k0)
    lens = g.edge_len()
    if g.n_e:
        le = int(np.argmax(lens))
        get_logger().info("Longest edge %d_%d, length %d",
                          le, int(g.edge_rc[le]), int(lens[le]))
    save_graph_info(g, cfg.out_dir, "from_fasta")
    g = construct_aux_info(cfg, g, ReadPath.from_sorted(cfg), device=device)
    asmg.save_graph(g, graph_path(cfg.out_dir, g.ksize, "added_barcode"))


def cmd_build_barcode_fastg(cfg: Config, device):
    """Load a FASTG graph, attach barcodes, run the n-m simple resolve
    (upstream build_barcode_process_fastg, src/process.c:811-822:
    load_asm_graph_fastg + build_barcode_read + build_3_4 -> level_4)."""
    from .barcode.builder import construct_aux_info
    from .barcode.sort_read import ReadPath
    from .io.fastg import load_fastg
    from .pipeline import save_graph_info
    from .resolve.barcodes import resolve_n_m_simple
    set_log_stage("build_barcode_fastg")
    g = load_fastg(cfg.in_fasta, cfg.k0)
    g = construct_aux_info(cfg, g, ReadPath.from_sorted(cfg), device=device)
    save_graph_info(resolve_n_m_simple(g), cfg.out_dir, "level_4")


def _graph_pass(stage: str, suffix: str, fn):
    """A command that loads the graph -i, runs one host pass over it and
    saves graph_k_<k>_<suffix>.{bin,gfa,fasta} in -o."""
    def cmd(cfg: Config, device):
        from .io import asmg
        from .pipeline import save_graph_info
        set_log_stage(stage)
        save_graph_info(fn(asmg.load_graph(cfg.in_file)), cfg.out_dir,
                        suffix)
    return cmd


def _checked(g):
    """build_2_3 (upstream src/process.c:218-226): the resolve_chain body
    is commented out upstream, so level 3 is a verified copy of level 2."""
    from .graph.invariants import check_graph
    check_graph(g, check_seq=False)
    return g


def _n_m(g):
    """resolve_n_m: barcode n-m simple, then bridges and nodes (upstream
    resolve_n_m_simple / collapse_n_m_bridge entry points)."""
    from .resolve.barcodes import resolve_n_m_bridges, resolve_n_m_simple
    return resolve_n_m_bridges(resolve_n_m_simple(g))


def _n_m_simple(g):
    """build_3_4 (upstream src/process.c:228-236), and build_3_4_nobc
    on a graph that already carries barcodes (:757-765)."""
    from .resolve.barcodes import resolve_n_m_simple
    return resolve_n_m_simple(g)


def _complex(g):
    """build_4_5 (upstream src/process.c:238-246): complex-jungle joins."""
    from .resolve.barcodes import resolve_complex
    return resolve_complex(g)


def _simple_bulges(g):
    """resolve_bulges (upstream src/process.c:430-440)."""
    from .resolve.bulges import resolve_simple_bulges_ite
    return resolve_simple_bulges_ite(g)


def _complex_bulges(g):
    """resolve_complex_bulges (upstream src/process.c:416-424)."""
    from .resolve.bulges import resolve_complex_bulges_ite
    return resolve_complex_bulges_ite(g)


def _local(g):
    """resolve_local (upstream src/process.c:493-514): simple + complex
    bulge passes, then condense."""
    from .graph.condense import asm_condense
    return asm_condense(_complex_bulges(_simple_bulges(g)))


def _212_cov(g):
    """resolve_212_cov (upstream src/process.c:206-210): 2-1-2 repeats
    by coverage, then condense."""
    from .graph.condense import asm_condense
    from .graph.mutable import MutableGraph
    from .resolve.big import resolve_212_by_cov
    mg = MutableGraph.from_asm(g)
    resolve_212_by_cov(mg)
    return asm_condense(mg.to_asm())


def _dump(g):
    """resolve_dump (upstream src/basic_resolve.c:1198-1317): dump-loop
    duplication to its fixpoint, the 2-branch collapse, condense."""
    from .graph.condense import asm_condense
    from .graph.mutable import MutableGraph
    from .logging_utils import get_logger
    from .resolve.basic import resolve_dump_branch, resolve_dump_loop
    mg = MutableGraph.from_asm(g)
    n_loop = 0
    while True:
        r = resolve_dump_loop(mg)
        if not r:
            break
        n_loop += r
    n_branch = resolve_dump_branch(mg)
    get_logger().info("resolve_dump: %d loop(s) duplicated, "
                      "%d branch(es) collapsed", n_loop, n_branch)
    return asm_condense(mg.to_asm())


def cmd_dirty(cfg: Config, device):
    """Load-and-validate (upstream dirty() has an empty body,
    src/scaffolding/scaffolding.c:900-902)."""
    from .graph.invariants import check_graph
    from .io import asmg
    set_log_stage("dirty")
    g = asmg.load_graph(cfg.in_file)
    check_graph(g, check_seq=False)
    print(f"loaded graph: n_v={g.n_v}, n_e={g.n_e}, k={g.ksize}")


def cmd_bin2text(cfg: Config, device):
    """Graph round-trip debug dump, every live edge to <-i>.fasta
    (upstream process.c:31-45)."""
    from .io import asmg
    from .io.fasta import write_fasta_all
    g = asmg.load_graph(cfg.in_file)
    out = cfg.in_file + ".fasta"
    write_fasta_all(g, out)
    print(f"wrote {out} (n_v={g.n_v}, n_e={g.n_e}, k={g.ksize})")


COMMANDS = {"assembly3": cmd_assembly3, "basic": cmd_basic,
            "build_0": cmd_build_0,
            "build_0_1": cmd_build_0_1, "build_1_2": cmd_build_1_2,
            "sort_read": cmd_sort_read, "get_rp_count": cmd_get_rp_count,
            "debug_current": cmd_debug_current,
            "build_coverage": cmd_build_coverage,
            "build_barcode": cmd_build_barcode,
            "build_barcode_coverage": cmd_build_barcode_coverage,
            "scaffold": cmd_scaffold,
            "build_scaffolding_1_2": cmd_scaffold,
            "count_bx": cmd_count_bx, "reduce_reads": cmd_reduce_reads,
            "minimizers_hit": cmd_minimizers_hit,
            "barcode_graph": cmd_barcode_graph,
            "split_molecules": cmd_split_molecules,
            "local_assembly": cmd_local_assembly,
            # upstream dispatches both names to build_bridge_process
            # (src/main.c:458-461)
            "build_bridge": cmd_local_assembly,
            "evaluate": cmd_evaluate,
            # the graph-file passes and the barcode levels 3 -> 4 -> 5
            "build_2_3": _graph_pass("build_2_3", "level_3", _checked),
            "build_3_4": _graph_pass("build_3_4", "level_4", _n_m_simple),
            "build_3_4_nobc": _graph_pass("build_3_4_nobc", "level_4",
                                          _n_m_simple),
            "build_4_5": _graph_pass("build_4_5", "level_5", _complex),
            "resolve_n_m": _graph_pass("resolve_n_m", "n_m_resolved", _n_m),
            "resolve_dump": _graph_pass("resolve_dump", "dump_resolved",
                                        _dump),
            "resolve_bulges": _graph_pass("resolve_bulges",
                                          "bulges_resolved", _simple_bulges),
            "resolve_complex_bulges": _graph_pass(
                "resolve_complex_bulges", "complex_bulges_resolved",
                _complex_bulges),
            "resolve_local": _graph_pass("resolve_local", "level_2", _local),
            "resolve_212_cov": _graph_pass("resolve_212_cov", "212_resolved",
                                           _212_cov),
            "dirty": cmd_dirty, "bin2text": cmd_bin2text,
            # the commands that touch the device
            "mm_index": cmd_mm_index, "barcode_hit": cmd_barcode_hit,
            "build_barcode_fasta": cmd_build_barcode_fasta,
            "build_barcode_fastg": cmd_build_barcode_fastg,
            # upstream's names of the molecule commands
            # (src/main.c:480-481, src/process.c:212-216, :271-305)
            "debug_get_barcode_graph": cmd_barcode_graph,
            "resolve_molecule": cmd_barcode_graph,
            "debug_split_molecules": cmd_debug_split_molecules}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="turingassembler_tpu_torch",
        description="read-cloud genome assembler, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        _add_common(sub.add_parser(name))
    return parser


def main(argv=None) -> int:
    tune_host_malloc()
    argv = argv if argv is not None else sys.argv[1:]
    a = build_parser().parse_args(argv)
    cfg = _cfg_from_args(a)
    device = resolve_device(a.device)
    init_logger(cfg.out_dir, logging.DEBUG if a.verbose else logging.INFO)
    init_distributed(coordinator=a.dist_coordinator,
                     num_processes=a.dist_nproc, process_id=a.dist_pid)
    device = rank_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    try:
        rc = COMMANDS[a.cmd](cfg, device)
    except FileNotFoundError as e:
        print(f"{a.cmd}: file not found: {e}", file=sys.stderr)
        return 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return int(rc) if rc is not None else 0


if __name__ == "__main__":
    raise SystemExit(main())
