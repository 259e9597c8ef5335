"""Drive the PyTorch/CUDA port (turingassembler_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
before printing a result:
  1. device: name, power limit (nvidia-smi), torch and CUDA versions
  2. build: compile every CUDA kernel of the port (nvcc, sm_90a, one
     nvcc a source) and its four host C++ libraries (native/*.cpp: the
     FASTQ reader, the barcode sorter, the graph kernels, the read pack;
     the host compiler, one a source), all started together.  Every
     phase below reads FASTQ, sorts the archive and builds host graphs
     through the host libraries
  3. kernel vs plain: the NW alignment kernel against its plain PyTorch
     version on the card, exact equality: map, ragged and long-query
     shapes, every compiled strip width at and around its tile edge
     (both scorings and modes), and the bubble check's shapes; kernel
     and plain times, G cells/s and the bound at the map shape, kernel
     time at a bubble shape; the map shape also at the small batches
     the scaffolds path gives it
  4. slice parity: a reduced error-laden workload through the port on
     the card and on the CPU; every output identical
 21. mm_map kernel vs plain (run here, before phase 5): the minimizer
     map kernel (csrc/mm_map.cu) against its plain versions on the card,
     exact: its three entries (map_batch, vote and verified with a
     per-read and a scalar threshold; gapless_bound; minimizer_rows) on
     testing.mm_map_cases' edge cases and the gapless bound's alignment
     and pool-end cases (testing.mm_align_cases), with an index the
     kernel built == the CPU's; then phase 5's workload counted and
     built, its index, and each entry at its own bench shape (the first
     65,536 reads, their votes, the index build's first 256 segment
     rows): kernel, plain and bound ms (and the int64 layout's bound);
     map_batch's stage split and its alternatives (key-only and value
     rows; the earlier byte-wise gapless bound) and gapless_bound beside
     the byte-wise bound, scratch copies of the source built beside the
     phase, held equal and timed in turns; the graph pool's first copy
     and its cached lookup; map_reads of the bench reads, wall beside
     device time
 23. kmer_sort kernels vs plain (run here, after phase 21, on its
     workload: the profiler sees the card early in the process), exact:
     the count's kernels (csrc/kmer_sort.cu) against their plain
     versions: sort_count (int64 and int32 rows), merge_runs (the raw
     halves, the LSD route unless both are ascending; their sorted
     tables, the merge path) and lex_order (int64 and int32 rows) on
     testing.kmer_sort_cases, each route case at its route, int64 limbs
     outside [0, 2^32) refused; extract_keys and sort_count of a
     131,072-read record of phase 5's workload at k1 = 46, 31 and 64 (nl
     3, 2, 4), sort_count of the full flush (110,100,480 rows),
     merge_runs of its halves' tables (the merge path), lex_order of the
     level-0 build's fingerprints, each with wrapper, device (profiler),
     plain and bound ms (sort_count beside torch.unique, lex_order beside
     torch.sort of the rows packed into int64; sort_count, merge_runs and
     lex_order each in turns with the LSD form and by kernel); sort_count
     of the yeast cell's shape of buckets over capacity (2,000 of them,
     23 M rows at nl = 4) against the plain version, in turns with the
     host loop over those buckets that the batched route replaced (wall,
     device ms, launches and syncs a call)
 25. unitig_build kernels vs plain (run here, after phase 23, on its
     workload), exact: the level-0 build's kernels
     (csrc/unitig_build.cu) against their plain versions on the card:
     front_keys, link_nodes, rank_chains and assemble_unitigs in the
     build's order on every case of testing.unitig_build_cases (the
     circular case's cycle break and second ranking on the card), and
     each case's whole build card == CPU (the circular one must break its
     cycles on the card); link_nodes on made-up fingerprint collisions
     (testing.link_collision_cases, also with the equal rows shuffled)
     of three cases' and the many-unitig table's fingerprints; then on
     phase 5's workload counted on the card (1,999,953 k-edges, k=45),
     each entry again and its wrapper, device (profiler, device_ms's
     retry), plain and bound ms (assemble_unitigs beside torch.unique of
     the endpoints; link_nodes by kernel, at a many-unitig table too, and
     in turns with other forms of csrc/unitig_build.cu where TA_UB_FORMS
     lists them); the build's split by the
     kernel route and the tensor route (the plain versions swapped in),
     in turns: wall, host syncs (torch's sync debug mode; device_build's
     own at most 3 on the kernel route), device ms by stage, the output
     pulls and rebuild_adjacency
  5. full width: bench.py's workload (2 Mbp genome, 1,048,576 reads of
     150 bp, k=45; the bench twin's make_workload) through the bench
     twin's stages, count -> level-0 build -> minimizer index ->
     DP-verified map, plus 66,560 reads with one mid-read indel; launch
     counts are reset just before and read just after; then one more
     pass under torch.profiler for the device's busy share; then two
     passes and a profiled one with the mapper's plain versions on the
     card (the mm_map wrapper swapped by this script for that window):
     index and map seconds and busy shares before and after the kernel
  6. levels parity: a 100 kbp two-haplotype library from FASTQ files
     through assembly_basic (level 0, 1, 2 graph files) on the card and
     on the CPU, nine files byte-identical; once more with count budgets
     that force runs to disk, on the card and on the CPU: level 0's files
     byte-identical, and its graph isomorphic to the in-memory run's
  7. levels at full width: a 250 kbp two-haplotype library (about 67k
     reads of 150 bp, 0.5% substitutions, k=45, min count 2; the depth
     is cut from 2 Mbp to keep the script short) through the CLI
     function, `basic --device cuda`: stage seconds, the bubble check's
     NW launches, and checks of the three graphs against the haplotypes;
     then the count alone under the profiler on the parsed batches: the
     records of at most 131,072 reads (COUNT_CHUNK) the batches were
     joined into, and the device's busy share
  8. assembly3 parity: the linked-read recipe of phase 9 (segments
     between identical repeat copies, barcoded molecules, an index read),
     cut to 4 segments (3 gaps), through pipeline.assembly3 on the card
     and on the CPU; the sorted archive, the extended contigs, the
     barcode graph, the scaffold files, every local graph cache and
     scaffold.full.fasta byte-identical
  9. assembly3 at full width: the same recipe at 2 Mbp (about 263k pairs
     of 150 bp at 40x, 12 segments, 11 gaps) stage by stage through the
     CLI function: `basic`, `sort_read`, `debug_current` (read-pair
     counts and extension), `build_coverage` (k=31 recount),
     `build_barcode`, `scaffold`, `local_assembly`, each with `--device
     cuda`; stage seconds, the bridge stage's parts and outcomes, the
     device's busy share of the map stages, the recount and the bridge
     stage, NW pairs and launches per stage, checks of the archive, the
     barcode sets and the scaffold paths against the genome, and of the
     final assembly by evaluate_assembly (no misassembly, genome
     fraction, NGA50, every gap bridged)
 10. path scoring: a local graph with two candidate paths (two alleles,
     a 40 bp indel and a substitution every 20 bases apart) and read
     pairs of one allele with the recipe's errors through the bridge's
     score_paths on the card: the allele's path, >= 1 NW launch, and the
     same per-read hits, accepts and scores as on the CPU
 11. barcode levels: on phase 8's 65 kbp outputs, on the card,
     build_2_3, build_barcode on level 3, build_3_4, build_4_5,
     resolve_n_m, resolve_212_cov, build_barcode_fasta,
     build_barcode_fastg, mm_index and barcode_hit, the last four also on
     the CPU (every file byte-identical, the same printed lines; the host
     passes are held against JAX by the tests); then on phase 9's 2 Mbp
     level 2 and sorted archive the level chain build_2_3 ->
     build_barcode -> build_3_4 -> build_4_5 with `--device cuda`: stage
     seconds, the aux map's parts, device busy, NW launches, reads
     mapped, live edges and N50 a level, and the level-4 and level-5
     contigs against the genome;
     it raises unless the aux map launched the kernel, >= 95% of reads
     mapped, every level passes check_graph and level 4 has no more live
     edges than level 3
 13. multi-process (run after phase 11, before the replay of phase 12,
     which holds its shapes too): (a) `assembly3 --device cuda` through
     the CLI as two ranks on cuda:0 under the Gloo control group, on
     phase 8's library, beside the same two ranks on the CPU: both ranks
     exit 0 and write their dist/ tables, every file card == CPU, level
     0's contigs equal to phase 8's single-process run (other node
     numbers) and both final assemblies correct on the genome; (b) two
     ranks' stripes of phase 9's read-pair-count and aux-info maps on
     the card (its 2 Mbp level 2, recount graph and 263,049-pair
     archive: 3 batches, 2 on rank 0, 1 on rank 1), merged on rank 0:
     phase 9's extend.fasta byte for byte, its barcode sets, and the
     read-pair candidates (not in the .bin) of a single-process
     construct_aux_info run beside the ranks, as dicts; a cross-process
     mesh on the shared card must refuse; (c) 4 shards on cuda:0 at the
     bench widths (262,144 reads of 150 bp, k=45): the sharded count ==
     the single count with none dropped, the sharded verified map ==
     map_reads.  Each rank prints its seconds and its NW launches; the
     ranks' launches and (c)'s join the kernels line's count, and the
     card ranks' mm_map launches (each rank reports its own).  The ranks
     are this script again: `chip_smoke.py --rank <spec>`
 14. secondary engines (after phase 13): (a) the devhash kernel
     (csrc/devhash.cu): its own hashes (the check entry) == hashes() bit
     for bit on the bench batch's 876,544 lanes and on random keys at
     every nl 1-8; then its rows entry (keys) and its reads entry (codes:
     extraction and insert in one launch) against the plain version on
     the card: the bench batch (8,192 reads, k=45, 860,160 valid lanes)
     into 2^25 slots fresh and as the 7th batch, when most lanes hit;
     860,160 lanes on 64 keys; then equal finalized tables with 0
     overflow in both.  At 0.7 load (734,003 keys into 2^20 slots) both
     overflow (8 probes), so each is held against the exact count of the
     keys it holds; 1,000 keys into 64 slots raise in both.  At the bench
     batch the rows insert's ms (wrapper + launch, the kernels line's
     `ms`), the launch alone (`kernel_ms`), the plain insert's,
     torch.unique's (yardstick) and the insert's bytes bound; the reads
     entry's ms and bound, and extraction in tensor code + the rows
     insert (`unfused_ms`); (b) the hash engine (one reads-entry launch a
     batch) on phase 5's 1,048,576 reads == phase 5's count, beside
     megasort's seconds; (c) the device and np engines on phase 13 (c)'s
     262,144 reads == megasort; (d)
     ShardedHashCounter on 4 shards of cuda:0 over those reads == the
     single count, one rows-entry launch a shard and batch, and then its
     first batch again into fresh kernel and plain shard tables, held
     equal shard by shard; (e) the span k-mer table
     and resolve_212_pair_kmer_all on the 2-1-2 library card == CPU (the
     table, the .bin, the FASTA), and a card table of the 262,144 reads
     whose total count is their number of valid 111-windows; (f) phase
     5's k-edges through a KMC database and back.  The devhash launches
     of (d) (rows entry) and (b) (reads entry) are the kernels line's
     counts of `devhash` and `devhash_count_reads`
 15. host twins (after phase 13, on its files): each host library
     against its plain version on this host, with both times: (a) the
     FASTQ reader on phase 9's R1 and R2 in the archive maps' batches
     (bases, lengths, headers == the Python reader's) and a .gz copy of
     R1; (b) the sorter on phase 9's library under a budget of a fifth
     of its records' bytes (at least 4 spilled runs, as the sorter
     counts them, merged) == phase 9's
     archive byte for byte, and on phase 8's library == the Python loop;
     (c) the level-0 host build of phase 5's 1,999,953 k-edges through
     the graph kernels == through their numpy versions, array for array,
     and each kernel alone; (d) the read pack of phase 5's first 131,072
     reads == numpy, unpacked on the card == the codes, timed beside the
     plain copy of the codes (pageable and pinned); (e) (c)'s build twice
     in a fresh process with tune_host_malloc and in one without
 16. E. coli scale (after phase 14): the E. coli twin
     (turingassembler_tpu_torch/tools/ecoli_scale.py) at its defaults, in
     this process: a 4.6 Mbp genome with 7x900 bp and 4x700 bp repeat
     families, 715,000 barcoded pairs of 120 bp, `assembly3 --device
     cuda`, then evaluate_assembly; it raises unless assembly3 returns 0
     and the twin's quality gates hold (no misassembly, genome fraction
     >= 0.99, NGA50 >= 0.9 x genome, at most 5.65 mismatches and 0.47
     indels per 100 kbp).  Stage seconds by name, the bridge stage's
     parts, NW launches, peak device memory and RSS, and the quality
     beside the JAX tool's record (ECOLI_r05.json, quality only)
 17. spill scale: the spill twin (tools/spill_scale.py) at 1,000,000
     pairs, the sorter under 32 MB (at least 4 spilled runs, as the
     sorter counts them), the
     archive verified on 512 barcodes and 32 content-exact, and
     1,000,000 reads counted on the card in memory and under a device
     budget of a fifth of their unique (k+1)-mers: host and disk runs
     counted, tables equal; then the same reads in memory in flush
     windows of a fifth of their rows, each window's table merged into
     the running one (merge_runs): the same table
 18. the bench twin as users run it: `python -m
     turingassembler_tpu_torch.bench` in a subprocess at its defaults
     (phase 5's workload; best of 5 count + build passes and of 3 map
     passes, the twin's own output checks); exit 0 and one JSON line
     with bench.py's keys, the card and the NW counts; its value,
     passes, weather and NW launches and pairs beside phase 5's reads/s;
     the NW launches of all its map passes join the kernels line, their
     shapes phase 12; its mm_map launches (its `mm_map shapes:` line)
     join the kernels line, their shapes phase 22; the graph's device
     pool is not made again in its timed map passes (its `pool rebuilt`
     line)
 19. the graft twin (turingassembler_tpu_torch/graft_entry.py): entry()'s
     forward card == CPU, then dryrun_multichip(1) and (4) on cuda:0
     with every check of the JAX function, and unique by the hash engine
     == unique by sort; the devhash rows launches of their hash counters
     join the kernels line, their NW shapes phase 12; each dryrun's hash
     stage again into kernel and plain tables of 2^12 slots, equal
 12. kernel vs plain once more, at every (B, Lq, Lt) that phases 5, 7,
     9, 10, 11, 13, 16, 18 and 19 launched the kernel at, with their scoring
     and mode
 22. the mm_map kernel vs plain once more, at every (entry, B, L) that
     phases 5, 9, 10, 11, 13, 16, 18 and 19 launched it at (their mm_map
     counts are set to 0 just before each and read just after), on a
     synthetic world's reads, queries or segment rows of that shape
 24. the kmer_sort kernels vs plain once more, at every shape that
     phases 4-11, 13 and 16-19 launched their four entries at (each
     phase's kmer_sort count is set to 0 just before it and read just
     after; the ranks and the bench twin report theirs), on synthetic
     rows or reads of that shape (merge_runs on random rows, the LSD
     route, and on the same rows sorted, the merge path).  Before it the
     script requires extract_keys and sort_count launches in each count
     path (phases 5, 7, 9, 16, 17, 18), merge_runs in phase 17, and every
     merge of the paths on the merge path
 26. the unitig_build kernels vs plain once more, at every shape that
     the paths launched their four entries at (each phase's count set to
     0 just before it and read just after; the bench twin reports its
     own): a synthetic table of each (n, k) through all four entries, a
     rank_chains shape of no such table on random chains.  Before it the
     script requires all four entries in every phase whose path builds
     level 0 on the card (UB_PATH_PHASES: 4-9, 16, 18)
 20. the `kernels` JSON line (nw_align, devhash, devhash_count_reads,
     mm_map, kmer_extract_keys, kmer_sort_count, kmer_merge_runs,
     kmer_lex_order, unitig_front_keys, unitig_link_nodes,
     unitig_rank_chains, unitig_assemble_unitigs), the nvidia-smi line,
     and last the result line {"ok": true, "device": {...}}

It needs one CUDA GPU; without one it exits non-zero and prints no
result.  Kernels build at first use into build/kernels/, the host
libraries into build/native/.  The peak RSS of the process is printed
after each phase: cli.main, first called in phase 7, tunes glibc's
malloc for the rest of the process (no mmap, no trim).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): memory 3.35 TB/s; no int32 ALU rate
# is published, so the float32 non-tensor rate (67 TFLOP/s) bounds the
# kernel's 32-bit integer operations from below.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(*a):
    print(*a, flush=True)


def device_info():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f"; CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    return smi


def cuda_ms(fn, reps: int) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int, kernel: str, tries: int = 3,
              whole: bool = False) -> float:
    """Device time a call of fn spends in the kernels whose names hold
    `kernel` (with whole, in all its kernels and memsets, copies aside),
    from torch.profiler over reps calls: the kernels alone, without the
    host's time to enqueue them.  The profiler at times sees fewer
    launches than were made (CUPTI drops them); it is asked again up to
    `tries` times while it sees fewer than reps `kernel` launches, and
    past that the call is timed with CUDA events (the wrapper's host time
    included), which the log says."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                   # warm-up
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel in e.key]
        seen = sum(e.count for e in ev)
        if seen >= reps:
            if whole:
                ev = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "Memcpy" not in e.key]
            return sum(e.self_device_time_total for e in ev) / 1e3 / reps
    log(f"device_ms: the profiler saw {seen} of {reps} {kernel} launches "
        f"{tries} times; CUDA events instead (the wrapper included)")
    return cuda_ms(fn, reps)


def random_pairs(rng, B, Lq, Lt):
    """Random codes with some code-4 bases and 255 padding past random
    lengths (qlen = 0 and tlen = 0 included); half the pairs are a
    target slice with edits."""
    q = rng.integers(0, 5, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(0, Lt + 1, B).astype(np.int32)
    qlen[0], tlen[1] = 0, 0
    half = np.arange(0, B, 2)
    off = rng.integers(0, 17, len(half))
    src = np.minimum(off[:, None] + np.arange(Lq)[None, :], Lt - 1)
    q[half] = np.take_along_axis(t[half], src, axis=1)
    q[half, rng.integers(0, Lq, len(half))] = rng.integers(0, 4, len(half))
    q[np.arange(Lq)[None, :] >= qlen[:, None]] = 255
    t[np.arange(Lt)[None, :] >= tlen[:, None]] = 255
    return q, qlen, t, tlen


def map_shape_pairs(rng, B, read_len=150, Lq=152, pad=16):
    """The remainder DP's own shape: a 150 bp read with one deleted base
    at read position 50-99 against its target window, which has 16 bases
    of slack on each side (Lt = Lq + 32)."""
    from turingassembler_tpu_torch import testing as tt
    Lt = Lq + 2 * pad
    genome = tt.random_genome(1 << 20, seed=5)
    w0 = rng.integers(0, len(genome) - Lt, B)
    t = genome[w0[:, None] + np.arange(Lt)[None, :]]
    t[:, read_len + 2 * pad:] = 255
    p = rng.integers(50, 100, B)[:, None]
    j = np.arange(read_len)[None, :]
    q = np.full((B, Lq), 255, np.uint8)
    q[:, :read_len] = np.take_along_axis(t, pad + j + (j >= p), axis=1)
    return (q, np.full(B, read_len, np.int32), t,
            np.full(B, read_len + 2 * pad, np.int32))


def bubble_pairs(rng, B, L):
    """The bubble check's shape: two branches padded to a common power
    of two L.  Half the pairs are a copy with a few substitutions and
    one short deletion (a length difference); the rest are unrelated."""
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    qlen = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    tlen = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    half = np.arange(0, B, 2)
    cut = rng.integers(1, 9, len(half))
    at = rng.integers(0, L // 2, len(half))
    j = np.arange(L)[None, :]
    src = np.minimum(j + (j >= at[:, None]) * cut[:, None], L - 1)
    t[half] = np.take_along_axis(q[half], src, axis=1)
    for _ in range(3):
        t[half, rng.integers(0, L // 2, len(half))] = rng.integers(
            0, 4, len(half))
    tlen[half] = qlen[half] - cut
    q[j >= qlen[:, None]] = 255
    t[j >= tlen[:, None]] = 255
    return q, qlen, t, tlen


def put(*arrs):
    return [torch.as_tensor(a).to("cuda") for a in arrs]


def hold_kernel(what, q, ql, t, tl, scorings, modes, strip=None) -> int:
    """The NW kernel against its plain version on the same tensors, for
    each (name, scoring) and mode: raises unless equal, returns the
    largest |difference| (0)."""
    from turingassembler_tpu_torch.ops import nw_align
    from turingassembler_tpu_torch.ops.align import affine_global_score_batch
    for name, sc in scorings:
        for mode in modes:
            got = nw_align.banded_affine_score(q, ql, t, tl, *sc, mode=mode,
                                               _strip=strip)
            want = affine_global_score_batch(q, ql, t, tl, *sc, mode=mode)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            log(f"kernel vs plain {what} B={q.shape[0]} Lq={q.shape[1]} "
                f"Lt={t.shape[1]} {name} {mode}: max |diff| {err}")
            if err:
                raise AssertionError("NW kernel disagrees with plain")
    return 0


def phase_kernel_vs_plain():
    from turingassembler_tpu_torch.ops import dp, nw_align
    from turingassembler_tpu_torch.ops.align import affine_global_score_batch
    rng = np.random.default_rng(0)
    both = (("bwa", dp.SCORING_BWA), ("bubble", dp.SCORING_BUBBLE))
    max_err = 0

    def hold(what, q, ql, t, tl, scorings=both, modes=("global", "fit"),
             strip=None):
        nonlocal max_err
        max_err = max(max_err, hold_kernel(what, q, ql, t, tl, scorings,
                                           modes, strip))

    # the map shape; a ragged shape that crosses column tiles; a long
    # query; 8 pairs a block whose tile carries need the shared-memory
    # opt-in above 48 KB
    for (B, Lq, Lt) in ((65_536, 152, 184), (300, 37, 1_500),
                        (8, 3_500, 3_600), (2_112, 1_000, 600)):
        plan = nw_align.launch_plan(B, Lq, Lt)
        hold(f"(strip {plan[0]}, {plan[1]} pairs a block)",
             *put(*random_pairs(rng, B, Lq, Lt)))
    # every compiled strip width S: one column short of a full tile of
    # 32*S columns, the full tile, and one column into a second tile;
    # the narrowest width also over three tiles
    for S in nw_align.STRIPS:
        edges = (32 * S - 1, 32 * S, 32 * S + 1) + ((150,) if S == 2 else ())
        for Lt in edges:
            hold(f"strip {S}", *put(*random_pairs(rng, 512, 40, Lt)),
                 strip=S)
    # the map shape at the batches the scaffolds path's mappers give it:
    # a few thousand pairs, and a tail of some twenty (one pair a block)
    for B in (2_640, 20):
        plan = nw_align.launch_plan(B, 152, 184)
        hold(f"scaffolds map shape (strip {plan[0]}, {plan[1]} pairs a "
             "block)", *put(*map_shape_pairs(rng, B)), scorings=both[:1],
             modes=("fit",))
    # the bubble check: global mode, bubble scoring, many narrow pairs,
    # few wide ones, and the batch a 2 Mbp levels run gives it
    bubble = both[1:]
    for (B, L) in ((4_096, 256), (32, 1_024), (3_584, 150)):
        hold("bubble shape", *put(*bubble_pairs(rng, B, L)), scorings=bubble,
             modes=("global",))

    def rate(ql, tl, ms):
        cells = int((ql.long() * (tl.long() + 1)).sum())
        return cells, cells / ms / 1e6

    # timing at the map's remainder-DP shape, BWA scoring, fit mode
    q, ql, t, tl = put(*map_shape_pairs(rng, 65_536))
    sc = dp.SCORING_BWA

    def kernel():
        return nw_align.banded_affine_score(q, ql, t, tl, *sc, mode="fit")

    def plain():
        return affine_global_score_batch(q, ql, t, tl, *sc, mode="fit")

    got, want = kernel(), plain()
    err = int((got.long() - want.long()).abs().max())
    max_err = max(max_err, err)
    if err:
        raise AssertionError("NW kernel disagrees with plain (map shape)")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    ms_again = cuda_ms(kernel, 20)
    cells, gcells = rate(ql, tl, min(ms, ms_again))
    nbytes = q.numel() + t.numel() + 4 * 3 * q.shape[0]  # qlen, tlen, out
    t_ops = nw_align.OPS_PER_CELL * cells / PEAK_OPS_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    log(f"NW kernel at map shape B=65536 Lq=152 Lt=184 (fit, BWA): "
        f"{ms:.4f} ms then {ms_again:.4f} ms ({gcells:.1f} G cells/s); "
        f"plain {plain_ms:.4f} ms; "
        f"{cells} cells; bound {max(t_ops, t_bytes):.5f} ms "
        f"(ops {t_ops:.5f}, bytes {t_bytes:.6f})")

    # timing at the bubble check's shapes, bubble scoring, global mode:
    # phase 3's own ragged shape, and the batch a 2 Mbp levels run gives
    # the kernel (about 3,500 branch pairs of 90-150 bases)
    for (B, L) in ((4_096, 256), (3_584, 150)):
        bq, bql, bt, btl = put(*bubble_pairs(rng, B, L))
        bms = cuda_ms(lambda: nw_align.banded_affine_score(
            bq, bql, bt, btl, *dp.SCORING_BUBBLE, mode="global"), 20)
        bcells, bg = rate(bql, btl, bms)
        log(f"NW kernel at bubble shape B={B} Lq={L} Lt={L} (global, "
            f"bubble): {bms:.4f} ms ({bg:.1f} G cells/s); {bcells} cells; "
            f"bound {nw_align.OPS_PER_CELL * bcells / PEAK_OPS_S * 1e3:.5f}"
            " ms (ops)")
    return dict(max_abs_err=max_err, ms=min(ms, ms_again), plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nw_shapes(start: int = 0):
    """The NW kernel's launches from the start-th on, (B, Lq, Lt) each
    (nw_align.COUNT records them as ("banded_affine_score", B, Lq, Lt))."""
    from turingassembler_tpu_torch.ops import nw_align
    return [tuple(sh[1:]) for sh in nw_align.COUNT.shapes[start:]]


def phase_hold_path_shapes(recorded):
    """Every (B, Lq, Lt) the main paths launched the kernel at, held
    against the plain version at that very shape, scoring and mode.
    recorded: (caller, (B, Lq, Lt)) per launch; caller "map" is the
    remainder DP of the mappers and of the path scoring (fit, BWA
    scoring), "bubble" the bubble check of the levels and of the local
    graphs (global, bubble scoring).  Returns the largest |difference|."""
    from turingassembler_tpu_torch.ops import dp
    rng = np.random.default_rng(7)
    err = 0
    for caller, (B, Lq, Lt) in sorted(set(recorded)):
        if caller == "map":
            pad = (Lt - Lq) // 2
            pairs = map_shape_pairs(rng, B, Lq - 2, Lq, pad) \
                if Lt == Lq + 2 * pad and pad > 0 \
                else random_pairs(rng, B, Lq, Lt)
            args = ((("bwa", dp.SCORING_BWA),), ("fit",))
        else:
            pairs = bubble_pairs(rng, B, Lq) if Lq == Lt \
                else random_pairs(rng, B, Lq, Lt)
            args = ((("bubble", dp.SCORING_BUBBLE),), ("global",))
        err = max(err, hold_kernel(f"{caller} shape of the main paths",
                                   *put(*pairs), *args))
    return err


def run_slice(reads, lengths, k, min_count, device):
    """count -> build -> index -> verified map on one device."""
    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import \
        count_kedges_megasort_device
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)

    def batches():
        for i in range(0, len(reads), 4096):
            yield reads[i:i + 4096], lengths[i:i + 4096]

    u, c, n = count_kedges_megasort_device(batches(), k, min_count=min_count,
                                           device=device)
    g = build_graph_on_device(u, c, n, k, device=device)
    idx = EdgeMinimizerIndex.build(g, device=device)
    e, h, s = map_reads(idx, reads, lengths, graph=g, device=device)
    return dict(uniq=u.cpu().numpy(), counts=c.cpu().numpy(), graph=g,
                index=idx, edges=e, hits=h, starts=s)


def phase_slice_parity():
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import nw_align
    genome = tt.random_genome(50_000, seed=11)
    reads, lengths = tt.sim_reads(genome, coverage=30, read_len=150,
                                  seed=12, error_rate=0.004, pad_to=152)
    ir, il = tt.sim_indel_reads(genome, 2_000, 150, seed=13, pad_to=152)
    reads = np.concatenate([reads, ir])
    lengths = np.concatenate([lengths, il])
    before = nw_align.COUNT.launches
    gpu = run_slice(reads, lengths, 45, 2, "cuda")
    torch.cuda.synchronize()
    launched = nw_align.COUNT.launches - before
    cpu = run_slice(reads, lengths, 45, 2, "cpu")
    for key in ("uniq", "counts", "edges", "hits", "starts"):
        if not np.array_equal(gpu[key], cpu[key]):
            raise AssertionError(f"slice parity: {key} differs")
    for f in ("edge_source", "edge_target", "edge_rc", "edge_count",
              "seq_off", "seq_data", "node_rc", "adj_off", "adj_list"):
        if not np.array_equal(getattr(gpu["graph"], f),
                              getattr(cpu["graph"], f)):
            raise AssertionError(f"slice parity: graph {f} differs")
    for f in ("keys", "edge", "pos", "count"):
        if not np.array_equal(getattr(gpu["index"], f),
                              getattr(cpu["index"], f)):
            raise AssertionError(f"slice parity: index {f} differs")
    if launched < 1:
        raise AssertionError("slice parity: the NW kernel never launched")
    mapped = (gpu["edges"] >= 0).mean()
    log(f"slice parity (50 kbp, {len(reads)} reads, k=45, min count 2): "
        f"card == CPU for the count table ({len(gpu['counts'])} k-edges), "
        f"graph (n_e {gpu['graph'].n_e}), index and map "
        f"({mapped * 100:.2f}% mapped); NW launches {launched}")


N_INDEL = 66_560   # 65,536 + 1,024: a few hundred indel reads near
                   # position 99 clear the gapless bound and skip the DP


def run_main_path(reads, lengths, ir, il, k, around=None):
    """count -> build -> index -> verified map of the reads (from the
    count's device tensors), then the verified map of the indel reads:
    the bench twin's stages (turingassembler_tpu_torch/bench.py), each
    ending in a device sync; `around(name)`, when given, is a context
    manager entered around each stage.  Returns stage seconds and the
    outputs."""
    from turingassembler_tpu_torch import bench
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)
    stage, out = bench.Stages("cuda", around), {}
    out["u"], out["c"], out["n"], shipped, g = bench.count_and_build(
        stage, reads, lengths, k)
    out["g"] = g
    idx = out["idx"] = stage("index", lambda: EdgeMinimizerIndex.build(g))
    out["e"], out["s"] = bench.map_shipped(stage, idx, reads, lengths, g,
                                           shipped)
    out["ei"], _, _ = stage("map_indel", lambda: map_reads(
        idx, ir, il, graph=g))
    return stage.seconds, out


class StageProfiler:
    """torch.profiler around one stage at a time: per stage the device's
    busy time (sum of kernel and copy times) and the host's top ops, and
    over all stages the kernels that take the time."""

    def __init__(self, host_ops=True):
        """host_ops=False traces device activity only, which costs a
        stage of host work less."""
        self.busy, self.kernels, self.host = {}, {}, {}
        self.host_ops = host_ops

    @contextlib.contextmanager
    def around(self, name):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU] * self.host_ops
                     + [ProfilerActivity.CUDA]) as prof:
            yield
        self.busy[name] = 0.0
        cpu_ops = []
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                self.busy[name] += ev.self_device_time_total / 1e6
                c = self.kernels.setdefault(ev.key, [0.0, 0])
                c[0] += ev.self_device_time_total / 1e3
                c[1] += ev.count
            elif ev.self_cpu_time_total:
                cpu_ops.append((ev.self_cpu_time_total / 1e3, ev.key))
        self.host[name] = sorted(cpu_ops, reverse=True)[:3]

    def report(self, what, st):
        """st: stage -> wall seconds, measured inside `around`."""
        wall, dev = sum(st.values()), sum(self.busy.values())
        if dev == 0:
            log(f"{what}: the profiler saw no device time (not measured)")
            return
        log(f"{what} (profiler on): stages wall {wall:.3f} s, device busy "
            f"{dev:.3f} s ({dev / wall * 100:.1f}%)")
        for name, sec in st.items():
            log(f"{what}:   stage {name:9s} wall {sec:.3f} s, device busy "
                f"{self.busy[name]:.3f} s ({self.busy[name] / sec * 100:.1f}"
                "%); top host ops (self ms): " + ", ".join(
                    f"{k_} {ms:.1f}" for ms, k_ in self.host[name]))
        for key, (ms, cnt) in sorted(self.kernels.items(),
                                     key=lambda kv: -kv[1][0])[:10]:
            log(f"{what}:   {ms:10.3f} ms  x{cnt:<6d} {key[:100]}")


def phase_full_width(workload):
    """workload: (genome, reads, lengths) of bench.make_workload at the
    bench twin's defaults (phase 21 made it)."""
    from turingassembler_tpu_torch import bench
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import nw_align

    k, read_len, n_reads = 45, 150, 1_048_576
    genome, reads, lengths = workload
    ir, il = tt.sim_indel_reads(genome, N_INDEL, read_len, seed=2,
                                pad_to=read_len + 2)

    torch.cuda.reset_peak_memory_stats()
    nw_align.COUNT.reset()
    st, out = run_main_path(reads, lengths, ir, il, k)
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
    shapes = [("map", sh) for sh in nw_shapes()]
    g, idx, e, s, ei = out["g"], out["idx"], out["e"], out["s"], out["ei"]

    passes = [st] + [run_main_path(reads, lengths, ir, il, k)[0]
                     for _ in range(2)]
    for i, p in enumerate(passes):
        log(f"full width pass {i} stage seconds: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in p.items()))
    st = {k_: float(np.median([p[k_] for p in passes])) for k_ in st}
    mapped, acc_indel = float((e >= 0).mean()), float((ei >= 0).mean())
    log(f"full width: n_unique {out['n']}, n_v {g.n_v}, n_e {g.n_e}, "
        f"{len(idx.keys)} minimizer keys; mapped {mapped * 100:.3f}% of "
        f"{n_reads} error-free reads, {acc_indel * 100:.3f}% of {N_INDEL} "
        f"indel reads; remainder DP pairs {pairs} in {launches} NW launches"
        f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    reads_per_s = n_reads / (st['count'] + st['build'] + st['map'])
    log(f"full width: count+build+map {reads_per_s:.1f} reads/s "
        f"(median of {len(passes)} passes; index build excluded, as "
        f"bench.py does)")
    # the assembly against the reference: a 2 Mbp random genome at 79x
    # with error-free reads is one unitig per strand; the bench twin's
    # checks of the unitig and of the map
    bench.check_outputs(genome, g, e, s)
    if acc_indel < 0.95:
        raise AssertionError(f"only {acc_indel:.4f} of indel reads accepted")
    if pairs < 65_536 or launches < 1:
        raise AssertionError(f"remainder DP ran {pairs} pairs through the "
                             "NW kernel, expected >= 65536")
    # one more pass with the profiler around each stage on its own
    prof = StageProfiler()
    st_prof, _ = run_main_path(reads, lengths, ir, il, k, prof.around)
    prof.report("profile, one more full-width pass", st_prof)
    # the map before the mm_map kernel: the same passes with the mapper's
    # plain versions on the card, timed and profiled in this call
    with plain_mapper():
        plain = [run_main_path(reads, lengths, ir, il, k)[0]
                 for _ in range(2)]
        prof_p = StageProfiler()
        st_pp, _ = run_main_path(reads, lengths, ir, il, k, prof_p.around)
    prof_p.report("profile, one full-width pass, plain mapper", st_pp)
    for i, p in enumerate(plain):
        log(f"full width plain-mapper pass {i} stage seconds: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in p.items()))
    for name in ("index", "map"):
        busy = (prof.busy[name] / st_prof[name] * 100,
                prof_p.busy[name] / st_pp[name] * 100)
        log(f"full width {name}: mm_map kernel {st[name]:.4f} s (median of "
            f"{len(passes)}) at {busy[0]:.1f}% busy; plain versions on the "
            f"card " + ", ".join(f"{p[name]:.4f}" for p in plain)
            + f" s at {busy[1]:.1f}% busy")
    n = out["n"]
    bench_data = dict(reads=reads, lengths=lengths, k=k,
                      kedges=out["u"][:n].cpu().numpy().astype(np.uint32),
                      counts=out["c"][:n].cpu().numpy().astype(np.int64))
    return launches, shapes, bench_data, reads_per_s


# ---------------------------------------------------------------------------
# phases 21-22: the mm_map kernel (the minimizer map's device program)
# ---------------------------------------------------------------------------

MM_BATCH = 65_536        # map_reads' batch: phase 5's map launches
MM_K, MM_W = 17, 17


def plain_tables(hkeys, vals):
    """The plain version's int64 (hkeys (NB, 8), vals (NB * 4, 2)) from
    the tables of a device: the kernel's bucket records (NB, 16) int32
    (vals None) on a card are unpacked on their device."""
    if vals is not None:
        return hkeys, vals
    nb = hkeys.shape[0]
    r = (hkeys.long() & 0xFFFFFFFF).view(nb, 4, 4)
    return (r[:, :, :2].reshape(nb, 8).contiguous(),
            r[:, :, 2:].reshape(nb * 4, 2).contiguous())


def plain_pool(pool):
    """The plain version's nibble-packed pool (pack_pool_nibbles, on the
    pool's device) from the kernel's uint8 codes; a packed pool as it
    is."""
    from turingassembler_tpu_torch.ops.mm_map import POOL_PAD_W
    if pool.dtype != torch.uint8:
        return pool
    n, dev = pool.shape[0], pool.device
    nw = -(-n // 8)
    buf = torch.full((8 * nw,), 0xF, dtype=torch.int64, device=dev)
    buf[:n] = pool
    words = (buf.view(nw, 8) << (4 * torch.arange(8, device=dev))).sum(1)
    pad = torch.full((POOL_PAD_W,), 0xFFFFFFFF, dtype=torch.int64,
                     device=dev)
    return torch.cat([pad, words, pad])


def plain_map_batch(bases, lengths, hkeys, vals, salt, k, w, seq_pk=None,
                    seq_off=None, thr=None, mt=0, mm=0, out=None):
    """ops/mm_map.map_batch's plain version on any device, from the
    tables and pool in either layout."""
    from turingassembler_tpu_torch.ops import mm_map
    hkeys, vals = plain_tables(hkeys, vals)
    if seq_pk is None:
        res = mm_map.plain_vote(bases, lengths, hkeys, vals, salt, k, w)
    else:
        res = mm_map.plain_verified(bases, lengths, hkeys, vals, salt,
                                    plain_pool(seq_pk), seq_off, thr, k, w,
                                    mt, mm)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def plain_gapless_bound(seq_pk, *args):
    """ops/mm_map.gapless_bound's plain version on any device."""
    from turingassembler_tpu_torch.ops import mm_map
    return mm_map.plain_gapless_bound(plain_pool(seq_pk), *args)


def plain_minimizer_rows(bases, lengths, k, w):
    """ops/mm_map.minimizer_rows's plain version on any device."""
    from turingassembler_tpu_torch.ops import mm_map
    return mm_map.plain_minimizer_rows(bases, lengths, k, w)


@contextlib.contextmanager
def plain_mapper():
    """map_reads, rescore_hits and the index build through the plain
    versions on the card, for phase 5's before figures.  No path has such
    a switch: only this script swaps the wrapper's entries, for one
    window."""
    from unittest import mock
    from turingassembler_tpu_torch.ops import mm_map
    with mock.patch.object(mm_map, "map_batch", plain_map_batch), \
            mock.patch.object(mm_map, "gapless_bound", plain_gapless_bound), \
            mock.patch.object(mm_map, "minimizer_rows", plain_minimizer_rows):
        yield


def source_variants(kernel, variants, src=None,
                    timed=("map_kernel", "bound_kernel")):
    """Scratch copies of csrc/<kernel>.cu with text edits, for timing
    stages and layouts; the committed source is never edited.  variants:
    {name: [(anchor, text), ...]}: each anchor, found exactly once, is
    replaced by text.  All copies build at once (one nvcc each) into a
    fresh directory under build/; the registers of the `timed` kernels
    are logged.  Returns {name: ctypes library}."""
    import ctypes
    from turingassembler_tpu_torch import _build
    src = src if src is not None else \
        (_build.CSRC / f"{kernel}.cu").read_text()
    d = tempfile.mkdtemp(prefix=f"{kernel}_variants_",
                         dir=_build.BUILD_DIR.parent)
    procs = {}
    for name, edits in variants.items():
        text = src
        for anchor, new in edits:
            if text.count(anchor) != 1:
                raise AssertionError(f"{kernel} variant {name}: anchor found "
                                     f"{text.count(anchor)} times: {anchor!r}")
            text = text.replace(anchor, new)
        cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, f"{name}.so")
        with open(cu, "w") as fp:
            fp.write(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"{kernel} variant {name}: nvcc failed:\n"
                                 f"{out}")
        libs[name] = ctypes.CDLL(so)
        log(f"{kernel} variant {name}: registers " + ", ".join(
            f"{k_} {v_}" for k_, v_ in ptxas_registers(out, timed).items()))
    return libs


def ptxas_registers(out, kernels):
    """{kernel: registers} from nvcc's -Xptxas -v report, for the named
    kernels."""
    regs, kernel = {}, None
    pattern = r"Function properties for \S*?(" + "|".join(kernels) + ")"
    for line in out.splitlines():
        m = re.search(pattern, line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            regs[kernel] = int(m.group(1))
            kernel = None
    return regs


@contextlib.contextmanager
def use_library(kernel, lib):
    """The launches of csrc/<kernel>.cu go to `lib` (a variant built
    beside it)."""
    from unittest import mock
    from turingassembler_tpu_torch import _build
    real = _build.load
    with mock.patch.object(_build, "load",
                           lambda name: lib if name == kernel else
                           real(name)):
        yield


def _stop(value):
    """A map_kernel stage's end in a timing variant: the warp writes a
    value that depends on the stage's work and goes on to its next
    read."""
    return (f"        {{ const int z_ = __reduce_add_sync(FULL, {value});\n"
            "          if (lane == 0) a.best_hits[b] = z_;\n"
            "          __syncwarp(); continue; }\n")


# map_kernel cut after each stage (anchor, its text with the stop after)
MM_STAGES = {
    "load": "            len_next = a.lengths[b + stride];\n        }\n",
    "pack": ("        pack_row(seq, L, words, bad, lane, 32);\n"
             "        __syncwarp();\n"),
    "marks": ("            n = n < a.cap ? n : a.cap;\n        }\n"
              "        __syncwarp();\n"),
    "probe": ("        // vote: each slot's count of its edge among the "
              "read's hits\n"),
}
# the map's bound stage, the vote's cut just before it
MM_BOUND_STAGE = ("        if (a.verified) {              // the gapless "
                  "bound at the vote\n")
MM_STOPS = {"load": "(int)seq[lane] + len",
            "pack": "(int)words[lane & 3] + len",
            "marks": "n + s_pos[lane]",
            "probe": "edge[0] + edge[1] + start[0] + start[1]"}

# the probe of key-only rows (32 bytes a bucket) and value rows (8 bytes a
# slot) in one (NB, 16) buffer: NB key rows, then NB * 4 value rows
MM_SPLIT_PROBE = """\
__device__ __forceinline__ void probe(const MapArgs& a, const uint32_t* words,
                                      const uint32_t* bad, int p, int* edge,
                                      int* start) {
    const Win wd = window_at(words, bad, p, a.k);
    const uint2* vals = reinterpret_cast<const uint2*>(
        a.table + ((size_t)a.mask + 1) * 2);
    for (int which = 0; which < 2; ++which) {
        const uint32_t bk = cuckoo_h(wd.l0, wd.l1, a.salt, a.mask, which);
        const uint4 r0 = __ldg(a.table + (size_t)bk * 2);
        const uint4 r1 = __ldg(a.table + (size_t)bk * 2 + 1);
        const uint32_t key[8] = {r0.x, r0.y, r0.z, r0.w,
                                 r1.x, r1.y, r1.z, r1.w};
        int t = -1;
#pragma unroll
        for (int u = CUCKOO_CAP - 1; u >= 0; --u)
            if (key[2 * u] == wd.l0 && key[2 * u + 1] == wd.l1) t = u;
        if (t >= 0) {
            const uint2 v = __ldg(vals + (size_t)bk * CUCKOO_CAP + t);
            if (v.x > 0) {
                *edge = (int)(v.x - 1);
                *start = (int)v.y - p;
            }
            return;
        }
    }
}

"""


# The earlier, byte-wise gapless bound, timed beside the word-wide one: a
# warp a query in the bound entry, a code a lane a step (its kernel
# writes int32, as the wrapper takes); the device function, the map's
# bound stage and the bound entry's kernel
MM_BYTEWISE_GAPLESS = """\
__device__ __forceinline__ void gapless_bytes(const Pool& pool,
                                              const uint8_t* q, int L,
                                              int len, long long edge,
                                              long long start, int lane,
                                              int* bound, bool* feas) {
    const long long e = edge > 0 ? edge : 0;
    const long long off = pool.off[e];
    const long long elen = pool.off[e + 1] - off;
    const int lo = (int)(start < 0 ? (-start < L ? -start : L) : 0);
    const long long tail = elen - start;
    const int hi = min(len, (int)(tail < L ? (tail > 0 ? tail : 0) : L));
    const uint8_t* t = pool.codes + off + start;
    int nm = 0;
    for (int j = lo + lane; j < hi; j += 32) nm += q[j] == __ldg(t + j);
    nm = __reduce_add_sync(FULL, nm);
    const int non = hi > lo ? hi - lo : 0;
    *bound = nm * pool.mt + (non - nm) * pool.mm;
    *feas = non > 0 && edge >= 0;
}

"""
MM_BYTEWISE_MAP_BOUND = """\
        if (a.verified) {
            int bound;
            bool feas;
            gapless_bytes(a.pool, seq, L, len, be, bs, lane, &bound, &feas);
            if (lane == 0) {
                a.bound[b] = bound;
                a.fast[b] = feas && bound >= (a.thr ? a.thr[b] : a.thr_all);
            }
        }
"""
MM_BYTEWISE_BOUND_KERNEL = """\
__global__ void __launch_bounds__(32 * MAP_WARPS)
bound_kernel(const uint8_t* __restrict__ bases, const int* __restrict__ lengths,
             const long long* __restrict__ edges,
             const long long* __restrict__ starts, long long N, int L, int G,
             Pool pool, int* bound, uint8_t* feas) {
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * MAP_WARPS + (threadIdx.x >> 5);
    if (b >= N) return;
    int bd;
    bool fs;
    gapless_bytes(pool, bases + b * L, L, lengths[b], edges[b], starts[b],
                  lane, &bd, &fs);
    if (lane == 0) {
        bound[b] = bd;
        feas[b] = fs;
    }
}

"""


def _between(src, first, stop):
    """The text of src from `first` up to `stop` (each found once)."""
    for a in (first, stop):
        if src.count(a) != 1:
            raise AssertionError(f"mm_map variant: anchor found "
                                 f"{src.count(a)} times: {a!r}")
    return src[src.index(first):src.index(stop)]


def mm_timing_variants():
    """The variants phase 21 times: map_kernel stopped after each stage
    (the stage split); the probe of key-only rows and value rows ("split
    tables"); the earlier byte-wise gapless bound in both entries
    ("byte-wise bound")."""
    from turingassembler_tpu_torch import _build
    src = (_build.CSRC / "mm_map.cu").read_text()
    v = {}
    for name, anchor in MM_STAGES.items():
        v[name] = [(anchor, anchor + _stop(MM_STOPS[name]))]
    v["vote"] = [(MM_BOUND_STAGE, "        { __syncwarp(); continue; }\n"
                  + MM_BOUND_STAGE)]
    probe = _between(src, "__device__ __forceinline__ void probe(",
                     "__global__ void __launch_bounds__(32 * MAP_WARPS)\n"
                     "map_kernel")
    v["split tables"] = [(probe, MM_SPLIT_PROBE)]
    group = _between(src, "__host__ __device__ __forceinline__ int "
                     "bound_group(", "// The bound entry: a group of G")
    v["byte-wise bound"] = [
        ("__device__ __forceinline__ void cp_async4(",
         MM_BYTEWISE_GAPLESS + "__device__ __forceinline__ void cp_async4("),
        (_between(src, MM_BOUND_STAGE,
                  "        __syncwarp();                  // seq is refilled"),
         MM_BYTEWISE_MAP_BOUND),
        (group, "__host__ __device__ __forceinline__ int bound_group(int) "
                "{ return 32; }\n\n"),
        (_between(src, "// The bound entry: a group of G",
                  "// The rows entry's shared memory"),
         MM_BYTEWISE_BOUND_KERNEL)]
    return source_variants("mm_map", v, src)


def hold_mm(what, got, want) -> int:
    """Each output of an mm_map entry == the plain version's: the same
    shape and values (the kernel's int32 where the plain version has
    int64).  Returns the largest |difference| (0)."""
    torch.cuda.synchronize()
    err = 0
    if len(got) != len(want):
        raise AssertionError(f"mm_map {what}: {len(got)} outputs, plain "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or (a.dtype != b.dtype and (
                a.dtype, b.dtype) != (torch.int32, torch.int64)):
            raise AssertionError(
                f"mm_map {what}: output {i} is {a.dtype} {tuple(a.shape)}, "
                f"plain {b.dtype} {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    log(f"mm_map kernel vs plain, {what}: max |diff| {err}")
    if err:
        raise AssertionError(f"mm_map {what}: the kernel disagrees with the "
                             "plain version")
    return err


def hold_mm_entry(what, entry, arrays, tables, pool) -> int:
    """One mm_map entry on the card against its plain version on the
    same tensors: "map" arrays (bases, lengths, thr), vote and verified,
    with thr per read and with one scalar; "bound" (edges, starts, bases,
    lengths); "rows" (rows, lengths).  tables and pool as the card's map
    takes them.  Returns the largest |difference| (0)."""
    from turingassembler_tpu_torch.ops import mm_map
    from turingassembler_tpu_torch.ops.dp import SCORING_BWA
    mt, mm = SCORING_BWA[:2]
    t = [torch.as_tensor(np.ascontiguousarray(a)).to("cuda") for a in arrays]
    shape = "x".join(map(str, arrays[-2 if entry == "bound" else 0].shape))
    if entry == "map":
        bases, lengths, thr = t
        args = (bases, lengths, *tables, MM_K, MM_W)
        err = hold_mm(f"{what} ({shape}) vote", mm_map.map_batch(*args),
                      plain_map_batch(*args))
        for th in (thr, int(thr[0])):
            a = args + (*pool, th, mt, mm)
            kind = "scalar" if isinstance(th, int) else "per-read"
            err = max(err, hold_mm(
                f"{what} ({shape}) verified, {kind} threshold",
                mm_map.map_batch(*a), plain_map_batch(*a)))
        return err
    if entry == "bound":
        args = (*pool, *t, mt, mm)
        return hold_mm(f"{what} ({shape})", mm_map.gapless_bound(*args),
                       plain_gapless_bound(*args))
    return hold_mm(f"{what} ({shape})", (mm_map.minimizer_rows(
        *t, MM_K, MM_W),), (plain_minimizer_rows(*t, MM_K, MM_W),))


def mm_ops(n_pos, n_win):
    """Least integer operations of the marks: a window position packs its
    k-mer (a shift-or a base, 2k) and hashes two limbs (two limb mixes of
    5, two rounds of 6, fmix32's 7: 29, and its validity: 30); a window
    takes its leftmost minimum with a compare and a select a position
    after the first."""
    return n_pos * (2 * MM_K + 30) + n_win * 2 * (MM_W - 1)


def on_edge(off, edges, starts, lengths, L):
    """The on-edge span [lo, hi) of queries of width L at (edges,
    starts), and its first pool position g0 = off[e] + lo."""
    e = torch.clamp(edges.long(), min=0)
    elen = off[e + 1] - off[e]
    lo = torch.clamp(starts.long(), min=0)
    hi = torch.minimum(starts.long() + torch.clamp(lengths.long(), max=L),
                       elen)
    return lo, hi, off[e] + lo


def covered(off, edges, starts, lengths, L):
    """The pool positions under the on-edge positions of queries, each
    once: a bool mask over the pool's codes.  Queries of one edge overlap
    and unvoted reads share edge 0's first codes, so a position counts
    once however many queries cover it."""
    lo, hi, g0 = on_edge(off, edges, starts, lengths, L)
    n = torch.clamp(hi - lo, min=0)
    n_codes = int(off[-1])
    d = torch.zeros(n_codes + 1, dtype=torch.int64, device=off.device)
    d.index_add_(0, g0[n > 0], torch.ones_like(g0[n > 0]))
    d.index_add_(0, (g0 + n)[n > 0], -torch.ones_like(g0[n > 0]))
    return torch.cumsum(d, 0)[:n_codes] > 0


def pool_bytes(off, edges, starts, lengths, L):
    """Pool codes (1 byte each) under the on-edge positions of queries,
    each position once: what the bound must read from the uint8 pool."""
    return int(covered(off, edges, starts, lengths, L).sum())


def pool_words(off, edges, starts, lengths, L):
    """Nibble-packed pool words (8 bytes each, the int64 layout) under the
    on-edge positions of queries, each word once."""
    from turingassembler_tpu_torch.ops.mm_map import POOL_PAD_W
    g = torch.nonzero(covered(off, edges, starts, lengths, L))[:, 0]
    return int(torch.unique((g + 8 * POOL_PAD_W) >> 3).numel())


def off_bytes(edges):
    """The seq_off entries (8 bytes each) the queries' spans read,
    off[e] and off[e + 1] of each edge e (edge 0 for an unvoted query),
    each entry once."""
    e = torch.clamp(edges.long(), min=0)
    return 8 * int(torch.unique(torch.cat([e, e + 1])).numel())


def n_windows(lengths, L):
    """Complete windows of the reads (the marks' argmins)."""
    w_len = torch.clamp(lengths.long() - MM_K - MM_W + 2, min=0)
    return int(torch.clamp(w_len, max=L - MM_K + 1).sum())


def mm_map_bytes(bases, lengths, ptables, off, out, per_read_thr):
    """Least bytes of the verified map of a batch, from this run's data,
    in the kernel's layout, each input read once: codes and lengths (and a
    per-read threshold, 4 bytes, where there is one); the bucket records
    the probes need (b1's 64 bytes, and b2's where the key is not in b1),
    each bucket once; the pool codes under the reads' on-edge positions
    and the seq_off entries of their edges, each once; five outputs (17
    bytes a read).  Returns (bytes, probes, the int64 layout's bytes: key
    rows of 64 bytes, each bucket once, and a value row of 16 a found key,
    each key once, nibble-packed int64 pool words, int64 thresholds, 33
    bytes of outputs)."""
    from turingassembler_tpu_torch.ops import mm_map
    hkeys, vals, salt = ptables
    B, L = bases.shape
    km, _h, is_mm = mm_map.minimizer_mask(bases, lengths, MM_K, MM_W)
    P = km.shape[1]
    pos = torch.where(is_mm, torch.arange(P, device=bases.device),
                      mm_map.BIG)
    sp = torch.sort(pos, dim=1).values[:, :mm_map.MM_CAP]
    q = torch.gather(km, 1, torch.clamp(sp, max=P - 1)[:, :, None]
                     .expand(-1, -1, 2))[sp < P]
    mask = hkeys.shape[0] - 1
    b1 = mm_map.cuckoo_hash(q[:, 0], q[:, 1], salt, mask, 0)
    b2 = mm_map.cuckoo_hash(q[:, 0], q[:, 1], salt, mask, 1)
    r1 = hkeys[b1]
    in_b1 = ((r1[:, 0::2] == q[:, :1]) & (r1[:, 1::2] == q[:, 1:])).any(1)
    found = mm_map.cuckoo_probe(hkeys, vals, salt, q)[2]
    n_probe = q.shape[0]
    rows = int(torch.unique(torch.cat([b1, b2[~in_b1]])).numel())
    keys = int(torch.unique(q[found], dim=0).shape[0])
    edges, starts = out[0], out[2]
    spans = pool_bytes(off, edges, starts, lengths, L) + off_bytes(edges)
    nbytes = B * (L + 4 + 4 * per_read_thr + 17) + 64 * rows + spans
    old = B * (L + 4 + 8 + 33) + 64 * rows + 16 * keys + off_bytes(edges) \
        + 8 * pool_words(off, edges, starts, lengths, L)
    return nbytes, n_probe, old


def bound_of(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_mm_kernel_vs_plain():
    """Phase 21: the mm_map kernel's three entries against their plain
    versions on the card, exact: (a) on testing.mm_map_cases (Ns, reads
    too short for a window, more than 48 minimizers, ties, overhangs,
    per-read and scalar thresholds, both bound branches, rows too narrow
    for a window) and testing.mm_align_cases (the bound at widths 1-200
    and all 16 start alignments, code-4 bases in query and pool, spans
    that end on the pool's last byte; reads at the pool's end) with an
    index the kernel built == the CPU's; (b) at the bench batch: phase
    5's workload counted and built on the card, its index, the first
    65,536 reads (one map_reads batch) through map_batch, their votes
    through gapless_bound, the index build's first batch of 256 segment
    rows through minimizer_rows; kernel, plain and bound ms of each;
    map_batch's stage split and its alternatives, gapless_bound beside
    the byte-wise bound (scratch variants of the source,
    mm_timing_variants), held equal and timed in turns; the
    pool's first copy and its cached lookup; and map_reads of all the
    bench reads, its wall beside its device time.
    Returns the kernels line's figures and the workload."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        # the variants build (nvcc) while the edge cases run
        return mm_kernel_vs_plain(ex.submit(mm_timing_variants))


def mm_kernel_vs_plain(variants):
    """Phase 21's body; variants: the future of mm_timing_variants."""
    from turingassembler_tpu_torch import bench
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.mapper import minimizers as mz
    from turingassembler_tpu_torch.ops import dp, mm_map
    err = 0
    # (a) the edge cases, then the bound's alignment and pool-end cases
    for world, (g, cases) in (("edge-case", tt.mm_map_cases(seed=0)),
                              ("alignment", tt.mm_align_cases(seed=0))):
        idx = mz.EdgeMinimizerIndex.build(g, device="cuda")
        ref = mz.EdgeMinimizerIndex.build(g, device="cpu")
        for f in ("keys", "edge", "pos", "count"):
            if not np.array_equal(getattr(idx, f), getattr(ref, f)):
                raise AssertionError(f"mm_map: the card's index {f} differs")
        tables = idx.device_tables("cuda")
        pool = mz._device_pool(g.seq_data, g.seq_off,
                               torch.device("cuda"))[:2]
        for name, (entry, arrays) in cases.items():
            err = max(err, hold_mm_entry(name, entry, arrays, tables, pool))
        log(f"mm_map (a): {len(idx.keys)} index keys of the {world} world "
            "(card == CPU); every case equal")

    # (b) the bench batch
    genome, reads, lengths = bench.make_workload(2_000_000, 1_048_576)
    stage = bench.Stages("cuda")
    _, _, _, shipped, gb = bench.count_and_build(stage, reads, lengths, 45)
    idx = mz.EdgeMinimizerIndex.build(gb, device="cuda")
    tables = idx.device_tables("cuda")
    hk, vals, salt = idx.hash_tables()
    ptables = (torch.as_tensor(hk).to("cuda"),
               torch.as_tensor(vals).to("cuda"), salt)
    mz._POOL_CACHE.clear()
    pool_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = mz._device_pool(gb.seq_data, gb.seq_off,
                               torch.device("cuda"))[:2]
        torch.cuda.synchronize()
        pool_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    pk_host = mm_map.pack_pool_nibbles(gb.seq_data)
    pack_ms = (time.perf_counter() - t0) * 1e3
    log(f"mm_map pool of the bench graph ({len(gb.seq_data)} codes): first "
        f"map {pool_ms[0]:.3f} ms (the codes copied), then {pool_ms[1]:.3f} "
        f"ms (cached); the host nibble pack alone {pack_ms:.3f} ms")
    ppool = (torch.as_tensor(pk_host).to("cuda"), pool[1])
    bases, lens = shipped[0][:MM_BATCH], shipped[1][:MM_BATCH]
    thr = dp.MIN_MAP_SCORE           # one scalar, as map_reads passes it
    mt, mm = dp.SCORING_BWA[:2]
    args = (bases, lens, *tables, MM_K, MM_W, *pool, thr, mt, mm)
    pargs = (bases, lens, *ptables, MM_K, MM_W, *ppool, thr, mt, mm)
    out = mm_map.map_batch(*args)
    err = max(err, hold_mm("bench batch verified", out,
                           plain_map_batch(*pargs)),
              hold_mm("bench batch vote", mm_map.map_batch(*args[:7]),
                      plain_map_batch(*pargs[:7])))
    B, L = bases.shape
    res = {}

    def timed(name, kernel, plain, nbytes, ops, key, extra=""):
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        ms2 = cuda_ms(kernel, 20)
        dev = device_ms(kernel, 20, key)
        bound, by = bound_of(nbytes, ops)
        log(f"mm_map {name}: kernel {ms:.4f} ms then {ms2:.4f} ms (wrapper "
            f"and launch), {dev:.4f} ms on the device (profiler); plain "
            f"{plain_ms:.4f} ms; bound {bound:.5f} ms ({by}: {nbytes} "
            f"bytes, {ops} operations){extra}")
        res[name] = dict(ms=min(ms, ms2), kernel_ms=dev, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by)

    nbytes, n_probe, old = mm_map_bytes(bases, lens, ptables, pool[1], out,
                                        False)
    ops = mm_ops(B * (L - MM_K + 1), n_windows(lens, L))
    timed("map_batch", lambda: mm_map.map_batch(*args),
          lambda: plain_map_batch(*pargs), nbytes, ops, "map_kernel",
          f"; B={B} L={L} verified, {len(idx.keys)} index keys, "
          f"{tables[0].shape[0]} buckets, {n_probe} probes; "
          f"{(out[0] >= 0).float().mean().item() * 100:.3f}% voted; the int64 "
          f"layout {old} bytes, bound {bound_of(old, ops)[0]:.5f} ms")
    res["map_batch"]["int64_layout_bound_ms"] = bound_of(old, ops)[0]

    # map_batch's stage split and its alternatives, in turns with the kernel
    stage_of = ("load", "pack", "marks", "probe", "vote")
    variants = variants.result()
    split = (torch.as_tensor(np.concatenate([
        hk.astype(np.uint32).ravel(), vals.astype(np.uint32).ravel()])
        .view(np.int32).reshape(-1, 16)).to("cuda"), None, salt)
    alt = {"split tables": (bases, lens, *split, MM_K, MM_W, *pool, thr, mt,
                            mm),
           "byte-wise bound": args}
    for name, a in alt.items():
        with use_library("mm_map", variants[name]):
            err = max(err, hold_mm(f"bench batch, {name} variant",
                                   mm_map.map_batch(*a), out))
    times = {}
    for turn in range(3):
        times.setdefault("kernel", []).append(
            device_ms(lambda: mm_map.map_batch(*args), 30, "map_kernel"))
        for name in stage_of + tuple(alt):
            a = alt.get(name, args)
            with use_library("mm_map", variants[name]):
                times.setdefault(name, []).append(device_ms(
                    lambda: mm_map.map_batch(*a), 30, "map_kernel"))
    best = {k_: min(v) for k_, v in times.items()}
    prev, parts = 0.0, []
    for name in stage_of + ("kernel",):
        parts.append(f"{'bound' if name == 'kernel' else name} "
                     f"{best[name] - prev:+.4f}")
        prev = best[name]
    byte_stage = best["byte-wise bound"] - best["vote"]
    log("mm_map map_batch stage split (device ms from the profiler, each "
        "the cut's best of 3 turns less the cut before): " + ", ".join(parts)
        + f"; the byte-wise bound stage {byte_stage:+.4f}"
        + "; cuts " + ", ".join(f"{k_} " + "/".join(f"{x:.4f}" for x in v)
                                for k_, v in times.items()))
    res["map_batch"]["stages_ms"] = {k_: round(v, 4) for k_, v in best.items()}

    # map_reads of all the bench reads: its wall beside its device time
    from turingassembler_tpu_torch.mapper.minimizers import map_reads
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        map_reads(idx, reads, lengths, graph=gb, shipped=shipped)
        walls.append(time.perf_counter() - t0)
    prof = StageProfiler()
    with prof.around("map"):
        t0 = time.perf_counter()
        map_reads(idx, reads, lengths, graph=gb, shipped=shipped)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.report("mm_map map_reads of the 1,048,576 bench reads (tables and "
                "pool cached)", {"map": wall})
    log(f"mm_map map_reads: wall " + ", ".join(f"{x:.4f}" for x in walls)
        + f" s; device busy {prof.busy['map']:.4f} s of the profiled "
        f"{wall:.4f} s: the rest is host glue")

    # the bound alone on the votes: the bridge's rescore_hits entry
    edges, starts = out[0].long(), out[2].long()
    bargs = (*pool, edges, starts, bases, lens, mt, mm)
    want = plain_gapless_bound(*bargs)
    err = max(err, hold_mm("bench batch gapless bound",
                           mm_map.gapless_bound(*bargs), want))
    with use_library("mm_map", variants["byte-wise bound"]):
        err = max(err, hold_mm("bench batch gapless bound, byte-wise bound "
                               "variant", mm_map.gapless_bound(*bargs), want))
    timed("gapless_bound", lambda: mm_map.gapless_bound(*bargs),
          lambda: mm_map.plain_gapless_bound(ppool[0], *bargs[1:]),
          B * (L + 4 + 16 + 5) + pool_bytes(pool[1], edges, starts, lens, L)
          + off_bytes(edges), 0, "bound_kernel",
          f"; {B} queries of {L} codes, {mm_map.POOL_PAD}-byte pool pad")
    btimes, wtimes = {}, {}
    for turn in range(3):
        for name in ("kernel", "byte-wise bound"):
            with use_library("mm_map", variants[name]) \
                    if name != "kernel" else contextlib.nullcontext():
                btimes.setdefault(name, []).append(device_ms(
                    lambda: mm_map.gapless_bound(*bargs), 30,
                    "bound_kernel"))
                wtimes.setdefault(name, []).append(cuda_ms(
                    lambda: mm_map.gapless_bound(*bargs), 30))
    log("mm_map gapless_bound in turns (device ms from the profiler, 3 "
        "turns of 30 launches; kernel: bound_group's lanes a query): "
        + ", ".join(f"{k_} " + "/".join(f"{x:.4f}" for x in v)
                    for k_, v in btimes.items())
        + "; with the wrapper (CUDA events) " + ", ".join(
            f"{k_} " + "/".join(f"{x:.4f}" for x in v)
            for k_, v in wtimes.items()))
    res["gapless_bound"]["turns_ms"] = {k_: round(min(v), 4)
                                        for k_, v in btimes.items()}
    # the index build's first device batch
    _, _, mat, elen = next(mz.EdgeMinimizerIndex.segment_batches(gb))
    rows, rlen = (torch.as_tensor(a).to("cuda") for a in (mat, elen))
    got = mm_map.minimizer_rows(rows, rlen, MM_K, MM_W)
    err = max(err, hold_mm("bench index rows", (got,),
                           (plain_minimizer_rows(rows, rlen, MM_K, MM_W),)))
    R, RL = rows.shape
    timed("minimizer_rows",
          lambda: mm_map.minimizer_rows(rows, rlen, MM_K, MM_W),
          lambda: plain_minimizer_rows(rows, rlen, MM_K, MM_W),
          R * (RL + 4) + 16 * got.shape[0] + 4,
          mm_ops(R * (RL - MM_K + 1), n_windows(rlen, RL)), "rows_",
          f"; B={R} L={RL}, {got.shape[0]} marks; writing every "
          f"position would take {R * (RL - MM_K + 1) * 17} bytes, bound "
          f"{bound_of(R * (RL + 4 + 17 * (RL - MM_K + 1)), 0)[0]:.5f} ms")
    P = RL - MM_K + 1
    bufs = [torch.empty((R, -(-P // 32)), dtype=torch.int32, device="cuda"),
            torch.empty(R, dtype=torch.int32, device="cuda"),
            torch.empty((R * P, 4), dtype=torch.int64, device="cuda"),
            torch.empty(1, dtype=torch.int32, device="cuda")]
    res["minimizer_rows"]["launch_ms"] = cuda_ms(lambda: mm_map.LIB.launch(
        "mm_minimizer_rows_launch", rows.device, rows.data_ptr(),
        rlen.data_ptr(), R, RL, MM_K, MM_W, *(b_.data_ptr() for b_ in bufs)),
        20)
    log(f"mm_map minimizer_rows: the launch alone (both passes, no wrapper, "
        f"no sync) {res['minimizer_rows']['launch_ms']:.4f} ms")
    res["max_abs_err"] = err
    return res, (genome, reads, lengths)


def phase_mm_hold_path_shapes(recorded):
    """Phase 22: every (entry, B, L, verified) the paths launched the
    mm_map kernel at, held against the plain version on a synthetic
    world's reads (testing.mm_reads), queries or segment rows of that
    very shape.  Returns the largest |difference| (0)."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.mapper import minimizers as mz
    g = tt.mm_world(seed=9)
    idx = mz.EdgeMinimizerIndex.build(g, device="cuda")
    tables = idx.device_tables("cuda")
    pool = mz._device_pool(g.seq_data, g.seq_off, torch.device("cuda"))[:2]
    make = {"map_batch": ("map", tt.mm_reads),
            "gapless_bound": ("bound", tt.mm_bound_queries),
            "minimizer_rows": ("rows", tt.mm_segment_rows)}
    err = 0
    shapes = sorted({(entry, B, L) for entry, B, L, _v in recorded})
    for i, (entry, B, L) in enumerate(shapes):
        kind, gen = make[entry]
        err = max(err, hold_mm_entry(f"{entry} shape of the paths", kind,
                                     gen(g, B, L, 100 + i), tables, pool))
    log(f"mm_map: {len(shapes)} shapes of the paths held, max |diff| {err}")
    return err


# ---------------------------------------------------------------------------
# phase 23: the kmer_sort kernels (the count's device program)
# ---------------------------------------------------------------------------

KS_K1 = 46                  # the bench's (k+1)-mers
KS_RECORD = 131_072         # reads a count record (megasort.COUNT_CHUNK)
KS_ENTRIES = ("extract_keys", "sort_count", "merge_runs", "lex_order")
# the jitted JAX device code each entry replaces
KS_REPLACES = {
    "extract_keys": "turingassembler_tpu/kmer/megasort.py:73",
    "sort_count": "turingassembler_tpu/kmer/megasort.py:165",
    "merge_runs": "turingassembler_tpu/kmer/megasort.py:225",
    "lex_order": "turingassembler_tpu/graph/device_build.py:89"}
# the phases that drive a path; the kernels line counts their launches
KS_PATH_PHASES = (
    "phase_slice_parity", "phase_full_width", "phase_levels_parity",
    "phase_levels_full_width", "phase_scaffold_parity",
    "phase_scaffold_full_width", "phase_path_scoring",
    "phase_barcode_levels", "phase_multi_process", "phase_ecoli",
    "phase_spill", "phase_bench_twin", "phase_graft_twin")
# the count paths, each of which must launch extract_keys and sort_count
KS_COUNT_PHASES = ("phase_full_width", "phase_levels_full_width",
                   "phase_scaffold_full_width", "phase_ecoli", "phase_spill",
                   "phase_bench_twin")
# kmer_sort launches a phase made in its subprocesses (phase 13's card
# ranks, phase 18's bench twin): (by entry, shapes, sort_count's routes),
# added by main()
KS_REMOTE = []


def ks_remote(by_entry, shapes, routes):
    KS_REMOTE.append((dict(by_entry), [tuple(sh) for sh in shapes],
                      {e: dict(r) for e, r in routes.items()}))


def hold_ks(what, got, want) -> int:
    """Largest |difference| of kmer_sort outputs and their plain versions
    (limbs as unsigned 32-bit values, the card's int32 rows included);
    raises unless the shapes agree and it is 0."""
    from turingassembler_tpu_torch.ops.kmer_sort import as_limbs
    err = 0
    for g_, w_ in zip(got, want):
        g_, w_ = as_limbs(g_), as_limbs(w_)
        if g_.shape != w_.shape:
            raise AssertionError(f"kmer_sort {what}: shape {tuple(g_.shape)}"
                                 f" != the plain version's {tuple(w_.shape)}")
        if g_.numel():
            err = max(err, int((g_.long() - w_.long()).abs().max()))
    if err:
        raise AssertionError(f"kmer_sort {what}: max |diff| {err}")
    return err


def ks_rows(n, nl, seed):
    """n limb rows (int64 on the card) drawn from n / 3 random keys, every
    bit of every limb random."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_keys = max(1, n // 3)
    pool = torch.randint(0, 1 << 32, (n_keys, nl), dtype=torch.int64,
                         device="cuda", generator=gen)
    return pool[torch.randint(0, n_keys, (n,), device="cuda", generator=gen)]


def ks_reads(B, L, seed):
    """B random reads of width L on the card: code-4 bases, a tenth of them
    truncated (255 past their length)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, (B, L), dtype=np.uint8)
    b[rng.random((B, L)) < 0.002] = 4
    ln = np.full(B, L, np.int32)
    short = rng.random(B) < 0.1
    ln[short] = rng.integers(0, L + 1, int(short.sum()))
    b[np.arange(L)[None, :] >= ln[:, None]] = 255
    return put(b, ln)


def device_ms_by_kernel(fn, reps=3):
    """Device ms a call of fn spends in each kernel, memset and copy
    (torch.profiler over reps calls, without the host's time), and its
    launches a call: {profiler key: (ms, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def device_ms_all(fn, reps):
    """Device time a call of fn spends in all its kernels and memsets;
    None when the profiler saw no device time (not measured)."""
    t = sum(ms_ for k_, (ms_, _) in device_ms_by_kernel(fn, reps).items()
            if "Memcpy" not in k_)
    return t if t else None


def ks_timing(what, fn, plain, nbytes, ops, reps=5, library=None,
              tag="kmer_sort", anchor=None):
    """An entry's figures at one shape: wrapper ms (CUDA events around the
    call, its host syncs included), device ms (profiler; with an anchor
    kernel name, device_ms's retry over all the call's kernels), plain ms,
    the library call's ms, and the bound."""
    bound, by = bound_of(nbytes, ops)
    t = {"ms": cuda_ms(fn, reps),
         "device_ms": device_ms_all(fn, reps) if anchor is None
         else device_ms(fn, reps, anchor, whole=True),
         "plain_ms": cuda_ms(plain, 2), "bound_ms": bound, "bound_by": by,
         "library_ms": cuda_ms(library, 2) if library else None}
    dev = "not measured" if t["device_ms"] is None \
        else f"{t['device_ms']:.4f} ms"
    log(f"{tag} {what}: wrapper {t['ms']:.4f} ms, device "
        f"{dev}, plain {t['plain_ms']:.4f} ms, bound "
        f"{bound:.5f} ms ({by}: {nbytes} bytes, {ops} operations)"
        + (f", library {t['library_ms']:.4f} ms" if library else ""))
    return t


def log2_ceil(n):
    return max(1, (int(n) - 1).bit_length())


# the sort_count route each kmer_sort case is named for, on the card
# (ops/kmer_sort.py:LaunchCount.routes["sort_count"] of its call)
KS_CASE_ROUTES = {
    "one prefix over the capacity":
        lambda r: r["over_capacity"] == 1 and r["partition_passes"] >= 1,
    "all equal, large":
        lambda r: r == {"partition_passes": 0, "bucket_groups": 0,
                        "over_capacity": 1},
    "canonical-skewed prefixes":
        lambda r: r["over_capacity"] == 0 and r["bucket_groups"] > 1,
    "many prefixes over the capacity":   # testing.OVER_CAPACITY_CASE's
        lambda r: r["over_capacity"] == 200 and r["partition_passes"] == 2}
# and the lex_order route (LaunchCount.routes["lex_order"])
LEX_CASE_ROUTES = {
    "few values, large":
        lambda r: r == {"partition_passes": 2, "warp_buckets": 0,
                        "block_buckets": 0, "over_capacity": 3},
    "one prefix over the capacity":
        lambda r: r["over_capacity"] == 1 and r["warp_buckets"] > 0,
    "all equal, large": lambda r: not any(r.values()),
    "all ones, nl=2":
        lambda r: r["block_buckets"] > 0 and r["over_capacity"] == 0,
    "canonical-skewed prefixes":
        lambda r: r["over_capacity"] == r["block_buckets"] == 0
        and r["warp_buckets"] > 1}


def ks_routes_of(fn):
    """fn's result and the routes its calls took, by entry."""
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    before = {e: dict(r) for e, r in ks.COUNT.counts.items()}
    out = fn()
    return out, {e: {r: ks.COUNT.counts[e][r] - n_ for r, n_ in rs.items()}
                 for e, rs in before.items()}


def ks_merge_route(what, fn, want):
    """fn's merge_runs result; raises unless its one call took route want
    ("merge_path" or "lsd")."""
    out, routes = ks_routes_of(fn)
    got = routes["merge_runs"]
    if got != {r: int(r == want) for r in got}:
        raise AssertionError(f"kmer_sort: merge_runs {what} took {got}, "
                             f"not {want}")
    return out


def ascending(rows):
    """Every row of (n, nl) limbs at or above the one before it."""
    from turingassembler_tpu_torch.ops import limbs as lb
    from turingassembler_tpu_torch.ops.kmer_sort import as_limbs
    rows = as_limbs(rows)
    return len(rows) < 2 or not bool(lb.lex_lt(rows[1:], rows[:-1]).any())


def lex_library(fp):
    """One PyTorch call that computes lex_order at nl = 2: each row packed
    into an int64 whose signed order is the rows' order, stably sorted."""
    return lambda: torch.sort(((fp[:, 0] - 2 ** 31) << 32) | fp[:, 1],
                              stable=True).indices


def turns_and_split(what, new, old):
    """new and old (the LSD form) in turns, device ms (profiler), then
    new's device ms by kernel; returns the turns' (name, ms)."""
    turns = [(name, device_ms_all(fn, 3)) for name, fn in
             (("new", new), ("LSD form", old), ("LSD form", old),
              ("new", new))]
    log(f"kmer_sort (b) {what} in turns, device ms: " + ", ".join(
        f"{name_} {'not measured' if ms_ is None else f'{ms_:.4f}'}"
        for name_, ms_ in turns))
    split = device_ms_by_kernel(new)
    log(f"kmer_sort (b) {what} by kernel, device ms (launches): " + ", ".join(
        f"{kernel_name(k_)} {ms_:.4f} ({n_})"
        for k_, (ms_, n_) in sorted(split.items(), key=lambda kv: -kv[1][0])))
    return turns


def kernel_name(key):
    """A profiler key's kernel name: 'bucket_kernel<3>', 'Memcpy DtoH'."""
    return key.replace("(anonymous namespace)::", "").split("(")[0] \
        .replace("void ", "").strip()


def phase_ks_kernel_vs_plain(workload):
    """Phase 23 (run after phase 21, before phase 5, on its workload): the
    kmer_sort kernels (csrc/kmer_sort.cu) against their plain versions on
    the card, exact: (a) on testing.kmer_sort_cases, sort_count (int64
    rows and their int32 bit patterns), merge_runs of the raw halves with
    their weights (the LSD route unless both halves are ascending) and of
    the halves' sorted tables (plain_sort_count: the merge path), and
    lex_order (int64 rows and int32 bit patterns); (b) on phase 5's
    workload (1,048,576 reads of 150 bp): extract_keys on the first
    131,072-read record at k1 = 46, 31 and 64 (nl 3, 2, 4) and sort_count
    of each record's rows; the full flush, all eight records' 110,100,480
    rows, through sort_count; merge_runs of the two halves' tables (the
    merge path); lex_order of the level-0 build's fingerprints of the
    bench table; each with wrapper, device, plain and bound ms
    (sort_count beside torch.unique, lex_order beside torch.sort of the
    rows packed into int64).  The routes are logged for every case and
    gated (KS_CASE_ROUTES, LEX_CASE_ROUTES, merge_runs' by the halves'
    order) and for the flush (at most MAX_PARTITION partition passes);
    sort_count of the flush, merge_runs of the tables and lex_order of the
    fingerprints are each timed in turns with the LSD form (a full LSD
    sort and the run pass, _radix + _runs) and split by kernel.
    Returns the kernels line's figures."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.graph import device_build
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    from turingassembler_tpu_torch.ops.devhash import to_i32
    err, n_gates = 0, 0

    def hold(what, got, want):
        nonlocal err, n_gates
        err = max(err, hold_ks(what, got, want))
        n_gates += 1

    # (a) the edge cases; each route case reaches its route
    for name, (keys, w) in tt.kmer_sort_cases().items():
        t, wt = put(keys, w)
        h = len(keys) // 2
        got, routes = ks_routes_of(lambda: ks.sort_count(t))
        routes = routes["sort_count"]
        hold(f"sort_count on {name!r}", got, ks.plain_sort_count(t))
        log(f"kmer_sort (a) sort_count on {name!r} ({len(keys)} x "
            f"{keys.shape[1]}): routes " + ", ".join(
                f"{r} {n_}" for r, n_ in routes.items()))
        if name in KS_CASE_ROUTES and not KS_CASE_ROUTES[name](routes):
            raise AssertionError(f"kmer_sort: {name!r} took the routes "
                                 f"{routes}")
        hold(f"sort_count of int32 rows on {name!r}",
             ks.sort_count(to_i32(t)), ks.plain_sort_count(t))
        # the raw halves: the LSD route unless both are ascending
        raw = "merge_path" if ascending(t[:h]) and ascending(t[h:]) \
            else "lsd"
        hold(f"merge_runs of the raw halves on {name!r} ({raw})",
             ks_merge_route(f"of the raw halves on {name!r}",
                            lambda: ks.merge_runs(t[:h], wt[:h], t[h:],
                                                  wt[h:]), raw),
             ks.plain_merge_runs(t[:h], wt[:h], t[h:], wt[h:]))
        ta, tb = ks.plain_sort_count(t[:h]), ks.plain_sort_count(t[h:])
        hold(f"merge_runs of the halves' tables on {name!r}",
             ks_merge_route(f"of the halves' tables on {name!r}",
                            lambda: ks.merge_runs(*ta, *tb), "merge_path"),
             ks.plain_merge_runs(*ta, *tb))
        got, routes = ks_routes_of(lambda: ks.lex_order(t))
        routes = routes["lex_order"]
        hold(f"lex_order on {name!r}", [got], [ks.plain_lex_order(t)])
        log(f"kmer_sort (a) lex_order on {name!r}: routes " + ", ".join(
            f"{r} {n_}" for r, n_ in routes.items()) + f"; merge_runs of "
            f"the raw halves: {raw}")
        if name in LEX_CASE_ROUTES and not LEX_CASE_ROUTES[name](routes):
            raise AssertionError(f"kmer_sort: lex_order on {name!r} took "
                                 f"the routes {routes}")
        hold(f"lex_order of int32 rows on {name!r}", [ks.lex_order(to_i32(t))],
             [ks.plain_lex_order(t)])
    log(f"kmer_sort (a) testing.kmer_sort_cases: {n_gates} gates, max |diff| "
        f"{err}")
    # an int64 limb outside [0, 2^32) would sort by its low word: refused
    for v in (1 << 32, -1):
        wide, = put(np.array([[5, 1], [3, v], [5, 0]], np.int64))
        try:
            ks.lex_order(wide)
        except ValueError:
            continue
        raise AssertionError(f"kmer_sort: lex_order took the limb {v}")
    log("kmer_sort (a) int64 limbs 2^32 and -1 refused")

    # (b) the bench: a record at three widths, the full flush, a merge, the
    # level-0 build's fingerprints
    res = {}
    bases, lens = put(*workload[1:])
    rec = (bases[:KS_RECORD], lens[:KS_RECORD])
    n_rows = {}
    for k1 in (KS_K1, 31, 64):
        got = ks.extract_keys(*rec, k1)
        n_rows[k1] = got.shape[0]
        want = ks.plain_extract_keys(*rec, k1)
        hold(f"extract_keys of a bench record at k1={k1}", [got], [want])
        hold(f"sort_count of a bench record at k1={k1}",
             ks.sort_count(got), ks.plain_sort_count(want))
        log(f"kmer_sort (b) bench record (131,072 x {rec[0].shape[1]}), "
            f"k1={k1} (nl {got.shape[1]}): {got.shape[0]} rows == plain, "
            "sorted and counted == plain")
    B, L = rec[0].shape
    res["extract_keys"] = ks_timing(
        f"extract_keys ({B} x {L}, k1={KS_K1}, {n_rows[KS_K1]} rows)",
        lambda: ks.extract_keys(*rec, KS_K1),
        lambda: ks.plain_extract_keys(*rec, KS_K1),
        B * L + 4 * B + 4 * 3 * n_rows[KS_K1], 8 * 3 * B * (L - KS_K1 + 1))
    rows = torch.cat([ks.extract_keys(bases[i:i + KS_RECORD],
                                      lens[i:i + KS_RECORD], KS_K1)
                      for i in range(0, bases.shape[0], KS_RECORD)])
    del bases, lens, rec, got, want
    n = rows.shape[0]
    (u, c), routes = ks_routes_of(lambda: ks.sort_count(rows))
    routes = routes["sort_count"]
    hold(f"sort_count of the full flush ({n} rows)", (u, c),
         ks.plain_sort_count(rows))
    log("kmer_sort (b) sort_count of the full flush: routes " + ", ".join(
        f"{r} {n_}" for r, n_ in routes.items()))
    if routes["partition_passes"] > ks.MAX_PARTITION:
        raise AssertionError(f"kmer_sort: the flush took {routes}")
    torch.cuda.empty_cache()
    n_u = u.shape[0]
    # the LSD form (a full LSD sort, the run pass), as lex_order and
    # merge_runs sort, in turns with sort_count: device ms
    new = lambda: ks.sort_count(rows)                       # noqa: E731
    old = lambda: ks._runs(*ks._radix((rows,), ks.digit_plan(3), 0))  # noqa
    hold("the LSD form of sort_count on the full flush", old(), (u, c))
    turns = [(name, device_ms_all(fn, 3)) for name, fn in
             (("sort_count", new), ("LSD form", old), ("LSD form", old),
              ("sort_count", new))]
    log("kmer_sort (b) sort_count of the full flush in turns, device ms: "
        + ", ".join(f"{name_} {'not measured' if ms_ is None else f'{ms_:.4f}'}"
                    for name_, ms_ in turns))
    split = device_ms_by_kernel(new)
    log("kmer_sort (b) sort_count of the full flush by kernel, device ms "
        "(launches): " + ", ".join(
            f"{kernel_name(k_)} {ms_:.4f} ({n_})"
            for k_, (ms_, n_) in sorted(split.items(),
                                        key=lambda kv: -kv[1][0])))
    torch.cuda.empty_cache()
    res["sort_count"] = ks_timing(
        f"sort_count (the full flush: {n} x 3 int32 rows, {n_u} unique)",
        lambda: ks.sort_count(rows),
        lambda: ks.plain_sort_count(rows),
        4 * 3 * n + (8 * 3 + 4) * n_u, 3 * n * log2_ceil(n), reps=3,
        library=lambda: torch.unique(rows, dim=0, return_counts=True))
    res["sort_count"]["turns_device_ms"] = [ms_ for _, ms_ in turns]
    res["sort_count"]["lsd_form_device_ms"] = [
        ms_ for name_, ms_ in turns if name_ == "LSD form"]
    torch.cuda.empty_cache()
    half = n // 2
    ta = ks.sort_count(rows[:half])
    tb = ks.sort_count(rows[half:])
    del rows
    torch.cuda.empty_cache()
    m = ks_merge_route("of the halves' tables",
                       lambda: ks.merge_runs(*ta, *tb), "merge_path")
    hold("merge_runs of the halves' tables", m, ks.plain_merge_runs(*ta, *tb))
    hold("merge_runs of the halves' tables == the full flush's table", m,
         (u, c))
    na, nb = ta[0].shape[0], tb[0].shape[0]
    new = lambda: ks.merge_runs(*ta, *tb)                   # noqa: E731
    old = lambda: ks._runs(*ks._radix(                      # noqa: E731
        (ta[0], tb[0]), ks.digit_plan(3), 1, (ta[1], tb[1])))
    hold("the LSD form of merge_runs on the halves' tables", old(), m)
    turns = turns_and_split(f"merge_runs of the halves' tables ({na} + "
                            f"{nb} rows)", new, old)
    res["merge_runs"] = ks_timing(
        f"merge_runs (the halves' tables: {na} + {nb} rows, {n_u} unique)",
        new, lambda: ks.plain_merge_runs(*ta, *tb),
        (8 * 3 + 4) * (na + nb) + (8 * 3 + 4) * n_u, 3 * (na + nb))
    res["merge_runs"]["turns_device_ms"] = [ms_ for _, ms_ in turns]
    res["merge_runs"]["lsd_form_device_ms"] = [
        ms_ for name_, ms_ in turns if name_ == "LSD form"]
    del ta, tb, m
    captured = []
    kernel_lex_order = ks.lex_order

    def grab(keys):
        captured.append(keys.clone())
        return kernel_lex_order(keys)

    ks.lex_order = grab
    try:
        device_build.build_graph_on_device(u, c, n_u, KS_K1 - 1,
                                           device="cuda")
    finally:
        ks.lex_order = kernel_lex_order
    fp = captured[0]
    got, routes = ks_routes_of(lambda: ks.lex_order(fp))
    routes = routes["lex_order"]
    want = ks.plain_lex_order(fp)
    hold(f"lex_order of the level-0 build's fingerprints {tuple(fp.shape)}",
         [got], [want])
    log("kmer_sort (b) lex_order of the fingerprints: routes " + ", ".join(
        f"{r} {n_}" for r, n_ in routes.items()))
    if routes["partition_passes"] != 2 or not routes["warp_buckets"]:
        raise AssertionError(f"kmer_sort: the fingerprints took {routes}")
    library = lex_library(ks.as_limbs(fp))
    hold("torch.sort of the packed fingerprints (the library call)",
         [library()], [want])
    nf = fp.shape[0]
    new = lambda: ks.lex_order(fp)                          # noqa: E731
    old = lambda: ks._radix((fp,), ks.digit_plan(2), 2)[1]  # noqa: E731
    hold("the LSD form of lex_order on the fingerprints", [old()], [want])
    del got, want
    turns = turns_and_split(f"lex_order of the fingerprints ({nf} x 2)",
                            new, old)
    res["lex_order"] = ks_timing(
        f"lex_order (the level-0 build's fingerprints, {nf} x 2 int32 bit "
        "patterns)", new, lambda: ks.plain_lex_order(fp),
        4 * 2 * nf + 8 * nf, 2 * nf * log2_ceil(nf), library=library)
    res["lex_order"]["routes"] = routes
    res["lex_order"]["turns_device_ms"] = [ms_ for _, ms_ in turns]
    res["lex_order"]["lsd_form_device_ms"] = [
        ms_ for name_, ms_ in turns if name_ == "LSD form"]
    del u, c, fp, captured
    torch.cuda.empty_cache()

    log(f"kmer_sort (b) the bench shapes: all {n_gates} gates max |diff| "
        f"{err}")
    skew_err, res["sort_count"]["over_capacity_shape"] = ks_over_capacity()
    ks_count_split(*workload[1:])
    res["max_abs_err"] = max(err, skew_err)
    return res


# the yeast cell's buckets over capacity, in shape (a repeat-rich
# library's count at nl = 4): prefixes, copies of each prefix's repeated
# row, random rows beside it (testing.over_capacity_rows), 23 M rows
KS_SKEW = (2_000, 7_500, 4_000)


def ks_loop_route(src, part, plan, info, run_keys, run_counts, gruns,
                  rows):
    """The route for sort_count's groups over capacity before the batched
    one, for kmer_sort._over_capacity's place: a host loop, each group
    through _radix + _runs on its own segment, its runs copied into the
    bucket kernel's scratch and its run count written from the host
    (three syncs a group; the list's pull, and here n_over's)."""
    from turingassembler_tpu_torch import tracing
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    tracing.host_sync(2)
    n_over = int(info[1].item())
    for g, r0, r1, _ in info[4:4 + 4 * n_over].view(n_over, 4).tolist():
        u, c = ks._runs(*ks._radix((), plan, 0, soa=(src, r0, r1 - r0))) \
            if part else ks._runs(src, None)
        run_keys[:, r0:r0 + u.shape[0]] = ks.to_i32(u).t()
        run_counts[r0:r0 + u.shape[0]] = c
        tracing.host_sync()             # the scalar's blocking copy
        gruns[g] = u.shape[0]


def ks_syncs(fn):
    """The host syncs the program counts (tracing.host_sync) in one call
    of fn."""
    from turingassembler_tpu_torch import tracing
    tracing.clear()
    tracing.start()
    try:
        with tracing.span("probe"):
            fn()
    finally:
        tracing.stop()
    n = sum(r[6].get("syncs", 0) for r in tracing.records())
    tracing.clear()
    return n


def ks_over_capacity():
    """Phase 23 (c): sort_count on the yeast cell's shape of buckets over
    capacity (KS_SKEW: 2,000 buckets of one row 7,500 times beside 4,000
    random rows, nl = 4) against the plain version, exact, every such
    bucket through the batched route; then in turns (route, loop, loop,
    route) with the host loop it replaced (ks_loop_route in the route's
    place): wall ms (CUDA events, the host's syncs included) and device
    ms (profiler), and each one's launches by kernel and host syncs a
    call.  Returns (max |diff|, the figures)."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    rows = tt.over_capacity_rows(*KS_SKEW, seed=25, device="cuda")
    n = rows.shape[0]
    what = f"sort_count of the repeat-rich shape ({n} x 4 rows)"
    got, routes = ks_routes_of(lambda: ks.sort_count(rows))
    routes = routes["sort_count"]
    err = hold_ks(what, got, ks.plain_sort_count(rows))
    log(f"kmer_sort (c) {what}: routes " + ", ".join(
        f"{r} {n_}" for r, n_ in routes.items()))
    if routes["over_capacity"] != KS_SKEW[0]:
        raise AssertionError(f"kmer_sort: the repeat-rich shape took "
                             f"{routes}")
    route = ks._over_capacity

    def loop():
        ks._over_capacity = ks_loop_route
        try:
            return ks.sort_count(rows)
        finally:
            ks._over_capacity = route

    new = lambda: ks.sort_count(rows)                       # noqa: E731
    err = max(err, hold_ks(f"the host loop on {what}", loop(), got))
    del got
    turns = [(name, cuda_ms(fn, 2), device_ms_all(fn, 1)) for name, fn in
             (("route", new), ("loop", loop), ("loop", loop),
              ("route", new))]
    log(f"kmer_sort (c) {what} in turns, wall / device ms: " + ", ".join(
        f"{name_} {w_:.3f} / "
        f"{'not measured' if d_ is None else f'{d_:.3f}'}"
        for name_, w_, d_ in turns))
    out = {"rows": n, "over_capacity": KS_SKEW[0], "turns": turns}
    for name, fn in (("route", new), ("loop", loop)):
        split = device_ms_by_kernel(fn, reps=1)
        out[f"{name}_launches"] = sum(n_ for _, n_ in split.values())
        out[f"{name}_syncs"] = ks_syncs(fn)
        log(f"kmer_sort (c) {what}, the {name}: {out[f'{name}_launches']} "
            f"device operations, {out[f'{name}_syncs']} host syncs a call; "
            "device ms (launches) by kernel: " + ", ".join(
                f"{kernel_name(k_)} {ms_:.4f} ({n_})" for k_, (ms_, n_) in
                sorted(split.items(), key=lambda kv: -kv[1][0])[:8]))
    del rows
    torch.cuda.empty_cache()
    return err, out


# kernel-name pieces of one count's device work, by part (the rest is
# "other": casts, copies, the tensor code around the kernels)
KS_PARTS = (("ship", ("Memcpy HtoD",)),
            ("extraction", ("extract_kernel",)),
            ("window concat", ("CatArrayBatchedCopy",)),
            ("sort load", ("load_hist_kernel",)),
            ("partition", ("tile_count_kernel", "group_scan_kernel",
                           "tile_scan_kernel", "scatter_kernel")),
            ("bounds and groups", ("bounds_kernel", "groups_kernel")),
            ("bucket", ("bucket_kernel",)),
            ("compaction", ("scan_ll_kernel", "compact_kernel")),
            ("run-length (over capacity)", ("runs_kernel",
                                            "run_counts_kernel",
                                            "gather_kernel",
                                            "place_runs_kernel")))


def ks_count_split(reads, lengths):
    """One count of phase 5's reads from host arrays, as the bench twin
    counts them (count_reads_device: the reads shipped, eight records
    extracted, one flush sorted and run-length counted), under the
    profiler: its wall and its device time by part (KS_PARTS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from turingassembler_tpu_torch.kmer.megasort import count_reads_device
    count_reads_device(reads, lengths, KS_K1 - 1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        count_reads_device(reads, lengths, KS_K1 - 1, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts = dict.fromkeys([p_ for p_, _ in KS_PARTS] + ["other"], 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        part = next((p_ for p_, keys in KS_PARTS
                     if any(k_ in e.key for k_ in keys)), "other")
        parts[part] += e.self_device_time_total / 1e3
    busy = sum(parts.values())
    if not busy:
        log(f"kmer_sort count split: wall {wall * 1e3:.3f} ms; device time "
            "not measured (the profiler saw no device time)")
        return
    log(f"kmer_sort count split (count_reads_device of {len(reads)} reads "
        f"from host arrays, k1={KS_K1}): wall {wall * 1e3:.3f} ms, device "
        f"{busy:.3f} ms: " + ", ".join(f"{p_} {ms:.3f}"
                                     for p_, ms in parts.items()))


def phase_ks_hold_path_shapes(recorded):
    """Phase 24: the kmer_sort kernels against their plain versions once
    more, at every shape the paths launched them at (`recorded`, as
    kmer_sort.COUNT records them), on synthetic rows or reads of that
    shape (merge_runs twice: random rows, the LSD route, and the same rows
    sorted, the merge path).  Returns the largest |difference| (0)."""
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    from turingassembler_tpu_torch.ops.devhash import to_i32
    err = 0
    shapes = sorted(set(recorded))
    for i, sh in enumerate(shapes):
        entry, seed = sh[0], 1_000 + i
        if entry == "extract_keys":
            _, B, L, k1 = sh
            b, ln = ks_reads(B, L, seed)
            got, want = [ks.extract_keys(b, ln, k1)], \
                [ks.plain_extract_keys(b, ln, k1)]
        elif entry == "sort_count":
            _, n, nl = sh
            r = ks_rows(n, nl, seed)
            got, want = ks.sort_count(to_i32(r)), ks.plain_sort_count(r)
        elif entry == "merge_runs":
            # random rows (the LSD route) and the same rows sorted, as
            # tables are (the merge path)
            _, na, nb, nl = sh
            ka, kb = ks_rows(na, nl, seed), ks_rows(nb, nl, seed + 1)
            ca = torch.randint(1, 1000, (na,), dtype=torch.int32,
                               device="cuda")
            cb = torch.randint(1, 1000, (nb,), dtype=torch.int32,
                               device="cuda")
            raw = "merge_path" if ascending(ka) and ascending(kb) else "lsd"
            err = max(err, hold_ks(f"{entry} of random rows at {sh[1:]}",
                                   ks_merge_route(
                                       f"of random rows at {sh[1:]}",
                                       lambda: ks.merge_runs(ka, ca, kb, cb),
                                       raw),
                                   ks.plain_merge_runs(ka, ca, kb, cb)))
            oa, ob = ks.plain_lex_order(ka), ks.plain_lex_order(kb)
            ka, ca, kb, cb = ka[oa], ca[oa], kb[ob], cb[ob]
            got = ks_merge_route(f"of sorted rows at {sh[1:]}",
                                 lambda: ks.merge_runs(ka, ca, kb, cb),
                                 "merge_path")
            want = ks.plain_merge_runs(ka, ca, kb, cb)
        else:
            _, n, nl = sh
            r = ks_rows(n, nl, seed)
            got, want = [ks.lex_order(r)], [ks.plain_lex_order(r)]
        err = max(err, hold_ks(f"{entry} at {sh[1:]}", got, want))
        del got, want
        torch.cuda.empty_cache()
    log(f"kmer_sort: {len(shapes)} shapes of the paths held, max |diff| "
        f"{err}")
    return err


# ---------------------------------------------------------------------------
# phase 25: the unitig_build kernels (the level-0 build's device program)
# ---------------------------------------------------------------------------

UB_ENTRIES = ("front_keys", "link_nodes", "rank_chains", "assemble_unitigs")
# the jitted JAX device code each entry replaces
UB_REPLACES = {
    "front_keys": "turingassembler_tpu/graph/device_build.py:71",
    "link_nodes": "turingassembler_tpu/graph/device_build.py:90",
    "rank_chains": "turingassembler_tpu/graph/device_build.py:150",
    "assemble_unitigs": "turingassembler_tpu/graph/device_build.py:228"}
# each entry's first kernel: device_ms's check that the profiler saw it
UB_ANCHORS = {"front_keys": "front_kernel", "link_nodes": "link_runs_kernel",
              "rank_chains": "rank_link_kernel",
              "assemble_unitigs": "unitig_sums_kernel"}
# the phases whose path builds level 0 on the card: each must launch all
# four entries (phase 6's spilled runs and phase 13's ranks build on the
# host)
UB_PATH_PHASES = (
    "phase_slice_parity", "phase_full_width", "phase_levels_parity",
    "phase_levels_full_width", "phase_scaffold_parity",
    "phase_scaffold_full_width", "phase_ecoli", "phase_bench_twin")
# unitig_build launches a phase made in a subprocess (phase 18's bench
# twin): (by entry, shapes), added by main()
UB_REMOTE = []


def hold_ub(what, got, want) -> int:
    """Largest |difference| of unitig_build outputs and their plain
    versions; raises unless every pair has one shape and dtype and it is
    0."""
    err = 0
    for g_, w_ in zip(got, want):
        if g_.shape != w_.shape or g_.dtype != w_.dtype:
            raise AssertionError(
                f"unitig_build {what}: {g_.dtype} {tuple(g_.shape)} != the "
                f"plain version's {w_.dtype} {tuple(w_.shape)}")
        if g_.numel():
            err = max(err, int((g_.long() - w_.long()).abs().max()))
    if err:
        raise AssertionError(f"unitig_build {what}: max |diff| {err}")
    return err


def ub_entries(u, c, k, what, hold):
    """Every entry of the build on the card against its plain version on
    the same inputs, in the build's order (the cycle break and the second
    ranking where the first finds cycles).  Returns the kernel route's
    lanes and scalars for the timings."""
    from turingassembler_tpu_torch.graph import device_build as tdb
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    from turingassembler_tpu_torch.ops import unitig_build as ub
    fp, flags, info = ub.front_keys(u, k)
    hold(f"front_keys on {what}", (fp, flags, info), ub.plain_front_keys(u, k))
    order = ks.lex_order(fp)
    link = ub.link_nodes(fp, order, flags)
    hold(f"link_nodes on {what}", link, ub.plain_link_nodes(fp, order, flags))
    sk, tk, lbase, prev = link
    head, dist, info = ub.rank_chains(prev, info)
    ph, pd, pinfo = ub.plain_rank_chains(prev)
    hold(f"rank_chains on {what}", (head, dist, info[:2]),
         (ph, pd, pinfo[:2]))
    n_cyc, n_e, bad = info.tolist()
    if bad:
        raise AssertionError(f"unitig_build {what}: a limb out of range")
    if n_cyc:
        prev, head, dist = tdb._break_cycles(prev, head, info)
        n_e = info.tolist()[1]
        ph, pd, pinfo = ub.plain_rank_chains(prev)
        hold(f"rank_chains after the cycle break on {what}",
             (head, dist, info[:2]), (ph, pd, pinfo[:2]))
    out = ub.assemble_unitigs(u, c, sk, tk, lbase, head, dist, k, n_e)
    want = ub.plain_assemble_unitigs(u, c, sk, tk, lbase, head, dist, k, n_e)
    hold(f"assemble_unitigs on {what}", (out.ints, out.seq),
         (want.ints, want.seq))
    return {"fp": fp, "flags": flags, "order": order, "link": link,
            "head": head, "dist": dist, "n_cyc": n_cyc, "n_e": n_e,
            "unitigs": out}


# the cases whose fingerprints link_nodes is held on with made-up
# collisions (tests/test_torch_unitig_build.py's LINK_BASES, the same
# seeds)
UB_LINK_BASES = ("error-laden branching, k=31", "k=45", "circular, k=21")
# lists other forms of csrc/unitig_build.cu to time link_nodes against
UB_FORMS = "TA_UB_FORMS"


def ub_link_collisions(what, fp, flags, seed, hold):
    """link_nodes against its plain version on made-up collisions of the
    fingerprints fp (testing.link_collision_cases), in lex_order's order
    and, for two of them, with the equal rows shuffled."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    from turingassembler_tpu_torch.ops import limbs as lb
    from turingassembler_tpu_torch.ops import unitig_build as ub
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for case, f in tt.link_collision_cases(fp.cpu().numpy(),
                                           flags.cpu().numpy(), seed).items():
        f = torch.as_tensor(f, device="cuda")
        orders = {"": ks.lex_order(f)}
        if case in ("runs of 9-40 lanes", "one run of 5,000 lanes"):
            o = orders[""]
            run = torch.cumsum(lb.run_starts(f[o]), 0)
            mix = torch.randperm(len(f), device="cuda", generator=gen)
            orders[", the equal rows shuffled"] = \
                o[mix[torch.argsort(run[mix], stable=True)]]
        for tag, o in orders.items():
            hold(f"link_nodes on {what}, {case}{tag}",
                 ub.link_nodes(f, o, flags), ub.plain_link_nodes(f, o, flags))
    log(f"unitig_build link_nodes on {what}'s fingerprints with made-up "
        f"collisions ({', '.join(tt.LINK_COLLISIONS)}): == plain")


def ub_link_timing(what, lanes, n):
    """link_nodes' wrapper, device, plain and bound ms at one table, and
    its device ms by kernel (the profiler)."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    fp, order, flags = lanes["fp"], lanes["order"], lanes["flags"]
    D = 2 * n
    call = lambda: ub.link_nodes(fp, order, flags)  # noqa: E731
    t = ks_timing(f"link_nodes on {what} ({D} lanes)", call,
                  lambda: ub.plain_link_nodes(fp, order, flags),
                  8 * D + 8 * D + n + 13 * D, 30 * D, tag="unitig_build",
                  anchor=UB_ANCHORS["link_nodes"])
    by = device_ms_by_kernel(call)
    t["stages_ms"] = {kernel_name(k_): ms_ for k_, (ms_, _) in by.items()}
    log(f"unitig_build link_nodes on {what} by kernel, device ms "
        "(launches a call): " + ", ".join(
            f"{kernel_name(k_)} {ms_:.4f} ({n_})" for k_, (ms_, n_) in
            by.items()))
    return t


UB_LINK_KERNELS = ("link_runs_kernel", "link_lanes_kernel")
# link_runs_kernel with a part cut out, timed beside the whole kernel
# (the outputs are not held): the word scatter written by position, the
# fingerprint gather replaced by a made-up value of the position
UB_LINK_CUTS = {
    "no word scatter": [("            word[d[q]] = run_word(",
                         "            word[j0 + q] = run_word(")],
    "no fingerprint gather": [("            v[q] = fp[d[q]];",
                               "            v[q] = make_uint2((unsigned)"
                               "((j0 + q) >> 1), 0u);")]}
UB_LINK_CUTS["neither"] = UB_LINK_CUTS["no word scatter"] + \
    UB_LINK_CUTS["no fingerprint gather"]


def ub_link_cut_variants():
    """The UB_LINK_CUTS copies of csrc/unitig_build.cu, built."""
    return source_variants("unitig_build", UB_LINK_CUTS,
                           timed=UB_LINK_KERNELS)


def ub_link_cuts(lanes, libs):
    """link_runs_kernel's device ms (the profiler) whole and with each cut
    of libs (ub_link_cut_variants), in turns there and back: what its
    random gather and scatter cost."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    fp, order, flags = lanes["fp"], lanes["order"], lanes["flags"]
    call = lambda: ub.link_nodes(fp, order, flags)  # noqa: E731
    names = ["whole", *libs]
    turns = []
    for name in names + names[::-1]:
        with use_library("unitig_build", libs[name]) if name in libs \
                else contextlib.nullcontext():
            by = device_ms_by_kernel(call)
        turns.append((name, sum(ms_ for k_, (ms_, _) in by.items()
                                if "link_runs_kernel" in k_)))
    log("unitig_build link_runs_kernel with parts cut out, in turns, device "
        "ms: " + ", ".join(f"{name} {ms_:.4f}" for name, ms_ in turns))
    return turns


def ub_form_turns(lanes):
    """link_nodes at one table in turns with other forms of
    csrc/unitig_build.cu, the sources that TA_UB_FORMS lists (paths
    joined by os.pathsep, each named by its file name, built one after
    another): this form, then each listed one, then back in the
    reverse order (device ms, the profiler), each form's outputs held
    equal to this one's.  None when it is unset."""
    srcs = [p_ for p_ in os.environ.get(UB_FORMS, "").split(os.pathsep)
            if p_]
    if not srcs:
        log("unitig_build link_nodes in turns with other forms: not "
            f"measured ({UB_FORMS} unset)")
        return None
    from turingassembler_tpu_torch.ops import unitig_build as ub
    libs = {}
    for path in srcs:
        with open(path) as f:
            libs.update(source_variants(
                "unitig_build", {os.path.basename(path): []}, src=f.read(),
                timed=UB_LINK_KERNELS))
    fp, order, flags = lanes["fp"], lanes["order"], lanes["flags"]
    call = lambda: ub.link_nodes(fp, order, flags)  # noqa: E731
    for name, lib in libs.items():
        with use_library("unitig_build", lib):
            hold_ub(f"link_nodes, the form {name}", call(), lanes["link"])
    turns = []
    names = ["this", *libs]
    for name in names + names[::-1]:
        with use_library("unitig_build", libs[name]) if name in libs \
                else contextlib.nullcontext():
            turns.append((name, device_ms_all(call, 3)))
    log("unitig_build link_nodes in turns with other forms, device ms: "
        + ", ".join(f"{name} {'not measured' if ms_ is None else f'{ms_:.4f}'}"
                    for name, ms_ in turns))
    return turns


def ub_routes():
    """The build's entries by route: the kernels (the wrappers) and the
    tensor route (their plain versions on the card, the build before
    csrc/unitig_build.cu; lex_order is a kernel in both)."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    kernels = {e: getattr(ub, e) for e in UB_ENTRIES}
    tensor = {e: getattr(ub, "plain_" + e) for e in UB_ENTRIES}
    # device_build hands rank_chains the kernel's walks tally (None unless
    # tracing); the tensor route keeps none
    tensor["rank_chains"] = lambda prev_ptr, info=None, walks=None: \
        ub.plain_rank_chains(prev_ptr, info)
    return {"kernels": kernels, "tensor": tensor}


@contextlib.contextmanager
def ub_route(fns):
    """graph/device_build.py with fns (an ub_routes() route) in place of
    ops/unitig_build.py's entries."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    saved = {e: getattr(ub, e) for e in UB_ENTRIES}
    for e, fn in fns.items():
        setattr(ub, e, fn)
    try:
        yield
    finally:
        for e, fn in saved.items():
            setattr(ub, e, fn)


def host_syncs(fn):
    """fn's result and the synchronizing CUDA calls it made (torch's sync
    debug mode warns at each)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def traced_build(fn):
    """fn() under the program's tracer (turingassembler_tpu_torch/
    tracing.py): its result and the records of the `build` spans it
    made."""
    from turingassembler_tpu_torch import tracing
    tracing.clear()
    tracing.start()
    try:
        out = fn()
    finally:
        tracing.stop()
    recs = [r for r in tracing.records() if r[2].split(".")[0] == "build"]
    tracing.clear()
    return out, recs


def ub_build_split(route, fns, u, c, k, lanes):
    """One route's level-0 build of the bench table: its wall (median of 3
    synchronized builds), its host syncs (all, and device_build's own),
    each stage's device ms (profiler, the stage alone on the kernel
    route's inputs), the output pulls' and the host's rebuild_adjacency
    ms."""
    from turingassembler_tpu_torch.graph import device_build as tdb
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    n = u.shape[0]
    build = lambda: tdb.build_graph_on_device(u, c, n, k,  # noqa: E731
                                              device="cuda")
    with ub_route(fns):
        build()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = build()
            walls.append((time.perf_counter() - t0) * 1e3)
        _, syncs = host_syncs(build)
        # device_build's own: every sync of its spans but lex_order's,
        # which build.front holds
        own = sum(r[6].get("syncs", 0) for r in traced_build(build)[1]
                  if r[2] != "build.front")
    stages = {
        "front_keys": lambda: fns["front_keys"](u, k),
        "lex_order": lambda: ks.lex_order(lanes["fp"]),
        "link_nodes": lambda: fns["link_nodes"](lanes["fp"], lanes["order"],
                                                lanes["flags"]),
        "rank_chains": lambda: fns["rank_chains"](lanes["link"][3]),
        "assemble_unitigs": lambda: fns["assemble_unitigs"](
            u, c, *lanes["link"][:3], lanes["head"], lanes["dist"], k,
            lanes["n_e"])}
    dev = {name: device_ms_all(fn, 3) for name, fn in stages.items()}
    # the output pulls: the wait for the queued build, then the copies
    t0 = time.perf_counter()
    out = stages["assemble_unitigs"]()
    torch.cuda.synchronize()
    wait = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out.to_host()
    pulls = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    g.rebuild_adjacency()
    adjacency = (time.perf_counter() - t0) * 1e3
    res = {"wall_ms": sorted(walls)[1], "syncs": syncs, "own_syncs": own,
           "device_ms": dev, "wait_ms": wait, "pulls_ms": pulls,
           "adjacency_ms": adjacency}
    log(f"unitig_build (b) the build by the {route} route: wall "
        f"{res['wall_ms']:.3f} ms (median of 3), {syncs} host syncs "
        f"({own} of device_build's own), device ms by stage: " + ", ".join(
            f"{k_} {'not measured' if v is None else f'{v:.4f}'}"
            for k_, v in dev.items())
        + f"; assemble_unitigs queued and waited for {wait:.3f} ms, then "
        f"the output pulls {pulls:.3f} ms (copies alone), "
        f"rebuild_adjacency {adjacency:.3f} ms")
    return res


def phase_ub_kernel_vs_plain(workload):
    """Phase 25: ub_kernel_vs_plain, the link_nodes cuts building (nvcc)
    while the edge cases run."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        return ub_kernel_vs_plain(workload, ex.submit(ub_link_cut_variants))


def ub_kernel_vs_plain(workload, cuts):
    """Phase 25 (after phase 23, before phase 5, on its workload): the
    level-0 build's kernels (csrc/unitig_build.cu) against their plain
    versions on the card, exact: (a) each entry on every non-empty case
    of testing.unitig_build_cases (with the circular case's cycle break
    and second ranking on the card), and every case's whole build on the
    card == on the CPU, the circular one through the cycle break;
    link_nodes on made-up collisions of UB_LINK_BASES' fingerprints; (b)
    on phase 5's workload counted on the card (1,999,953 k-edges at k =
    45): each entry again, then its wrapper, device (profiler), plain and
    bound ms, link_nodes by kernel, link_runs_kernel with parts cut out
    (cuts: the future of ub_link_cut_variants) and link_nodes in turns
    with the other forms of the source that TA_UB_FORMS lists, where it
    is set; rank_chains by stage with the kernel's own tally of its
    walks, assemble_unitigs' renumbering stage alone beside torch.unique
    of the same endpoints; (c) the three again at a many-unitig table
    (ub_table: random k-edges beside a genome's windows), and link_nodes
    on its fingerprints' made-up collisions; (d) rank_chains on random
    chains with short cycles and a walk long enough to promote rulers
    (ub_chains), at three lane counts and at 2^25 - 1 lanes (where a
    lane's word leaves a walk 5 offset bits), timed there too; the
    build's split (wall, host syncs, device ms by stage, the wait and the
    output pulls after it, rebuild_adjacency) by the kernel route and the
    tensor route in turns.  Returns the kernels line's figures."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.graph import device_build as tdb
    from turingassembler_tpu_torch.kmer.megasort import count_reads_device
    from turingassembler_tpu_torch.ops import unitig_build as ub
    err, n_gates = 0, 0

    def hold(what, got, want):
        nonlocal err, n_gates
        err = max(err, hold_ub(what, got, want))
        n_gates += 1

    # (a) the edge cases
    for name, (keys, counts, k) in tt.unitig_build_cases().items():
        u, c = put(keys, counts)
        if len(keys):
            r = ub_entries(u, c, k, repr(name), hold)
            log(f"unitig_build (a) {name!r} ({len(keys)} k-edges): "
                f"{r['n_cyc']} cycle lanes, {r['n_e']} unitigs == plain")
            if name.startswith("circular") and not r["n_cyc"]:
                raise AssertionError("unitig_build: the circular case has "
                                     "no cycle")
            if name in UB_LINK_BASES:
                ub_link_collisions(repr(name), r["fp"], r["flags"], len(name),
                                   hold)
        g, recs = traced_build(lambda: tdb.build_graph_on_device(
            u, c, len(keys), k, device="cuda"))
        if name.startswith("circular") and not any(
                r[2] == "build" and r[6]["cycle_breaks"] for r in recs):
            raise AssertionError("unitig_build: the circular build broke no "
                                 "cycle on the card")
        gc = tdb.build_graph_on_device(u.cpu(), c.cpu(), len(keys), k,
                                       device="cpu")
        for f in ("edge_source", "edge_target", "edge_rc", "edge_count",
                  "seq_off", "seq_data", "node_rc", "adj_off", "adj_list"):
            hold(f"the build's {f} on {name!r}, card vs CPU",
                 [torch.as_tensor(getattr(g, f))],
                 [torch.as_tensor(getattr(gc, f))])
    log(f"unitig_build (a) testing.unitig_build_cases: {n_gates} gates, max "
        f"|diff| {err}")

    # (b) the bench table
    _, reads, lengths = workload
    u, c, n = count_reads_device(reads, lengths, 45, device="cuda")
    u, c, k = u[:n], c[:n], 45
    lanes = ub_entries(u, c, k, f"the bench table ({n} k-edges)", hold)
    D, nl1 = 2 * n, u.shape[1]
    nl = (k + 15) // 16
    res = {}
    res["front_keys"] = ks_timing(
        f"front_keys ({n} x {nl1} int64 k-edges, k={k})",
        lambda: ub.front_keys(u, k), lambda: ub.plain_front_keys(u, k),
        8 * nl1 * n + 8 * D + n, n * (64 * nl + 4 * nl1 + 42),
        tag="unitig_build", anchor=UB_ANCHORS["front_keys"])
    res["link_nodes"] = ub_link_timing("the bench table", lanes, n)
    res["link_nodes"]["cuts"] = ub_link_cuts(lanes, cuts.result())
    res["link_nodes"]["turns"] = ub_form_turns(lanes)
    res.update(ub_rank_and_assemble("the bench table", u, c, k, lanes))
    # (c) many short unitigs: random k-edges beside a genome's windows
    mu, mc = ub_table(1_999_953, 45, 4_000)
    many = ub_entries(mu, mc, 45, "the many-unitig table", hold)
    res["link_nodes"]["many_unitigs"] = ub_link_timing(
        "the many-unitig table", many, mu.shape[0])
    ub_link_collisions("the many-unitig table", many["fp"], many["flags"],
                       4_000, hold)
    for e, r_ in ub_rank_and_assemble("the many-unitig table", mu, mc, 45,
                                      many).items():
        res[e]["many_unitigs"] = {"n_e": many["n_e"], **r_}
    del mu, mc, many
    # (d) random chains with short cycles and a long walk, at the bench's
    # lanes, two more counts and UB_LARGE_D
    for D_ in (D, 65_537, 1_000, UB_LARGE_D):
        prev_ = ub_chains(D_, 3_000 + D_ % 1000)
        ph, pd, pinfo = ub.plain_rank_chains(prev_)
        if not pinfo[0]:
            raise AssertionError(f"ub_chains({D_}) holds no cycle")
        h, d_, info_ = ub.rank_chains(prev_)
        hold(f"rank_chains on chains with short cycles (D={D_})",
             (h, d_, info_[:2]), (ph, pd, pinfo[:2]))
        walks = ub_rank_walks(prev_, f"chains of {D_} lanes")
        if D_ >= UB_RUN_MIN_D and not walks["promoted_rulers"]:
            raise AssertionError(f"unitig_build: ub_chains({D_})'s long walk "
                                 "promoted no ruler")
        log(f"unitig_build (d) {D_} lanes in chains, {int(pinfo[0])} on "
            f"short cycles: == plain")
        if D_ == UB_LARGE_D:
            res["rank_chains"]["large_d"] = {
                "lanes": D_, **ub_rank_timing(
                    f"chains of {D_} lanes", prev_), **walks}
        del prev_, ph, pd, h, d_
    torch.cuda.empty_cache()

    # the build's split, the kernel and the tensor route in turns
    routes = ub_routes()
    turns = [(r_, ub_build_split(r_, routes[r_], u, c, k, lanes))
             for r_ in ("kernels", "tensor", "tensor", "kernels")]
    for r_, sp in turns:
        if r_ == "kernels" and sp["own_syncs"] > 3:
            raise AssertionError(f"unitig_build: the kernel route's build "
                                 f"made {sp['own_syncs']} syncs of its own")
    res["split"] = turns
    log(f"unitig_build (b) the bench shapes: all {n_gates} gates max |diff| "
        f"{err}")
    res["max_abs_err"] = err
    return res


def ub_table(n, k, seed):
    """n sorted unique canonical k-edge rows (int64 limbs) on the card and
    their counts: the windows of a random genome (chains) and random
    (k+1)-mers, n of them kept."""
    from turingassembler_tpu_torch.ops import kmers as km
    from turingassembler_tpu_torch.ops import limbs as lb
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1 = k + 1
    g = torch.randint(0, 4, (1, n // 2 + k1), dtype=torch.uint8,
                      device="cuda", generator=gen)
    walk = km._pack_windows(g, k1)[0]
    nl1 = walk.shape[1]
    rnd = torch.randint(0, 1 << 32, (n, nl1), dtype=torch.int64,
                        device="cuda", generator=gen)
    used = 2 * k1 - 32 * (nl1 - 1)
    rnd[:, -1] &= ((1 << used) - 1) << (32 - used)
    rows = torch.unique(lb.canonicalize(torch.cat([walk, rnd]), k1)[0], dim=0)
    keep = torch.randperm(rows.shape[0], device="cuda", generator=gen)[:n]
    counts = torch.randint(1, 100, (n,), dtype=torch.int32, device="cuda",
                           generator=gen)
    return rows[keep.sort().values], counts


def ub_ruler_lanes(D, stride):
    """rank_chains' sampled lane of each ruler block of `stride` lanes
    (csrc/unitig_build.cu's ruler_lane: murmur3's finalizer of the block
    picks the offset; 32-bit products in 16-bit pieces), on the card; the
    last may lie past D."""
    M = 0xFFFFFFFF

    def mul(h, c):
        return (h * (c & 0xFFFF) + ((h * (c >> 16)) << 16)) & M
    i = torch.arange(-(-D // stride), dtype=torch.int64, device="cuda")
    h = i ^ (i >> 16)
    h = mul(h, 0x85EBCA6B)
    h = mul(h ^ (h >> 13), 0xC2B2AE35)
    return i * stride + ((h ^ (h >> 16)) & (stride - 1))


# ub_chains' lanes from which a head leads a run of UB_RUN lanes that are
# no sample: past 2^ob (ob at most 10), so its walk promotes rulers
UB_RUN, UB_RUN_MIN_D = 1_100, 2_000
# rank_chains' lanes of a 16.8 M k-edge table: a lane's word leaves a walk
# 5 offset bits there (8 at the bench)
UB_LARGE_D = (1 << 25) - 1


def ub_chains(D, seed):
    """prev_ptr (D,) int32 on the card: a random permutation cut into
    chains; with D >= 200, five short cycles closed from lanes that are
    no ruler at rank_chains' stride (no walk reaches them) and one of
    2-12 sampled lanes (its rulers stay pending); with D >= UB_RUN_MIN_D,
    a head followed by UB_RUN lanes that are no sample."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    gen = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(D, device="cuda", generator=gen)
    prev = torch.full((D,), -1, dtype=torch.int32, device="cuda")
    prev[perm[1:]] = perm[:-1].int()
    cuts = torch.randperm(D, device="cuda", generator=gen)[:max(D // 1000, 1)]
    prev[perm[cuts]] = -1
    if D >= 200:
        rulers = ub_ruler_lanes(D, ub.RANK_STRIDE)
        rulers = rulers[rulers < D]
        plain = torch.ones(D, dtype=torch.bool, device="cuda")
        plain[rulers] = False
        plain = plain.nonzero().squeeze(1)
        plain = plain[torch.randperm(plain.numel(), device="cuda",
                                     generator=gen)]
        pick = torch.randperm(rulers.numel(), device="cuda", generator=gen)
        cycles = [plain[6 * i:6 * i + 2 + i] for i in range(5)] + \
            [rulers[pick[:min(12, rulers.numel())]]]
        for cyc in cycles:
            prev[torch.isin(prev.long(), cyc)] = -1
            prev[cyc] = torch.roll(cyc, 1).int()
        if D >= UB_RUN_MIN_D:
            run = plain[40:40 + UB_RUN]
            prev[torch.isin(prev.long(), run)] = -1
            prev[run[0]] = -1
            prev[run[1:]] = run[:-1].int()
    return prev


def ub_rank_walks(prev, what):
    """One more rank_chains of prev with the kernel's walks tally: its
    walks, the longest in lanes, the rulers its long walks promoted and
    the offset bits a lane's word gave a walk, logged."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    tally = torch.zeros(4, dtype=torch.int32, device="cuda")
    ub.rank_chains(prev, walks=tally)
    w = dict(zip(("walks", "longest_walk", "promoted_rulers", "walk_bits"),
                 tally.tolist()))
    log(f"unitig_build rank_chains on {what} at stride {ub.RANK_STRIDE}, "
        f"the kernel's tally: {w['walks']} walks, the longest "
        f"{w['longest_walk']} lanes, {w['promoted_rulers']} rulers promoted "
        f"(a walk promotes 2^{w['walk_bits']} lanes past its ruler)")
    return w


def ub_rank_timing(what, prev):
    """rank_chains' wrapper, device, plain and bound ms on prev, and its
    device ms by stage (the profiler, kernel by kernel)."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    D = prev.shape[0]
    rank = ks_timing(
        f"rank_chains on {what} ({D} lanes, stride {ub.RANK_STRIDE})",
        lambda: ub.rank_chains(prev), lambda: ub.plain_rank_chains(prev),
        4 * D + 8 * D, 10 * D, tag="unitig_build",
        anchor=UB_ANCHORS["rank_chains"])
    by = device_ms_by_kernel(lambda: ub.rank_chains(prev))
    rank["stages_ms"] = {name: sum(ms_ for k_, (ms_, _) in by.items()
                                   if key in k_) for name, key in RANK_STAGES}
    log(f"unitig_build rank_chains on {what} by stage: " + ", ".join(
        f"{k_} {v:.4f}" for k_, v in rank["stages_ms"].items()) + " ms")
    return rank


def ub_renumber_input(sk, tk, head, dist, n_e):
    """assemble_unitigs' renumbering input: the heads' source and the
    tails' target keys (int64)."""
    D = head.shape[0]
    d_idx = torch.arange(D, device="cuda")
    is_head = head == d_idx
    u_of = (torch.cumsum(is_head, 0) - 1)[head.long()]
    ulen = torch.bincount(u_of, minlength=n_e)
    tail = dist == ulen[u_of] - 1
    tail_d = torch.empty(n_e, dtype=torch.int64, device="cuda")
    tail_d[u_of[tail]] = d_idx[tail]
    return sk[torch.nonzero(is_head).squeeze(1)].long(), tk[tail_d].long()


RANK_STAGES = (("successors", "rank_link"), ("walks", "rank_walk"),
               ("ruler rounds", "rank_rulers"), ("finish", "rank_finish"),
               ("cycles", "rank_cycles"), ("memsets", "Memset"))
# the renumbering stage's kernels: the Used scan of the marked endpoint
# nodes and the renumbering pass
RENUMBER_KERNELS = ("renumber", "Used")


def ub_rank_and_assemble(what, u, c, k, lanes):
    """rank_chains and assemble_unitigs timed at one table: wrapper,
    device, plain and bound ms; rank_chains' device ms by stage and the
    kernel's tally of its walks; assemble_unitigs' renumbering stage alone
    (its kernels' device ms) beside torch.unique of the same
    endpoints."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    n = u.shape[0]
    D, n_e, nl1 = 2 * n, lanes["n_e"], u.shape[1]
    sk, tk, lbase, prev = lanes["link"]
    head, dist = lanes["head"], lanes["dist"]
    res = {"rank_chains": {**ub_rank_timing(what, prev),
                           **ub_rank_walks(prev, what)}}
    e_src, e_tgt = ub_renumber_input(sk, tk, head, dist, n_e)
    call = lambda: ub.assemble_unitigs(  # noqa: E731
        u, c, sk, tk, lbase, head, dist, k, n_e)
    asm = ks_timing(
        f"assemble_unitigs on {what} ({D} lanes, {n_e} unitigs)", call,
        lambda: ub.plain_assemble_unitigs(u, c, sk, tk, lbase, head, dist, k,
                                          n_e),
        4 * n + D + 8 * D + 8 * n_e + 8 * nl1 * n_e + 8 * (5 * n_e + 2)
        + D + k * n_e, 10 * D + k * n_e, tag="unitig_build",
        anchor=UB_ANCHORS["assemble_unitigs"],
        library=lambda: torch.unique(torch.cat([e_src // 2, e_tgt // 2]),
                                     sorted=True, return_inverse=True))
    by = device_ms_by_kernel(call)
    asm["stages_ms"] = {k_: ms_ for k_, (ms_, _) in by.items()}
    asm["renumber_ms"] = sum(ms_ for k_, (ms_, _) in by.items()
                             if any(r_ in k_ for r_ in RENUMBER_KERNELS))
    log(f"unitig_build assemble_unitigs on {what} by kernel: " + ", ".join(
        f"{k_} {ms_:.4f} ({n_} a call)" for k_, (ms_, n_) in by.items())
        + f"; the renumbering stage alone {asm['renumber_ms']:.4f} ms "
        f"against torch.unique {asm['library_ms']:.4f} ms "
        f"({2 * n_e} endpoints)")
    res["assemble_unitigs"] = asm
    return res


def phase_ub_hold_path_shapes(recorded):
    """Phase 26: the level-0 build's kernels against their plain versions
    once more, at every shape the paths launched them at (`recorded`, as
    unitig_build.COUNT records them): a synthetic table (ub_table) of
    each (n, k) through all four entries, and a rank_chains shape of no
    such table on random chains.  Returns the largest |difference| (0)."""
    from turingassembler_tpu_torch.ops import unitig_build as ub
    err, n_gates = 0, 0

    def hold(what, got, want):
        nonlocal err, n_gates
        err = max(err, hold_ub(what, got, want))
        n_gates += 1

    tables = sorted({(sh[1], sh[2]) for sh in recorded
                     if sh[0] in ("front_keys", "assemble_unitigs")})
    for i, (n, k) in enumerate(tables):
        u, c = ub_table(n, k, 2_000 + i)
        ub_entries(u, c, k, f"a path shape (n={n}, k={k})", hold)
        del u, c
        torch.cuda.empty_cache()
    lanes = {2 * n for n, _ in tables}
    for sh in sorted({sh for sh in recorded if sh[0] == "rank_chains"}):
        if sh[1] not in lanes:
            prev = ub_chains(sh[1], 3_000 + sh[1] % 1000)
            h, d, info = ub.rank_chains(prev)
            ph, pd, pinfo = ub.plain_rank_chains(prev)
            hold(f"rank_chains at D={sh[1]}", (h, d, info[:2]),
                 (ph, pd, pinfo[:2]))
    if {sh[1] for sh in recorded if sh[0] == "link_nodes"} - \
            {n for n, _ in tables}:
        raise AssertionError("unitig_build: a link_nodes shape without its "
                             "front_keys shape")
    log(f"unitig_build: {len(tables)} tables of the paths' shapes held "
        f"({n_gates} gates), max |diff| {err}")
    return err


# ---------------------------------------------------------------------------
# levels: FASTQ files -> level 0, 1, 2 graph files (pipeline.assembly_basic)
# ---------------------------------------------------------------------------

K_LEVELS, MIN_COUNT_LEVELS = 45, 2
LEVEL_FILES = [f"graph_k_{K_LEVELS}_level_{lv}.{ext}" for lv in (0, 1, 2)
               for ext in ("bin", "gfa", "fasta")]


def write_library(d, genome_len, seed):
    """The levels workload (testing.diploid_reads) as two FASTQ files,
    half the reads each, haplotypes interleaved.  Returns (hap_a, hap_b,
    n_clusters, n_reads, [R1, R2], seconds the writing took)."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.io.fastq import write_fastq
    hap_a, hap_b, n_clusters, reads, _ = tt.diploid_reads(genome_len, seed)
    reads = reads[np.random.default_rng(seed).permutation(len(reads))]
    half = len(reads) // 2
    paths = [os.path.join(d, "R1.fq"), os.path.join(d, "R2.fq")]
    t0 = time.perf_counter()
    for path, part in zip(paths, (reads[:half], reads[half:])):
        write_fastq(path, [b"r%d" % i for i in range(len(part))], list(part))
    return (hap_a, hap_b, n_clusters, len(reads), paths,
            time.perf_counter() - t0)


def levels_config(paths, out_dir, **device_kw):
    from turingassembler_tpu_torch.config import Config
    cfg = Config(k0=K_LEVELS, out_dir=out_dir, files_1=(paths[0],),
                 files_2=(paths[1],))
    return cfg.replace(device=dataclasses.replace(
        cfg.device, min_kmer_count=MIN_COUNT_LEVELS, **device_kw))


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def alive_key(g):
    """Sorted (sequence, count) of a graph's live edges."""
    return sorted((g.get_seq(int(e)).tobytes(), int(g.edge_count[e]))
                  for e in np.flatnonzero(g.alive_mask()))


# phase 6's depth: cut from 200 kbp to keep the script near its time aim
# (PERF.md section 4); the spill budgets are halved with it, for several
# disk runs
PARITY_LEVELS_GENOME = 100_000


def phase_levels_parity():
    from turingassembler_tpu_torch import pipeline
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.ops import nw_align
    with tempfile.TemporaryDirectory() as d:
        _, _, n_clusters, n_reads, paths, _ = write_library(
            d, PARITY_LEVELS_GENOME, 21)
        out = {w: os.path.join(d, w)
               for w in ("card", "cpu", "spill", "spill_cpu")}
        before = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
        g2 = pipeline.assembly_basic(levels_config(paths, out["card"]),
                                     device="cuda")
        torch.cuda.synchronize()
        launched = nw_align.COUNT.launches - before[0]
        pairs = nw_align.COUNT.total("pairs") - before[1]
        pipeline.assembly_basic(levels_config(paths, out["cpu"]),
                                device="cpu")
        for name in LEVEL_FILES:
            if file_bytes(os.path.join(out["card"], name)) != \
                    file_bytes(os.path.join(out["cpu"], name)):
                raise AssertionError(f"levels parity: {name} differs")
        if launched < 1:
            raise AssertionError("levels parity: the NW kernel never "
                                 "launched on the card run")
        g0 = asmg.load_graph(os.path.join(out["card"], LEVEL_FILES[0]))
        log(f"levels parity ({PARITY_LEVELS_GENOME} bp x 2 haplotypes, "
            f"{n_clusters} variant "
            f"clusters, {n_reads} reads, k={K_LEVELS}, min count "
            f"{MIN_COUNT_LEVELS}): card == CPU for all {len(LEVEL_FILES)} "
            f"files; n_e {g0.n_e} -> {g2.n_e}; bubble check: {pairs} pairs "
            f"in {launched} NW launches")

        # the same library under count budgets that force disk runs: the
        # table comes back as host arrays and level 0 is built on the
        # host, nodes numbered by first appearance; card and CPU alike
        for w in ("spill", "spill_cpu"):
            pipeline.build_0(levels_config(paths, out[w],
                                           sort_device_lanes=250_000,
                                           sort_host_mb=5.0),
                             device="cuda" if w == "spill" else "cpu")
        runs = [f for f in os.listdir(os.path.join(out["spill"], "spill"))
                if f.startswith("count_run") and f.endswith("_keys.npy")]
        if len(runs) < 2:
            raise AssertionError(f"levels parity: {len(runs)} disk runs, "
                                 "expected at least 2")
        for name in LEVEL_FILES[:3]:
            if file_bytes(os.path.join(out["spill"], name)) != \
                    file_bytes(os.path.join(out["spill_cpu"], name)):
                raise AssertionError(f"levels parity: spilled {name} "
                                     "differs card vs CPU")
        gs = asmg.load_graph(os.path.join(out["spill"], LEVEL_FILES[0]))
        tt.graphs_isomorphic(g0, gs)
        if alive_key(g0) != alive_key(gs):
            raise AssertionError("levels parity: spilled level 0 holds "
                                 "other (sequence, count) edges")
        log(f"levels parity, spilled count ({len(runs)} runs on disk, host "
            f"build): level 0 card == CPU for all 3 files, isomorphic to the "
            f"in-memory run's, same (sequence, count) set")


def n50(lens):
    lens = np.sort(np.asarray(lens))[::-1]
    return int(lens[np.searchsorted(np.cumsum(lens), lens.sum() / 2)])


def profile_count_and_build(cfg):
    """Device busy share of the count and of the level-0 build, each
    under the profiler on batches parsed beforehand (so the count's wall
    holds no parsing)."""
    from turingassembler_tpu_torch import pipeline
    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import (
        COUNT_CHUNK, count_kedges_megasort_device)
    batches = list(pipeline._genomic_batches(cfg))
    n_reads = sum(len(b) for b, _ in batches)
    prof, st, stats = StageProfiler(), {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with prof.around(name):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            st[name] = time.perf_counter() - t0
        return res

    u, c, n = stage("count", lambda: count_kedges_megasort_device(
        iter(batches), cfg.k0, min_count=cfg.device.min_kmer_count,
        stats=stats))
    stage("build", lambda: build_graph_on_device(u, c, n, cfg.k0))
    prof.report(f"levels profile ({len(batches)} parsed batches of "
                f"{len(batches[0][0])} reads)", st)
    busy = prof.busy["count"] / st["count"] * 100 if prof.busy["count"] \
        else None
    log(f"levels count records: {len(batches)} parser batches "
        f"({n_reads} reads, {len(batches[0][0])} a batch) coalesced into "
        f"{stats['records']} records of at most {COUNT_CHUNK} reads; count "
        f"wall {st['count']:.3f} s, "
        "device busy " + (f"{busy:.1f}%" if busy is not None
                          else "not measured (the profiler saw no device "
                          "time)"))
    if stats["records"] != -(-n_reads // COUNT_CHUNK):
        raise AssertionError(f"levels: the count received {stats['records']}"
                             f" records of {len(batches)} batches")


def phase_levels_full_width(genome_len=250_000):
    from turingassembler_tpu_torch import cli
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.graph.invariants import check_graph
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.logging_utils import (reset_stage_walls,
                                                         stage_walls)
    from turingassembler_tpu_torch.ops import nw_align
    from turingassembler_tpu_torch.resolve import basic
    with tempfile.TemporaryDirectory() as d:
        hap_a, hap_b, n_clusters, n_reads, paths, t_write = \
            write_library(d, genome_len, 31)
        out = os.path.join(d, "out")
        torch.cuda.reset_peak_memory_stats()
        reset_stage_walls()
        nw_align.COUNT.reset()
        # device activity only: the host passes run unobserved, and the
        # NW kernel's own time comes out by name
        prof = StageProfiler(host_ops=False)
        with prof.around("basic"):
            rc = cli.main(["basic", "-1", paths[0], "-2", paths[1], "-k0",
                           str(K_LEVELS), "-mc", str(MIN_COUNT_LEVELS),
                           "-o", out, "--device", "cuda"])
            torch.cuda.synchronize()
        launches = nw_align.COUNT.launches
        pairs = nw_align.COUNT.total("pairs")
        shapes = nw_shapes()
        walls = stage_walls()
        if rc != 0:
            raise AssertionError(f"levels: the CLI returned {rc}")
        nw = [v for key, v in prof.kernels.items()
              if "nw_wavefront_kernel" in key]
        nw_ms, nw_n = sum(v[0] for v in nw), sum(v[1] for v in nw)

        graphs = [asmg.load_graph(os.path.join(out, LEVEL_FILES[i]))
                  for i in (0, 3, 6)]
        for g in graphs:
            check_graph(g)
        n_e = [int(g.alive_mask().sum()) for g in graphs]
        n50s = [n50(g.edge_len()[g.alive_mask()]) for g in graphs]
        log(f"levels full width ({genome_len} bp x 2 haplotypes, "
            f"{n_clusters} variant clusters, {n_reads} reads of 150 bp, "
            f"k={K_LEVELS}, min count {MIN_COUNT_LEVELS}): live edges "
            f"{n_e[0]} -> {n_e[1]} -> {n_e[2]}, N50 {n50s[0]} -> "
            f"{n50s[1]} -> {n50s[2]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log("levels stage seconds: FASTQ write %.3f, " % t_write
            + ", ".join(f"{k_} {walls.get(k_, 0.0):.3f}" for k_ in (
                "build_0.parse", "build_0.count", "build_0.build",
                "build_0.check_save", "build_0", "build_0_1", "build_1_2"))
            + " (build_0.count is the count's wall less its wait on the "
            "parser, and holds the host-to-device copies)")
        by_shape = {}
        for sh in shapes:
            by_shape[sh] = by_shape.get(sh, 0) + 1
        log(f"levels bubble DP: {pairs} pairs in {launches} NW launches; "
            "padded shapes (B, Lq, Lt) x launches: " + ", ".join(
                f"{sh} x{n}" for sh, n in by_shape.items()) + "; "
            + (f"{nw_ms / nw_n:.4f} ms a launch over {nw_n} launches "
               f"(profiler, device time)" if nw_n
               else "ms a launch: not measured (the profiler saw no kernel)"))
        if not (n_e[0] > n_e[1] >= n_e[2] and n50s[0] < n50s[1] <= n50s[2]):
            raise AssertionError("levels: edges did not fall or N50 did "
                                 "not rise from level 0 to level 2")
        if pairs < 500 or launches < 1:
            raise AssertionError(f"levels: {pairs} pairs in {launches} NW "
                                 "launches, expected at least 500 pairs")

        # the planted bubbles are gone: no two live level-2 edges under
        # 1000 bp share both endpoints with a score the check accepts
        g2 = graphs[2]
        lens = g2.edge_len()
        groups = {}
        for e in np.flatnonzero(g2.alive_mask() & (lens < 1000)).tolist():
            u, v = int(g2.edge_source[e]), int(g2.edge_target[e])
            if u != int(g2.node_rc[v]):
                groups.setdefault((u, v), []).append(e)
        left = [(a, b) for es in groups.values() for i, a in enumerate(es)
                for b in es[i + 1:]]
        scores = basic.nw_align_scores_batch(
            [(g2.get_seq(a), g2.get_seq(b)) for a, b in left], device="cuda")
        if any(basic._bubble_accept(int(s), int(lens[a]), int(lens[b]))
               for (a, b), s in zip(left, scores)):
            raise AssertionError("levels: an acceptable bubble survived to "
                                 "level 2")
        # no pass invents sequence: every 46-mer of a sample of level-2
        # contigs is a 46-mer of a level-0 edge, i.e. one the count kept.
        # Against the truth: nearly every 45-mer occurs in haplotype A or
        # B on either strand.  Not every one: a substitution error that
        # three reads share passes the coverage filters as a bubble of
        # two branches of equal length, and the bubble pass keeps the
        # first of them, as upstream does.
        live = np.flatnonzero(g2.alive_mask())
        sample = np.random.default_rng(0).choice(
            live, size=min(400, len(live)), replace=False)
        g0 = graphs[0]
        counted = np.unique(np.concatenate(
            [tt.kmer_hashes(g0.get_seq(int(e)), K_LEVELS + 1)
             for e in np.flatnonzero(g0.alive_mask())]))
        edges46 = np.concatenate(
            [tt.kmer_hashes(g2.get_seq(int(e)), K_LEVELS + 1)
             for e in sample])
        invented = int((~np.isin(edges46, counted)).sum())
        known = np.unique(np.concatenate(
            [tt.kmer_hashes(s, K_LEVELS) for h in (hap_a, hap_b)
             for s in (h, tt.revcomp(h).copy())]))
        kmers = np.concatenate([tt.kmer_hashes(g2.get_seq(int(e)), K_LEVELS)
                                for e in sample])
        foreign = int((~np.isin(kmers, known)).sum())
        log(f"levels level 2: {len(left)} parallel edge pairs under 1000 bp "
            f"left, none acceptable as a bubble; of {len(sample)} sampled "
            f"contigs, {invented} of {len(edges46)} 46-mers are in no "
            f"level-0 edge and {foreign} of {len(kmers)} 45-mers "
            f"({foreign / len(kmers) * 100:.3f}%) in neither haplotype")
        if invented:
            raise AssertionError(f"levels: {invented} 46-mers of level-2 "
                                 "contigs were never counted")
        if foreign > 0.01 * len(kmers):
            raise AssertionError(f"levels: {foreign} of {len(kmers)} 45-mers "
                                 "of level-2 contigs occur in neither "
                                 "haplotype, more than 1%")
        profile_count_and_build(levels_config(paths, out))
    return launches, [("bubble", sh) for sh in shapes]


# ---------------------------------------------------------------------------
# scaffolds: level 2 -> sorted archive -> extended contigs -> barcode aux
# info -> scaffold paths (pipeline.assembly_to_scaffolds)
# ---------------------------------------------------------------------------

SCAFFOLD_FILES = ["R1.sorted.fq", "R2.sorted.fq", "barcode.idx",
                  f"graph_k_{K_LEVELS}_extend.fasta",
                  f"graph_k_{K_LEVELS}_added_barcode.bin", "scaffolds.fasta",
                  "local_assembly_scaffold_path.txt"]


def linked_config(files, out_dir):
    from turingassembler_tpu_torch.config import LIB_TYPE_UST, Config
    cfg = Config(k0=K_LEVELS, out_dir=out_dir, files_1=(files["R1"],),
                 files_2=(files["R2"],), files_I=(files["I1"],),
                 lib_type=LIB_TYPE_UST)
    return cfg.replace(device=dataclasses.replace(
        cfg.device, min_kmer_count=MIN_COUNT_LEVELS))


FINAL = "scaffold.full.fasta"
# phase 8's depth: 4 segments of the recipe (3 gaps) instead of 12 (11);
# every width of the recipe is kept (PERF.md section 4)
PARITY_GENOME, PARITY_SEGMENTS = 65_000, 4


def local_graph_caches(out):
    """Relative paths of the local graph caches the bridge stage left."""
    return sorted(os.path.relpath(p, out) for p in glob.glob(
        os.path.join(out, "local_assembly_*", "graph_k_*_local_lvl_1.bin")))


def phase_scaffold_parity(d):
    from turingassembler_tpu_torch import pipeline
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.localasm import bridge
    from turingassembler_tpu_torch.logging_utils import (reset_stage_walls,
                                                         set_log_stage,
                                                         stage_walls)
    from turingassembler_tpu_torch.ops import nw_align
    genome, files = tt.linked_read_library(PARITY_GENOME, 41, d,
                                           n_segments=PARITY_SEGMENTS)
    out = {w: os.path.join(d, w) for w in ("card", "cpu")}
    before = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
    # the stage clock starts here, not at the last stage of a phase before
    set_log_stage("init")
    reset_stage_walls()
    t0 = time.perf_counter()
    pipeline.assembly3(linked_config(files, out["card"]), device="cuda")
    torch.cuda.synchronize()
    t_card, walls = time.perf_counter() - t0, stage_walls()
    launched = nw_align.COUNT.launches - before[0]
    pairs = nw_align.COUNT.total("pairs") - before[1]
    counts = dict(bridge.BRIDGE_COUNTS)
    pipeline.assembly3(linked_config(files, out["cpu"]), device="cpu")
    caches = local_graph_caches(out["card"])
    if caches != local_graph_caches(out["cpu"]) or not caches:
        raise AssertionError("assembly3 parity: the local graph caches "
                             "differ in name or are missing")
    for name in SCAFFOLD_FILES + LEVEL_FILES + caches + [FINAL]:
        if file_bytes(os.path.join(out["card"], name)) != \
                file_bytes(os.path.join(out["cpu"], name)):
            raise AssertionError(f"assembly3 parity: {name} differs")
    if launched < 1:
        raise AssertionError("assembly3 parity: the NW kernel never "
                             "launched on the card run")
    n_pairs = file_bytes(os.path.join(out["card"], SCAFFOLD_FILES[0])
                         ).count(b"\n") // 4
    log(f"assembly3 parity ({len(genome)} bp, {PARITY_SEGMENTS} "
        f"segments, {n_pairs} barcoded pairs, k={K_LEVELS}, min count "
        f"{MIN_COUNT_LEVELS}): card == CPU for all "
        f"{len(SCAFFOLD_FILES)} scaffold files, the {len(LEVEL_FILES)} "
        f"level files, {len(caches)} local graph caches and {FINAL}; "
        f"bridges {counts}; {pairs} pairs in {launched} NW launches; the "
        f"card run {t_card:.3f} s, stages " + ", ".join(
            f"{k_} {v:.3f}" for k_, v in walls.items() if "." not in k_))
    return out["card"], files, genome


def place_contigs(g, genome, k=K_LEVELS, n_probe=24):
    """Genome interval and strand of each live contig by exact k-mer
    lookup: probes spread over the contig vote for the diagonal; k-mers
    that occur twice in the genome (the repeat copies) do not vote.
    Returns {edge: (start, end, strand)}; a contig with no unique probe
    is left out."""
    from turingassembler_tpu_torch import testing as tt
    tables = []
    for strand in (genome, tt.revcomp(genome).copy()):
        h = tt.kmer_hashes(strand, k)
        order = np.argsort(h, kind="stable")
        hs = h[order]
        uniq = np.ones(len(hs), bool)
        uniq[1:] &= hs[1:] != hs[:-1]
        uniq[:-1] &= hs[:-1] != hs[1:]
        tables.append((hs[uniq], order[uniq]))
    G = len(genome)
    placed = {}
    for e in np.flatnonzero(g.alive_mask()).tolist():
        seq = g.get_seq(e)
        if len(seq) < k:
            continue
        at = np.unique(np.linspace(0, len(seq) - k, n_probe).astype(np.int64))
        h = tt.kmer_hashes(seq, k)[at]
        best = None
        for strand, (hs, pos) in enumerate(tables):
            i = np.minimum(np.searchsorted(hs, h), len(hs) - 1)
            ok = hs[i] == h
            if ok.any():
                diag, n = np.unique(pos[i[ok]] - at[ok], return_counts=True)
                if best is None or n.max() > best[0]:
                    best = (int(n.max()), int(diag[np.argmax(n)]), strand)
        if best is not None:
            _, diag, strand = best
            if strand == 0:
                placed[e] = (diag, diag + len(seq), 0)
            else:       # position on the reverse strand -> forward coords
                placed[e] = (G - diag - len(seq), G - diag, 1)
    return placed


# threads of the bridge stage in phase 9 (`local_assembly -t`)
BRIDGE_THREADS = 4


def phase_scaffold_full_width(d, genome_len=2_000_000):
    from turingassembler_tpu_torch import cli
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.barcode.sort_read import (
        ReadPath, load_barcode_index, verify_read_archive)
    from turingassembler_tpu_torch.evaluate import evaluate_assembly
    from turingassembler_tpu_torch.localasm import bridge
    from turingassembler_tpu_torch.graph.from_contigs import \
        graph_from_contigs
    from turingassembler_tpu_torch.graph.invariants import check_graph
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.io.fasta import read_fasta
    from turingassembler_tpu_torch.logging_utils import (reset_stage_walls,
                                                         stage_walls)
    from turingassembler_tpu_torch.mapper.minimizers import _device_pool
    from turingassembler_tpu_torch.ops import nw_align
    from turingassembler_tpu_torch.scaffold.scaffolding import (
        MIN_SHARE_BARCODE, THRES_LENGTH)
    t0 = time.perf_counter()
    genome, files = tt.linked_read_library(genome_len, 51, d)
    t_write = time.perf_counter() - t0
    out = os.path.join(d, "out")
    path = lambda name: os.path.join(out, name)     # noqa: E731
    common = ["-k0", str(K_LEVELS), "-mc", str(MIN_COUNT_LEVELS), "-o",
              out, "--device", "cuda"]
    library = ["-1", files["R1"], "-2", files["R2"], "-I", files["I1"],
               "-l", "ust"]
    archive = ["-l", "sorted", "-1", path(SCAFFOLD_FILES[0]), "-2",
               path(SCAFFOLD_FILES[1]), "-I", path(SCAFFOLD_FILES[2])]
    sec, nw = {}, {}
    prof = StageProfiler(host_ops=False)

    def stage(name, args, profiled=False):
        """One CLI command: wall seconds to the device's sync, the NW
        kernel's pairs and launches, and under the profiler (device
        activity only) the device's busy seconds."""
        before = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
        n_shapes = len(nw_align.COUNT.shapes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof.around(name) if profiled \
                else contextlib.nullcontext():
            rc = cli.main(args + common)
            torch.cuda.synchronize()
            sec[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"scaffolds: `{name}` returned {rc}")
        nw[name] = (nw_align.COUNT.total("pairs") - before[1],
                    nw_align.COUNT.launches - before[0],
                    nw_shapes(n_shapes))

    torch.cuda.reset_peak_memory_stats()
    reset_stage_walls()
    nw_align.COUNT.reset()
    stage("basic", ["basic"] + library)
    stage("sort_read", ["sort_read"] + library)
    rpath = ReadPath(*archive[3::2])
    t0 = time.perf_counter()
    index = load_barcode_index(rpath.idx_path)
    n_checked = verify_read_archive(rpath, index)
    sec["verify_archive"] = time.perf_counter() - t0
    if n_checked != len(index):
        raise AssertionError("scaffolds: not every barcode was verified")
    stage("debug_current", ["debug_current", "-i", path(LEVEL_FILES[6])]
          + archive, profiled=True)
    # the contig graph of the extended sequences (no command of its
    # own), then its k=31 recount over the library
    t0 = time.perf_counter()
    contigs = path("contigs.bin")
    asmg.save_graph(graph_from_contigs(
        [s for _, s in read_fasta(path(SCAFFOLD_FILES[3]))], K_LEVELS),
        contigs)
    sec["contig_graph"] = time.perf_counter() - t0
    stage("build_coverage", ["build_coverage", "-i", contigs] + library,
          profiled=True)
    recount = path(f"graph_k_{K_LEVELS}_recount.bin")
    g_ext = asmg.load_graph(recount)
    check_graph(g_ext, check_seq=False)
    stage("build_barcode", ["build_barcode", "-i", recount] + archive,
          profiled=True)
    stage("scaffold", ["scaffold", "-i", path(SCAFFOLD_FILES[4])])
    stage("local_assembly", ["local_assembly", "-i",
                             path(SCAFFOLD_FILES[4]), "-t",
                             str(BRIDGE_THREADS)] + archive,
          profiled=True)
    launches = nw_align.COUNT.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls, busy = stage_walls(), prof.busy
    parts, outcomes = dict(bridge.BRIDGE_PROF), dict(bridge.BRIDGE_COUNTS)

    g = asmg.load_graph(path(SCAFFOLD_FILES[4]))
    # what the head of a verified map_reads call costs: the graph's codes
    # copied to the card at its first map, the cached pool after
    pool_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _device_pool(g.seq_data, g.seq_off, torch.device("cuda"))
        torch.cuda.synchronize()
        pool_ms.append((time.perf_counter() - t0) * 1e3)
    n_pairs = file_bytes(rpath.R1_path).count(b"\n") // 4
    with open(path("assembly.log")) as fp:
        aux = [ln for ln in fp if "aux info:" in ln][-1]
    words = aux.split("aux info:")[1].replace(",", " ").split()
    aux_pairs, aux_mapped, n_cand = (int(words[i]) for i in (0, 2, 5))
    mapped = aux_mapped / (2 * aux_pairs)
    lens = g.edge_len()
    alive = g.alive_mask()
    long_e = np.flatnonzero(alive & (lens >= THRES_LENGTH))
    n_scaf = [len(g.barcodes_scaf[e]) for e in long_e]
    lines = file_bytes(path(SCAFFOLD_FILES[6])).decode().split("\n")
    paths = [list(map(int, lines[i].split()))
             for i in range(2, 2 + 2 * int(lines[0]), 2)]
    scaf_lens = [len(s) for _, s in read_fasta(path(SCAFFOLD_FILES[5]))]
    contig_n50 = n50(lens[alive][::2])
    scaf_n50 = n50(scaf_lens)
    placed = place_contigs(g, genome)
    n_adj = n_good = 0
    for p in paths:
        for a, b in zip(p, p[1:]):
            n_adj += 1
            if a not in placed or b not in placed:
                continue
            (sa, ea, ra), (sb, eb, rb) = placed[a], placed[b]
            gap = sb - ea if ra == 0 else sa - eb
            # neighbours on the genome: one repeat copy apart
            n_good += ra == rb and -K_LEVELS <= gap <= 3_000 + 2_000

    log(f"scaffolds full width ({len(genome)} bp in 12 segments between "
        f"11 identical 3,000 bp repeat copies, {n_pairs} pairs of 150 bp "
        f"in {len(index)} barcodes, k={K_LEVELS}, min count "
        f"{MIN_COUNT_LEVELS}): level 2 -> {int(alive.sum()) // 2} contigs "
        f"({len(long_e) // 2} of {THRES_LENGTH} bp and more), contig N50 "
        f"{contig_n50}, {len(paths)} multi-contig paths, scaffold N50 "
        f"{scaf_n50}; peak device memory {peak:.2f} GiB")
    log("scaffolds stage seconds: FASTQ write %.3f, " % t_write
        + ", ".join(f"{k_} {sec[k_]:.3f}" for k_ in (
            "basic", "sort_read", "verify_archive", "debug_current",
            "contig_graph", "build_coverage", "build_barcode",
            "scaffold", "local_assembly"))
        + " (debug_current = read-pair counts + extension + graph load; "
        "the four profiled stages' walls hold the profiler's overhead)")
    log("scaffolds stage parts, seconds: " + ", ".join(
        f"{k_} {walls.get(k_, 0.0):.3f}" for k_ in (
            "rp_count.index", "rp_count.parse", "rp_count.map",
            "rp_count.tally", "extend", "recount.table", "recount.parse",
            "recount.count", "recount.join", "aux.index", "aux.parse",
            "aux.map", "aux.attach"))
        + "; contig pool to the card at the head of a verified map_reads "
        "call: the graph's first map, then cached: "
        + ", ".join(f"{m:.3f}" for m in pool_ms) + " ms")
    for name, what in (("debug_current", "rp-count map (+ extension)"),
                       ("build_coverage", "k=31 recount"),
                       ("build_barcode", "aux map"),
                       ("local_assembly", "bridge stage")):
        if busy[name] == 0:
            log(f"scaffolds {what}: device busy not measured (the "
                "profiler saw no device time)")
        else:
            log(f"scaffolds {what}: wall {sec[name]:.3f} s, device busy "
                f"{busy[name]:.4f} s ({busy[name] / sec[name] * 100:.2f}"
                "%)")
    log("scaffolds NW kernel, pairs in launches per stage: " + ", ".join(
        f"{k_} {nw[k_][0]} in {nw[k_][1]}"
        + (" (B, Lq, Lt) " + " ".join(map(str, nw[k_][2]))
           if nw[k_][2] else "") for k_ in nw)
        + f"; aux stage mapped {aux_mapped} of {2 * aux_pairs} reads "
        f"({mapped * 100:.2f}%)")
    log(f"scaffolds paths: {n_good} of {n_adj} adjacent contig pairs are "
        f"neighbours and co-oriented on the genome; barcodes in "
        f"barcodes_scaf of the long contigs: min {min(n_scaf)}, median "
        f"{int(np.median(n_scaf))}; {n_cand} candidate pairs")
    if aux_pairs != n_pairs:
        raise AssertionError("scaffolds: the aux stage saw "
                             f"{aux_pairs} pairs of {n_pairs}")
    if mapped < 0.95:
        raise AssertionError(f"scaffolds: only {mapped:.4f} of the "
                             "reads mapped in the aux stage")
    for name in ("debug_current", "build_barcode"):
        if nw[name][1] < 1:
            raise AssertionError(f"scaffolds: `{name}` launched the NW "
                                 "kernel no time")
    if len(long_e) < 24:
        raise AssertionError(f"scaffolds: {len(long_e) // 2} contigs of "
                             f"{THRES_LENGTH} bp, expected at least 12")
    if min(n_scaf) < MIN_SHARE_BARCODE:
        raise AssertionError(f"scaffolds: a long contig has {min(n_scaf)}"
                             f" barcodes, under {MIN_SHARE_BARCODE}")
    if not paths:
        raise AssertionError("scaffolds: no multi-contig path")
    if n_good < 0.9 * n_adj:
        raise AssertionError(f"scaffolds: {n_good} of {n_adj} adjacent "
                             "pairs lie so on the genome, under 90%")
    if scaf_n50 <= contig_n50:
        raise AssertionError(f"scaffolds: scaffold N50 {scaf_n50} is not "
                             f"above contig N50 {contig_n50}")

    # the bridge stage and the final assembly against the genome
    t0 = time.perf_counter()
    contigs = [sq for _, sq in read_fasta(path(FINAL))]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    res = evaluate_assembly(contigs, acgt[genome].tobytes().decode())
    t_eval = time.perf_counter() - t0
    log(f"bridge stage (-t {BRIDGE_THREADS}): wall "
        f"{sec['local_assembly']:.3f} s; parts, thread-seconds: "
        + ", ".join(f"{k_} {parts.get(k_, 0.0):.3f}" for k_ in (
            "prebuild", "flank_map", "filters", "kmer_set",
            "path_search", "score_paths"))
        + f"; bridges dump {outcomes['dump']}, trivial "
        f"{outcomes['trivial']}, path {outcomes['path']}, no-path "
        f"{outcomes['no_path']}; score_paths calls "
        f"{outcomes.get('score_paths.calls', 0)} over "
        f"{outcomes.get('score_paths.paths', 0)} candidate paths; NW "
        f"{nw['local_assembly'][0]} pairs in {nw['local_assembly'][1]} "
        "launches")
    log(f"final assembly: {len(contigs)} records "
        f"({', '.join(str(len(c)) for c in contigs[:6])}"
        f"{' ...' if len(contigs) > 6 else ''} bp); {res}; "
        f"evaluate {t_eval:.3f} s")
    if res.n_misassemblies != 0:
        raise AssertionError(f"final assembly: {res.n_misassemblies} "
                             "misassemblies")
    if res.genome_fraction <= 0.97:
        raise AssertionError(f"final assembly: genome fraction "
                             f"{res.genome_fraction:.4f} <= 0.97")
    if res.nga50 < 0.9 * len(genome):
        raise AssertionError(f"final assembly: NGA50 {res.nga50} < 0.9 "
                             "x genome")
    if outcomes["dump"] or outcomes["no_path"]:
        raise AssertionError(f"final assembly: {outcomes['dump']} gaps "
                             f"dumped, {outcomes['no_path']} without a "
                             "path")
    # `basic` launches the bubble check, the mapper stages the remainder
    # DP; the bridge stage both: its local graphs' bubble check pads both
    # branches to one width (Lq == Lt), its path scoring is the mapper's
    # DP (Lt = Lq + 32)
    return launches, [("bubble" if name == "basic" or sh[1] == sh[2]
                       else "map", sh)
                      for name in nw for sh in nw[name][2]], out, genome


def phase_path_scoring(n_pairs=5_000):
    """The bridge's path scoring (localasm/bridge.py:score_paths) on a
    local graph with two candidate paths and the read pairs of one of
    them: 5,000 pairs, about the read count of one gap of phase 9."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.localasm import bridge
    from turingassembler_tpu_torch.ops import nw_align
    lg, paths, _, (seq_x, seq_y) = tt.two_path_local_graph(13)
    reads, lengths, n1 = tt.read_pairs_of(seq_x, n_pairs, seed=14)
    nw_align.COUNT.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = bridge.score_paths(lg, paths, reads, lengths, n1, device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
    shapes = nw_shapes()
    # card against CPU, lane by lane (after the path's counts were read)
    card = bridge.path_read_hits(lg, paths, reads, lengths, device="cuda")
    cpu = bridge.path_read_hits(lg, paths, reads, lengths, device="cpu")
    for name, a, b in zip(("records", "starts", "accept", "scores",
                           "record lengths"), card, cpu):
        if not np.array_equal(a, b):
            raise AssertionError(f"path scoring: {name} differ card vs CPU")
    best_cpu = bridge.score_paths(lg, paths, reads, lengths, n1, device="cpu")
    want = [len(bridge.path_center_seq(lg, p)) for p in paths].index(
        len(seq_x))
    edges, _, accept, _, _ = card
    log(f"path scoring ({len(paths)} paths of "
        f"{[len(bridge.path_center_seq(lg, p)) for p in paths]} bp, "
        f"{2 * n_pairs} reads of one allele, 0.5% substitutions, a "
        f"single-base indel in 2%): best path {best} (CPU {best_cpu}, the "
        f"reads' allele {want}); {int((edges >= 0).sum())} reads voted, "
        f"{int(accept.sum())} accepted; {pairs} DP pairs in {launches} NW "
        f"launches {shapes}; {sec:.3f} s; card == CPU for every lane")
    if not best == best_cpu == want:
        raise AssertionError("path scoring: wrong or differing best path")
    if launches < 1:
        raise AssertionError("path scoring: the NW kernel never launched")
    return launches, [("map", sh) for sh in shapes]


# ---------------------------------------------------------------------------
# barcode levels: level 2 -> 3 -> aux info -> 4 -> 5, and the commands
# beside them (resolve_n_m, resolve_212_cov, build_barcode_fasta and
# _fastg, mm_index, barcode_hit)
# ---------------------------------------------------------------------------

def cli_printed(args):
    """cli.main(args) with its standard output captured: (rc, text)."""
    from turingassembler_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def dir_files(d):
    """{relative path: bytes} of the files under d, the logs left out
    (they carry times)."""
    got = {}
    for root, _, files in os.walk(d):
        for f in files:
            if f != "assembly.log":
                got[os.path.relpath(os.path.join(root, f), d)] = \
                    file_bytes(os.path.join(root, f))
    return got


def write_fastg(fasta, path):
    """An adjacency-free FASTG of a FASTA's contigs, each with its rc
    record, as tests/test_cli_variants.py writes one."""
    from turingassembler_tpu_torch.io.fasta import read_fasta
    comp = str.maketrans("ACGT", "TGCA")
    with open(path, "w") as fp:
        for i, (_, sq) in enumerate(read_fasta(fasta), 1):
            fp.write(f">EDGE_{i}_length_{len(sq)}_cov_10;\n{sq}\n")
            fp.write(f">EDGE_{i}_length_{len(sq)}_cov_10';\n"
                     f"{sq[::-1].translate(comp)}\n")


def level_bin(out, suffix, sub=""):
    return os.path.join(out, sub, f"graph_k_{K_LEVELS}_{suffix}.bin")


def sorted_archive(d):
    return ["-l", "sorted", "-1", os.path.join(d, SCAFFOLD_FILES[0]), "-2",
            os.path.join(d, SCAFFOLD_FILES[1]), "-I",
            os.path.join(d, SCAFFOLD_FILES[2])]


def phase_barcode_levels(parity_out, full_out, genome):
    """(a) On phase 8's 65 kbp outputs, on the card: build_2_3,
    build_barcode on level 3, build_3_4, build_4_5, resolve_n_m and
    resolve_212_cov on the aux-info graph, build_barcode_fasta,
    build_barcode_fastg, mm_index and barcode_hit; the last four, which
    touch the device, again on the CPU, every file and printed line
    equal.  (b) On phase 9's 2 Mbp outputs with --device cuda, the
    level chain build_2_3 -> build_barcode -> build_3_4 -> build_4_5
    (upstream src/process.c:218-246): stage seconds, device busy, NW
    launches, reads mapped, live edges and N50 a level, and the level-4
    and level-5 contigs against the genome."""
    from turingassembler_tpu_torch import cli
    from turingassembler_tpu_torch.barcode.sort_read import load_barcode_index
    from turingassembler_tpu_torch.evaluate import evaluate_assembly
    from turingassembler_tpu_torch.graph.invariants import check_graph
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.io.fasta import read_fasta
    from turingassembler_tpu_torch.io.fastq import encode_barcode
    from turingassembler_tpu_torch.logging_utils import (reset_stage_walls,
                                                         stage_walls)
    from turingassembler_tpu_torch.ops import nw_align

    # (a) card == CPU at 65 kbp
    t_a = time.perf_counter()
    work = os.path.dirname(parity_out)
    lvl2 = os.path.join(parity_out, LEVEL_FILES[6])
    lvl2_fasta = os.path.join(parity_out, LEVEL_FILES[8])
    fastg = os.path.join(work, "level_2.fastg")
    write_fastg(lvl2_fasta, fastg)
    archive = sorted_archive(parity_out)
    index = load_barcode_index(os.path.join(parity_out, SCAFFOLD_FILES[2]))
    # the barcode with the most reads, as its 18-base index read spells it
    bc_seq = encode_barcode(max(index, key=lambda b: index[b][2]),
                            18).decode()
    runs, shapes = {}, []
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"levels_{dev}")
        steps = [
            ("build_2_3", ["-i", lvl2], ""),
            ("build_barcode", ["-i", level_bin(out, "level_3")] + archive, ""),
            ("build_3_4", ["-i", level_bin(out, "added_barcode")], ""),
            ("build_4_5", ["-i", level_bin(out, "level_4")], ""),
            ("resolve_n_m", ["-i", level_bin(out, "added_barcode")], "n_m"),
            ("resolve_212_cov", ["-i", level_bin(out, "added_barcode")],
             "212"),
            ("build_barcode_fasta", ["-f", lvl2_fasta] + archive, "fasta"),
            ("build_barcode_fastg", ["-f", fastg] + archive, "fastg"),
            ("mm_index", ["-i", lvl2], "mm"),
            ("barcode_hit", ["-i", lvl2, "-f", bc_seq] + archive, "hit")]
        if dev == "cpu":        # the host passes are held against JAX by
            steps = steps[6:]   # the tests; the CPU reruns the device four
        n_shapes = len(nw_align.COUNT.shapes)
        before = nw_align.COUNT.launches
        t0 = time.perf_counter()
        printed = {}
        for name, args, sub in steps:
            rc, printed[name] = cli_printed(
                [name] + args + ["-k0", str(K_LEVELS), "-o",
                                 os.path.join(out, sub), "--device", dev])
            if rc != 0:
                raise AssertionError(f"barcode levels: `{name}` on {dev} "
                                     f"returned {rc}")
        if dev == "cuda":
            torch.cuda.synchronize()
            shapes += nw_shapes(n_shapes)
            launched_a = nw_align.COUNT.launches - before
        runs[dev] = (dir_files(out), printed, time.perf_counter() - t0)
    files = runs["cpu"][0]
    card = {k_: v for k_, v in runs["cuda"][0].items()
            if k_.split(os.sep)[0] in ("fasta", "fastg", "mm", "hit")}
    if sorted(files) != sorted(card) or not files:
        raise AssertionError("barcode levels: card and CPU wrote other files")
    for name in files:
        if files[name] != card[name]:
            raise AssertionError(f"barcode levels: {name} differs card vs "
                                 "CPU")
    for name in ("mm_index", "barcode_hit"):
        if runs["cuda"][1][name] != runs["cpu"][1][name] \
                or not runs["cuda"][1][name].strip():
            raise AssertionError(f"barcode levels: `{name}` printed other "
                                 "lines card vs CPU, or none")
    if launched_a < 1:
        raise AssertionError("barcode levels: the NW kernel never launched "
                             "on the card at 65 kbp")
    alive = {lv: int(asmg.load_graph(level_bin(
        os.path.join(work, "levels_cuda"), lv)).alive_mask().sum())
        for lv in ("level_3", "level_4", "level_5")}
    log(f"barcode levels parity ({PARITY_GENOME} bp, {PARITY_SEGMENTS} "
        f"segments): ten commands on the card; card == CPU for all "
        f"{len(files)} files of the four that touch the device, and "
        f"mm_index's and barcode_hit's lines "
        f"({runs['cuda'][1]['mm_index'].strip()}; barcode_hit "
        f"{len(runs['cuda'][1]['barcode_hit'].splitlines())} edges); live "
        f"edges level 3 / 4 / 5 {alive['level_3']} / {alive['level_4']} / "
        f"{alive['level_5']}; {launched_a} NW launches on the card; card "
        f"{runs['cuda'][2]:.3f} s, CPU {runs['cpu'][2]:.3f} s, phase part "
        f"{time.perf_counter() - t_a:.3f} s")

    # (b) the level chain at 2 Mbp, --device cuda
    out = os.path.join(os.path.dirname(full_out), "levels")
    steps = [("build_2_3", ["-i", os.path.join(full_out, LEVEL_FILES[6])]),
             ("build_barcode", ["-i", level_bin(out, "level_3")]
              + sorted_archive(full_out)),
             ("build_3_4", ["-i", level_bin(out, "added_barcode")]),
             ("build_4_5", ["-i", level_bin(out, "level_4")])]
    prof = StageProfiler(host_ops=False)
    sec, nw = {}, {}
    reset_stage_walls()
    nw_align.COUNT.reset()
    for name, args in steps:
        before = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof.around(name):
            rc = cli.main([name] + args + ["-k0", str(K_LEVELS), "-o", out,
                                           "--device", "cuda"])
            torch.cuda.synchronize()
            sec[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"barcode levels: `{name}` returned {rc}")
        nw[name] = (nw_align.COUNT.total("pairs") - before[1],
                    nw_align.COUNT.launches - before[0])
    launches = nw_align.COUNT.launches
    shapes += nw_shapes()
    walls, busy = stage_walls(), prof.busy

    with open(os.path.join(out, "assembly.log")) as fp:
        aux = [ln for ln in fp if "aux info:" in ln][-1]
    words = aux.split("aux info:")[1].replace(",", " ").split()
    aux_pairs, aux_mapped = int(words[0]), int(words[2])
    mapped = aux_mapped / (2 * aux_pairs)
    levels = {}
    for lv, path in (("2", os.path.join(full_out, LEVEL_FILES[6])),
                     ("3", level_bin(out, "level_3")),
                     ("3+aux", level_bin(out, "added_barcode")),
                     ("4", level_bin(out, "level_4")),
                     ("5", level_bin(out, "level_5"))):
        g = asmg.load_graph(path)
        check_graph(g, check_seq=False)
        live = np.flatnonzero(g.alive_mask())
        one = live[live <= g.edge_rc[live]]          # one edge an rc pair
        levels[lv] = (len(live), n50(g.edge_len()[one]))
    t0 = time.perf_counter()
    genome_str = np.frombuffer(b"ACGT", np.uint8)[genome].tobytes().decode()
    evals, contigs_of = {}, {}
    for lv in ("4", "5"):
        contigs_of[lv] = [sq for _, sq in read_fasta(os.path.join(
            out, f"graph_k_{K_LEVELS}_level_{lv}.fasta"))]
        # the same contigs in the same order give the same report
        evals[lv] = evals["4"] if lv == "5" and \
            contigs_of["5"] == contigs_of["4"] \
            else evaluate_assembly(contigs_of[lv], genome_str)
    t_eval = time.perf_counter() - t0

    log("barcode levels full width (phase 9's 2 Mbp level 2 and sorted "
        f"archive, {aux_pairs} pairs): stage seconds "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in sec.items())
        + "; aux parts " + ", ".join(
            f"{k_} {walls.get(k_, 0.0):.3f}" for k_ in (
                "aux.index", "aux.parse", "aux.map", "aux.attach"))
        + f"; evaluate {t_eval:.3f}")
    for name in sec:
        if busy.get(name, 0.0) == 0:
            log(f"barcode levels `{name}`: device busy not measured (the "
                "profiler saw no device time)")
        else:
            log(f"barcode levels `{name}`: wall {sec[name]:.3f} s, device "
                f"busy {busy[name]:.4f} s "
                f"({busy[name] / sec[name] * 100:.2f}%)")
    log("barcode levels NW kernel, pairs in launches per stage: "
        + ", ".join(f"{k_} {p} in {n}" for k_, (p, n) in nw.items())
        + f"; aux map mapped {aux_mapped} of {2 * aux_pairs} reads "
        f"({mapped * 100:.2f}%)")
    log("barcode levels, live edges and N50 a level: " + ", ".join(
        f"level {lv} {n} edges N50 {m}" for lv, (n, m) in levels.items()))
    for lv in ("4", "5"):
        log(f"barcode levels, level {lv} FASTA ({len(contigs_of[lv])} "
            f"records) against the genome: {evals[lv]}")
    if nw["build_barcode"][1] < 1:
        raise AssertionError("barcode levels: the aux map launched the NW "
                             "kernel no time")
    if mapped < 0.95:
        raise AssertionError(f"barcode levels: only {mapped:.4f} of the "
                             "reads mapped")
    if levels["4"][0] > levels["3"][0]:
        raise AssertionError("barcode levels: level 4 has more live edges "
                             "than level 3")
    return launches, [("map", sh) for sh in shapes]


# ---------------------------------------------------------------------------
# multi-process: assembly3 as two ranks on the one card, the rank stripes
# of the two maps at 2 Mbp, and four shards of the sharded count and map
# ---------------------------------------------------------------------------

DIST_RANKS = 2
# phase 13 (c): the bench workload's widths on 4 shards of cuda:0
SHARDS, SHARD_READS, SHARD_INDEL = 4, 262_144, 16_384


def shard_library():
    """Phase 13 (c)'s reads: 262,144 of 150 bp from a 2 Mbp genome, 16,384
    of them with one indel, spread over every shard's rows.  Returns
    (reads, lengths, perm, n_clean): perm[i] < n_clean for a clean read."""
    from turingassembler_tpu_torch import testing as tt
    genome = tt.random_genome(2_000_000, seed=61)
    n_clean = SHARD_READS - SHARD_INDEL
    reads, lengths = tt.sim_reads(genome, coverage=n_clean * 150 / 2e6 + 0.1,
                                  read_len=150, seed=62, pad_to=152)
    ir, il = tt.sim_indel_reads(genome, SHARD_INDEL, 150, seed=63,
                                pad_to=152)
    perm = np.random.default_rng(64).permutation(SHARD_READS)
    reads = np.concatenate([reads[:n_clean], ir])[perm]
    lengths = np.concatenate([lengths[:n_clean], il]).astype(np.int32)[perm]
    return reads, lengths, perm, n_clean


def free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(specs, timeout=600):
    """`python3 chip_smoke.py --rank <spec>` once a spec, all started
    together; every process is waited for, and killed on a timeout.
    Returns each rank's JSON report (its last line of output)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here] + [os.environ[v] for v in ("PYTHONPATH",) if v in os.environ])}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank",
         json.dumps(sp)], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for sp in specs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{e[-4000:]}")
        reports.append(json.loads(o.strip().splitlines()[-1]))
    return reports


def rank_cli(spec):
    """One rank of the port's CLI (the command's own --dist-* flags)."""
    from turingassembler_tpu_torch import cli
    from turingassembler_tpu_torch.logging_utils import stage_walls
    rc = cli.main(spec["argv"])
    torch.cuda.synchronize()
    return {"rc": rc, "walls": stage_walls()}


def rank_stripes(spec):
    """One rank of phase 9's two maps: its stripe of the read-pair counts
    on level 2 and of the aux info on the recount graph, on the card;
    rank 0 merges the ranks' tables (pipeline.py's merge) and writes the
    extension and the aux-info graph.  Then a cross-process mesh on the
    shared card, which must refuse."""
    from turingassembler_tpu_torch import pipeline
    from turingassembler_tpu_torch.barcode import builder
    from turingassembler_tpu_torch.barcode.sort_read import ReadPath
    from turingassembler_tpu_torch.config import Config
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.parallel import distributed as pd
    from turingassembler_tpu_torch.parallel.mesh import make_mesh
    from turingassembler_tpu_torch.parallel.sharded_aux import \
        apply_aux_tables
    from turingassembler_tpu_torch.resolve.readpairs import \
        get_long_contigs_by_readpairs
    r, n, src, out = spec["rank"], spec["n"], spec["src"], spec["out"]
    pd.init_distributed(spec["coordinator"], n, r)
    dev = pd.rank_device("cuda")
    torch.cuda.set_device(dev)
    cfg = Config(k0=K_LEVELS, out_dir=out)
    rpath = ReadPath(*(os.path.join(src, f) for f in SCAFFOLD_FILES[:3]))
    sec = {}
    t0 = time.perf_counter()
    g2 = asmg.load_graph(os.path.join(src, LEVEL_FILES[6]))
    rp = builder.get_read_pair_counts(cfg, g2, rpath, stripe=(r, n),
                                      device=dev)
    keys, vals = pipeline._pair_arrays(rp)
    np.savez(os.path.join(out, f"rp_rank{r}.npz"), k=keys, v=vals)
    torch.cuda.synchronize()
    sec["rp_stripe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recount = os.path.join(src, f"graph_k_{K_LEVELS}_recount.bin")
    table, cands = builder.aux_tables_striped(
        cfg, asmg.load_graph(recount), rpath, (r, n), device=dev)
    ck, cv = pipeline._pair_arrays(cands)
    np.savez(os.path.join(out, f"aux_rank{r}.npz"), s=table[0], e=table[1],
             b=table[2], c=table[3], ck=ck, cv=cv)
    torch.cuda.synchronize()
    sec["aux_stripe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pd.barrier("stripes")
    sec["wait"] = time.perf_counter() - t0
    res = {"rp_keys": len(rp), "attach_rows": len(table[0]), "sec": sec}
    if r == 0:
        t0 = time.perf_counter()
        merged = {}
        for q in range(n):
            z = np.load(os.path.join(out, f"rp_rank{q}.npz"))
            pipeline._sum_pairs(merged, z["k"], z["v"])
        ext = os.path.join(out, f"graph_k_{K_LEVELS}_extend.fasta")
        get_long_contigs_by_readpairs(g2, merged, ext)
        tables, cands_all = [], {}
        for q in range(n):
            z = np.load(os.path.join(out, f"aux_rank{q}.npz"))
            tables.append((z["s"], z["e"], z["b"], z["c"]))
            pipeline._sum_pairs(cands_all, z["ck"], z["cv"])
        g = asmg.load_graph(recount)
        apply_aux_tables(g, builder.merge_attach_tables(tables), cands_all)
        added = os.path.join(out, SCAFFOLD_FILES[4])
        asmg.save_graph(g, added)
        keys, vals = candidate_arrays(g)
        np.savez(os.path.join(out, "cands_merged.npz"), k=keys, v=vals)
        sec["merge"] = time.perf_counter() - t0
        res.update(rp_merged=len(merged), candidates=len(cands_all))
    try:
        make_mesh(n, "cuda")
        res["nccl_refused"] = ""
    except RuntimeError as e:
        res["nccl_refused"] = str(e)
    pd.barrier("done")
    return res


def candidate_arrays(g):
    """A graph's read-pair candidates as (keys (n, 2), values (n, 2))."""
    c = g.candidates
    return (np.array(list(c.keys()), np.int64).reshape(-1, 2),
            np.array(list(c.values()), np.int64).reshape(-1, 2))


def aux_single(spec):
    """The single-process aux info of phase 9's recount graph on the
    card, for (b)'s merged candidates: they are not in the .bin."""
    from turingassembler_tpu_torch.barcode import builder
    from turingassembler_tpu_torch.barcode.sort_read import ReadPath
    from turingassembler_tpu_torch.config import Config
    from turingassembler_tpu_torch.io import asmg
    src = spec["src"]
    rpath = ReadPath(*(os.path.join(src, f) for f in SCAFFOLD_FILES[:3]))
    g = asmg.load_graph(os.path.join(src,
                                     f"graph_k_{K_LEVELS}_recount.bin"))
    g = builder.construct_aux_info(Config(k0=K_LEVELS, out_dir=spec["out"]),
                                   g, rpath, device="cuda:0")
    keys, vals = candidate_arrays(g)
    np.savez(os.path.join(spec["out"], "cands_single.npz"), k=keys, v=vals)
    torch.cuda.synchronize()
    return {"candidates": len(keys)}


def rank_worker(spec):
    from turingassembler_tpu_torch.ops import kmer_sort, mm_map, nw_align
    nw_align.COUNT.reset()
    mm_map.COUNT.reset()
    kmer_sort.COUNT.reset()
    t0 = time.perf_counter()
    res = {"cli": rank_cli, "stripes": rank_stripes,
           "aux_single": aux_single,
           "host_build": host_build}[spec["kind"]](spec)
    res.update(seconds=time.perf_counter() - t0,
               launches=nw_align.COUNT.launches,
               pairs=nw_align.COUNT.total("pairs"),
               shapes=nw_shapes(),
               mm_launches=mm_map.COUNT.launches,
               mm_shapes=mm_map.COUNT.shapes,
               ks_by_entry=kmer_sort.COUNT.by_entry,
               ks_shapes=kmer_sort.COUNT.shapes,
               ks_routes=kmer_sort.COUNT.counts)
    print(json.dumps(res), flush=True)


def sorted_contigs(path):
    from turingassembler_tpu_torch.io.fasta import read_fasta
    return sorted(sq for _, sq in read_fasta(path))


def label(shs):
    # the bubble checks pad both branches to one width, the mappers' DP
    # windows are 32 columns wider than the query
    return [("bubble" if sh[1] == sh[2] else "map", tuple(sh))
            for sh in shs]


def phase_multi_process(parity_out, parity_files, parity_genome, full_out):
    """(a) assembly3 through the CLI as two ranks on cuda:0 on phase 8's
    library, and as two ranks on the CPU; (b) two ranks' stripes of the
    two maps on phase 9's 2 Mbp level 2 and archive, merged on rank 0;
    (c) the sharded count and the sharded verified map on 4 shards of
    cuda:0."""
    from turingassembler_tpu_torch.evaluate import evaluate_assembly
    from turingassembler_tpu_torch.io import asmg
    from turingassembler_tpu_torch.io.fasta import read_fasta
    from turingassembler_tpu_torch.kmer.count import count_kedges_from_reads
    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import count_reads_device
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)
    from turingassembler_tpu_torch.ops import nw_align
    from turingassembler_tpu_torch.parallel.mesh import make_mesh
    from turingassembler_tpu_torch.parallel.sharded_count import \
        sharded_count_to_host
    work = os.path.dirname(full_out)
    shapes, launches = [], 0
    mm = [0, [], []]      # the card ranks' mm_map launches, shapes; refs

    # (a) the CLI as two ranks on the card, and as two ranks on the CPU
    t0 = time.perf_counter()
    f = parity_files
    specs, outs = [], {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(work, f"dist_assembly3_{dev}")
        argv = ["assembly3", "-1", f["R1"], "-2", f["R2"], "-I", f["I1"],
                "-l", "ust", "-k0", str(K_LEVELS), "-mc",
                str(MIN_COUNT_LEVELS), "-o", outs[dev], "--device", dev,
                "--dist-coordinator", f"127.0.0.1:{free_port()}",
                "--dist-nproc", str(DIST_RANKS)]
        specs += [{"kind": "cli", "argv": argv + ["--dist-pid", str(r)]}
                  for r in range(DIST_RANKS)]
    reps = run_ranks(specs)
    t_a = time.perf_counter() - t0
    for i, rep in enumerate(reps):
        dev, r = ("cuda", "cpu")[i // DIST_RANKS], i % DIST_RANKS
        if rep["rc"] != 0:
            raise AssertionError(f"dist assembly3: {dev} rank {r} returned "
                                 f"{rep['rc']}")
        for w in ("count", "rp", "aux"):
            if not os.path.exists(os.path.join(outs[dev], "dist",
                                               f"{w}_rank{r}.npz")):
                raise AssertionError(f"dist assembly3: {dev} rank {r} wrote"
                                     f" no dist/{w}_rank{r}.npz")
    reps = reps[:DIST_RANKS]             # the card's ranks
    for rep in reps:
        launches += rep["launches"]
        shapes += label(rep["shapes"])
        mm[0] += rep["mm_launches"]
        mm[1] += [tuple(sh) for sh in rep["mm_shapes"]]
        ks_remote(rep["ks_by_entry"], rep["ks_shapes"], rep["ks_routes"])
    card, cpu = (dir_files(outs[d]) for d in ("cuda", "cpu"))
    if sorted(card) != sorted(cpu):
        raise AssertionError("dist assembly3: card and CPU ranks wrote "
                             "other files")
    for name in sorted(card):
        if name.startswith("dist" + os.sep):
            want = np.load(os.path.join(outs["cpu"], name))
            got = np.load(os.path.join(outs["cuda"], name))
            if any(not np.array_equal(got[k_], want[k_])
                   for k_ in want.files):
                raise AssertionError(f"dist assembly3: {name} differs card "
                                     "vs CPU")
        elif card[name] != cpu[name]:
            raise AssertionError(f"dist assembly3: {name} differs card vs "
                                 "CPU")
    if reps[0]["launches"] < 1:
        raise AssertionError("dist assembly3: rank 0 launched the NW "
                             "kernel no time")
    # against phase 8's single-process card run: the same level 0 (other
    # node numbers), and assemblies that pass the same checks
    lv0 = LEVEL_FILES[2]
    if sorted_contigs(os.path.join(outs["cuda"], lv0)) != \
            sorted_contigs(os.path.join(parity_out, lv0)):
        raise AssertionError("dist assembly3: level 0's contigs differ from "
                             "the single-process run's")
    same = sorted(name for name in SCAFFOLD_FILES + LEVEL_FILES + [FINAL]
                  if card[name] == file_bytes(os.path.join(parity_out,
                                                           name)))
    genome_str = np.frombuffer(b"ACGT", np.uint8)[parity_genome] \
        .tobytes().decode()
    evals = {}
    for what, d in (("2 ranks", outs["cuda"]), ("1 process", parity_out)):
        res = evals[what] = evaluate_assembly(
            [sq for _, sq in read_fasta(os.path.join(d, FINAL))], genome_str)
        if res.n_misassemblies or res.genome_fraction <= 0.97 or \
                res.nga50 < 0.9 * len(parity_genome):
            raise AssertionError(f"dist assembly3: the {what} assembly "
                                 f"fails the checks: {res}")
    log(f"multi-process (a) assembly3 as {DIST_RANKS} ranks on cuda:0 and "
        f"as {DIST_RANKS} ranks on the CPU (phase 8's library, all four "
        f"processes at once): {t_a:.3f} s; card == CPU for all {len(card)} "
        f"files (dist/ tables array for array); against phase 8's "
        f"single-process card run: level-0 contigs equal, byte-identical "
        f"files: {', '.join(same) or 'none'}; against the genome: "
        + "; ".join(f"{w}: {res}" for w, res in evals.items()) + "; "
        + "; ".join(
            f"card rank {r}: {rep['seconds']:.3f} s, NW {rep['pairs']} "
            f"pairs in {rep['launches']} launches, stages " + ", ".join(
                f"{k_} {v:.3f}" for k_, v in rep["walls"].items()
                if "." not in k_)
            for r, rep in enumerate(reps)))

    # (b) the stripes of the two maps at 2 Mbp
    t0 = time.perf_counter()
    out = os.path.join(work, "dist_stripes")
    os.makedirs(out)
    port = free_port()
    # beside the ranks, one process computes the single-process aux info
    # of the same graph: the reference of the merged candidates
    reps = run_ranks([{"kind": "stripes", "rank": r, "n": DIST_RANKS,
                       "coordinator": f"127.0.0.1:{port}", "src": full_out,
                       "out": out} for r in range(DIST_RANKS)]
                     + [{"kind": "aux_single", "src": full_out,
                         "out": out}])
    reps, ref = reps[:DIST_RANKS], reps[DIST_RANKS]
    shapes += label(ref["shapes"])      # held by phase 12, not counted
    mm[2] += [tuple(sh) for sh in ref["mm_shapes"]]    # and by phase 22
    t_b = time.perf_counter() - t0
    n_pairs = file_bytes(os.path.join(full_out, SCAFFOLD_FILES[0])
                         ).count(b"\n") // 4
    n_batches = -(-n_pairs // 131_072)
    ext = SCAFFOLD_FILES[3]
    ext_same = file_bytes(os.path.join(out, ext)) == \
        file_bytes(os.path.join(full_out, ext))
    got = asmg.load_graph(os.path.join(out, SCAFFOLD_FILES[4]))
    want = asmg.load_graph(os.path.join(full_out, SCAFFOLD_FILES[4]))
    aux_same = (got.barcodes == want.barcodes
                and got.barcodes_scaf == want.barcodes_scaf
                and got.barcodes_cov == want.barcodes_cov)
    aux_bytes = file_bytes(os.path.join(out, SCAFFOLD_FILES[4])) == \
        file_bytes(os.path.join(full_out, SCAFFOLD_FILES[4]))
    cands = {}
    for what in ("merged", "single"):
        z = np.load(os.path.join(out, f"cands_{what}.npz"))
        cands[what] = {tuple(k_): tuple(v) for k_, v in
                       zip(z["k"].tolist(), z["v"].tolist())}
    cands_same = cands["merged"] == cands["single"]
    for rep in reps:
        launches += rep["launches"]
        shapes += label(rep["shapes"])
        mm[0] += rep["mm_launches"]
        mm[1] += [tuple(sh) for sh in rep["mm_shapes"]]
        ks_remote(rep["ks_by_entry"], rep["ks_shapes"], rep["ks_routes"])
    log(f"multi-process (b) stripes at 2 Mbp ({n_pairs} pairs in "
        f"{n_batches} archive batches, {DIST_RANKS} ranks on cuda:0): "
        f"{t_b:.3f} s; " + "; ".join(
            f"rank {r}: {len(range(r, n_batches, DIST_RANKS))} batches, "
            f"{rep['rp_keys']} read-pair keys, {rep['attach_rows']} attach "
            f"rows, NW {rep['pairs']} pairs in {rep['launches']} launches, "
            "seconds " + ", ".join(f"{k_} {v:.3f}"
                                   for k_, v in rep["sec"].items())
            + f", process {rep['seconds']:.3f}"
            for r, rep in enumerate(reps))
        + f"; merged {reps[0]['rp_merged']} read-pair keys, "
        f"{reps[0]['candidates']} candidate pairs; {ext} byte-identical to "
        f"phase 9's: {ext_same}; {SCAFFOLD_FILES[4]}: barcode sets equal to "
        f"phase 9's {aux_same}, byte-identical {aux_bytes}; candidate "
        f"pairs equal to the single-process construct_aux_info's "
        f"({ref['candidates']} pairs, NW {ref['pairs']} pairs in "
        f"{ref['launches']} launches, {ref['seconds']:.3f} s, a reference: "
        f"not counted): {cands_same}")
    if not ext_same:
        raise AssertionError(f"dist stripes: {ext} differs from phase 9's")
    if not aux_same:
        raise AssertionError("dist stripes: the merged barcode sets differ "
                             "from phase 9's")
    if not cands_same or not cands["single"]:
        raise AssertionError("dist stripes: the merged read-pair candidates "
                             "differ from the single-process aux info's")
    for r, rep in enumerate(reps):
        if rep["launches"] < 1:
            raise AssertionError(f"dist stripes: rank {r} launched the NW "
                                 "kernel no time")
        if "one GPU a rank" not in rep["nccl_refused"]:
            raise AssertionError(f"dist stripes: rank {r}'s cross-process "
                                 "mesh on a shared GPU did not refuse")
    log("multi-process (b): a cross-process mesh with both ranks on cuda:0 "
        f"refused: {reps[0]['nccl_refused'][:90]}...")

    # (c) four shards on cuda:0 at the bench workload's widths
    t0 = time.perf_counter()
    reads, lengths, perm, n_clean = shard_library()
    mesh = make_mesh(SHARDS, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ke_s, c_s = sharded_count_to_host(reads, lengths, mesh, 45)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t1
    ke_1, c_1 = count_kedges_from_reads(reads, lengths, 45, device="cuda")
    if not (np.array_equal(ke_s, ke_1) and np.array_equal(c_s, c_1)):
        raise AssertionError("sharded count != the single count")
    clean = perm < n_clean
    u, c, n = count_reads_device(reads[clean], lengths[clean], 45,
                                 device="cuda")
    g = build_graph_on_device(u, c, n, 45, device="cuda")
    idx = EdgeMinimizerIndex.build(g, device="cuda")
    nw_align.COUNT.reset()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sharded = map_reads(idx, reads, lengths, graph=g, mesh=mesh)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t1
    launches += nw_align.COUNT.launches
    n_c, p_c = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
    shapes += label(nw_shapes())
    single = map_reads(idx, reads, lengths, graph=g, device="cuda")
    for name, a, b in zip(("edges", "hits", "starts"), sharded, single):
        if not np.array_equal(a, b):
            raise AssertionError(f"sharded map: {name} differ from map_reads")
    mapped = float((sharded[0] >= 0).mean())
    log(f"multi-process (c) {SHARDS} shards on cuda:0, {SHARD_READS} reads "
        f"of 150 bp ({SHARD_INDEL} with an indel), k=45: sharded count "
        f"{t_count:.3f} s, {len(ke_s)} k-edges, none dropped, == the single "
        f"count; sharded verified map {t_map:.3f} s, {mapped * 100:.2f}% "
        f"mapped, == map_reads (edges, hits, starts); NW {p_c} pairs in "
        f"{n_c} launches (one a shard); part {time.perf_counter() - t0:.3f} s")
    if n_c < SHARDS:
        raise AssertionError("sharded map: fewer NW launches than shards")
    log(f"multi-process: the card ranks launched mm_map {mm[0]} times")
    if mm[0] < 1:
        raise AssertionError("multi-process: no card rank launched mm_map")
    return launches, shapes, mm


# ---------------------------------------------------------------------------
# phase 14: the secondary count engines and the devhash kernel
# ---------------------------------------------------------------------------

HASH_BATCH = 8192          # count_kedges_from_reads' batch: 860,160 lanes
BENCH_CAP_LOG2 = 25        # the hash engine's default table, 2^25 slots
SHARD_CAP_LOG2 = 23        # a shard's table in (d): load about 0.08
CARD = "cuda"              # the device phase 14 runs on


def table_of(counter):
    """A counter's live set, sorted, host arrays, whatever overflowed."""
    from turingassembler_tpu_torch.ops import kmer_sort as ks
    keys, counts = counter.live(counter.C)
    order = ks.lex_order(keys)
    return (keys[order].cpu().numpy().astype(np.uint32),
            counts[order].cpu().numpy().astype(np.int64))


def hold_tables(what, kc, pc) -> int:
    """Kernel counter vs plain counter: both without overflow and their
    finalized tables equal; returns the largest |count difference| (0)."""
    ko, po = kc.overflow(), pc.overflow()
    if ko or po:
        raise AssertionError(f"devhash {what}: overflow kernel {ko}, plain "
                             f"{po}")
    (kk, kn), (pk, pn) = table_of(kc), table_of(pc)
    if not np.array_equal(kk, pk):
        raise AssertionError(f"devhash {what}: kernel and plain tables hold "
                             "other keys")
    err = int(np.abs(kn - pn).max()) if len(kn) else 0
    log(f"devhash kernel vs plain, {what}: {len(kk)} keys, {int(kn.sum())} "
        f"lanes counted, overflow 0 in both; max |count diff| {err}")
    if err:
        raise AssertionError(f"devhash {what}: counts differ")
    return err


def exact_on_what_it_holds(what, counter, rows, n_lanes):
    """Near full load: every key the table holds has its exact count, and
    counted + overflowed lanes = the batch's lanes."""
    from turingassembler_tpu_torch.ops.sortops import searchsorted_limbs
    keys, counts = table_of(counter)
    truth, tc = torch.unique(rows, dim=0, return_counts=True)
    idx, found = searchsorted_limbs(
        truth, torch.from_numpy(keys.astype(np.int64)).to(CARD))
    if not (bool(found.all()) and np.array_equal(
            counts, tc[idx].cpu().numpy())):
        raise AssertionError(f"devhash {what}: a held key's count is wrong")
    ovf = counter.overflow()
    if int(counts.sum()) + ovf != n_lanes:
        raise AssertionError(f"devhash {what}: lanes not conserved")
    return len(keys), ovf


def cuda_ms_fresh(counter, fn, reps):
    """Mean device ms of fn() into a freshly emptied table (the reset is
    outside the timed events)."""
    fn()
    times = []
    for _ in range(reps):
        counter.table.fill_(-1)
        counter.counts.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    counter.ovf.zero_()
    return float(np.mean(times))


def hold_kernel_hashes(what, rows, capacity):
    """The kernel's own (slot, stride, fpA, fpB) == hashes() on every row,
    bit for bit; returns the rows held."""
    from turingassembler_tpu_torch.ops import devhash
    got = devhash.to_u32(devhash.kernel_hashes(rows, capacity))
    want = torch.stack(devhash.hashes(rows, capacity - 1))
    bad = int((got != want).any(dim=0).sum())
    if bad:
        raise AssertionError(f"devhash hashes, {what}: {bad} of "
                             f"{rows.shape[0]} rows differ from hashes()")
    return rows.shape[0]


def devhash_kernel_vs_plain(bench):
    """(a): the kernel's hashes against hashes(), both insert entries
    against the plain version on the card, and their times, bounds and
    library yardstick at the bench batch."""
    from turingassembler_tpu_torch.ops import devhash
    from turingassembler_tpu_torch.ops import kmers as km
    from turingassembler_tpu_torch.ops import limbs as lb
    from turingassembler_tpu_torch.ops.devhash import DeviceHashCounter
    reads, lengths, k1 = bench["reads"], bench["lengths"], bench["k"] + 1
    nl = lb.n_limbs(k1)
    C = 1 << BENCH_CAP_LOG2

    def codes(i):
        sl = slice(i * HASH_BATCH, (i + 1) * HASH_BATCH)
        return put(reads[sl], lengths[sl].astype(np.int32))

    def extract(b, ln):
        canon, _, valid = km.extract_canonical_kmers(b, ln, k1)
        return canon.reshape(-1, nl), valid.reshape(-1)

    res, err = {}, 0
    # the kernel's hashes, bit for bit: the bench batch's rows (every
    # lane), then random keys at every key width the kernel compiles
    b0, ln0 = codes(0)
    rows0, valid0 = extract(b0, ln0)
    n_held = hold_kernel_hashes("bench batch", rows0, C)
    rng = np.random.default_rng(14)
    for w in range(1, devhash.MAX_NL + 1):
        n_held += hold_kernel_hashes(f"nl={w}", torch.as_tensor(
            rng.integers(0, 2**32, (65_536, w))).to(CARD), 1 << 20)
    log(f"devhash kernel hashes == hashes() bit for bit on the bench batch's "
        f"{rows0.shape[0]} lanes (C=2^{BENCH_CAP_LOG2}) and 65,536 random "
        f"keys at each nl 1-{devhash.MAX_NL} (C=2^20): {n_held} rows")
    # the bench batch into 2^BENCH_CAP_LOG2 slots, fresh; then after 6
    # batches.  kc: the rows entry, fc: the reads entry, pc: plain
    kc = DeviceHashCounter(BENCH_CAP_LOG2, nl, device=CARD)
    fc = DeviceHashCounter(BENCH_CAP_LOG2, nl, device=CARD)
    pc = DeviceHashCounter(BENCH_CAP_LOG2, nl, device=CARD, plain=True)
    n_lanes, n_valid = rows0.shape[0], int(valid0.sum())
    for c in (kc, pc):
        c.insert(rows0, valid0)
    fc.insert_reads(b0, ln0, k1)
    torch.cuda.synchronize()
    what = f"bench batch fresh ({n_valid} of {n_lanes} lanes valid, C 2^" \
        f"{BENCH_CAP_LOG2})"
    err = max(err, hold_tables(what + ", rows entry", kc, pc),
              hold_tables(what + ", reads entry", fc, pc))
    n_unique = int((kc.counts > 0).sum())
    for i in range(1, 7):
        b6, ln6 = codes(i)
        rows6, valid6 = extract(b6, ln6)
        held, lanes = int((kc.counts > 0).sum()), int(kc.counts.sum())
        for c in (kc, pc):
            c.insert(rows6, valid6)
        fc.insert_reads(b6, ln6, k1)
    # the share of the 7th batch's valid lanes whose key was already held
    hits = 1 - (int((kc.counts > 0).sum()) - held) / max(
        int(kc.counts.sum()) - lanes, 1)
    what = f"7th batch after 6 ({hits * 100:.1f}% of its lanes hit)"
    err = max(err, hold_tables(what + ", rows entry", kc, pc),
              hold_tables(what + ", reads entry", fc, pc))
    # steady state: the 7th batch again, every lane a hit.  The insert as
    # a whole (the wrapper, then the launch or the plain version's hashes
    # and probe rounds) is the function the bound and torch.unique
    # measure; the launch alone is kernel_ms
    prep6 = kc.prepare(rows6, valid6)
    res["hit_ms"] = cuda_ms(lambda: kc.insert(rows6, valid6), 20)
    res["hit_kernel_ms"] = cuda_ms(lambda: kc.insert_prepared(prep6), 20)
    res["hit_plain_ms"] = cuda_ms(lambda: pc.insert(rows6, valid6), 3)
    res["hit_fused_ms"] = cuda_ms(lambda: fc.insert_reads(b6, ln6, k1), 20)
    # fresh times at the bench batch
    prep0 = kc.prepare(rows0, valid0)
    res["ms"] = cuda_ms_fresh(kc, lambda: kc.insert(rows0, valid0), 20)
    res["kernel_ms"] = cuda_ms_fresh(kc, lambda: kc.insert_prepared(prep0),
                                     20)
    res["plain_ms"] = cuda_ms_fresh(pc, lambda: pc.insert(rows0, valid0), 3)
    res["fused_ms"] = cuda_ms_fresh(
        fc, lambda: fc.insert_reads(b0, ln0, k1), 20)
    # the unfused path to the same table: extraction in tensor code, then the
    # rows insert
    res["unfused_ms"] = cuda_ms_fresh(
        kc, lambda: kc.insert(*extract(b0, ln0)), 20)
    res["fused_plain_ms"] = cuda_ms_fresh(
        pc, lambda: pc.insert_reads(b0, ln0, k1), 3)
    rows_v = rows0[valid0]
    res["library_ms"] = cuda_ms(
        lambda: torch.unique(rows_v, dim=0, return_counts=True), 5)
    # bytes of the insert as a function (its hashes are computed from the
    # key inside it, as in the JAX function): each valid lane's nl key
    # words and each lane's valid byte read once; a claimed slot's fp0
    # read, its fp0, fp1 and nl payload words written, its count read and
    # written; a hit slot's fp0, fp1 and payload read, its count read and
    # written.  A key's repeats in the batch touch its slot again, which
    # a minimal insert does not pay for
    claim_b = 4 + (2 + nl) * 4 + 8
    hit_b = (2 + nl) * 4 + 8
    nbytes = n_valid * nl * 4 + n_lanes + n_unique * claim_b
    res["bound_ms"] = nbytes / PEAK_BYTES_S * 1e3
    n_valid6 = int(valid6.sum())
    n_unique6 = int(torch.unique(rows6[valid6], dim=0).shape[0])
    hit_bytes = n_valid6 * nl * 4 + rows6.shape[0] + n_unique6 * hit_b
    res["hit_bound_ms"] = hit_bytes / PEAK_BYTES_S * 1e3
    # the reads entry as a function: the batch's codes and lengths read
    # once, a 32-byte record a claimed slot
    fused_bytes = b0.numel() + 4 * ln0.numel() + 32 * n_unique
    res["fused_bound_ms"] = fused_bytes / PEAK_BYTES_S * 1e3
    log(f"devhash at the bench batch ({n_lanes} lanes, {n_valid} valid, "
        f"{n_unique} distinct keys, nl={nl}, C=2^{BENCH_CAP_LOG2}), fresh "
        f"table: rows insert (wrapper + launch) {res['ms']:.4f} ms, the "
        f"launch alone {res['kernel_ms']:.4f} ms; plain insert (hashes + "
        f"probe rounds) {res['plain_ms']:.4f} ms; bound "
        f"{res['bound_ms']:.4f} ms (bytes, {nbytes / 1e6:.2f} MB at 3.35 "
        f"TB/s): insert {res['ms'] / res['bound_ms']:.1f}x its bound; "
        f"torch.unique(rows, dim=0, return_counts=True) on the {n_valid} "
        f"valid rows (yardstick) {res['library_ms']:.4f} ms, insert / "
        f"torch.unique {res['ms'] / res['library_ms']:.2f}x.  Reads entry "
        f"from the {b0.shape[0]} x {b0.shape[1]} codes {res['fused_ms']:.4f}"
        f" ms, bound {res['fused_bound_ms']:.4f} ms ({fused_bytes / 1e6:.2f}"
        f" MB), {res['fused_ms'] / res['fused_bound_ms']:.1f}x; extraction "
        f"in tensor code + rows insert {res['unfused_ms']:.4f} ms; plain "
        f"(extraction + plain insert) {res['fused_plain_ms']:.4f} ms.  7th "
        f"batch again, every lane a hit ({n_valid6} valid lanes, "
        f"{n_unique6} distinct keys): rows insert {res['hit_ms']:.4f} ms, "
        f"launch alone {res['hit_kernel_ms']:.4f} ms, reads entry "
        f"{res['hit_fused_ms']:.4f} ms, plain insert "
        f"{res['hit_plain_ms']:.4f} ms, bound {res['hit_bound_ms']:.4f} ms "
        f"({hit_bytes / 1e6:.2f} MB)")
    del kc, fc, pc

    # contention: every lane carries one of 64 keys
    pool = torch.as_tensor(rng.integers(0, 2**32, (64, nl))).to(CARD)
    rows = pool[torch.as_tensor(rng.integers(0, 64, n_lanes)).to(CARD)]
    ones = torch.ones(n_lanes, dtype=torch.bool, device=CARD)
    kc = DeviceHashCounter(20, nl, device=CARD)
    pc = DeviceHashCounter(20, nl, device=CARD, plain=True)
    for c in (kc, pc):
        c.insert(rows, ones)
    err = max(err, hold_tables(f"contention ({n_lanes} lanes on 64 keys)",
                               kc, pc))
    # 0.7 load: 0.7 C distinct keys in one batch, C = 2^20.  With 8 probes
    # about C * 0.7^9 / 9 keys find no slot in either version, so each is
    # held against the exact count of what it holds
    C = 1 << 20
    n = int(0.7 * C)
    rows = torch.unique(torch.as_tensor(
        rng.integers(0, 2**32, (n + 4096, nl))).to(CARD), dim=0)[:n]
    rows = rows[torch.randperm(n, device=CARD)]
    ones = torch.ones(n, dtype=torch.bool, device=CARD)
    kc = DeviceHashCounter(20, nl, device=CARD)
    pc = DeviceHashCounter(20, nl, device=CARD, plain=True)
    for c in (kc, pc):
        c.insert(rows, ones)
    held_k, ovf_k = exact_on_what_it_holds("0.7 load, kernel", kc, rows, n)
    held_p, ovf_p = exact_on_what_it_holds("0.7 load, plain", pc, rows, n)
    log(f"devhash at 0.7 load ({n} distinct keys into 2^20 slots): kernel "
        f"holds {held_k} with their exact counts, {ovf_k} lanes overflowed; "
        f"plain holds {held_p}, {ovf_p} overflowed (sequential inserts "
        f"with uniform probing would leave about {C * 0.7 ** 9 / 9:.0f})")
    # overflow: 1,000 keys into 64 slots, both must raise
    rows = torch.as_tensor(rng.integers(0, 2**32, (1000, nl))).to(CARD)
    ones = torch.ones(1000, dtype=torch.bool, device=CARD)
    for plain in (False, True):
        c = DeviceHashCounter(6, nl, device=CARD, plain=plain)
        c.insert(rows, ones)
        try:
            c.finalize()
        except RuntimeError as e:
            if "overflow" not in str(e):
                raise
            log(f"devhash overflow case, {'plain' if plain else 'kernel'}: "
                f"raised ({str(e)[:60]})")
        else:
            raise AssertionError("devhash: 1,000 keys in 64 slots did not "
                                 "raise")
    res["max_abs_err"] = err
    return res


def phase_secondary_engines(bench):
    """(a) the devhash kernel vs its plain version; (b) the hash engine at
    full width == phase 5's count; (c) the device and np engines; (d)
    ShardedHashCounter on 4 shards of cuda:0; (e) the span k-mer table
    and its resolver card vs CPU; (f) a KMC database round trip.
    Returns (devhash launches of the paths (b) and (d): the reads entry's,
    the rows entry's; kernel report)."""
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.graph.build import build_graph_from_kedges
    from turingassembler_tpu_torch.graph.mutable import MutableGraph
    from turingassembler_tpu_torch.io import asmg, kmc
    from turingassembler_tpu_torch.io.fasta import write_fasta
    from turingassembler_tpu_torch.kmer.count import count_kedges_from_reads
    from turingassembler_tpu_torch.ops import devhash
    from turingassembler_tpu_torch.ops import limbs as lb
    from turingassembler_tpu_torch.parallel.mesh import make_mesh
    from turingassembler_tpu_torch.ops.devhash import DeviceHashCounter
    from turingassembler_tpu_torch.parallel.sharded_count import (
        ShardedHashCounter, _route_and_insert, device_put_sharded_batch)
    from turingassembler_tpu_torch.resolve import big
    k = bench["k"]
    reads, lengths = bench["reads"], bench["lengths"]

    t0 = time.perf_counter()
    rep = devhash_kernel_vs_plain(bench)
    log(f"secondary engines (a): part {time.perf_counter() - t0:.3f} s")

    def same(what, got, want):
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"{what} differs from the reference count")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # (b) the hash engine at full width, a main path of the kernel
    devhash.COUNT.reset()
    got, t_hash = timed(lambda: count_kedges_from_reads(
        reads, lengths, k, batch_size=HASH_BATCH, engine="hash",
        device=CARD))
    read_launches = devhash.COUNT.by_entry["insert_reads"]
    lanes = devhash.COUNT.total("lanes")
    rows_in_b = devhash.COUNT.by_entry["insert"]
    same("hash engine", got, (bench["kedges"], bench["counts"]))
    ms_out, t_mega = timed(lambda: count_kedges_from_reads(
        reads, lengths, k, batch_size=HASH_BATCH, engine="megasort",
        device=CARD))
    same("megasort engine", ms_out, (bench["kedges"], bench["counts"]))
    n_batches = -(-len(reads) // HASH_BATCH)
    log(f"secondary engines (b) hash engine, {len(reads)} reads of 150 bp, "
        f"k={k}: {t_hash:.3f} s ({len(reads) / t_hash:.1f} reads/s), "
        f"{len(got[0])} k-edges == phase 5's count row for row; devhash "
        f"reads entry {read_launches} launches, {lanes} windows, rows entry "
        f"{rows_in_b}; megasort on the same reads {t_mega:.3f} s")
    if read_launches != n_batches or rows_in_b:
        raise AssertionError("hash engine: not one reads-entry launch a "
                             "batch")

    # (c) the device and np engines on phase 13 (c)'s reads
    sreads, slengths, perm, n_clean = shard_library()
    ref, t_ref = timed(lambda: count_kedges_from_reads(
        sreads, slengths, k, batch_size=HASH_BATCH, device=CARD))
    dev_out, t_dev = timed(lambda: count_kedges_from_reads(
        sreads, slengths, k, batch_size=HASH_BATCH, engine="device",
        device=CARD))
    same("device engine", dev_out, ref)
    np_out, t_np = timed(lambda: count_kedges_from_reads(
        sreads, slengths, k, batch_size=HASH_BATCH, engine="np",
        device=CARD))
    same("np engine", np_out, ref)
    log(f"secondary engines (c) on {len(sreads)} reads, {len(ref[0])} "
        f"k-edges, each == megasort ({t_ref:.3f} s): device engine "
        f"{t_dev:.3f} s, np engine {t_np:.3f} s")

    # (d) ShardedHashCounter, 4 shards on cuda:0, a main path of the kernel
    D = SHARDS
    per_dev = (HASH_BATCH // D) * (sreads.shape[1] - k)
    cap = int(2.2 * per_dev / D) + 64
    devhash.COUNT.reset()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sh = ShardedHashCounter(make_mesh(D, CARD), k, SHARD_CAP_LOG2, cap)
    for i in range(0, len(sreads), HASH_BATCH):
        sh.insert_batch(sreads[i:i + HASH_BATCH], slengths[i:i + HASH_BATCH])
    sh_ovf = [c.overflow() for c in sh.counters]
    if sh.overflow():
        log(f"secondary engines (d): {sh.overflow() - sum(sh_ovf)} k-mers "
            f"dropped by the routing, table overflow a shard {sh_ovf}")
    sh_out = sh.finalize()
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t1
    sh_launches = devhash.COUNT.by_entry["insert"]
    same("ShardedHashCounter", sh_out, ref)
    n_batches = -(-len(sreads) // HASH_BATCH)
    log(f"secondary engines (d) ShardedHashCounter, {D} shards on {CARD}, "
        f"2^{SHARD_CAP_LOG2} slots a shard, {n_batches} batches: {t_sh:.3f} "
        "s, none dropped or overflowed, == the single count; devhash rows "
        f"entry {sh_launches} launches")
    if sh_launches != D * n_batches or devhash.COUNT.by_entry["insert_reads"]:
        raise AssertionError("ShardedHashCounter: not one rows-entry launch "
                             "a shard and batch")
    # (d)'s first batch again, now that its counts are read: the same
    # routing and exchange into fresh kernel tables and fresh plain tables
    # of the shards' capacity, so the kernel is held at (d)'s own shape
    del sh
    mesh = make_mesh(D, CARD)
    db, dl = device_put_sharded_batch(sreads[:HASH_BATCH],
                                      slengths[:HASH_BATCH], mesh)
    tables = {}
    for plain in (False, True):
        tables[plain] = [DeviceHashCounter(SHARD_CAP_LOG2, lb.n_limbs(k + 1),
                                           device=d, plain=plain)
                         for d in mesh.devices]
        _route_and_insert(tables[plain], db, dl, mesh=mesh, k1=k + 1,
                          cap_per_dest=cap)
    for i, (kc, pc) in enumerate(zip(tables[False], tables[True])):
        rep["max_abs_err"] = max(rep["max_abs_err"], hold_tables(
            f"ShardedHashCounter shard {i}, batch 0 ({kc.counts.shape[0]} "
            f"slots, {D * cap} routed lanes)", kc, pc))
    del tables

    # (e) the span k-mer table and its resolver, card vs CPU
    h0, h1 = tt.make_212_genome(rep_len=60, k=21)
    r0, l0 = tt.sim_reads(h0, coverage=35, read_len=150, seed=3)
    r1, l1 = tt.sim_reads(h1, coverage=35, read_len=150, seed=4)
    r212, l212 = np.concatenate([r0, r1]), np.concatenate([l0, l1])
    ke, c = count_kedges_from_reads(r212, l212, 21, device=CARD)
    g = build_graph_from_kedges(ke, c, 21)
    outs = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in (CARD, "cpu"):
            table = big.SpanKmerTable.build(r212, l212, device=dev)
            mg = MutableGraph.from_asm(g.clone())
            n = big.resolve_212_pair_kmer_all(mg, table)
            g2 = mg.to_asm()
            asmg.save_graph(g2, os.path.join(d, dev + ".bin"))
            write_fasta(g2, os.path.join(d, dev + ".fasta"))
            outs[dev] = (table.keys, table.counts, n,
                         file_bytes(os.path.join(d, dev + ".bin")),
                         file_bytes(os.path.join(d, dev + ".fasta")))
    for i, name in enumerate(("table keys", "table counts", "joins",
                              ".bin", "FASTA")):
        if not np.array_equal(outs[CARD][i], outs["cpu"][i]):
            raise AssertionError(f"span k-mer resolver: {name} differ card "
                                 "vs CPU")
    if outs[CARD][2] < 1:
        raise AssertionError("span k-mer resolver joined nothing")
    table, t_span = timed(lambda: big.SpanKmerTable.build(
        sreads, slengths, device=CARD))
    bk = big.BIG_KSIZE
    inside = np.arange(sreads.shape[1])[None, :] < slengths[:, None]
    if (sreads[inside] >= 4).any():
        raise AssertionError("span table: a read holds an invalid base")
    n_windows = int(np.maximum(slengths.astype(np.int64) - bk + 1, 0).sum())
    if int(table.counts.sum()) != n_windows:
        raise AssertionError("span table: total count != valid windows")
    log(f"secondary engines (e) span k-mer resolver on the 2-1-2 library "
        f"({len(r212)} reads): card == CPU for the table "
        f"({len(outs[CARD][0])} keys), {outs[CARD][2]} join(s), the "
        f".bin and the FASTA; card table of {len(sreads)} reads {t_span:.3f} "
        f"s, {len(table.keys)} keys, total count {n_windows} == valid "
        f"{bk}-windows")

    # (f) KMC round trip of phase 5's k-edges (host)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"KMC_{k + 1}_count")
        kmc.write_kmc_database(lb.np_unpack_limbs(bench["kedges"], k + 1),
                               bench["counts"], path)
        ke_back, c_back, k_back = kmc.load_kedges_from_kmc(path)
        size = os.path.getsize(path + ".kmc_suf")
    if k_back != k:
        raise AssertionError("KMC round trip: k differs")
    same("KMC round trip", (ke_back, c_back), (bench["kedges"],
                                               bench["counts"]))
    log(f"secondary engines (f) KMC database of phase 5's {len(ke_back)} "
        f"k-edges ({size / 1e6:.1f} MB of records) written and loaded back "
        f"equal: {time.perf_counter() - t1:.3f} s")
    return read_launches, sh_launches, rep


# ---------------------------------------------------------------------------
# phase 15: the host twins (native/*.cpp) against their plain versions
# ---------------------------------------------------------------------------

def peak_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def rss_gib():
    """This process's resident set now (/proc/self/statm; the peak,
    ru_maxrss, of a subprocess holds its parent's from before exec)."""
    with open("/proc/self/statm") as fp:
        pages = int(fp.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


def host_seconds(fn, reps=3, warm=True):
    """Median host seconds of fn() over reps runs (after one warm-up
    run unless warm is False), and the last result."""
    out = fn() if warm else None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def read_all(reader, path, with_headers=True):
    """Every batch of a reader, as _iter_sorted_pairs reads the archive
    (131,072 reads a batch, padded to 256)."""
    return list(reader(path, 131_072, 256, with_headers))


def hold_batches(what, got, want):
    if len(got) != len(want):
        raise AssertionError(f"host twins: {what}: {len(got)} batches, "
                             f"plain {len(want)}")
    for i, ((b, ln, h), (wb, wl, wh)) in enumerate(zip(got, want)):
        if not (np.array_equal(b, wb) and np.array_equal(ln, wl)
                and h == wh):
            raise AssertionError(f"host twins: {what}: batch {i} differs "
                                 "from the Python reader's")
    return sum(len(b[1]) for b in got)


def host_build(spec):
    """One fresh process of (e): phase 5's k-edges through the level-0
    host build twice, with or without tune_host_malloc first; its
    resident set after them."""
    from turingassembler_tpu_torch.graph.build import build_graph_from_kedges
    from turingassembler_tpu_torch.ops.hostmem import tune_host_malloc
    tuned = tune_host_malloc() if spec["tune"] else False
    ke = np.load(spec["kedges"])
    c = np.load(spec["counts"])
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        g = build_graph_from_kedges(ke, c, spec["k"], first_seen=True)
        passes.append(time.perf_counter() - t0)
    return {"tuned": tuned, "passes": passes, "n_e": int(g.n_e),
            "rss_gib": rss_gib()}


def phase_host_twins(parity_files, full_out, bench, work):
    """The port's host libraries, each against its plain version on this
    host: (a) the FASTQ reader on phase 9's library, (b) the barcode
    sorter spilled on phase 9's library and against the Python loop on
    phase 8's, (c) the graph kernels in the level-0 host build of phase
    5's k-edges, (d) the read pack beside the plain host-to-device copy,
    (e) tune_host_malloc in fresh processes."""
    import gzip
    from turingassembler_tpu_torch.barcode import sort_read
    from turingassembler_tpu_torch.graph import build as gbuild
    from turingassembler_tpu_torch.io.fastq import read_fastq_batches_headers
    from turingassembler_tpu_torch.io.native_loader import \
        read_fastq_batches_native
    from turingassembler_tpu_torch.kmer.count import (device_unpack_reads,
                                                      host_pack_reads,
                                                      host_pack_reads_np)
    lib_dir = os.path.dirname(full_out)
    rep = {}

    # (a) the reader: phase 9's R1 and R2, batch by batch
    n = 0
    for name in ("R1", "R2"):
        path = os.path.join(lib_dir, f"{name}.fq")
        t_twin, got = host_seconds(lambda: read_all(
            read_fastq_batches_native, path), reps=1)
        t0 = time.perf_counter()
        want = read_all(read_fastq_batches_headers, path)
        rep[f"read_{name}"] = (t_twin, time.perf_counter() - t0)
        n = hold_batches(f"reader {name}", got, want)
        del got, want
    gz = os.path.join(work, "R1.fq.gz")
    with open(os.path.join(lib_dir, "R1.fq"), "rb") as src, \
            gzip.open(gz, "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    t_gz, got = host_seconds(lambda: read_all(read_fastq_batches_native,
                                              gz, False), reps=1, warm=False)
    if sum(len(b[1]) for b in got) != n:
        raise AssertionError("host twins: the .gz copy of R1 read "
                             f"{sum(len(b[1]) for b in got)} reads of {n}")
    del got
    log(f"host twins (a) FASTQ reader on phase 9's {n} pairs (131,072 "
        "reads a batch, with headers for R1 as the archive maps read it): "
        "bases, lengths and headers == the Python reader's; seconds, twin "
        "/ Python: R1 %.3f / %.3f, R2 %.3f / %.3f; R1.fq.gz (level 1) "
        "through the twin %.3f" % (*rep["read_R1"], *rep["read_R2"], t_gz))

    # (b) the sorter: spilled on phase 9's library; == the Python loop
    # on phase 8's
    archive = ("R1.sorted.fq", "R2.sorted.fq", "barcode.idx")
    want = [file_bytes(os.path.join(full_out, a)) for a in archive]
    budget = (len(want[0]) + len(want[1])) // 5
    files = {k_: os.path.join(lib_dir, f"{k_}.fq") for k_ in ("R1", "R2",
                                                              "I1")}
    cfg = linked_config(files, os.path.join(work, "spilled"))
    os.environ["TA_SORT_MEM_BYTES"] = str(budget)
    sort_stats = {}
    try:
        t0 = time.perf_counter()
        sort_read.sort_reads(cfg, stats=sort_stats)
        t_spill = time.perf_counter() - t0
    finally:
        del os.environ["TA_SORT_MEM_BYTES"]
    if sort_stats["runs"] < 4:
        raise AssertionError(f"host twins: the sorter spilled "
                             f"{sort_stats['runs']} runs under {budget} "
                             "bytes, expected at least 4")
    for a, w in zip(archive, want):
        if file_bytes(os.path.join(cfg.out_dir, a)) != w:
            raise AssertionError(f"host twins: the spilled sort's {a} "
                                 "differs from phase 9's")
    pcfg = linked_config(parity_files, os.path.join(work, "p_twin"))
    t_twin, _ = host_seconds(lambda: sort_read.sort_reads(pcfg), reps=1,
                             warm=False)
    lcfg = pcfg.replace(out_dir=os.path.join(work, "p_loop"))
    os.environ["TA_SORT_NATIVE"] = "0"
    try:
        t_loop, _ = host_seconds(lambda: sort_read.sort_reads(lcfg), reps=1,
                                 warm=False)
    finally:
        del os.environ["TA_SORT_NATIVE"]
    for a in archive:
        if file_bytes(os.path.join(pcfg.out_dir, a)) != \
                file_bytes(os.path.join(lcfg.out_dir, a)):
            raise AssertionError(f"host twins: phase 8's {a}: the twin "
                                 "differs from the Python loop")
    n8 = file_bytes(os.path.join(pcfg.out_dir, archive[0])).count(b"\n") // 4
    log(f"host twins (b) sorter: phase 9's {n} pairs with a budget of "
        f"{budget} bytes (a fifth of the formatted records) spilled "
        f"{sort_stats['runs']} runs, k-way merged, {t_spill:.3f} s; all "
        "three files "
        f"byte-identical to phase 9's unspilled archive; phase 8's {n8} "
        f"pairs: twin {t_twin:.3f} s, Python loop {t_loop:.3f} s, "
        "byte-identical")
    rep.update(sort_spill=t_spill, sort_p8=(t_twin, t_loop))

    # (c) the graph kernels in the level-0 host build of phase 5's k-edges
    ke, c, k = bench["kedges"], bench["counts"], bench["k"]
    t_twin, g = host_seconds(lambda: gbuild.build_graph_from_kedges(
        ke, c, k, first_seen=True), reps=1, warm=False)
    twins = gbuild._pointer_double_to_head, gbuild._first_seen_ids
    gbuild._pointer_double_to_head = gbuild._pointer_double_to_head_np
    gbuild._first_seen_ids = gbuild._first_seen_ids_np
    try:
        t_np, gp = host_seconds(lambda: gbuild.build_graph_from_kedges(
            ke, c, k, first_seen=True), reps=1, warm=False)
    finally:
        gbuild._pointer_double_to_head, gbuild._first_seen_ids = twins
    for f in ("node_rc", "adj_off", "adj_list", "edge_source",
              "edge_target", "edge_rc", "edge_count", "seq_off",
              "seq_data"):
        if not np.array_equal(getattr(g, f), getattr(gp, f)):
            raise AssertionError(f"host twins: build {f}: the twins differ "
                                 "from the numpy versions")
    prev = np.random.default_rng(0).permutation(2 * len(ke)).astype(
        np.int32)
    prev[::64] = -1          # chains of random elements, some pure cycles
    t_lr, _ = host_seconds(lambda: gbuild._pointer_double_to_head(prev), 1,
                           warm=False)
    t_lr_np, _ = host_seconds(
        lambda: gbuild._pointer_double_to_head_np(prev), reps=1, warm=False)
    fp = gbuild._np_fingerprint64(np.ascontiguousarray(ke))
    fp = np.concatenate([fp, fp[::-2]])
    t_ui, _ = host_seconds(lambda: gbuild._first_seen_ids(fp), 1,
                           warm=False)
    t_ui_np, _ = host_seconds(lambda: gbuild._first_seen_ids_np(fp), reps=1,
                              warm=False)
    log(f"host twins (c) level-0 host build of phase 5's {len(ke)} "
        f"k-edges (k={k}, first-seen numbering): {g.n_e} edges, every "
        f"array == the numpy versions'; seconds, twins {t_twin:.3f}, numpy "
        f"{t_np:.3f}; alone on {len(prev)} random prev pointers "
        f"ta_list_rank {t_lr:.4f} vs pointer doubling {t_lr_np:.4f}, on "
        f"{len(fp)} keys ta_unique_ids {t_ui:.4f} vs np.unique "
        f"{t_ui_np:.4f}")
    rep.update(build=(t_twin, t_np), list_rank=(t_lr, t_lr_np),
               unique_ids=(t_ui, t_ui_np))

    # (d) the read pack beside the plain copy of the codes
    x = np.ascontiguousarray(bench["reads"][:131_072])
    L = x.shape[1]
    t_pack, (packed, nmask) = host_seconds(lambda: host_pack_reads(x))
    t_pack_np, ref = host_seconds(lambda: host_pack_reads_np(x), reps=1,
                                  warm=False)
    if not (np.array_equal(packed, ref[0]) and np.array_equal(nmask, ref[1])):
        raise AssertionError("host twins: host_pack_reads differs from "
                             "its numpy version")
    codes = device_unpack_reads(torch.from_numpy(packed).cuda(),
                                torch.from_numpy(nmask).cuda(), L)
    if not np.array_equal(codes.cpu().numpy(), np.where(x < 4, x, 255)):
        raise AssertionError("host twins: device_unpack_reads on the card "
                             "differs from the codes")
    pinned = torch.from_numpy(x).pin_memory()

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out
        return run
    t_page, _ = host_seconds(synced(lambda: torch.from_numpy(x).cuda()), 5)
    t_pin, _ = host_seconds(synced(
        lambda: pinned.to("cuda", non_blocking=True)), 5)

    def packed_path():
        p, m = host_pack_reads(x)
        return device_unpack_reads(torch.from_numpy(p).cuda(),
                                   torch.from_numpy(m).cuda(), L)
    t_packed, _ = host_seconds(synced(packed_path), 5)
    pp, pm = torch.from_numpy(packed).cuda(), torch.from_numpy(nmask).cuda()
    t_unpack, _ = host_seconds(synced(lambda: device_unpack_reads(pp, pm,
                                                                  L)), 5)
    log(f"host twins (d) read pack of phase 5's first {x.shape[0]} x {L} "
        f"codes ({x.nbytes} bytes; packed {packed.nbytes + nmask.nbytes}): "
        f"twin == numpy, unpacked on the card == the codes; ms: raw copy "
        f"pageable {t_page * 1e3:.3f}, pinned {t_pin * 1e3:.3f}; pack "
        f"(twin) {t_pack * 1e3:.3f}, numpy pack {t_pack_np * 1e3:.3f}, "
        f"unpack on the card {t_unpack * 1e3:.3f}, pack + packed copy + "
        f"unpack {t_packed * 1e3:.3f}")
    rep.update(copy_pageable=t_page, copy_pinned=t_pin, pack=t_pack,
               pack_np=t_pack_np, unpack=t_unpack, packed_path=t_packed)
    del pinned, pp, pm, codes

    # (e) tune_host_malloc: (c)'s build in fresh processes, two passes each
    np.save(os.path.join(work, "kedges.npy"), ke)
    np.save(os.path.join(work, "counts.npy"), c)
    spec = {"kind": "host_build", "k": k,
            "kedges": os.path.join(work, "kedges.npy"),
            "counts": os.path.join(work, "counts.npy")}
    runs = {}
    for tune in (False, True):
        runs[tune], = run_ranks([dict(spec, tune=tune)], timeout=300)
        if runs[tune]["n_e"] != g.n_e or runs[tune]["tuned"] != tune:
            raise AssertionError(f"host twins: (e) process {runs[tune]}")
    log("host twins (e) level-0 host build in fresh processes, seconds of "
        "the first / second pass: without tune_host_malloc "
        "%.3f / %.3f (RSS after them %.2f GiB), with it %.3f / %.3f (RSS "
        "%.2f GiB)" % (*runs[False]["passes"], runs[False]["rss_gib"],
                       *runs[True]["passes"], runs[True]["rss_gib"]))
    rep["malloc"] = runs
    return rep


# ---------------------------------------------------------------------------
# phases 16-17: the scale tools, the E. coli run and the spill run
# ---------------------------------------------------------------------------

# the JAX tool's record of the same run, for its quality figures only
ECOLI_RECORD = "ECOLI_r05.json"
QUALITY = ("nga50", "n_misassemblies", "genome_fraction",
           "mismatches_per_100kbp", "indels_per_100kbp", "n_contigs",
           "gapless")


def phase_ecoli():
    """The E. coli twin at its defaults on the card: 4.6 Mbp, 715,000
    pairs of 120 bp, assembly3 --device cuda, the quality gates (its exit
    code).  Returns its NW launches and their shapes."""
    from turingassembler_tpu_torch.localasm import bridge
    from turingassembler_tpu_torch.ops import nw_align
    from turingassembler_tpu_torch.tools import ecoli_scale
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ECOLI_RECORD)) as fp:
        record = json.load(fp)["result"]
    with tempfile.TemporaryDirectory() as d:
        report = os.path.join(d, "report.json")
        # the twin prints its whole report: into the log's stderr
        with contextlib.redirect_stdout(sys.stderr):
            rc = ecoli_scale.main(["--out", os.path.join(d, "lib"),
                                   "--report", report])
        shapes = nw_shapes()
        parts, outcomes = dict(bridge.BRIDGE_PROF), dict(bridge.BRIDGE_COUNTS)
        if not os.path.exists(report):
            raise AssertionError(f"ecoli: assembly3 returned {rc}")
        with open(report) as fp:
            rep = json.load(fp)
    ds, res, nw = rep["dataset"], rep["result"], rep["nw"]
    log(f"ecoli ({ds['genome_bp']} bp, repeats {ds['repeats']}, "
        f"{ds['n_pairs']} pairs of {ds['read_len']} bp, "
        f"{ds['coverage_x']}x, errors {ds['error_rate']}, seed "
        f"{ds['seed']}; assembly3 --device cuda on {rep['device_name']}): "
        f"simulation {rep['sim_s']:.3f} s, assembly3 "
        f"{rep['wall_total_s']:.3f} s, evaluate {rep['eval_s']:.3f} s; NW "
        f"{nw['pairs']} pairs in {nw['launches']} launches; peak device "
        f"memory {rep['peak_device_memory_gib']:.3f} GiB, peak RSS "
        f"{rep['peak_rss_gib']:.3f} GiB")
    log("ecoli stage seconds: " + ", ".join(
        f"{k_} {v:.3f}" for k_, v in rep["walls_s"].items()))
    log("ecoli bridge stage parts, thread-seconds: " + ", ".join(
        f"{k_} {parts.get(k_, 0.0):.3f}" for k_ in (
            "prebuild", "flank_map", "filters", "kmer_set", "path_search",
            "score_paths"))
        + f"; bridges {outcomes}")
    log("ecoli quality, this run / the JAX tool's record: " + ", ".join(
        f"{k_} {res[k_]} / {record[k_]}" for k_ in QUALITY))
    if rc != 0:
        raise AssertionError(f"ecoli: the quality gates failed (exit {rc})"
                             f": {res}")
    if nw["launches"] < 1 or nw["launches"] != len(shapes):
        raise AssertionError(f"ecoli: {nw['launches']} NW launches, "
                             f"{len(shapes)} shapes recorded")
    # the bubble check pads both branches to one width (Lq == Lt); the
    # mappers' and the path scoring's DP has Lt = Lq + 32
    return nw["launches"], [("bubble" if sh[1] == sh[2] else "map", sh)
                            for sh in shapes]


# phase 17: the spill twin at a tenth of its default library
SPILL_ARGS = ["--pairs", "1000000", "--sort-budget-mb", "32",
              "--count-pairs", "500000"]


def phase_spill():
    """The spill twin on the card: 1,000,000 pairs sorted under 32 MB
    (at least 4 spilled runs), the archive verified; 1,000,000 reads
    counted in memory and under a device budget, which must leave host
    and disk runs and the same table.  Then the same reads counted in
    memory in flush windows of a fifth of their rows, each window's table
    merged into the running one on the card (merge_runs, the path of a
    count of more than 2^28 rows): the same table again."""
    from turingassembler_tpu_torch.kmer.megasort import count_kedges_megasort
    from turingassembler_tpu_torch.tools import spill_scale
    with tempfile.TemporaryDirectory() as d:
        report = os.path.join(d, "report.json")
        lib = os.path.join(d, "lib")
        with contextlib.redirect_stdout(sys.stderr):
            rc = spill_scale.main(SPILL_ARGS + ["--out", lib, "--report",
                                                report])
        with open(report) as fp:
            rep = json.load(fp)
        reads = spill_scale.first_reads(
            [os.path.join(lib, n) for n in ("R1.fq", "R2.fq")],
            int(SPILL_ARGS[SPILL_ARGS.index("--count-pairs") + 1]))
    srt, ab = rep["sort"], rep["count_ab"]
    log(f"spill: {rep['n_pairs']} pairs (simulation {rep['sim_s']:.3f} s); "
        f"sort_read under {srt['budget_mb']} MB spilled {srt['runs']} runs, "
        f"{srt['wall_s']:.3f} s = {srt['pairs_per_s']} pairs/s, peak RSS "
        f"{srt['peak_rss_mb']} MB; "
        f"archive verified on {srt['verified_barcodes_structural']} "
        f"barcodes, {srt['verified_barcodes_content']} content-exact; "
        f"count of {ab['reads']} reads on the card: in memory "
        f"{ab['in_memory_s']:.3f} s, under a device budget of "
        f"{ab['device_lanes']} rows and {ab['budget_mb']} MB of host runs "
        f"{ab['spilled_s']:.3f} s ({ab['host_runs']} host runs, "
        f"{ab['disk_runs']} disk runs), {ab['unique_kedges']} unique, "
        "tables equal")
    # the twin itself raises unless the archive checks hold, the budgeted
    # count left at least 2 host runs and 1 disk run and the tables agree
    if rc != 0 or srt["runs"] < 4:
        raise AssertionError(f"spill: exit {rc}, {srt['runs']} sort runs")
    lengths = np.full(len(reads), spill_scale.READ_LEN, np.int32)
    windows = len(reads) * (spill_scale.READ_LEN - spill_scale.K) // 5

    def batches():
        for lo in range(0, len(reads), spill_scale.COUNT_BATCH):
            hi = lo + spill_scale.COUNT_BATCH
            yield reads[lo:hi], lengths[lo:hi]

    t0 = time.perf_counter()
    whole = count_kedges_megasort(batches(), spill_scale.K, device="cuda")
    t1 = time.perf_counter()
    merged = count_kedges_megasort(batches(), spill_scale.K,
                                   max_lanes=windows, device="cuda")
    t2 = time.perf_counter()
    if not all(np.array_equal(a, b) for a, b in zip(whole, merged)):
        raise AssertionError("spill: the count in flush windows != the "
                             "count in one")
    log(f"spill: {len(reads)} reads counted in one flush window "
        f"{t1 - t0:.3f} s and in windows of {windows} rows, each merged "
        f"into the running table, {t2 - t1:.3f} s: tables equal "
        f"({len(whole[0])} unique)")


# bench.py's keys, then the twin's own; bench.py's weather keys on a card
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "value_count_build",
              "vs_baseline_count_build", "weather", "device", "nw_launches",
              "nw_pairs")
BENCH_WEATHER = ("h2d_MBps", "d2h_MBps", "compile_warmup_s", "count_s",
                 "build_s", "map_s")


def phase_bench_twin(phase5_reads_per_s):
    """The bench twin as users run it: `python -m
    turingassembler_tpu_torch.bench` in a subprocess on the card at its
    defaults (phase 5's workload).  Raises unless it exits 0 with one
    stdout line holding every key.  Returns the NW launches of all its
    map passes, warm one included, and their shapes (its stderr's
    `nw shapes:` line), and its mm_map launches, their shapes and no
    reference shapes (its `mm_map shapes:` line)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    torch.cuda.empty_cache()          # the card's memory for the twin
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "turingassembler_tpu_torch.bench"], cwd=root,
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    # its per-pass seconds and shares: into the log's stderr
    print(proc.stderr, file=sys.stderr, end="", flush=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench twin: exit {proc.returncode}, "
                             f"{len(lines)} stdout lines")
    line = json.loads(lines[-1])
    missing = [k_ for k_ in BENCH_KEYS if k_ not in line] + [
        k_ for k_ in BENCH_WEATHER if k_ not in line["weather"]]
    if missing:
        raise AssertionError(f"bench twin: keys missing {missing}")
    w = line["weather"]
    log(f"bench twin (python -m turingassembler_tpu_torch.bench, "
        f"{wall:.1f} s wall, {line['device']}): value {line['value']} "
        f"reads/s (vs_baseline {line['vs_baseline']}), value_count_build "
        f"{line['value_count_build']} (vs_baseline "
        f"{line['vs_baseline_count_build']}); phase 5's count+build+map "
        f"{phase5_reads_per_s:.1f} reads/s")
    log(f"bench twin: count_s {w['count_s']}, build_s {w['build_s']}, map_s "
        f"{w['map_s']}, compile_warmup_s {w['compile_warmup_s']}, h2d "
        f"{w['h2d_MBps']} MB/s, d2h {w['d2h_MBps']} MB/s; best map pass: NW "
        f"{line['nw_launches']} launches, {line['nw_pairs']} pairs")
    log(f"bench twin line: {lines[-1]}")
    nw = [json.loads(ln[len("nw shapes: "):])
          for ln in proc.stderr.splitlines() if ln.startswith("nw shapes: ")]
    if len(nw) != 1 or len(nw[0]) < line["nw_launches"]:
        raise AssertionError("bench twin: no `nw shapes:` line holding the "
                             "best map pass's launches")
    log(f"bench twin: NW {len(nw[0])} launches over all its map passes")
    mm = [json.loads(ln[len("mm_map shapes: "):])
          for ln in proc.stderr.splitlines()
          if ln.startswith("mm_map shapes: ")]
    if len(mm) != 1 or not any(sh[0] == "map_batch" for sh in mm[0]):
        raise AssertionError("bench twin: no `mm_map shapes:` line with a "
                             "map_batch launch")
    log(f"bench twin: mm_map {len(mm[0])} launches (index builds and maps)")
    ks = [json.loads(ln[len("kmer_sort shapes: "):])
          for ln in proc.stderr.splitlines()
          if ln.startswith("kmer_sort shapes: ")]
    if len(ks) != 1 or not any(sh[0] == "sort_count" for sh in ks[0]):
        raise AssertionError("bench twin: no `kmer_sort shapes:` line with a "
                             "sort_count launch")
    routes = [json.loads(ln[len("kmer_sort routes: "):])
              for ln in proc.stderr.splitlines()
              if ln.startswith("kmer_sort routes: ")]
    if len(routes) != 1:
        raise AssertionError("bench twin: no `kmer_sort routes:` line")
    ks_remote({e: sum(1 for sh in ks[0] if sh[0] == e) for e in KS_ENTRIES},
              ks[0], routes[0])
    log(f"bench twin: kmer_sort {len(ks[0])} launches (counts and level-0 "
        "builds)")
    ub = [json.loads(ln[len("unitig_build shapes: "):])
          for ln in proc.stderr.splitlines()
          if ln.startswith("unitig_build shapes: ")]
    if len(ub) != 1:
        raise AssertionError("bench twin: no `unitig_build shapes:` line")
    UB_REMOTE.append(({e: sum(1 for sh in ub[0] if sh[0] == e)
                       for e in UB_ENTRIES}, [tuple(sh) for sh in ub[0]]))
    log(f"bench twin: unitig_build {len(ub[0])} launches (level-0 builds)")
    rebuilt = [ln.rsplit(":", 1)[1].strip()
               for ln in proc.stderr.splitlines()
               if ln.startswith("pool rebuilt in the timed map passes:")]
    log(f"bench twin: the graph's pool rebuilt in the timed map passes: "
        f"{rebuilt}")
    if rebuilt != ["False"]:
        raise AssertionError("bench twin: the timed map passes made the "
                             f"graph's pool again ({rebuilt})")
    return (len(nw[0]), [("map", tuple(sh)) for sh in nw[0]],
            (len(mm[0]), [tuple(sh) for sh in mm[0]], []))


def phase_graft_twin():
    """The graft twin (turingassembler_tpu_torch/graft_entry.py): entry()'s
    forward on the card == on the CPU, then dryrun_multichip(1) and (4)
    on cuda:0, every check of the JAX function; then each dryrun's hash
    stage again into kernel tables and plain tables.  Returns the devhash
    rows-entry launches of their hash counters, the largest |count
    difference| of that hold (0), the NW launches and their shapes."""
    from turingassembler_tpu_torch import graft_entry
    from turingassembler_tpu_torch.ops import devhash, nw_align
    fwd, args = graft_entry.entry("cuda")
    u, c, n = fwd(*args)
    fwd_c, args_c = graft_entry.entry("cpu")
    uc, cc, nc = fwd_c(*args_c)
    n = int(n)
    if n != int(nc) or not (torch.equal(u[:n].cpu(), uc[:n])
                            and torch.equal(c[:n].cpu(), cc[:n])):
        raise AssertionError("graft entry: card != CPU")
    log(f"graft entry: forward on the card == on the CPU ({n} unique "
        f"(k+1)-mers of {args[0].shape[0]} reads)")
    devhash.COUNT.reset()
    nw_align.COUNT.reset()
    for n_shards in (1, 4):
        t0 = time.perf_counter()
        fig = graft_entry.dryrun_multichip(n_shards, device="cuda:0")
        log(f"graft dryrun_multichip({n_shards}) on cuda:0: "
            f"{time.perf_counter() - t0:.3f} s")
        if fig["unique_hash"] != fig["unique_sort"]:
            raise AssertionError(f"graft dryrun_multichip({n_shards}): "
                                 f"{fig['unique_hash']} unique by the hash "
                                 f"engine, {fig['unique_sort']} by sort")
    rows = devhash.COUNT.by_entry["insert"]
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.total("pairs")
    shapes = [("map", sh) for sh in nw_shapes()]
    log(f"graft dryruns: devhash rows entry {rows} launches; NW {pairs} "
        f"pairs in {launches} launches")
    # one rows-entry launch a shard of each hash counter
    reads_launches = devhash.COUNT.by_entry["insert_reads"]
    if rows != 1 + 4 or reads_launches:
        raise AssertionError(f"graft dryruns: {rows} rows launches, "
                             f"{reads_launches} reads launches")
    err = max(hold_graft_hash_stage(n_shards) for n_shards in (1, 4))
    return rows, err, launches, shapes


def hold_graft_hash_stage(n_shards):
    """A dryrun's hash stage on its own batch (k=31, 2^12 slots a shard),
    now that the paths' counts are read: the same routing and exchange
    into fresh kernel tables and fresh plain tables, so the kernel is
    held at the dryrun's own shape.  Returns the largest |count
    difference| (0)."""
    from turingassembler_tpu_torch import graft_entry as ge
    from turingassembler_tpu_torch.ops import limbs as lb
    from turingassembler_tpu_torch.ops.devhash import DeviceHashCounter
    from turingassembler_tpu_torch.parallel.mesh import make_mesh
    from turingassembler_tpu_torch.parallel.sharded_count import (
        _route_and_insert, device_put_sharded_batch)
    mesh = make_mesh(n_shards, "cuda:0")
    _, bases, lengths = ge.dryrun_batch(n_shards)
    k1 = ge.DRYRUN_K + 1
    cap = ge.hash_cap_per_dest(n_shards, bases)
    db, dl = device_put_sharded_batch(bases, lengths, mesh)
    tables = {}
    for plain in (False, True):
        tables[plain] = [DeviceHashCounter(ge.HASH_CAP_LOG2, lb.n_limbs(k1),
                                           device=d, plain=plain)
                         for d in mesh.devices]
        _route_and_insert(tables[plain], db, dl, mesh=mesh, k1=k1,
                          cap_per_dest=cap)
    return max(hold_tables(
        f"graft dryrun_multichip({n_shards}) shard {i} (2^"
        f"{ge.HASH_CAP_LOG2} slots, {n_shards * cap} routed lanes)", kc, pc)
        for i, (kc, pc) in enumerate(zip(tables[False], tables[True])))


def build_kernels():
    """nvcc for every CUDA source and the host compiler for every
    native/*.cpp, all started together."""
    import concurrent.futures
    from turingassembler_tpu_torch import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(_build.build_host)
        logs = _build.build()
        libs = host.result()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(logs) or 'cached'}; host: "
        f"{', '.join(p.name for p in libs.values())})")
    for name, text in logs.items():
        print(f"[{name}] {text}", file=sys.stderr, flush=True)


def main():
    smi = device_info()
    build_kernels()

    walls, rss = {}, {}
    from turingassembler_tpu_torch.ops import kmer_sort, unitig_build
    # each phase's kmer_sort and unitig_build launches, by entry, and their
    # shapes: the counts are set to 0 just before a phase and read just
    # after
    ks_count, ub_count = {}, {}

    def phase(fn, *args):
        kmer_sort.COUNT.reset()
        KS_REMOTE.clear()
        unitig_build.COUNT.reset()
        UB_REMOTE.clear()
        t0 = time.perf_counter()
        res = fn(*args)
        walls[fn.__name__] = time.perf_counter() - t0
        rss[fn.__name__] = peak_rss_gib()
        by = dict(kmer_sort.COUNT.by_entry)
        shs = list(kmer_sort.COUNT.shapes)
        routes = {e: dict(r) for e, r in kmer_sort.COUNT.counts.items()}
        for b, sub, rt in KS_REMOTE:
            by = {e: by[e] + b.get(e, 0) for e in KS_ENTRIES}
            shs += sub
            routes = {e: {r: n_ + rt.get(e, {}).get(r, 0)
                          for r, n_ in rs.items()}
                      for e, rs in routes.items()}
        ks_count[fn.__name__] = (by, shs, routes)
        by = dict(unitig_build.COUNT.by_entry)
        shs = list(unitig_build.COUNT.shapes)
        for b, sub in UB_REMOTE:
            by = {e: by[e] + b[e] for e in UB_ENTRIES}
            shs += sub
        ub_count[fn.__name__] = (by, shs)
        return res

    from turingassembler_tpu_torch.ops import mm_map
    # the mm_map kernel's launches on the paths (phases 5, 9, 10, 11, 13,
    # 16, 18, 19) and each launch's (entry, B, L, verified)
    mm_count = {"launches": 0, "shapes": [], "refs": []}

    def path(fn, *args):
        """A phase that drives a path: mm_map's count is set to 0 just
        before it and read just after."""
        mm_map.COUNT.reset()
        res = phase(fn, *args)
        mm_count["launches"] += mm_map.COUNT.launches
        mm_count["shapes"] += mm_map.COUNT.shapes
        return res

    def add_mm(sub):
        """Launches a path made in subprocesses (their own counts), and
        the shapes of reference runs beside it (held, not counted)."""
        mm_count["launches"] += sub[0]
        mm_count["shapes"] += sub[1]
        mm_count["refs"] += sub[2]

    nw = phase(phase_kernel_vs_plain)
    phase(phase_slice_parity)
    mm, workload = phase(phase_mm_kernel_vs_plain)
    ks = phase(phase_ks_kernel_vs_plain, workload)
    ub = phase(phase_ub_kernel_vs_plain, workload)
    launches, shapes, bench, reads_per_s = path(phase_full_width, workload)
    del workload
    phase(phase_levels_parity)
    n, sh = phase(phase_levels_full_width)
    launches, shapes = launches + n, shapes + sh
    # phase 11 reads what phases 8 and 9 wrote
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "parity"))
        os.makedirs(os.path.join(work, "full"))
        parity = phase(phase_scaffold_parity, os.path.join(work, "parity"))
        n, sh, full_out, genome = path(phase_scaffold_full_width,
                                       os.path.join(work, "full"))
        launches, shapes = launches + n, shapes + sh
        n, sh = path(phase_path_scoring)
        launches, shapes = launches + n, shapes + sh
        parity_out = parity[0]
        n, sh = path(phase_barcode_levels, parity_out, full_out, genome)
        launches, shapes = launches + n, shapes + sh
        n, sh, sub = path(phase_multi_process, *parity, full_out)
        launches, shapes = launches + n, shapes + sh
        add_mm(sub)
        phase(phase_host_twins, parity[1], full_out, bench, work)
    dh_reads, dh_rows, dh = phase(phase_secondary_engines, bench)
    del bench
    n, sh = path(phase_ecoli)
    launches, shapes = launches + n, shapes + sh
    phase(phase_spill)
    n, sh, sub = phase(phase_bench_twin, reads_per_s)
    launches, shapes = launches + n, shapes + sh
    add_mm(sub)
    rows, err, n, sh = path(phase_graft_twin)
    dh_rows, launches, shapes = dh_rows + rows, launches + n, shapes + sh
    dh["max_abs_err"] = max(dh["max_abs_err"], err)
    log(f"mm_map on the paths: {mm_count['launches']} launches; by entry "
        + ", ".join(f"{e} {sum(1 for s_ in mm_count['shapes'] if s_[0] == e)}"
                    for e in ("map_batch", "gapless_bound", "minimizer_rows")))
    if mm_count["launches"] < 1 or \
            mm_count["launches"] != len(mm_count["shapes"]):
        raise AssertionError("mm_map: the paths launched the kernel "
                             f"{mm_count['launches']} times")
    ks_launches = {e: sum(ks_count[p][0][e] for p in KS_PATH_PHASES)
                   for e in KS_ENTRIES}
    ks_shapes = [sh for p in KS_PATH_PHASES for sh in ks_count[p][1]]
    ks_routes = {e: {r: sum(ks_count[p][2][e][r] for p in KS_PATH_PHASES)
                     for r in rs} for e, rs in kmer_sort.ROUTES.items()}
    log("kmer_sort routes on the paths: " + "; ".join(
        f"{e} " + ", ".join(f"{r} {n_}" for r, n_ in rs.items())
        for e, rs in ks_routes.items()))
    log("kmer_sort on the paths: " + ", ".join(
        f"{e} {n_}" for e, n_ in ks_launches.items()) + "; by phase: "
        + "; ".join(f"{p[6:]} " + ", ".join(
            f"{e} {ks_count[p][0][e]}" for e in KS_ENTRIES if ks_count[p][0][e])
            for p in KS_PATH_PHASES))
    for p in KS_COUNT_PHASES:
        if not (ks_count[p][0]["extract_keys"] and ks_count[p][0]["sort_count"]):
            raise AssertionError(f"kmer_sort: the count of {p} launched no "
                                 "extract_keys or no sort_count")
    if not ks_count["phase_spill"][0]["merge_runs"]:
        raise AssertionError("kmer_sort: the spill count launched no "
                             "merge_runs")
    # every merge of the paths merges two tables, ascending: the merge path
    if ks_routes["merge_runs"]["lsd"] or ks_routes["merge_runs"][
            "merge_path"] != ks_launches["merge_runs"]:
        raise AssertionError("kmer_sort: merge_runs on the paths took "
                             f"{ks_routes['merge_runs']}")
    if sum(ks_launches.values()) != len(ks_shapes) or \
            min(ks_launches.values()) < 1:
        raise AssertionError(f"kmer_sort: launches {ks_launches}, "
                             f"{len(ks_shapes)} shapes")
    # every phase that drives a path (KS_PATH_PHASES) may build level 0
    ub_launches = {e: sum(ub_count[p][0][e] for p in KS_PATH_PHASES)
                   for e in UB_ENTRIES}
    ub_shapes = [sh for p in KS_PATH_PHASES for sh in ub_count[p][1]]
    log("unitig_build on the paths: " + ", ".join(
        f"{e} {n_}" for e, n_ in ub_launches.items()) + "; by phase: "
        + "; ".join(f"{p[6:]} " + ", ".join(
            f"{e} {ub_count[p][0][e]}" for e in UB_ENTRIES)
            for p in KS_PATH_PHASES if any(ub_count[p][0].values())))
    for p in UB_PATH_PHASES:
        if not all(ub_count[p][0].values()):
            raise AssertionError(f"unitig_build: the level-0 build of {p} "
                                 f"launched {ub_count[p][0]}")
    if sum(ub_launches.values()) != len(ub_shapes):
        raise AssertionError(f"unitig_build: launches {ub_launches}, "
                             f"{len(ub_shapes)} shapes")
    # launches made to compare: read after the paths' counts were taken
    nw["max_abs_err"] = max(nw["max_abs_err"],
                            phase(phase_hold_path_shapes, shapes))
    mm["max_abs_err"] = max(mm["max_abs_err"], phase(
        phase_mm_hold_path_shapes, mm_count["shapes"] + mm_count["refs"]))
    ks["max_abs_err"] = max(ks["max_abs_err"], phase(
        phase_ks_hold_path_shapes, ks_shapes))
    ub["max_abs_err"] = max(ub["max_abs_err"], phase(
        phase_ub_hold_path_shapes, ub_shapes))
    log("phase seconds (set-up included): " + ", ".join(
        f"{k_[6:]} {v:.1f}" for k_, v in walls.items()))
    # cli.main tunes malloc (no mmap, no trim) from phase 7 on
    log("peak RSS of this process after each phase, GiB: " + ", ".join(
        f"{k_[6:]} {v:.2f}" for k_, v in rss.items()))

    print(json.dumps({"kernels": [{
        "name": "nw_align", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/nw_align.cu",
        "replaces": "turingassembler_tpu/ops/pallas_align.py:159",
        "launches": launches, "max_abs_err": nw["max_abs_err"],
        "ms": nw["ms"], "plain_ms": nw["plain_ms"],
        "bound_ms": nw["bound_ms"], "bound_by": nw["bound_by"],
        "library_ms": None}, {
        "name": "devhash", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/devhash.cu",
        "replaces": "turingassembler_tpu/ops/devhash.py:103",
        "launches": dh_rows, "max_abs_err": dh["max_abs_err"],
        "ms": dh["ms"], "kernel_ms": dh["kernel_ms"],
        "plain_ms": dh["plain_ms"], "bound_ms": dh["bound_ms"],
        "bound_by": "bytes", "library_ms": dh["library_ms"],
        "fused_launches": dh_reads, "fused_ms": dh["fused_ms"],
        "fused_bound_ms": dh["fused_bound_ms"],
        "unfused_ms": dh["unfused_ms"]}, {
        "name": "devhash_count_reads", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/devhash.cu",
        "replaces": "turingassembler_tpu/kmer/count.py:101",
        "launches": dh_reads, "max_abs_err": dh["max_abs_err"],
        "ms": dh["fused_ms"], "plain_ms": dh["fused_plain_ms"],
        "bound_ms": dh["fused_bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "mm_map", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/mm_map.cu",
        "replaces": "turingassembler_tpu/mapper/minimizers.py:578",
        "launches": mm_count["launches"], "max_abs_err": mm["max_abs_err"],
        **mm["map_batch"], "library_ms": None,
        "launches_by_entry": {e: sum(1 for s_ in mm_count["shapes"]
                                     if s_[0] == e)
                              for e in ("map_batch", "gapless_bound",
                                        "minimizer_rows")},
        **{f"{e}_{k_}": mm[e][k_] for e in ("gapless_bound", "minimizer_rows")
           for k_ in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                      "bound_by")}}] + [{
        "name": f"kmer_{e}", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/kmer_sort.cu",
        "replaces": KS_REPLACES[e], "launches": ks_launches[e],
        "max_abs_err": ks["max_abs_err"], **ks[e],
        **({"over_capacity_buckets": ks_routes[e]["over_capacity"]}
           if e == "sort_count" else {}),
        **({"routes_on_paths": ks_routes[e]} if e in ks_routes else {})}
        for e in KS_ENTRIES] + [{
        "name": f"unitig_{e}", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/unitig_build.cu",
        "replaces": UB_REPLACES[e], "launches": ub_launches[e],
        "max_abs_err": ub["max_abs_err"], **ub[e]} for e in UB_ENTRIES]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank_worker(json.loads(sys.argv[2]))
    else:
        main()
