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
  5. full width: bench.py's workload (2 Mbp genome, 1,048,576 reads of
     150 bp, k=45) through count -> level-0 build -> minimizer index ->
     DP-verified map, plus 66,560 reads with one mid-read indel; launch
     counts are reset just before and read just after; then one more
     pass under torch.profiler for the device's busy share
  6. levels parity: a 100 kbp two-haplotype library from FASTQ files
     through assembly_basic (level 0, 1, 2 graph files) on the card and
     on the CPU, nine files byte-identical; once more with count budgets
     that force runs to disk, on the card and on the CPU: level 0's files
     byte-identical, and its graph isomorphic to the in-memory run's
  7. levels at full width: a 250 kbp two-haplotype library (about 67k
     reads of 150 bp, 0.5% substitutions, k=45, min count 2; the depth
     is cut from 2 Mbp to keep the script short) through the CLI
     function, `basic --device cuda`: stage seconds, the bubble check's
     NW launches, and checks of the three graphs against the haplotypes
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
     ranks' launches and (c)'s join the kernels line's count.  The ranks are this script again: `chip_smoke.py --rank <spec>`
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
     of its records' bytes (at least 4 spilled runs merged) == phase 9's
     archive byte for byte, and on phase 8's library == the Python loop;
     (c) the level-0 host build of phase 5's 1,999,953 k-edges through
     the graph kernels == through their numpy versions, array for array,
     and each kernel alone; (d) the read pack of phase 5's first 131,072
     reads == numpy, unpacked on the card == the codes, timed beside the
     plain copy of the codes (pageable and pinned); (e) (c)'s build twice
     in a fresh process with tune_host_malloc and in one without
 12. kernel vs plain once more, at every (B, Lq, Lt) that phases 5, 7,
     9, 10, 11 and 13 launched the kernel at, with their scoring and mode
 16. the `kernels` JSON line, the nvidia-smi line, and last the result
     line {"ok": true, "device": {...}}

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
    count's device tensors), then the verified map of the indel reads.
    Each stage ends in a device sync; `around(name)`, when given, is a
    context manager entered around each stage.  Returns stage seconds
    and the outputs."""
    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import count_reads_device
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)
    st, out = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with around(name) if around else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            st[name] = time.perf_counter() - t0
        return res

    u, c, out["n"], shipped = stage("count", lambda: count_reads_device(
        reads, lengths, k, return_chunks=True))
    out["u"], out["c"] = u, c
    g = out["g"] = stage("build", lambda: build_graph_on_device(
        u, c, out["n"], k))
    idx = out["idx"] = stage("index", lambda: EdgeMinimizerIndex.build(g))
    out["e"], _, out["s"] = stage("map", lambda: map_reads(
        idx, reads, lengths, graph=g, shipped=shipped, with_hits=False))
    out["ei"], _, _ = stage("map_indel", lambda: map_reads(
        idx, ir, il, graph=g))
    return st, out


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


def phase_full_width():
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import nw_align

    k, read_len, n_reads, G = 45, 150, 1_048_576, 2_000_000
    genome = tt.random_genome(G, seed=0)
    reads, lengths = tt.sim_reads(genome, coverage=n_reads * read_len / G,
                                  read_len=read_len, seed=1,
                                  pad_to=read_len + 2)
    reads, lengths = reads[:n_reads], lengths[:n_reads]
    ir, il = tt.sim_indel_reads(genome, N_INDEL, read_len, seed=2,
                                pad_to=read_len + 2)

    torch.cuda.reset_peak_memory_stats()
    nw_align.COUNT.reset()
    st, out = run_main_path(reads, lengths, ir, il, k)
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.pairs
    shapes = [("map", sh) for sh in nw_align.COUNT.shapes]
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
    log("full width: count+build+map "
        f"{n_reads / (st['count'] + st['build'] + st['map']):.1f} reads/s "
        f"(median of {len(passes)} passes; index build excluded, as "
        f"bench.py does)")
    # the assembly against the reference: a 2 Mbp random genome at 79x
    # with error-free reads is one unitig per strand
    lens = g.edge_len()
    longest = g.get_seq(int(np.argmax(lens))).tobytes()
    if not (genome.tobytes().find(longest) >= 0
            or tt.revcomp(genome).copy().tobytes().find(longest) >= 0):
        raise AssertionError("longest unitig is not a genome substring")
    if lens.max() < 0.999 * G:
        raise AssertionError(f"longest unitig {lens.max()} < 99.9% genome")
    if mapped < 0.99:
        raise AssertionError(f"only {mapped:.4f} of error-free reads mapped")
    if acc_indel < 0.95:
        raise AssertionError(f"only {acc_indel:.4f} of indel reads accepted")
    if pairs < 65_536 or launches < 1:
        raise AssertionError(f"remainder DP ran {pairs} pairs through the "
                             "NW kernel, expected >= 65536")
    m = e >= 0
    if not ((s[m] >= 0).all() and (s[m] < lens[e[m]]).all()):
        raise AssertionError("mapped starts outside their edges")
    # one more pass with the profiler around each stage on its own
    prof = StageProfiler()
    st, _ = run_main_path(reads, lengths, ir, il, k, prof.around)
    prof.report("profile, one more full-width pass", st)
    n = out["n"]
    bench = dict(reads=reads, lengths=lengths, k=k,
                 kedges=out["u"][:n].cpu().numpy().astype(np.uint32),
                 counts=out["c"][:n].cpu().numpy().astype(np.int64))
    return launches, shapes, bench


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
        before = nw_align.COUNT.launches, nw_align.COUNT.pairs
        g2 = pipeline.assembly_basic(levels_config(paths, out["card"]),
                                     device="cuda")
        torch.cuda.synchronize()
        launched = nw_align.COUNT.launches - before[0]
        pairs = nw_align.COUNT.pairs - before[1]
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
    from turingassembler_tpu_torch.kmer.megasort import \
        count_kedges_megasort_device
    batches = list(pipeline._genomic_batches(cfg))
    prof, st = StageProfiler(), {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with prof.around(name):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            st[name] = time.perf_counter() - t0
        return res

    u, c, n = stage("count", lambda: count_kedges_megasort_device(
        iter(batches), cfg.k0, min_count=cfg.device.min_kmer_count))
    stage("build", lambda: build_graph_on_device(u, c, n, cfg.k0))
    prof.report(f"levels profile ({len(batches)} parsed batches of "
                f"{len(batches[0][0])} reads)", st)


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
        launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.pairs
        shapes = list(nw_align.COUNT.shapes)
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
    before = nw_align.COUNT.launches, nw_align.COUNT.pairs
    # the stage clock starts here, not at the last stage of a phase before
    set_log_stage("init")
    reset_stage_walls()
    t0 = time.perf_counter()
    pipeline.assembly3(linked_config(files, out["card"]), device="cuda")
    torch.cuda.synchronize()
    t_card, walls = time.perf_counter() - t0, stage_walls()
    launched = nw_align.COUNT.launches - before[0]
    pairs = nw_align.COUNT.pairs - before[1]
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
        before = nw_align.COUNT.launches, nw_align.COUNT.pairs
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
        nw[name] = (nw_align.COUNT.pairs - before[1],
                    nw_align.COUNT.launches - before[0],
                    nw_align.COUNT.shapes[n_shapes:])

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
    # what the head of every verified map_reads call costs: packing
    # the contig pool on the host and copying it over
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
        + "; contig pool pack + copy, paid at the head of every verified "
        "map_reads call (two a batch in each map stage): "
        + ", ".join(f"{m:.1f}" for m in pool_ms) + " ms")
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
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.pairs
    shapes = list(nw_align.COUNT.shapes)
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
            shapes += nw_align.COUNT.shapes[n_shapes:]
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
        before = nw_align.COUNT.launches, nw_align.COUNT.pairs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof.around(name):
            rc = cli.main([name] + args + ["-k0", str(K_LEVELS), "-o", out,
                                           "--device", "cuda"])
            torch.cuda.synchronize()
            sec[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"barcode levels: `{name}` returned {rc}")
        nw[name] = (nw_align.COUNT.pairs - before[1],
                    nw_align.COUNT.launches - before[0])
    launches = nw_align.COUNT.launches
    shapes += list(nw_align.COUNT.shapes)
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
    from turingassembler_tpu_torch.ops import nw_align
    nw_align.COUNT.reset()
    t0 = time.perf_counter()
    res = {"cli": rank_cli, "stripes": rank_stripes,
           "aux_single": aux_single,
           "host_build": host_build}[spec["kind"]](spec)
    res.update(seconds=time.perf_counter() - t0,
               launches=nw_align.COUNT.launches, pairs=nw_align.COUNT.pairs,
               shapes=nw_align.COUNT.shapes)
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
    n_c, p_c = nw_align.COUNT.launches, nw_align.COUNT.pairs
    shapes += label(nw_align.COUNT.shapes)
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
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 14: the secondary count engines and the devhash kernel
# ---------------------------------------------------------------------------

HASH_BATCH = 8192          # count_kedges_from_reads' batch: 860,160 lanes
BENCH_CAP_LOG2 = 25        # the hash engine's default table, 2^25 slots
SHARD_CAP_LOG2 = 23        # a shard's table in (d): load about 0.08
CARD = "cuda"              # the device phase 14 runs on


def table_of(counter):
    """A counter's live set, sorted, host arrays, whatever overflowed."""
    from turingassembler_tpu_torch.ops import limbs as lb
    keys, counts = counter.live(counter.C)
    order = lb.lex_order(keys)
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
    read_launches, lanes = devhash.COUNT.reads, devhash.COUNT.lanes
    rows_in_b = devhash.COUNT.rows
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
    sh_launches = devhash.COUNT.rows
    same("ShardedHashCounter", sh_out, ref)
    n_batches = -(-len(sreads) // HASH_BATCH)
    log(f"secondary engines (d) ShardedHashCounter, {D} shards on {CARD}, "
        f"2^{SHARD_CAP_LOG2} slots a shard, {n_batches} batches: {t_sh:.3f} "
        "s, none dropped or overflowed, == the single count; devhash rows "
        f"entry {sh_launches} launches")
    if sh_launches != D * n_batches or devhash.COUNT.reads:
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
    try:
        t0 = time.perf_counter()
        sort_read.sort_reads(cfg)
        t_spill = time.perf_counter() - t0
    finally:
        del os.environ["TA_SORT_MEM_BYTES"]
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
        f"{budget} bytes (a fifth of the formatted records: at least 4 "
        f"spilled runs, k-way merged) {t_spill:.3f} s, all three files "
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

    def phase(fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        walls[fn.__name__] = time.perf_counter() - t0
        rss[fn.__name__] = peak_rss_gib()
        return res

    nw = phase(phase_kernel_vs_plain)
    phase(phase_slice_parity)
    launches, shapes, bench = phase(phase_full_width)
    phase(phase_levels_parity)
    n, sh = phase(phase_levels_full_width)
    launches, shapes = launches + n, shapes + sh
    # phase 11 reads what phases 8 and 9 wrote
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "parity"))
        os.makedirs(os.path.join(work, "full"))
        parity = phase(phase_scaffold_parity, os.path.join(work, "parity"))
        n, sh, full_out, genome = phase(phase_scaffold_full_width,
                                        os.path.join(work, "full"))
        launches, shapes = launches + n, shapes + sh
        n, sh = phase(phase_path_scoring)
        launches, shapes = launches + n, shapes + sh
        parity_out = parity[0]
        n, sh = phase(phase_barcode_levels, parity_out, full_out, genome)
        launches, shapes = launches + n, shapes + sh
        n, sh = phase(phase_multi_process, *parity, full_out)
        launches, shapes = launches + n, shapes + sh
        phase(phase_host_twins, parity[1], full_out, bench, work)
    dh_reads, dh_rows, dh = phase(phase_secondary_engines, bench)
    del bench
    # launches made to compare: read after the paths' counts were taken
    nw["max_abs_err"] = max(nw["max_abs_err"],
                            phase(phase_hold_path_shapes, shapes))
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
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank_worker(json.loads(sys.argv[2]))
    else:
        main()
