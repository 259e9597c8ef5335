"""Real-library-scale spill run of the port (twin of the JAX package's
tools/spill_scale.py).

Upstream's out-of-core machinery is its external barcode sort
(a memory budget, spilled sorted runs, a k-way merge) and KMC's -sm
counting budget.  The port's twins are the host sorter
(native/sort_read.cpp, budget TA_SORT_MEM_BYTES) and the count's spill
(kmer/megasort.py: device table -> host runs -> disk runs -> external
merge).  This tool drives both at a real library's size (default 10 M
pairs of 120 bp, the order of upstream's E. coli TELL-Seq library)
under small budgets, verifies the spilled archive against the
simulation's own barcode assignment on a sample, and records
pairs/s and the peak resident set.

The library, the argv, the sort budget, the archive checks and the
report's keys are the JAX tool's; `--device` (default cuda) places the
count.  Where it departs from the JAX tool: its count A/B spills.  The
JAX tool sets only TA_SORT_HOST_MB, but its count pulls the device table
to host runs only under TA_SORT_DEVICE_LANES, which it never sets, so
its "spilled" count never spilled and its "equal" compared two
in-memory counts.  Here the second count runs with a device budget of
a fifth of the first count's unique (k+1)-mers, `--count-budget-mb` of
host runs and a spill directory, the tool asserts that at least 2 runs
stayed in host memory and at least 1 went to disk (the report's
"host_runs" and "disk_runs"), and that both tables are equal.  The
report's "sort" also holds "runs", the sorted runs the sorter spilled.
`--keep-reads` (reuse the library under --out) is kept only so that the
argv is the JAX tool's.

Usage:
    python -m turingassembler_tpu_torch.tools.spill_scale \\
        --pairs 10000000 --out OUT --report SPILL_report.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import testing as tt
from .ecoli_scale import BARCODE_LEN, RssPeak

READ_LEN = 120
CHUNK_PAIRS = 500_000
K = 45
COUNT_BATCH = 8192


def write_library(out_dir: str, genome, n_pairs: int, seed: int):
    """Chunked simulation + FASTQ write; returns (paths, bcs array)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = [os.path.join(out_dir, n) for n in ("R1.fq", "R2.fq", "I1.fq")]
    os.makedirs(out_dir, exist_ok=True)
    all_bcs = []
    ridx = 0
    bc_base = 0
    mols_per_chunk = CHUNK_PAIRS // 20
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2, \
            open(paths[2], "wb") as fI:
        while ridx < n_pairs:
            want = min(CHUNK_PAIRS, n_pairs - ridx)
            r1, r2, _, _, bcs = tt.sim_barcoded_pairs_fast(
                genome, molecule_len=20_000,
                n_molecules=-(-want // 20), reads_per_molecule=20,
                read_len=READ_LEN, insert=300,
                seed=seed + ridx, error_rate=0.002)
            r1, r2, bcs = r1[:want], r2[:want], bcs[:want] + bc_base
            bc_base += mols_per_chunk + 10
            all_bcs.append(bcs)
            f1.write(tt.fastq_block(ridx, acgt[r1]))
            f2.write(tt.fastq_block(ridx, acgt[r2]))
            fI.write(tt.fastq_block(ridx, tt.encode_barcodes(bcs + 1,
                                                             BARCODE_LEN)))
            ridx += want
            print(f"  simulated {ridx:,}/{n_pairs:,} pairs", file=sys.stderr)
    return paths, np.concatenate(all_bcs)


def first_reads(paths, n: int) -> np.ndarray:
    """The first n reads of each FASTQ file, stacked: (len(paths) * n,
    READ_LEN) codes."""
    from ..io.native_loader import read_fastq_batches_native
    parts = []
    for path in paths:
        got = 0
        for bases, _, _ in read_fastq_batches_native(path, 1 << 17,
                                                     pad_to=READ_LEN):
            parts.append(bases[: n - got])
            got += len(parts[-1])
            if got == n:
                break
        if got != n:
            raise ValueError(f"{path}: {got} reads, fewer than {n}")
    return np.concatenate(parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10_000_000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "spill_scale"))
    ap.add_argument("--report", default="SPILL_report.json")
    ap.add_argument("--sort-budget-mb", type=int, default=256,
                    help="external-sort budget; 10M pairs ~ 5.6 GB of "
                         "records, so 256 MB forces ~20+ spill runs")
    ap.add_argument("--count-budget-mb", type=int, default=512,
                    help="host budget of the spilled count's runs")
    ap.add_argument("--count-pairs", type=int, default=1_000_000,
                    help="subset for the spilled==in-memory count A/B")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--keep-reads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the count (cuda, cpu)")
    args = ap.parse_args(argv)

    # restore the sorter's budget for whoever called main() in-process
    saved = os.environ.get("TA_SORT_MEM_BYTES")
    try:
        return _run(args)
    finally:
        if saved is None:
            os.environ.pop("TA_SORT_MEM_BYTES", None)
        else:
            os.environ["TA_SORT_MEM_BYTES"] = saved


def _run(args):
    from ..barcode.sort_read import (fetch_reads_by_barcodes,
                                     load_barcode_index, parse_fastq_blob,
                                     sort_reads, verify_read_archive)
    from ..config import LIB_TYPE_UST, Config
    from ..kmer.megasort import count_kedges_megasort

    genome = tt.random_genome(5_000_000, seed=args.seed)
    t0 = time.time()
    bcs_path = os.path.join(args.out, "truth_bcs.npy")
    if args.keep_reads and os.path.exists(bcs_path):
        paths = [os.path.join(args.out, n) for n in ("R1.fq", "R2.fq", "I1.fq")]
        bcs = np.load(bcs_path)
    else:
        paths, bcs = write_library(args.out, genome, args.pairs,
                                   args.seed + 1)
        np.save(bcs_path, bcs)
    sim_s = time.time() - t0
    n_pairs = len(bcs)
    print(f"library: {n_pairs:,} pairs in {sim_s:.0f}s", file=sys.stderr)

    # --- external barcode sort under a constrained budget -------------
    out_dir = os.path.join(args.out, "sorted")
    os.environ["TA_SORT_MEM_BYTES"] = str(args.sort_budget_mb << 20)
    cfg = Config(files_1=(paths[0],), files_2=(paths[1],),
                 files_I=(paths[2],), lib_type=LIB_TYPE_UST, out_dir=out_dir)
    t1 = time.time()
    sort_stats = {}
    with RssPeak() as rss:
        rpath = sort_reads(cfg, stats=sort_stats)
    sort_s = time.time() - t1
    peak_rss_mb = rss.peak / 2**20
    print(f"sort_read: {n_pairs:,} pairs in {sort_s:.1f}s = "
          f"{n_pairs/sort_s:,.0f} pairs/s under a "
          f"{args.sort_budget_mb} MB budget, {sort_stats['runs']} spilled "
          f"runs (peak RSS {peak_rss_mb:.0f} MB)", file=sys.stderr)

    # --- verify the spilled archive -----------------------------------
    # (a) structural integrity on a barcode sample (upstream
    #     test_same_barcode)
    index = load_barcode_index(rpath.idx_path)
    n_checked = verify_read_archive(rpath, index=index, max_barcodes=512)
    # (b) content: for sampled barcodes, the read-id set fetched through
    #     the index must equal the simulation's own assignment
    rng = np.random.default_rng(7)
    sample = rng.choice(np.unique(bcs), size=32, replace=False)
    truth = {}
    for b in sample:
        truth[int(b)] = set(np.flatnonzero(bcs == b).tolist())
    # the I1 index read encodes sim barcode b as b+1 (0 is the
    # no-barcode sentinel), so the archive keys are b+1
    blob1, _ = fetch_reads_by_barcodes(rpath, index,
                                       [b + 1 for b in sorted(truth)])
    names, _, _, _ = parse_fastq_blob(blob1)
    got_ids = {int(n.decode().split()[0][1:]) for n in names}
    want_ids = set().union(*truth.values())
    if got_ids != want_ids:
        raise AssertionError(f"archive sample mismatch: {len(got_ids)} "
                             f"fetched vs {len(want_ids)} simulated")
    print(f"archive verified: {n_checked} barcodes structurally, "
          f"{len(sample)} barcodes content-exact ({len(want_ids)} reads)",
          file=sys.stderr)

    # --- count A/B on a subset: in memory, then spilled ---------------
    sub = args.count_pairs
    reads = first_reads(paths[:2], sub)
    lengths = np.full(len(reads), READ_LEN, np.int32)

    def batches():
        for lo in range(0, len(reads), COUNT_BATCH):
            yield reads[lo : lo + COUNT_BATCH], lengths[lo : lo + COUNT_BATCH]

    t2 = time.time()
    mem_stats = {}
    k_mem, c_mem = count_kedges_megasort(batches(), K, device=args.device,
                                         stats=mem_stats)
    mem_s = time.time() - t2
    device_lanes = max(len(k_mem) // 5, 1)
    sp_stats = {}
    t3 = time.time()
    k_sp, c_sp = count_kedges_megasort(
        batches(), K, device_lanes=device_lanes,
        host_mb=args.count_budget_mb,
        spill_dir=os.path.join(args.out, "count_spill"), device=args.device,
        stats=sp_stats)
    spill_s = time.time() - t3
    if mem_stats["host_runs"] or mem_stats["disk_runs"]:
        raise AssertionError(f"the in-memory count spilled: {mem_stats}")
    if sp_stats["host_runs"] < 2 or sp_stats["disk_runs"] < 1:
        raise AssertionError("the budgeted count left "
                             f"{sp_stats['host_runs']} host runs and "
                             f"{sp_stats['disk_runs']} disk runs, expected "
                             "at least 2 and 1")
    if not (np.array_equal(k_mem, k_sp) and np.array_equal(c_mem, c_sp)):
        raise AssertionError("spilled count != in-memory count")
    print(f"count A/B on {len(reads):,} reads: in-memory {mem_s:.1f}s == "
          f"spilled {spill_s:.1f}s under a device budget of "
          f"{device_lanes:,} rows and {args.count_budget_mb} MB of host runs "
          f"({sp_stats['host_runs']} host runs, {sp_stats['disk_runs']} disk "
          f"runs; {len(k_mem):,} unique)", file=sys.stderr)

    report = {
        "round": "port",
        "n_pairs": n_pairs,
        "read_len": READ_LEN,
        "sort": {
            "budget_mb": args.sort_budget_mb,
            "runs": sort_stats["runs"],
            "wall_s": round(sort_s, 3),
            "pairs_per_s": round(n_pairs / sort_s, 1),
            "peak_rss_mb": round(peak_rss_mb, 1),
            "verified_barcodes_structural": n_checked,
            "verified_barcodes_content": len(sample),
        },
        "count_ab": {
            "reads": len(reads),
            "budget_mb": args.count_budget_mb,
            "device_lanes": device_lanes,
            "in_memory_s": round(mem_s, 3),
            "spilled_s": round(spill_s, 3),
            "unique_kedges": len(k_mem),
            "host_runs": sp_stats["host_runs"],
            "disk_runs": sp_stats["disk_runs"],
            "equal": True,
        },
        "sim_s": round(sim_s, 3),
    }
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
