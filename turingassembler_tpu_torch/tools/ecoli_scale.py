"""E. coli-scale run of the port (twin of the JAX package's
tools/ecoli_scale.py).

Synthesizes upstream's own operating point: a 4.6 Mbp genome with two
planted repeat families (7x900 bp at 99% identity + 4x700 bp at 99.5%)
and 715,000 TELL-Seq-style barcoded read pairs of 120 bp (~37x).  Then
it runs the port's whole `assembly3` through its CLI and scores the
result against the truth genome with the port's QUAST stand-in.  The
claim being matched is upstream's published E. coli K12 TELL-Seq table
(NGA50 4,632,444, gapless, 5.65 mismatches and 0.47 indels per 100 kbp).

Usage:
    python -m turingassembler_tpu_torch.tools.ecoli_scale \\
        --out OUT --report ECOLI_report.json       # on the GPU
    ... --cpu                                      # on the host
    ... --harsh      # 0.5% errors + barcode collisions + chimeric molecules

The constants, the genome, the library's bytes, the flags and the
quality gates are the JAX tool's; `--keep-reads` (reuse the library
under --out) is kept only so that the argv is the JAX tool's.  `--cpu` runs `assembly3 --device
cpu`; without it `--device cuda`.  The report has the JAX tool's keys
("backend" is "cuda" or "cpu"), plus "device_name", "nw" (the NW
kernel's launches and pairs in the run), "peak_device_memory_gib"
(torch.cuda.max_memory_allocated) and "peak_rss_gib" (the resident set
sampled from /proc/self/statm through the run).

Exit status 0 iff every quality bound holds (misassemblies == 0,
genome fraction >= 0.99, NGA50 >= 0.9x genome, mismatches/100kbp and
indels/100kbp within the published table's; twice those two under the
--harsh model); assembly3's own code when it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import testing as tt

GENOME_SIZE = 4_600_000
N_MOLECULES = 35_750
READS_PER_MOL = 20           # 715k pairs
READ_LEN = 120               # 715k * 2 * 120 / 4.6 Mbp = 37x
MOLECULE_LEN = 20_000
INSERT = 300
# bounds from the published table (5.65 / 0.47): the synthetic library
# is substitution-only at --error, so the assembly's residual should be
# at or below upstream's real-data numbers
MISMATCH_BOUND_100KBP = 5.65
INDEL_BOUND_100KBP = 0.47
BARCODE_LEN = 16
FASTQ_CHUNK = 50_000


def build_genome(seed: int = 11) -> np.ndarray:
    genome = tt.random_genome(GENOME_SIZE, seed=seed)
    # repeat family 1: 7 copies, 900 bp, 99% identity
    rep1 = tt.random_genome(900, seed=seed + 100)
    pos1 = np.linspace(300_000, GENOME_SIZE - 300_000, 7).astype(int)
    for i, p in enumerate(pos1):
        genome[p : p + 900] = tt.mutate_identity(rep1, 0.99, seed=seed + 200 + i)
    # repeat family 2: 4 copies, 700 bp, 99.5% identity
    rep2 = tt.random_genome(700, seed=seed + 300)
    pos2 = np.linspace(150_000, GENOME_SIZE - 150_000, 4).astype(int) + 37_000
    for i, p in enumerate(pos2):
        genome[p : p + 700] = tt.mutate_identity(rep2, 0.995, seed=seed + 400 + i)
    return genome


def write_library(out_dir: str, genome: np.ndarray, error_rate: float,
                  collision_rate: float, chimera_rate: float, seed: int):
    """Write R1/R2/I1 FASTQ of the simulated library (records `@r<i>`,
    quality all 'I', the index read the barcode + 1 in base 5 over
    ACGTN); returns (paths, n_pairs)."""
    r1, r2, _, _, bcs = tt.sim_barcoded_pairs_fast(
        genome, molecule_len=MOLECULE_LEN, n_molecules=N_MOLECULES,
        reads_per_molecule=READS_PER_MOL, read_len=READ_LEN, insert=INSERT,
        seed=seed, error_rate=error_rate, collision_rate=collision_rate,
        chimera_rate=chimera_rate)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = [os.path.join(out_dir, n) for n in ("R1.fq", "R2.fq", "I1.fq")]
    os.makedirs(out_dir, exist_ok=True)
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2, \
            open(paths[2], "wb") as fI:
        for lo in range(0, len(r1), FASTQ_CHUNK):
            hi = min(lo + FASTQ_CHUNK, len(r1))
            f1.write(tt.fastq_block(lo, acgt[r1[lo:hi]]))
            f2.write(tt.fastq_block(lo, acgt[r2[lo:hi]]))
            fI.write(tt.fastq_block(lo, tt.encode_barcodes(
                bcs[lo:hi] + 1, BARCODE_LEN)))
    return paths, len(r1)


def gates_hold(res, harsh_model: bool) -> bool:
    """The quality gates on an evaluate_assembly result.  The bounds hold
    at the default 0.2% substitution model; the --harsh model carries
    2.5x the raw read errors (plus collisions and chimeras), so its
    residual bounds are twice as wide."""
    widen = 2.0 if harsh_model else 1.0
    return (res.n_misassemblies == 0
            and res.genome_fraction >= 0.99
            and res.nga50 >= 0.9 * GENOME_SIZE
            and res.mismatches_per_100kbp <= MISMATCH_BOUND_100KBP * widen
            and res.indels_per_100kbp <= INDEL_BOUND_100KBP * widen)


class RssPeak:
    """The largest resident set of this process, sampled from
    /proc/self/statm every `every` seconds while the block runs."""

    def __init__(self, every: float = 0.1):
        self.every, self.peak = every, 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        with open("/proc/self/statm") as fp:
            self.peak = max(self.peak, int(fp.read().split()[1]) * self._page)

    def _run(self):
        while not self._stop.wait(self.every):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    @property
    def gib(self) -> float:
        return self.peak / 2**30


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "ecoli_scale"))
    ap.add_argument("--report", default="ECOLI_report.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run assembly3 with --device cpu")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--error", type=float, default=0.002)
    ap.add_argument("--harsh", action="store_true",
                    help="0.5%% errors + 10%% barcode collisions + "
                         "3%% chimeric molecules")
    ap.add_argument("--keep-reads", action="store_true",
                    help="reuse FASTQs already in --out if present")
    args = ap.parse_args(argv)

    from .. import logging_utils
    from ..cli import main as cli_main
    from ..evaluate import evaluate_assembly
    from ..io.fasta import read_fasta
    from ..ops import nw_align

    device = "cpu" if args.cpu else "cuda"
    error_rate = 0.005 if args.harsh else args.error
    collision = 0.10 if args.harsh else 0.0
    chimera = 0.03 if args.harsh else 0.0

    t0 = time.time()
    genome = build_genome(args.seed)
    f1 = os.path.join(args.out, "R1.fq")
    params_path = os.path.join(args.out, "library_params.json")
    if args.keep_reads and os.path.exists(f1):
        paths = [os.path.join(args.out, n) for n in ("R1.fq", "R2.fq", "I1.fq")]
        with open(paths[0], "rb") as fp:
            n_pairs = sum(1 for _ in fp) // 4
        # the reused library was simulated with its own parameters:
        # report those, not this invocation's flags
        if os.path.exists(params_path):
            with open(params_path) as fp:
                saved = json.load(fp)
            error_rate = saved["error_rate"]
            collision = saved["collision_rate"]
            chimera = saved["chimera_rate"]
        else:
            print("WARNING: reused reads have no library_params.json; "
                  "dataset labels may not match", file=sys.stderr)
        print(f"reusing {n_pairs:,} pairs in {args.out} "
              f"(error={error_rate}, collisions={collision}, "
              f"chimera={chimera})", file=sys.stderr)
    else:
        paths, n_pairs = write_library(args.out, genome, error_rate,
                                       collision, chimera, args.seed + 1)
        with open(params_path, "w") as f:
            json.dump({"error_rate": error_rate,
                       "collision_rate": collision,
                       "chimera_rate": chimera, "seed": args.seed}, f)
        print(f"simulated {n_pairs:,} pairs "
              f"(error={error_rate}, collisions={collision}, "
              f"chimera={chimera}) in {time.time()-t0:.0f}s", file=sys.stderr)
    sim_s = time.time() - t0

    out_dir = os.path.join(args.out, "asm")
    on_card = device == "cuda" and torch.cuda.is_available()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    nw_align.COUNT.reset()
    t1 = time.time()
    # close a stage an earlier run in this process left open, so the
    # walls hold this run's stages only
    logging_utils.set_log_stage("init")
    logging_utils.reset_stage_walls()
    with RssPeak() as rss:
        rc = cli_main(["assembly3", "-1", paths[0], "-2", paths[1],
                       "-I", paths[2], "-l", "ust", "-k0", "45", "-mc", "2",
                       "-o", out_dir, "--device", device])
    wall = time.time() - t1
    if rc != 0:
        print(f"assembly3 failed rc={rc}", file=sys.stderr)
        return rc
    walls = logging_utils.stage_walls()
    nw = {"launches": nw_align.COUNT.launches,
          "pairs": nw_align.COUNT.total("pairs")}

    final = os.path.join(out_dir, "scaffold.full.fasta")
    contigs = [s for _, s in read_fasta(final)]
    t2 = time.time()
    res = evaluate_assembly(contigs, tt.codes_to_str(genome))
    eval_s = time.time() - t2

    report = {
        "round": "port",
        "dataset": {
            "genome_bp": GENOME_SIZE, "n_pairs": n_pairs,
            "read_len": READ_LEN, "coverage_x": round(
                2 * n_pairs * READ_LEN / GENOME_SIZE, 1),
            "error_rate": error_rate, "collision_rate": collision,
            "chimera_rate": chimera, "seed": args.seed,
            "repeats": "7x900bp@99% + 4x700bp@99.5%",
        },
        "backend": device,
        "device_name": (torch.cuda.get_device_name(0) if device == "cuda"
                        else "cpu"),
        "result": {
            "nga50": res.nga50,
            "n_misassemblies": res.n_misassemblies,
            "n_translocations": res.n_translocations,
            "n_inversions": res.n_inversions,
            "genome_fraction": round(res.genome_fraction, 5),
            "largest_alignment": res.largest_alignment,
            "mismatches_per_100kbp": round(res.mismatches_per_100kbp, 3),
            "indels_per_100kbp": round(res.indels_per_100kbp, 3),
            "n_contigs": len(contigs),
            "gapless": bool(contigs)
                       and max(len(c) for c in contigs) >= 0.95 * GENOME_SIZE
                       and "N" not in max(contigs, key=len),
        },
        "reference_published": {
            "nga50": 4_632_444, "mismatches_per_100kbp": 5.65,
            "indels_per_100kbp": 0.47, "source": "README.md:13-15",
        },
        "walls_s": {k: round(v, 3) for k, v in sorted(walls.items())},
        "wall_total_s": round(wall, 3),
        "sim_s": round(sim_s, 3),
        "eval_s": round(eval_s, 3),
        "nw": nw,
        "peak_device_memory_gib": (
            round(torch.cuda.max_memory_allocated() / 2**30, 3)
            if on_card else None),
        "peak_rss_gib": round(rss.gib, 3),
    }
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))

    harsh_model = error_rate > 0.003 or collision > 0 or chimera > 0
    ok = gates_hold(res, harsh_model)
    print(f"quality bounds {'PASS' if ok else 'FAIL'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
