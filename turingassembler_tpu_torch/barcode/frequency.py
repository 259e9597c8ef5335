"""Barcode frequency counting + dataset reduction utilities (port of
turingassembler_tpu/barcode/frequency.py; reduce_reads maps on `device`).

count_bx_freq — reads-per-barcode histogram, dumped as
barcode_frequencies.txt (reference count_bx_freq,
src/minimizers/count_barcodes.c:354-457).

reduce_reads — dataset shrinker: keep only read pairs mapping near
contig heads (reference fastq_reducer.c; STRICT_HEAD_LEN=1000) using the
minimizer mapper instead of BWA.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import numpy as np

from ..config import LIB_TYPE_UST, Config
from ..graph.structs import AsmGraph
from ..io.fastq import decode_barcode_seq, read_fastq_batches
from ..logging_utils import get_logger
from ..mapper.minimizers import EdgeMinimizerIndex, map_reads

STRICT_HEAD_LEN = 1000  # reference fastq_reducer.h:7


def count_bx_freq(cfg: Config, out_dir: Optional[str] = None) -> str:
    """Count reads per barcode over the input library."""
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    counts: Counter = Counter()
    if cfg.lib_type == LIB_TYPE_UST:
        for fI in cfg.files_I:
            for b in read_fastq_batches(fI, keep_text=True):
                for s in b.raw_seqs:
                    counts[decode_barcode_seq(s)] += 1
    else:
        for f1 in cfg.files_1:
            for b in read_fastq_batches(f1, keep_text=True):
                for cm in b.comments:
                    i = cm.find(b"BX:Z:")
                    if i >= 0:
                        counts[decode_barcode_seq(cm[i + 5 :].split()[0])] += 1
    out = os.path.join(out_dir, "barcode_frequencies.txt")
    with open(out, "w") as fp:
        for bc, c in sorted(counts.items()):
            fp.write(f"{bc}\t{c}\n")
    get_logger().info("count_bx: %d barcodes", len(counts))
    return out


def reduce_reads(cfg: Config, contigs: AsmGraph,
                 out_dir: Optional[str] = None, *, device="cuda"):
    """Keep only read pairs where either mate maps within
    STRICT_HEAD_LEN of a contig start (head regions of both strands)."""
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    index = EdgeMinimizerIndex.build(contigs, device=device)
    outs = []
    for fi, (f1, f2) in enumerate(zip(cfg.files_1, cfg.files_2)):
        o1 = os.path.join(out_dir, f"R1.reduced.{fi}.fq")
        o2 = os.path.join(out_dir, f"R2.reduced.{fi}.fq")
        outs.append((o1, o2))
        g1 = read_fastq_batches(f1, keep_text=True)
        g2 = read_fastq_batches(f2, keep_text=True)
        with open(o1, "wb") as w1, open(o2, "wb") as w2:
            for b1 in g1:
                b2 = next(g2)
                e1, _, p1 = map_reads(index, b1.bases, b1.lengths,
                                      device=device)
                e2, _, p2 = map_reads(index, b2.bases, b2.lengths,
                                      device=device)
                keep = ((e1 >= 0) & (p1 >= 0) & (p1 < STRICT_HEAD_LEN)) | \
                       ((e2 >= 0) & (p2 >= 0) & (p2 < STRICT_HEAD_LEN))
                for i in np.flatnonzero(keep):
                    for b, w in ((b1, w1), (b2, w2)):
                        cm = b" " + b.comments[i] if b.comments[i] else b""
                        w.write(b"@" + b.names[i] + cm + b"\n" + b.raw_seqs[i]
                                + b"\n+\n" + b.quals[i] + b"\n")
    return outs
