"""level0: one library through the count of canonical (k0+1)-mers and
the level-0 unitig build, as pipeline.build_0 calls them once the FASTQ
reader has made its batches: count_kedges_megasort_device over host
(bases, lengths) batches, then build_graph_on_device, which returns the
host graph.  The parse and the check-and-save are left out.

Judged: the table after the cutoff (every (k0+1)-mer and its count) and
the graph (unitigs, counts, links, partners) of a sample of the window's
jobs, drawn from the seed, against the reference's of the same library.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from asmbench.reference import compare
from asmbench.reference import level0 as ref0
from asmbench.reference import unitigs
from asmbench.roofline import bytes as rb
from asmbench.roofline import peaks

LIMITS = {"kmers_wrong": 0, "unitigs_wrong": 0, "links_wrong": 0}


def batch_width(lengths: np.ndarray, lo: int = 64) -> int:
    """The reader's batch width: the longest read rounded up to 8."""
    return max(lo, -(-int(lengths.max()) // 8) * 8) if len(lengths) else lo


def genomic_batches(lib, size: int) -> list:
    """Host (bases, lengths) batches as the FASTQ reader's path yields
    them: `size` reads a batch, R1 then R2, each file's last batch filled
    up with empty reads, every batch cut to its batch width."""
    out = []
    for r, n in ref0.reads(lib):
        for i in range(0, len(n), size):
            b, ln = r[i:i + size], n[i:i + size]
            if len(ln) < size:
                pad = size - len(ln)
                b = np.concatenate(
                    [b, np.full((pad, b.shape[1]), 255, np.uint8)])
                ln = np.concatenate([ln, np.zeros(pad, np.int32)])
            out.append((np.ascontiguousarray(b[:, :batch_width(ln)]), ln))
    return out


def program(config, device):
    """The program's entries this mix drives, and its sizes.  The host
    allocator is tuned as the program's command line tunes it first
    thing (ops/hostmem.py: large blocks kept, not returned)."""
    from turingassembler_tpu_torch.graph import device_build
    from turingassembler_tpu_torch.kmer import megasort
    from turingassembler_tpu_torch.ops.hostmem import tune_host_malloc
    tune_host_malloc()
    return SimpleNamespace(k=config["k0"], mc=config["min_kmer_count"],
                           device=device, megasort=megasort,
                           device_build=device_build)


def count_and_build(st, batches, spans):
    """The count, then the level-0 build: (uniq, counts, n, graph)."""
    with spans.span("count"):
        res = st.megasort.count_kedges_megasort_device(
            iter(batches), st.k, min_count=st.mc, device=st.device)
    if len(res) != 3:
        raise RuntimeError("the count left the device; this mix sets no "
                           "budget, so it never should")
    uniq, counts, n = res
    with spans.span("build"):
        g = st.device_build.build_graph_on_device(uniq, counts, n, st.k,
                                                  device=st.device)
    return uniq, counts, n, g


def setup(config, mix, libs, device, spans):
    st = program(config, device)
    st.batches = [genomic_batches(lib, mix["batch_reads"]) for lib in libs]
    st.reads = [lib.reads for lib in libs]
    st.width = libs[0].r1.shape[1]
    for i in range(len(libs)):          # one warm-up job a library
        job(st, i, spans)
    return st


def job(st, lib: int, spans):
    uniq, counts, n, g = count_and_build(st, st.batches[lib], spans)
    k1 = st.k + 1
    least = {
        "count": peaks.least_time(*rb.count(st.reads[lib], st.width, n,
                                            k1))[0],
        "build": peaks.least_time(*rb.build(n, k1, len(g.seq_data),
                                            g.n_e))[0]}
    return (uniq, counts, n, g), least


def reads(st, lib: int) -> int:
    return st.reads[lib]


def release(st, kept: dict) -> dict:
    """Host copies of the kept jobs' outputs: {lib: [(job, rows, counts,
    layout, graph)]}, rows in the program's layout."""
    return {lib: [(j, u[:n].cpu().numpy(), c[:n].cpu().numpy(), "program",
                   compare.ProgramGraph(g)) for j, (u, c, n, g) in items]
            for lib, items in kept.items()}


def control(config, mix, libs, device) -> dict:
    """The reference in the program's place with one guarantee broken:
    (k0+1)-mers told apart by a 32-bit fingerprint, not by their bases,
    before the cutoff (a count table that keeps no keys)."""
    rows, counts, g = ref0.table_and_graph(
        libs[0], config["k0"], config["min_kmer_count"], device,
        fingerprinted=True)
    return {0: [(0, rows, counts, "reference",
                 compare.ProgramGraph.from_reference(g))]}


def check(config, mix, libs, judged, device):
    """({number: worst reading over the judged jobs}, jobs judged wrong)."""
    k = config["k0"]
    worst = dict.fromkeys(LIMITS, 0)
    failed = 0
    for lib, items in judged.items():
        rows, counts, g = ref0.table_and_graph(
            libs[lib], k, config["min_kmer_count"], device)
        rk = unitigs.keys(g)
        for _, pr, pc, layout, pg in items:
            if layout == "program":
                pr, pc = compare.program_table(pr, pc, k + 1, device)
            got = {"kmers_wrong": compare.kmers_wrong(pr, pc, rows, counts)}
            got["unitigs_wrong"], got["links_wrong"], _ = \
                compare.graph_wrong(pg, g, rk)
            failed += any(got[n] > LIMITS[n] for n in LIMITS)
            for n in LIMITS:
                worst[n] = max(worst[n], got[n])
    return worst, failed
