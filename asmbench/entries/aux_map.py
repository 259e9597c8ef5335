"""aux_map: one library's read pairs mapped onto a level-0 graph, as
barcode/builder.py:construct_aux_info maps them: host batches of
`batch_pairs` pairs, and for each batch map_reads(index, b1, l1,
graph=g, with_hits=False) and the same for b2.  The set-up counts and
builds the graph from one library (`graph_library`) and indexes it
(EdgeMinimizerIndex.build); the graph stands in for the scaffold graph
the aux map runs on.  The archive parse and the barcode attach are left
out.

Judged: the set-up's table and graph, and each read's edge (or none) and
start in a sample of the window's jobs, drawn from the seed, against the
reference's count, graph, index and verified map of the same libraries.
"""

from __future__ import annotations

import numpy as np

from asmbench.entries import level0
from asmbench.reference import compare, mapper, unitigs
from asmbench.reference import level0 as ref0
from asmbench.roofline import bytes as rb
from asmbench.roofline import peaks

LIMITS = {"kmers_wrong": 0, "unitigs_wrong": 0, "links_wrong": 0,
          "reads_wrong": 0}


def setup(config, mix, libs, device, spans):
    from turingassembler_tpu_torch.mapper import minimizers
    st = level0.program(config, device)
    st.minimizers = minimizers
    gl = mix["graph_library"]
    st.table_u, st.table_c, st.table_n, st.graph = level0.count_and_build(
        st, level0.genomic_batches(libs[gl], mix["batch_reads"]),
        spans)
    st.index = minimizers.EdgeMinimizerIndex.build(st.graph, device=device)
    B = mix["batch_pairs"]
    st.batches = [[(lib.r1[i:i + B], lib.l1[i:i + B], lib.r2[i:i + B],
                    lib.l2[i:i + B]) for i in range(0, lib.pairs, B)]
                  for lib in libs]
    st.reads = [lib.reads for lib in libs]
    st.width = libs[0].r1.shape[1]
    for i in range(len(libs)):          # one warm-up job a library
        job(st, i, spans)
    return st


def job(st, lib: int, spans):
    out = []
    for b1, l1, b2, l2 in st.batches[lib]:
        with spans.span("map"):
            e1, _, p1 = st.minimizers.map_reads(
                st.index, b1, l1, graph=st.graph, with_hits=False,
                device=st.device)
        with spans.span("map"):
            e2, _, p2 = st.minimizers.map_reads(
                st.index, b2, l2, graph=st.graph, with_hits=False,
                device=st.device)
        out.append((e1, p1, e2, p2))
    least = peaks.least_time(*rb.map_reads(
        st.reads[lib], st.width, len(st.graph.seq_data)))[0]
    return out, {"map": least}


def reads(st, lib: int) -> int:
    return st.reads[lib]


def _ends(out):
    """A job's (R1 edges, R1 starts, R2 edges, R2 starts), whole."""
    return tuple(np.concatenate([o[i] for o in out]) for i in range(4))


def release(st, kept: dict) -> dict:
    n = st.table_n
    return {"setup": (st.table_u[:n].cpu().numpy(),
                      st.table_c[:n].cpu().numpy(), "program",
                      compare.ProgramGraph(st.graph)),
            "jobs": {lib: [(j, *_ends(out)) for j, out in items]
                     for lib, items in kept.items()}}


def control(config, mix, libs, device) -> dict:
    """The reference in the program's place with one guarantee broken:
    no DP, a voted read is accepted on its gapless bound or not at all."""
    rows, counts, g = ref0.table_and_graph(
        libs[mix["graph_library"]], config["k0"], config["min_kmer_count"],
        device)
    ix = mapper.build_index(g, device)
    jobs = {}
    for i, lib in enumerate(libs):
        e1, s1 = mapper.map_reads(ix, lib.r1, lib.l1, device, with_dp=False)
        e2, s2 = mapper.map_reads(ix, lib.r2, lib.l2, device, with_dp=False)
        jobs[i] = [(0, e1, s1, e2, s2)]
    return {"setup": (rows, counts, "reference",
                      compare.ProgramGraph.from_reference(g)),
            "jobs": jobs}


def check(config, mix, libs, judged, device):
    """({number: worst reading}, jobs judged wrong)."""
    k = config["k0"]
    rows, counts, g = ref0.table_and_graph(
        libs[mix["graph_library"]], k, config["min_kmer_count"], device)
    pr, pc, layout, pg = judged["setup"]
    if layout == "program":
        pr, pc = compare.program_table(pr, pc, k + 1, device)
    rk = unitigs.keys(g)
    worst = dict.fromkeys(LIMITS, 0)
    worst["kmers_wrong"] = compare.kmers_wrong(pr, pc, rows, counts)
    worst["unitigs_wrong"], worst["links_wrong"], pk = \
        compare.graph_wrong(pg, g, rk)
    failed = 0
    if any(worst[n] > LIMITS[n] for n in worst):
        failed = 1
    to_prog = compare.unitig_translation(rk, pk)
    ix = mapper.build_index(g, device)
    for lib, items in judged["jobs"].items():
        e1, s1 = mapper.map_reads(ix, libs[lib].r1, libs[lib].l1, device)
        e2, s2 = mapper.map_reads(ix, libs[lib].r2, libs[lib].l2, device)
        for _, pe1, ps1, pe2, ps2 in items:
            wrong = compare.reads_wrong(pe1, ps1, e1, s1, to_prog) + \
                compare.reads_wrong(pe2, ps2, e2, s2, to_prog)
            failed += wrong > LIMITS["reads_wrong"]
            worst["reads_wrong"] = max(worst["reads_wrong"], wrong)
    return worst, failed
