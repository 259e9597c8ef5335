"""The port's read-pair extension (resolve/readpairs.py), contig graph
(graph/from_contigs.py) and k=31 coverage recount (kmer/coverage.py)
against the JAX package, on one level-2 graph file and library made once
by the port on the CPU.  Tolerance: exact equality (graph_k_<k>_extend.fasta
and the graph files byte for byte, edge_count element for element).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import pipeline as jpipe
from turingassembler_tpu.graph import from_contigs as jfc
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.io.fasta import read_fasta as jread_fasta
from turingassembler_tpu.kmer import coverage as jcov
from turingassembler_tpu.resolve import readpairs as jrp
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode import builder as tbuilder
from turingassembler_tpu_torch.barcode import sort_read as tsort
from turingassembler_tpu_torch.graph import from_contigs as tfc
from turingassembler_tpu_torch.graph.invariants import check_graph
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.io.fasta import read_fasta
from turingassembler_tpu_torch.kmer import coverage as tcov
from turingassembler_tpu_torch.logging_utils import stage_walls
from turingassembler_tpu_torch.resolve import readpairs as trp

torch.set_num_threads(1)

K = 45
ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
          "edge_rc", "edge_count", "seq_off", "seq_data")


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.fixture(scope="module", params=[8, 9])
def staged(request, tmp_path_factory):
    seed = request.param
    d = str(tmp_path_factory.mktemp("extend%d" % seed))
    genome, files = tt.linked_read_library(
        21_000, seed, d, n_segments=3, repeat_len=1_500, coverage=60.0,
        molecule_len=5_000, pairs_per_molecule=8)
    cfg = tcfg.Config(k0=K, out_dir=os.path.join(d, "port"),
                      files_1=(files["R1"],), files_2=(files["R2"],),
                      files_I=(files["I1"],))
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 min_kmer_count=2))
    g = tpipe.assembly_basic(cfg, device="cpu")
    rpath = tsort.sort_reads(cfg)
    rp = tbuilder.get_read_pair_counts(cfg, g, rpath, device="cpu")
    level2 = tpipe.graph_path(cfg.out_dir, K, "level_2")
    jc = jcfg.Config(k0=K, out_dir=os.path.join(d, "jax"),
                     files_1=cfg.files_1, files_2=cfg.files_2,
                     files_I=cfg.files_I)
    os.makedirs(jc.out_dir)
    return dict(dir=d, cfg=cfg, jcfg=jc, level2=level2, rp=rp,
                genome=genome)


def forced_case():
    """Six unlinked contigs under 5 kbp at even coverage and read-pair
    counts that chain the first three: the joins have no graph path, so
    each is written as 50 N."""
    seqs = [tt.random_genome(n, seed=70 + i)
            for i, n in enumerate((3_000, 2_500, 2_000, 1_200, 1_000, 900))]
    counts = [30 * (len(s) - K) for s in seqs]
    g = tfc.graph_from_contigs(seqs, K, counts=counts)
    jg = jfc.graph_from_contigs(seqs, K, counts=counts)
    rp = {}
    for a, b in ((0, 2), (2, 4)):
        # key (edge of r1, edge of r2): r2 lies on rc(b)
        rp[(a, int(g.edge_rc[b]))] = 500
        rp[(int(g.edge_rc[b]), a)] = 500
    rp[(4, 6)] = 3                      # too few to follow
    # two rivals, the better one not 1.3 times the other plus ten: no join
    rp[(6, int(g.edge_rc[8]))] = 500
    rp[(6, int(g.edge_rc[10]))] = 390
    return g, jg, rp


def extend_inputs(staged, counts):
    if counts == "forced":
        return forced_case()
    return (tasmg.load_graph(staged["level2"]),
            jasmg.load_graph(staged["level2"]), staged["rp"])


@pytest.mark.parametrize("counts", ["mapped", "forced"])
def test_extend_fasta_bytes(staged, counts):
    g, jg, rp = extend_inputs(staged, counts)
    cand = trp.build_rp_cand(g, rp)
    jcand = jrp.build_rp_cand(jg, rp)
    assert list(cand.items()) == list(jcand.items()) and len(cand) >= 4
    got = trp.get_long_contigs_by_readpairs(
        g, rp, os.path.join(staged["dir"], "port", counts + ".fasta"))
    want = jrp.get_long_contigs_by_readpairs(
        jg, rp, os.path.join(staged["jcfg"].out_dir, counts + ".fasta"))
    assert file_bytes(got) == file_bytes(want)
    seqs = [s for _, s in read_fasta(got)]
    assert seqs == [s for _, s in jread_fasta(want)]
    assert stage_walls().get("extend", 0) > 0
    n_joins = sum(s.count("N" * 50) for s in seqs)
    assert n_joins == (2 if counts == "forced" else 0)
    if counts == "forced":
        assert sorted(map(len, seqs)) == [900, 1_000, 1_200, 7_600]


def test_shortest_path_and_stitch(staged):
    g = tasmg.load_graph(staged["level2"])
    jg = jasmg.load_graph(staged["level2"])
    alive = np.flatnonzero(g.alive_mask())
    n_paths = 0
    for a in alive:
        for b in alive:
            got = trp.shortest_path_edges(g, int(a), int(b), max_bp=4_000)
            assert got == jrp.shortest_path_edges(jg, int(a), int(b),
                                                  max_bp=4_000)
            if got is not None:
                n_paths += 1
                assert trp._stitch_path_seq(g, [int(a), int(b)]) == \
                    jrp._stitch_path_seq(jg, [int(a), int(b)])
    far = [int(alive[0]), int(alive[-1])]
    assert trp._stitch_path_seq(g, far) == jrp._stitch_path_seq(jg, far)
    assert n_paths > 0


@pytest.mark.parametrize("counts", ["mapped", "forced"])
def test_graph_from_contigs_with_holes(staged, counts):
    path = os.path.join(staged["dir"], "port", counts + ".fasta")
    if not os.path.exists(path):
        g2, _, rp = extend_inputs(staged, counts)
        trp.get_long_contigs_by_readpairs(g2, rp, path)
    seqs = [s for _, s in read_fasta(path)]
    g = tfc.graph_from_contigs(seqs, K)
    jg = jfc.graph_from_contigs(seqs, K)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f), f)
        assert getattr(g, f).dtype == getattr(jg, f).dtype, f
    assert sorted(g.holes) == sorted(jg.holes)
    for e in g.holes:
        for a, b in zip(g.holes[e], jg.holes[e]):
            np.testing.assert_array_equal(a, b)
    assert bool(g.holes) == (counts == "forced")
    if g.holes:
        e = min(g.holes)
        assert g.get_seq_str(e).count("N") == 100
        assert len(g.holes[e][0]) == 2
        assert len(g.get_seq_str(e)) == int(g.edge_lens_with_holes()[e])
    check_graph(g, check_seq=False)
    got = os.path.join(staged["dir"], "port", counts + ".contigs.bin")
    want = os.path.join(staged["jcfg"].out_dir, counts + ".contigs.bin")
    tasmg.save_graph(g, got)
    jasmg.save_graph(jg, want)
    assert file_bytes(got) == file_bytes(want)
    carried = convert.graph(jg)
    for e in jg.holes:
        np.testing.assert_array_equal(carried.holes[e][0], jg.holes[e][0])
    # the other input forms, and explicit counts
    as_codes = [tfc.NT4[np.frombuffer(s.encode() if isinstance(s, str)
                                      else s, np.uint8)] for s in seqs]
    g3 = tfc.graph_from_contigs(as_codes, K, counts=list(range(1, len(seqs) + 1)))
    np.testing.assert_array_equal(g3.seq_data, g.seq_data)
    np.testing.assert_array_equal(g3.edge_count[::2],
                                  np.arange(1, len(seqs) + 1))


def test_split_holes():
    seq = np.array([4, 4, 0, 1, 4, 4, 4, 2, 3, 4], np.uint8)
    clean, holes = tfc._split_holes(seq)
    jclean, jholes = jfc._split_holes(seq)
    np.testing.assert_array_equal(clean, jclean)
    assert holes == jholes == [(1, 3), (3, 1)]
    clean, holes = tfc._split_holes(seq[2:4])
    assert holes == [] and len(clean) == 2


def contig_graphs(staged):
    path = os.path.join(staged["dir"], "port", "mapped.fasta")
    if not os.path.exists(path):
        trp.get_long_contigs_by_readpairs(
            tasmg.load_graph(staged["level2"]), staged["rp"], path)
    seqs = [s for _, s in read_fasta(path)]
    return tfc.graph_from_contigs(seqs, K), jfc.graph_from_contigs(seqs, K)


def test_edge_kmer_table(staged):
    g, jg = contig_graphs(staged)
    table, rows = tcov.build_edge_kmer_table(g)
    jtable, jrows = jcov.build_edge_kmer_table(jg)
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_array_equal(rows, jrows)
    assert table.dtype == np.uint32 and table.shape[1] == 2
    u64 = tcov._rows_to_u64(table)
    assert (np.diff(u64.astype(object)) > 0).all()     # ascending, unique
    empty = tfc.graph_from_contigs([], K)
    t0, r0 = tcov.build_edge_kmer_table(empty)
    assert t0.shape == (0, 2) and r0.shape == (0, 2)


def test_recount_from_batches_edge_count(staged):
    g, jg = contig_graphs(staged)
    before = g.edge_count.copy()
    g = tcov.recount_coverage_from_batches(
        g, tpipe._genomic_batches(staged["cfg"]), device="cpu")
    jg = jcov.recount_coverage_from_batches(
        jg, jpipe._genomic_batches(staged["jcfg"]))
    np.testing.assert_array_equal(g.edge_count, jg.edge_count)
    assert g.edge_count.dtype == jg.edge_count.dtype
    assert (g.edge_count != before).any()
    np.testing.assert_array_equal(g.edge_count, g.edge_count[g.edge_rc])
    cov = g.edge_cov()
    assert 30 < np.median(cov[g.edge_len() > 4_000]) < 90
    walls = stage_walls()
    assert all(walls.get("recount." + part, 0) > 0
               for part in ("table", "parse", "count", "join"))


def test_recount_from_read_matrix(staged):
    g, jg = contig_graphs(staged)
    reads, lengths = tt.sim_reads(staged["genome"], 6.0, 100, seed=4,
                                  error_rate=0.01, pad_to=104)
    table, rows = tcov.build_edge_kmer_table(g)
    for bs in (8192, 500):
        got = tcov.count_reads_into_table(table, reads, lengths,
                                          batch_size=bs, device="cpu")
        np.testing.assert_array_equal(
            got, jcov.count_reads_into_table(table, reads, lengths))
    assert got.dtype == np.int64 and got.max() >= 6
    assert tcov.count_reads_into_table(table, reads[:0], lengths[:0],
                                       device="cpu").sum() == 0
    g = tcov.recount_coverage(g, reads, lengths, device="cpu")
    jg = jcov.recount_coverage(jg, reads, lengths)
    np.testing.assert_array_equal(g.edge_count, jg.edge_count)
    # the clamp: a 31-mer seen more than 999 times counts as 999
    g2 = tcov._apply_counts(g, table, rows, np.full(len(table), 5_000))
    n_occ = np.bincount(rows[:, 1], minlength=g.n_e)
    np.testing.assert_array_equal(
        g2.edge_count, np.maximum(n_occ, n_occ[g.edge_rc]) * 999)


def test_recount_defaults_to_cuda(staged):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    g, _ = contig_graphs(staged)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcov.recount_coverage_from_batches(
            g, tpipe._genomic_batches(staged["cfg"]))
