"""The port's scaffolding (scaffold/scaffolding.py), molecule analysis
(scaffold/molecules.py) and barcode frequency tools
(barcode/frequency.py) against the JAX package.

Scaffolding runs in both packages on one graph_k_<k>_added_barcode.bin
written by the port's pipeline on the CPU, and on a synthetic contig
graph with planted barcode sets whose paths have several contigs and a
hole.  Tolerance: exact equality
(scaffolds.fasta, local_assembly_scaffold_path.txt, molecules.fasta,
barcode_frequencies.txt and the reduced FASTQ files byte for byte).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu.barcode import frequency as jfreq
from turingassembler_tpu.barcode import sort_read as jsort
from turingassembler_tpu.graph import from_contigs as jfc
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.scaffold import molecules as jmol
from turingassembler_tpu.scaffold import scaffolding as jscaf
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode import frequency as tfreq
from turingassembler_tpu_torch.graph import from_contigs as tfc
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.io.fasta import read_fasta
from turingassembler_tpu_torch.scaffold import molecules as tmol
from turingassembler_tpu_torch.scaffold import scaffolding as tscaf

torch.set_num_threads(1)

K = 45
OUTPUTS = ("scaffolds.fasta", "local_assembly_scaffold_path.txt")


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.fixture(scope="module", params=[("ust", 12), ("bioturing", 13)],
                ids=["ust", "bioturing"])
def staged(request, tmp_path_factory):
    lib, seed = request.param
    d = str(tmp_path_factory.mktemp("scaffold_" + lib))
    genome, files = tt.linked_read_library(
        21_000, seed, d, n_segments=3, repeat_len=1_500, coverage=60.0,
        molecule_len=5_000, pairs_per_molecule=8, lib=lib)
    cfg = tcfg.Config(k0=K, out_dir=os.path.join(d, "port"),
                      files_1=(files["R1"],), files_2=(files["R2"],),
                      files_I=((files["I1"],) if lib == "ust" else ()),
                      lib_type=tcfg.LIB_TYPE_NAMES[lib])
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 min_kmer_count=2))
    g, rpath, scaf_path = tpipe.assembly_to_scaffolds(cfg, device="cpu")
    jc = jcfg.Config(k0=K, out_dir=os.path.join(d, "jax"),
                     files_1=cfg.files_1, files_2=cfg.files_2,
                     files_I=cfg.files_I, lib_type=cfg.lib_type)
    os.makedirs(jc.out_dir)
    return dict(dir=d, cfg=cfg, jcfg=jc, g=g, rpath=rpath, lib=lib,
                scaf_path=scaf_path, genome=genome,
                added=tpipe.graph_path(cfg.out_dir, K, "added_barcode"),
                level2=tpipe.graph_path(cfg.out_dir, K, "level_2"))


def candidate_inputs(g):
    lens = g.edge_len().copy()
    cov = g.edge_cov()
    usable = g.alive_mask()
    return usable, lens, cov, usable & (lens >= tscaf.THRES_LENGTH)


def planted_graph(mod_fc, seed=0, n=9):
    """n contigs that lie in id order on a genome, each in a random
    orientation, with barcode sets that the neighbours share: the tail of
    one and the head of the next have 150 barcodes in common, and a
    contig shares 40 more with the next but one.  Contig 3 has a hole of
    1,500 N, contig 5 is short, contig 6 has twice the coverage."""
    rng = np.random.default_rng(seed)
    lens = [9_000, 12_000, 6_000, 8_000, 15_000, 900, 7_000, 5_000, 11_000]
    seqs = []
    for i, n_b in enumerate(lens[:n]):
        s = tt.random_genome(n_b, seed=100 * seed + i)
        if i == 3:
            s = np.concatenate([s[:3_000], np.full(1_500, 4, np.uint8),
                                s[3_000:]])
        seqs.append(s)
    counts = [30 * (len(s) - K) for s in seqs]
    counts[6] *= 2                        # usable twice
    g = mod_fc.graph_from_contigs(seqs, K, counts=counts)
    flip = rng.random(n) < 0.5
    oriented = [2 * i + int(flip[i]) for i in range(n)]   # genome order
    g.barcodes = [[{}, {}, {}] for _ in range(g.n_e)]
    g.barcodes_cov = [{} for _ in range(g.n_e)]
    g.barcodes_scaf = [{} for _ in range(g.n_e)]
    g.aux_flag |= 1
    nxt = 1_000
    for e in range(g.n_e):                # 50 barcodes of its own a head
        for _ in range(50):
            g.barcodes_scaf[e][nxt] = 1
            nxt += 1
    long_ids = [e for e in oriented if lens[e // 2] >= 4_000]
    for a, b in zip(long_ids, long_ids[1:]):
        tail_a, head_b = int(g.edge_rc[a]), b
        for _ in range(150):
            g.barcodes_scaf[tail_a][nxt] = 2
            g.barcodes_scaf[head_b][nxt] = 1
            nxt += 1
    # a weaker, farther link two contigs on (the look-back term)
    for a, b in zip(long_ids, long_ids[2:]):
        for _ in range(40):
            g.barcodes_scaf[int(g.edge_rc[a])][nxt] = 1
            g.barcodes_scaf[b][nxt] = 1
            nxt += 1
    return g, oriented


@pytest.mark.parametrize("which", ["pipeline", "planted0", "planted1"])
def test_candidate_edges_fast_ref_jax(staged, which):
    if which == "pipeline":
        g, jg = tasmg.load_graph(staged["added"]), \
            jasmg.load_graph(staged["added"])
    else:
        g, _ = planted_graph(tfc, int(which[-1]))
        jg, _ = planted_graph(jfc, int(which[-1]))
    args = candidate_inputs(g)
    fast = tscaf._candidate_edges_fast(g, *args)
    ref = tscaf._candidate_edges_ref(g, *args)
    jfast = jscaf._candidate_edges_fast(jg, *args)
    assert fast == ref == jfast
    assert list(fast) == list(jfast)
    assert sum(len(v) for v in fast.values()) >= 2
    np.testing.assert_array_equal(tscaf._scaf_keys(g, 0),
                                  jscaf._scaf_keys(jg, 0))


def test_candidate_ties_break_by_contig_id():
    """Two destinations with the same score come out in ascending contig
    id, from the reference-shaped tally and from the vectorised join."""
    graphs = []
    for mod in (tfc, jfc):
        g = mod.graph_from_contigs(
            [tt.random_genome(5_000, seed=20 + i) for i in range(3)], K,
            counts=[30 * 4_955] * 3)
        g.barcodes_scaf = [{} for _ in range(g.n_e)]
        for e in range(g.n_e):
            for b in range(100):
                g.barcodes_scaf[e][10_000 * (e + 1) + b] = 1
        for b in range(100):              # tail of 0 with heads of 4 and 2
            for e in (int(g.edge_rc[0]), 4, 2):
                g.barcodes_scaf[e][b] = 1
        graphs.append(g)
    g, jg = graphs
    args = candidate_inputs(g)
    fast = tscaf._candidate_edges_fast(g, *args)
    assert fast == tscaf._candidate_edges_ref(g, *args) == \
        jscaf._candidate_edges_fast(jg, *args) == \
        jscaf._candidate_edges_ref(jg, *args)
    assert fast[0] == [(2, 0.5), (4, 0.5)]


def test_pipeline_scaffolds_bytes(staged):
    jg = jasmg.load_graph(staged["added"])
    want = jscaf.scaffolding(staged["jcfg"], jg, staged["jcfg"].out_dir)
    for name in OUTPUTS:
        assert file_bytes(os.path.join(staged["jcfg"].out_dir, name)) == \
            file_bytes(os.path.join(staged["cfg"].out_dir, name)), name
    assert os.path.basename(want) == os.path.basename(staged["scaf_path"])
    lines = file_bytes(staged["scaf_path"]).decode().split("\n")
    assert int(lines[0]) >= 1 and int(lines[1]) >= 2
    recs = list(read_fasta(os.path.join(staged["cfg"].out_dir, OUTPUTS[0])))
    assert max(len(s) for _, s in recs) > 10_000
    assert any("N" * 100 in s for _, s in recs)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("metagenomics", [False, True])
def test_planted_scaffolds_bytes(seed, metagenomics, tmp_path):
    g, oriented = planted_graph(tfc, seed)
    jg, _ = planted_graph(jfc, seed)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    cfg = tcfg.Config(k0=K, out_dir=out, metagenomics=metagenomics)
    jc = jcfg.Config(k0=K, out_dir=jout, metagenomics=metagenomics)
    tscaf.scaffolding(cfg, g)
    jscaf.scaffolding(jc, jg, jout)
    for name in OUTPUTS:
        assert file_bytes(os.path.join(out, name)) == \
            file_bytes(os.path.join(jout, name)), name
    lines = file_bytes(os.path.join(out, OUTPUTS[1])).decode().split("\n")
    paths = [list(map(int, lines[i].split()))
             for i in range(2, len(lines), 2) if lines[i].strip()]
    assert paths and max(map(len, paths)) >= 4
    # the longest path follows the planted order, forwards or backwards
    best = max(paths, key=len)
    rc = [int(g.edge_rc[e]) for e in reversed(best)]
    long_order = [e for e in oriented if g.edge_len()[e] >= 4_000]

    def in_order(p):
        idx = [long_order.index(e) for e in p if e in long_order]
        return len(idx) == len(p) and idx == sorted(idx)
    assert in_order(best) or in_order(rc)
    recs = list(read_fasta(os.path.join(out, OUTPUTS[0])))
    assert any("N" * 1_000 in s and "N" * 1_001 not in s for _, s in recs)
    assert not os.path.exists(os.path.join(out, "scaffold.full.fasta"))


def test_no_multi_path_copies_scaffolds(tmp_path):
    g = tfc.graph_from_contigs([tt.random_genome(5_000, seed=1),
                                tt.random_genome(300, seed=2)], K)
    jg = jfc.graph_from_contigs([tt.random_genome(5_000, seed=1),
                                 tt.random_genome(300, seed=2)], K)
    for x in (g, jg):
        x.barcodes_scaf = [{} for _ in range(x.n_e)]
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    tscaf.scaffolding(tcfg.Config(k0=K, out_dir=out), g)
    jscaf.scaffolding(jcfg.Config(k0=K, out_dir=jout), jg, jout)
    for name in OUTPUTS + ("scaffold.full.fasta",):
        assert file_bytes(os.path.join(out, name)) == \
            file_bytes(os.path.join(jout, name)), name
    assert file_bytes(os.path.join(out, OUTPUTS[1])) == b"0\n"
    with pytest.raises(AssertionError):
        tscaf.scaffolding(tcfg.Config(k0=K, out_dir=out),
                          tfc.graph_from_contigs([], K))


# ---------------------------------------------------------------------------
# molecules.py
# ---------------------------------------------------------------------------

def plain(table):
    return {int(k): dict(v) for k, v in table.items()}


def test_molecules_equal_jax(staged):
    g = tasmg.load_graph(staged["level2"])
    jg = jasmg.load_graph(staged["level2"])
    rp = staged["rpath"]
    jr = jsort.ReadPath(rp.R1_path, rp.R2_path, rp.idx_path)
    bx, rpt = tmol.hit_all_barcodes(staged["cfg"], g, rp, device="cpu")
    jbx, jrpt = jmol.hit_all_barcodes(staged["jcfg"], jg, jr)
    assert plain(bx) == plain(jbx) and list(bx) == list(jbx)
    assert list(rpt.items()) == list(jrpt.items())
    assert len(bx) > 100 and len(rpt) >= 4
    shared = tmol.count_edge_link_shared_bc(bx)
    assert list(shared.items()) == \
        list(jmol.count_edge_link_shared_bc(jbx).items())
    assert len(shared) >= 4
    pairs = tmol.candidate_pairs(g, shared, rpt)
    assert pairs == jmol.candidate_pairs(jg, jmol.count_edge_link_shared_bc(
        jbx), jrpt)
    assert tmol.extract_molecules(g, pairs, shared) == \
        jmol.extract_molecules(jg, pairs, shared)
    some = sorted(bx)[::9]
    for bc in some:
        assert tmol.order_molecule_edges(g, sorted(bx[bc])) == \
            jmol.order_molecule_edges(jg, sorted(jbx[bc]))
    got = tmol.molecule_contigs(staged["cfg"], g, rp, device="cpu")
    want = jmol.molecule_contigs(staged["jcfg"], jg, jr)
    assert os.path.basename(got) == "molecules.fasta"
    assert len(file_bytes(got)) > 10_000
    assert file_bytes(got) == file_bytes(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_barcode_graph_filters_on_planted_links(seed):
    """The filter pipeline and the molecule paths on a hand-made table:
    a chain of contigs joined through short connectors, links with
    plenty of shared barcodes and read pairs."""
    rng = np.random.default_rng(seed)
    n = 6
    parts = [tt.random_genome(int(rng.integers(1_500, 4_000)), seed=50 + i)
             for i in range(n)]
    # one linear genome: its level of detail is a unitig graph of n
    # edges chained head to tail
    graphs = []
    for mod in (tfc, jfc):
        g = mod.graph_from_contigs(parts, K,
                                   counts=[20 * len(p) for p in parts])
        # chain contig i -> i+1 by sharing a node
        for i in range(n - 1):
            a, b = 2 * i, 2 * (i + 1)
            node = int(g.edge_target[a])
            g.edge_source[b] = node
            g.edge_target[int(g.edge_rc[b])] = int(g.node_rc[node])
        g.rebuild_adjacency()
        graphs.append(g)
    g, jg = graphs
    all_count, rp_table = {}, {}
    for i in range(n - 1):
        a, b = 2 * i, 2 * (i + 1)
        all_count[(a, b)] = 150 + i
        # either mate may be read 1
        rp_table[(a, int(g.edge_rc[b]))] = 5
        rp_table[(int(g.edge_rc[b]), a)] = 4
    all_count[(0, 2 * (n - 1))] = 120      # a link with no read pairs
    pairs = tmol.candidate_pairs(g, all_count, rp_table)
    assert pairs == jmol.candidate_pairs(jg, all_count, rp_table)
    assert len(pairs) == 2 * (n - 1) and (0, 2) in pairs
    mols = tmol.extract_molecules(g, pairs, all_count)
    assert mols == jmol.extract_molecules(jg, pairs, all_count)
    assert sorted(map(len, mols)) == [n]
    for hits in ([0, 2, 4], [0, 4, 8], list(range(0, 2 * n, 2))):
        assert tmol.order_molecule_edges(g, hits) == \
            jmol.order_molecule_edges(jg, hits)
    assert tmol._edges_in_radius(g, 0) == jmol._edges_in_radius(jg, 0)


# ---------------------------------------------------------------------------
# frequency.py
# ---------------------------------------------------------------------------

def test_count_bx_freq_bytes(staged):
    got = tfreq.count_bx_freq(staged["cfg"])
    want = jfreq.count_bx_freq(staged["jcfg"])
    assert os.path.basename(got) == "barcode_frequencies.txt"
    assert file_bytes(got) == file_bytes(want)
    rows = [r.split(b"\t") for r in file_bytes(got).split(b"\n") if r]
    assert len(rows) > 100
    n_pairs = file_bytes(staged["cfg"].files_1[0]).count(b"\n") // 4
    assert sum(int(c) for _, c in rows) == n_pairs


def test_reduce_reads_bytes(staged):
    seqs = [s for _, s in read_fasta(tpipe.graph_path(
        staged["cfg"].out_dir, K, "extend", "fasta"))]
    got = tfreq.reduce_reads(staged["cfg"], tfc.graph_from_contigs(seqs, K),
                             os.path.join(staged["dir"], "port", "red"),
                             device="cpu")
    want = jfreq.reduce_reads(staged["jcfg"], jfc.graph_from_contigs(seqs, K),
                              os.path.join(staged["jcfg"].out_dir, "red"))
    assert len(got) == len(want) == 1
    n_all = file_bytes(staged["cfg"].files_1[0]).count(b"\n")
    for (g1, g2), (w1, w2) in zip(got, want):
        assert file_bytes(g1) == file_bytes(w1)
        assert file_bytes(g2) == file_bytes(w2)
        assert 0 < file_bytes(g1).count(b"\n") < n_all


def test_device_entry_points_default_to_cuda(staged):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    g = tasmg.load_graph(staged["level2"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmol.hit_all_barcodes(staged["cfg"], g, staged["rpath"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmol.molecule_contigs(staged["cfg"], g, staged["rpath"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tfreq.reduce_reads(staged["cfg"], g)
