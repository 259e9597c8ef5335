"""The port's host graph layer against the JAX package's: file formats
(asmg .bin, GFA, FASTA, FASTQ batches), numpy limb twins, the host
level-0 build, condense, the invariant checker, MutableGraph, and the
state converter.

Inputs come from numpy seeds and go into both packages as the same
arrays.  Tolerance: exact equality (integer arrays and file bytes).
"""

import gzip

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import pipeline as jpipe
from turingassembler_tpu.graph import build as jbuild
from turingassembler_tpu.graph import condense as jcond
from turingassembler_tpu.graph.invariants import check_graph as jcheck
from turingassembler_tpu.graph.mutable import MutableGraph as JMutable
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.io import binseq as jbinseq
from turingassembler_tpu.io import fasta as jfasta
from turingassembler_tpu.io import fastq as jfastq
from turingassembler_tpu.io.native_loader import read_fastq_batches_native
from turingassembler_tpu.kmer.count import count_kedges_from_reads
from turingassembler_tpu.ops import limbs as jlb
from turingassembler_tpu.resolve import resolve_graph_operation as jresolve
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.graph import build as tbuild
from turingassembler_tpu_torch.graph import condense as tcond
from turingassembler_tpu_torch.graph import device_build as tdb
from turingassembler_tpu_torch.graph.invariants import check_graph as tcheck
from turingassembler_tpu_torch.graph.mutable import MutableGraph as TMutable
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.io import binseq as tbinseq
from turingassembler_tpu_torch.io import fasta as tfasta
from turingassembler_tpu_torch.io import fastq as tfastq
from turingassembler_tpu_torch.ops import limbs as tlb

torch.set_num_threads(1)

GRAPH_ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source",
                "edge_target", "edge_rc", "edge_count", "seq_off", "seq_data")


def kedge_table(seed, genome_bp=6_000, k=31, error_rate=0.01, coverage=20,
                circular=False):
    """Sorted unique canonical (k+1)-mers with counts (count >= 2) of an
    error-laden read set, as host arrays."""
    genome = tt.random_genome(genome_bp, seed=seed)
    reads, lengths = tt.sim_reads(genome, coverage=coverage, read_len=100,
                                  seed=seed + 1, error_rate=error_rate,
                                  circular=circular)
    return count_kedges_from_reads(reads, lengths, k, engine="np",
                                   min_count=2)


def assert_graphs_equal(a, b):
    assert a.ksize == b.ksize
    for f in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert sorted(a.holes) == sorted(b.holes)
    for e in a.holes:
        np.testing.assert_array_equal(a.holes[e][0], b.holes[e][0])
        np.testing.assert_array_equal(a.holes[e][1], b.holes[e][1])


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def level_graphs(seed):
    """JAX graphs at level 0 and after resolve (tombstone-free, condensed),
    plus a mutable round trip that leaves tombstoned edges, and one with
    N-gap holes on an rc pair."""
    ke, c = kedge_table(seed, genome_bp=8_000)
    g0 = jbuild.build_graph_from_kedges(ke, c, 31)
    g1 = jresolve(g0)
    mg = JMutable.from_asm(g0)
    live = [e for e in range(mg.n_e) if mg.edges[e].source != -1]
    mg.remove_edge_pair(live[len(live) // 2])
    g_tomb = mg.to_asm()
    g_holes = g1.clone()
    e = int(np.argmax(g_holes.edge_len()))
    n = int(g_holes.edge_len(e))
    g_holes.holes[e] = (np.array([5, 20], np.int64), np.array([7, 100], np.int64))
    g_holes.holes[int(g_holes.edge_rc[e])] = (
        np.array([n - 22, n - 7], np.int64), np.array([100, 7], np.int64))
    return {"level0": g0, "resolved": g1, "tombstones": g_tomb,
            "holes": g_holes}


# ---------------------------------------------------------------------------
# limbs, binseq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [15, 16, 31, 32, 45, 46])
def test_np_limb_twins(k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, (300, k)).astype(np.uint8)
    limbs = jlb.np_pack_bases(bases, k)
    np.testing.assert_array_equal(tlb.np_pack_bases(bases, k), limbs)
    np.testing.assert_array_equal(tlb.np_unpack_limbs(limbs, k), bases)
    other = np.roll(limbs, 1, axis=0)
    other[::3] = limbs[::3]
    for name, args in (("np_revcomp_limbs", (limbs, k)),
                       ("np_revcomp_limbs_fast", (limbs, k)),
                       ("np_lex_lt", (limbs, other)),
                       ("np_lexsort_rows", (limbs,)),
                       ("np_base_at", (limbs, k - 1)),
                       ("np_base_at", (limbs, 0))):
        np.testing.assert_array_equal(getattr(tlb, name)(*args),
                                      getattr(jlb, name)(*args), err_msg=name)
    if k > 1:
        want = jlb.np_split_kedge(limbs, k - 1)
        got = tlb.np_split_kedge(limbs, k - 1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 100])
def test_binseq(n):
    seq = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    words = tbinseq.pack_binseq(seq)
    np.testing.assert_array_equal(words, jbinseq.pack_binseq(seq))
    np.testing.assert_array_equal(tbinseq.unpack_binseq(words, n), seq)


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def write_odd_fastq(path, seed, n=150):
    """Reads of mixed lengths incl. one longer than 256, an N, lower
    case, and a header comment; gzip when the path ends in .gz."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        ln = int(rng.integers(30, 200)) if i != 7 else 300
        s = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, ln))
        if i % 11 == 0:
            s[ln // 2] = ord("N")
        if i % 13 == 0:
            s = bytearray(bytes(s).lower())
        lines += [b"@r%d BX:Z:AAA" % i, bytes(s), b"+", b"I" * ln]
    data = b"\n".join(lines) + b"\n"
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fp:
        fp.write(data)


@pytest.mark.parametrize("ext", ["fq", "fq.gz"])
def test_fastq_batches_vs_native_loader(tmp_path, ext):
    path = str(tmp_path / f"odd.{ext}")
    write_odd_fastq(path, seed=3)
    want = list(read_fastq_batches_native(path, batch_size=64, pad_to=256))
    got = list(tfastq.read_fastq_batches(path, batch_size=64, pad_to=256))
    assert len(got) == len(want) == 3
    for b, (bases, lengths, _) in zip(got, want):
        np.testing.assert_array_equal(b.bases, bases)
        np.testing.assert_array_equal(b.lengths, lengths)
        assert b.bases.dtype == bases.dtype and b.lengths.dtype == lengths.dtype
    assert got[0].lengths[7] == 256 and (got[0].bases == 4).any()


@pytest.mark.parametrize("lib", ["ust", "10x"])
def test_genomic_batches(tmp_path, lib):
    p1, p2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq")
    write_odd_fastq(p1, seed=5)
    write_odd_fastq(p2, seed=6, n=70)
    kw = dict(files_1=(p1,), files_2=(p2,),
              lib_type=jcfg.LIB_TYPE_NAMES[lib])
    want = list(jpipe._genomic_batches(jcfg.Config(**kw), batch_size=64))
    got = list(tpipe._genomic_batches(tcfg.Config(**kw), batch_size=64))
    assert len(got) == len(want) == 5
    for (gb, gl), (wb, wl) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
        assert gb.dtype == wb.dtype and gl.dtype == wl.dtype


def test_fastq_malformed_raises(tmp_path):
    path = str(tmp_path / "bad.fq")
    with open(path, "wb") as fp:
        fp.write(b"r0\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="malformed"):
        list(tfastq.read_fastq_batches(path, 8, 16))
    with open(path, "wb") as fp:
        fp.write(b"@r0\nACGT\n+\n")
    with pytest.raises(ValueError, match="truncated"):
        list(tfastq.read_fastq_batches(path, 8, 16))


def test_write_fastq_same_bytes(tmp_path):
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 5, int(rng.integers(1, 80))).astype(np.uint8)
            for _ in range(40)]
    seqs[3] = b"ACGTNACGT"
    names = [b"read%d" % i for i in range(40)]
    comments = [b"BX:Z:%d" % i if i % 2 else b"" for i in range(40)]
    jfastq.write_fastq(str(tmp_path / "j.fq"), names, seqs, comments=comments)
    tfastq.write_fastq(str(tmp_path / "t.fq"), names, seqs, comments=comments)
    assert file_bytes(tmp_path / "j.fq") == file_bytes(tmp_path / "t.fq")
    assert (tfastq.NT4 == jfastq.NT4).all()


# ---------------------------------------------------------------------------
# level-0 build on the host
# ---------------------------------------------------------------------------

def random_prev(seed, n=4_000):
    """Functional prev pointers: chains of random lengths, some closed
    into pure cycles, element ids shuffled."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    prev = np.full(n, -1, np.int64)
    i = 0
    while i < n:
        ln = int(rng.integers(1, 60))
        chain = perm[i:i + ln]
        prev[chain[1:]] = chain[:-1]
        if len(chain) > 1 and rng.random() < 0.2:
            prev[chain[0]] = chain[-1]
        i += ln
    return prev


@pytest.mark.parametrize("native", ["as_found", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pointer_double_to_head(seed, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setattr(jbuild, "_NATIVE_GRAPH", None)
    prev = random_prev(seed)
    jh, jd = jbuild._pointer_double_to_head(prev)
    th, td = tbuild._pointer_double_to_head(prev)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(td, jd)
    assert (prev[th] < 0).sum() < len(prev)      # some cycles were broken


@pytest.mark.parametrize("native", ["as_found", "numpy"])
@pytest.mark.parametrize("seed,circular", [(20, False), (21, False),
                                           (22, True)])
def test_host_build(seed, circular, native, tmp_path, monkeypatch):
    """np.unique numbering equals the JAX package's without its C++
    library byte for byte; with the library (first-appearance numbering)
    the graphs are isomorphic."""
    ke, c = kedge_table(seed, circular=circular,
                        error_rate=0.0 if circular else 0.01)
    if native == "numpy":
        monkeypatch.setattr(jbuild, "_NATIVE_GRAPH", None)
    gj = jbuild.build_graph_from_kedges(ke, c, 31)
    gt = tbuild.build_graph_from_kedges(ke, c, 31)
    tcheck(gt)
    assert gt.n_e >= (2 if circular else 20)
    tt.graphs_isomorphic(gj, gt)
    if native == "numpy":
        assert_graphs_equal(gj, gt)
        jasmg.save_graph(gj, str(tmp_path / "j.bin"))
        tasmg.save_graph(gt, str(tmp_path / "t.bin"))
        assert file_bytes(tmp_path / "j.bin") == file_bytes(tmp_path / "t.bin")


@pytest.mark.parametrize("seed", [20, 22])
def test_host_build_vs_port_device_build(seed):
    """The port's two level-0 builds on one table give the same graph,
    node numbering included: both number the used k-mers in the sorted
    order of the same 64-bit fingerprint."""
    ke, c = kedge_table(seed)
    host = tbuild.build_graph_from_kedges(ke, c, 31)
    dev = tdb.build_graph_on_device(
        torch.as_tensor(ke.astype(np.int64)),
        torch.as_tensor(c.astype(np.int32)), len(ke), 31, device="cpu")
    tt.graphs_isomorphic(host, dev)
    assert_graphs_equal(host, dev)


def test_first_seen_build_equals_native_build():
    """With first_seen=True the port's host build numbers nodes as the
    JAX package's committed C++ library does (ta_unique_ids): the graph
    arrays are equal, not only isomorphic.  The spilled count's level 0
    takes this numbering (pipeline.build_0)."""
    assert jbuild._NATIVE_GRAPH is not None
    ke, c = kedge_table(20)
    gj = jbuild.build_graph_from_kedges(ke, c, 31)
    gt = tbuild.build_graph_from_kedges(ke, c, 31, first_seen=True)
    assert gt.n_e >= 20
    assert_graphs_equal(gj, gt)


def test_graphs_isomorphic_refuses():
    ke, c = kedge_table(20)
    g = tbuild.build_graph_from_kedges(ke, c, 31)
    other = g.clone()
    other.edge_target = other.edge_target.copy()
    a, b = np.flatnonzero(other.edge_target != other.edge_target[0])[:2]
    other.edge_target[[a, b]] = other.edge_target[[b, a]]
    if other.edge_target[a] != g.edge_target[a]:
        with pytest.raises(AssertionError):
            tt.graphs_isomorphic(g, other)
    other = g.clone()
    other.edge_count = other.edge_count + 1
    with pytest.raises(AssertionError):
        tt.graphs_isomorphic(g, other)


# ---------------------------------------------------------------------------
# files, converter, condense, invariants, MutableGraph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    return level_graphs(30)


@pytest.mark.parametrize("which", ["level0", "resolved", "tombstones", "holes"])
def test_graph_files_both_ways(graphs, which, tmp_path):
    gj = graphs[which]
    gt = convert.graph(gj)
    assert_graphs_equal(gj, gt)
    if which == "tombstones":
        assert (gt.edge_source == -1).any()
    for name, jw, tw in (("bin", jasmg.save_graph, tasmg.save_graph),
                         ("gfa", jfasta.write_gfa, tfasta.write_gfa),
                         ("fasta", jfasta.write_fasta, tfasta.write_fasta)):
        jw(gj, str(tmp_path / f"j.{name}"))
        tw(gt, str(tmp_path / f"t.{name}"))
        assert file_bytes(tmp_path / f"j.{name}") == \
            file_bytes(tmp_path / f"t.{name}"), name
    # a .bin written by either package loads in the other to equal arrays
    a = tasmg.load_graph(str(tmp_path / "j.bin"))
    b = jasmg.load_graph(str(tmp_path / "t.bin"))
    assert_graphs_equal(a, b)
    assert_graphs_equal(a, jasmg.load_graph(str(tmp_path / "j.bin")))
    want = list(jfasta.read_fasta(str(tmp_path / "j.fasta")))
    got = list(tfasta.read_fasta(str(tmp_path / "t.fasta")))
    assert len(got) == len(want)
    for (gn, gs), (wn, ws) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gs, ws)


def test_convert_config():
    cj = jcfg.Config(k0=31, lk=21, out_dir="x", mmem_gb=3,
                     lib_type=jcfg.LIB_TYPE_10X, files_1=("a", "b"),
                     files_2=("c",), in_file="g.bin",
                     graph=jcfg.GraphThresholds(tips_len_thres=99),
                     device=jcfg.DeviceConfig(min_kmer_count=3))
    ct = convert.config(cj)
    assert isinstance(ct, tcfg.Config)
    assert isinstance(ct.graph, tcfg.GraphThresholds)
    for f in ("k0", "lk", "out_dir", "mmem_gb", "lib_type", "files_1",
              "files_2", "in_file", "n_threads", "metagenomics"):
        assert getattr(ct, f) == getattr(cj, f), f
    for sub in ("graph", "bridge", "molecule", "minimizer", "scaffold"):
        import dataclasses
        assert dataclasses.asdict(getattr(ct, sub)) == \
            dataclasses.asdict(getattr(cj, sub)), sub
    assert ct.device.min_kmer_count == 3
    assert ct.device.sort_device_lanes == 0 and ct.device.sort_host_mb is None
    assert tcfg.LIB_TYPE_NAMES == jcfg.LIB_TYPE_NAMES


@pytest.mark.parametrize("which", ["level0", "tombstones", "holes"])
def test_condense(graphs, which):
    gj = graphs[which]
    want, wmap = jcond.asm_condense(gj.clone(), return_map=True)
    got, gmap = tcond.asm_condense(convert.graph(gj), return_map=True)
    assert_graphs_equal(want, got)
    np.testing.assert_array_equal(wmap, gmap)
    slow = tcond.asm_condense_py(convert.graph(gj))
    assert_graphs_equal(want, slow)


def test_check_graph_agrees(graphs):
    for g in graphs.values():
        jcheck(g)
        tcheck(convert.graph(g))
    bad = convert.graph(graphs["level0"])
    bad.edge_rc = bad.edge_rc.copy()
    bad.edge_rc[0] = bad.edge_rc[1]
    jbad = graphs["level0"].clone()
    jbad.edge_rc = bad.edge_rc.copy()
    with pytest.raises(AssertionError):
        jcheck(jbad)
    with pytest.raises(AssertionError):
        tcheck(bad)


@pytest.mark.parametrize("which", ["level0", "resolved", "holes"])
def test_mutable_graph_round_trip(graphs, which):
    gj = graphs[which]
    mj = JMutable.from_asm(gj)
    mt = TMutable.from_asm(convert.graph(gj))
    assert mj.node_adj == mt.node_adj and mj.node_rc == mt.node_rc
    # the same edits on both: a removal, a join through a (1,1) node
    # where there is one, a new node
    live = [e for e in range(mj.n_e) if mj.edges[e].source != -1]
    for m in (mj, mt):
        m.remove_edge_pair(live[1])
        m.create_node()
    from turingassembler_tpu.resolve import basic as jbasic
    from turingassembler_tpu_torch.resolve import basic as tbasic
    jbasic.lazy_condense(mj)
    tbasic.lazy_condense(mt)
    assert_graphs_equal(mj.to_asm(), mt.to_asm())
