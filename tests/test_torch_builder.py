"""The port's barcode aux info (barcode/builder.py) against the
JAX package.

The host tallies are held against the JAX functions on seeded arrays.
The two mappers (get_read_pair_counts, construct_aux_info) run in both
packages on one level-2 graph file and one sorted archive, made once by
the port on the CPU: the dicts must be equal item for item in insertion
order, and graph_k_<k>_added_barcode.bin byte for byte.  The JAX side
runs as its own tests run it (8 virtual CPU devices, so its mappers take
the sharded path).  Tolerance: exact equality.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu.barcode import builder as jbuilder
from turingassembler_tpu.barcode import sort_read as jsort
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.mapper import minimizers as jmm
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode import builder as tbuilder
from turingassembler_tpu_torch.barcode import sort_read as tsort
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.logging_utils import stage_walls
from turingassembler_tpu_torch.mapper import minimizers as tmm

torch.set_num_threads(1)

K = 45
BX_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


# ---------------------------------------------------------------------------
# host tallies on seeded arrays
# ---------------------------------------------------------------------------

def test_archive_batch_size_is_the_jax_one():
    """The archive reader's batch borders decide the order in which the
    mappers' dicts fill, so its defaults are part of the result."""
    assert tbuilder._iter_sorted_pairs.__defaults__ == (131_072, 256)
    assert jbuilder._iter_sorted_pairs.__defaults__[:2] == (131_072, 256)
    assert tbuilder.RP_FULL_LEN_SLACK == jbuilder.RP_FULL_LEN_SLACK == 30
    for name in ("CONTIG_LEVEL_0", "CONTIG_LEVEL_1", "CONTIG_LEVEL_2",
                 "MIN_CONTIG_BARCODE", "MAX_READ_FRAG_LEN"):
        assert getattr(tbuilder, name) == getattr(jbuilder, name)


def test_decode_barcode_comments():
    comments = [b"BX:Z:ACGTACGTACGTACGTAC QB:Z:IIII", b"", b"BX:Z:ACGTN",
                b"QB:Z:II BX:Z:ACGT", b"BX:Z:TTTTTTTTTTTTTTTTTTTTTTTTTTTT",
                b"BX:Z:A", b"BX:Z:", b"other"]
    got = tbuilder.decode_barcode_comments(comments)
    want = jbuilder.decode_barcode_comments(comments)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert got[1] == got[3] == got[7] == BX_NONE
    from turingassembler_tpu_torch.io.fastq import decode_barcode_seq
    assert int(got[0]) == decode_barcode_seq(b"ACGTACGTACGTACGTAC")
    assert len(tbuilder.decode_barcode_comments([])) == 0
    np.testing.assert_array_equal(
        tbuilder.decode_barcode_comments([b"", b"x"]), [BX_NONE, BX_NONE])


class _G:
    """The fields the tallies read of a graph."""

    def __init__(self, n_e, seed):
        rng = np.random.default_rng(seed)
        self.n_e = n_e
        self.edge_rc = np.arange(n_e, dtype=np.int64) ^ 1
        self.lens = np.repeat(rng.integers(300, 30_000, n_e // 2), 2)
        self.aux_flag = 0
        self.candidates = {}

    def edge_len(self):
        return self.lens


def random_hits(g, n, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(-1, g.n_e, n).astype(np.int32)
    p = np.where(e >= 0, rng.integers(0, 12_000, n), -1).astype(np.int32)
    bcs = rng.integers(1, 40, n).astype(np.uint64)
    bcs[rng.random(n) < 0.1] = BX_NONE
    ql = rng.integers(100, 151, n).astype(np.int32)
    return e, p, bcs, ql


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_attach_vs_attach_vs_jax(seed):
    g, gj, gs = _G(12, seed), _G(12, seed), _G(12, seed)
    for x, b in ((g, tbuilder), (gj, jbuilder), (gs, tbuilder)):
        b.init_barcode_structs(x)
    assert g.aux_flag & 1
    for batch in range(3):
        e, p, bcs, _ = random_hits(g, 4_000, 10 * seed + batch)
        tbuilder._bulk_attach(g, g.lens, e, p, bcs)
        jbuilder._bulk_attach(gj, gj.lens, e, p, bcs)
        for ei, pi, bi in zip(e, p, bcs):
            if ei >= 0 and bi != BX_NONE:
                tbuilder._attach(gs, gs.lens, int(ei), int(pi), int(bi))
        table = tbuilder.attach_table(g.lens, e, p, bcs)
        for a, b in zip(table, jbuilder.attach_table(g.lens, e, p, bcs)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for name in ("barcodes", "barcodes_scaf", "barcodes_cov"):
        got, want, slow = (getattr(x, name) for x in (g, gj, gs))
        assert got == slow                       # same counts, any order
        flat = (lambda v: [list(d.items()) for lv in v for d in
                           (lv if isinstance(lv, list) else [lv])])
        assert flat(got) == flat(want)           # and JAX's order
    assert sum(len(d) for d in g.barcodes_scaf) > 50
    assert sum(len(d) for d in g.barcodes_cov) > 50


def test_attach_table_empty_and_merge():
    g = _G(8, 3)
    none = np.full(5, -1, np.int32)
    t = tbuilder.attach_table(g.lens, none, none, np.ones(5, np.uint64))
    assert [len(a) for a in t] == [0, 0, 0, 0]
    assert [a.dtype for a in t] == [np.int8, np.int64, np.uint64, np.int64]
    tables = []
    for s in range(3):
        e, p, bcs, _ = random_hits(g, 500, 30 + s)
        tables.append(tbuilder.attach_table(g.lens, e, p, bcs))
    got = tbuilder.merge_attach_tables(tables)
    for a, b in zip(got, jbuilder.merge_attach_tables(tables)):
        np.testing.assert_array_equal(a, b)
    assert int(got[3].sum()) == sum(int(t[3].sum()) for t in tables)
    ga, gb = _G(8, 3), _G(8, 3)
    tbuilder.init_barcode_structs(ga)
    tbuilder.init_barcode_structs(gb)
    tbuilder.apply_attach_table(ga, got)
    for t in tables:
        tbuilder.apply_attach_table(gb, t)
    assert ga.barcodes == gb.barcodes and ga.barcodes_scaf == gb.barcodes_scaf


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_hits_and_candidate_keys(seed):
    g = _G(10, seed)
    e1, p1, _, q1 = random_hits(g, 3_000, seed + 50)
    e2, p2, _, q2 = random_hits(g, 3_000, seed + 60)
    p1, p2 = np.minimum(p1, 200), np.minimum(p2, 200)
    # pairs right at the fragment-length gate: 349 passes, 350 does not
    e1[:40], e2[:40], p1[:40] = 0, 4, 170
    p2[:20], p2[20:40] = 179, 180
    m1 = tbuilder._mirror_hits(g, g.lens, e1, p1, q1)
    m2 = tbuilder._mirror_hits(g, g.lens, e2, p2, q2)
    for a, b in zip(m1, jbuilder._mirror_hits(g, g.lens, e1, p1, q1)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    on = e1 >= 0
    np.testing.assert_array_equal(m1[0][on], e1[on] ^ 1)
    assert (m1[0][~on] == -1).all() and (m1[1][~on] == -1).all()
    got = list(tbuilder._candidate_pair_keys(g, (e1, p1) + m1, (e2, p2) + m2))
    want = list(jbuilder._candidate_pair_keys(g, (e1, p1) + m1,
                                              (e2, p2) + m2))
    assert got == want and len(got) > 10
    assert dict(got)[(0 << 32) + 4] >= 20
    gated = list(tbuilder._candidate_pair_keys(
        g, (e1[20:40], p1[20:40], m1[0][20:40], m1[1][20:40]),
        (e2[20:40], p2[20:40], m2[0][20:40], m2[1][20:40])))
    assert (0 << 32) + 4 not in dict(gated)
    keys = [k for k, _ in got]
    assert keys == sorted(keys)
    assert all(((k >> 32) << 32 | (k & 0xFFFFFFFF)) == k for k in keys)
    none = np.full(4, -1, np.int32)
    assert list(tbuilder._candidate_pair_keys(
        g, (none,) * 4, (none,) * 4)) == []


# ---------------------------------------------------------------------------
# the two mappers on one level-2 graph and archive
# ---------------------------------------------------------------------------

# (seed, library type, reads a batch of the archive reader; None: 131,072)
CASES = {"ust": (3, "ust", None), "bioturing_small_batches":
         (4, "bioturing", 1_500)}


@pytest.fixture(scope="module", params=list(CASES))
def staged(request, tmp_path_factory):
    seed, lib, batch = CASES[request.param]
    d = str(tmp_path_factory.mktemp(request.param))
    _, files = tt.linked_read_library(
        21_000, seed, d, n_segments=3, repeat_len=1_500, coverage=60.0,
        molecule_len=5_000, pairs_per_molecule=8, lib=lib)
    cfg = tcfg.Config(k0=K, out_dir=os.path.join(d, "port"),
                      files_1=(files["R1"],), files_2=(files["R2"],),
                      files_I=((files["I1"],) if lib == "ust" else ()),
                      lib_type=tcfg.LIB_TYPE_NAMES[lib])
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 min_kmer_count=2))
    tpipe.assembly_basic(cfg, device="cpu")
    rpath = tsort.sort_reads(cfg)
    level2 = tpipe.graph_path(cfg.out_dir, K, "level_2")
    mp = pytest.MonkeyPatch()
    if batch is not None:
        # the same batch boundaries on both sides: several batches, so
        # that the dicts are filled across batch borders
        mp.setattr(tbuilder._iter_sorted_pairs, "__defaults__", (batch, 256))
        mp.setattr(jbuilder._iter_sorted_pairs, "__defaults__",
                   (batch, 256, None))
    jr = jsort.ReadPath(rpath.R1_path, rpath.R2_path, rpath.idx_path)
    jc = jcfg.Config(k0=K, out_dir=os.path.join(d, "jax"))
    os.makedirs(jc.out_dir)
    jg = jasmg.load_graph(level2)
    out = dict(dir=d, cfg=cfg, rpath=rpath, level2=level2,
               n_pairs=file_bytes(rpath.R1_path).count(b"\n") // 4,
               j_rp=jbuilder.get_read_pair_counts(jc, jg, jr),
               j_aux=jbuilder.construct_aux_info(jc, jg, jr), jcfg=jc)
    yield out
    mp.undo()


def test_read_pair_counts_in_order(staged):
    g = tasmg.load_graph(staged["level2"])
    got = tbuilder.get_read_pair_counts(staged["cfg"], g, staged["rpath"],
                                        device="cpu")
    assert list(got.items()) == list(staged["j_rp"].items())
    assert len(got) >= 8 and sum(got.values()) > staged["n_pairs"]
    assert all(isinstance(a, int) and isinstance(b, int) and
               isinstance(c, int) for (a, b), c in got.items())
    assert staged["n_pairs"] % 65_536 != 0
    walls = stage_walls()
    assert all(walls.get("rp_count." + part, 0) > 0
               for part in ("index", "parse", "map", "tally"))


def test_aux_info_in_order_and_added_barcode_bytes(staged):
    g = tasmg.load_graph(staged["level2"])
    g = tbuilder.construct_aux_info(staged["cfg"], g, staged["rpath"],
                                    device="cpu")
    jg = staged["j_aux"]
    assert list(g.candidates.items()) == list(jg.candidates.items())
    assert len(g.candidates) >= 4
    for e in range(g.n_e):
        for lv in range(3):
            assert list(g.barcodes[e][lv].items()) == \
                list(jg.barcodes[e][lv].items())
        assert list(g.barcodes_scaf[e].items()) == \
            list(jg.barcodes_scaf[e].items())
        assert list(g.barcodes_cov[e].items()) == \
            list(jg.barcodes_cov[e].items())
    assert g.aux_flag == jg.aux_flag == 1
    long_edges = np.flatnonzero(g.edge_len() >= 4_000)
    assert len(long_edges) >= 4
    assert all(len(g.barcodes_scaf[e]) >= 75 for e in long_edges)
    want = os.path.join(staged["jcfg"].out_dir, "added.bin")
    jasmg.save_graph(jg, want)
    got = os.path.join(staged["dir"], "port", "added.bin")
    tasmg.save_graph(g, got)
    assert file_bytes(got) == file_bytes(want)
    # the state carried across: a JAX graph with aux info becomes the
    # port's with the same dict orders
    carried = os.path.join(staged["dir"], "port", "carried.bin")
    cg = convert.graph(jg)
    assert list(cg.candidates.items()) == list(jg.candidates.items())
    tasmg.save_graph(cg, carried)
    assert file_bytes(carried) == file_bytes(want)
    cg.barcodes[0][2][-1] = 99                    # a copy, not a view
    assert -1 not in jg.barcodes[0][2]
    # without the read-pair tally the barcodes are the same
    g2 = tbuilder.construct_aux_info(
        staged["cfg"], tasmg.load_graph(staged["level2"]), staged["rpath"],
        build_readpairs=False, device="cpu")
    assert g2.candidates == {} and g2.barcodes == g.barcodes
    walls = stage_walls()
    assert all(walls.get("aux." + part, 0) > 0
               for part in ("index", "parse", "map", "attach"))


def test_mappers_default_to_cuda_and_raise_without_gpu(staged):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    g = tasmg.load_graph(staged["level2"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbuilder.get_read_pair_counts(staged["cfg"], g, staged["rpath"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbuilder.construct_aux_info(staged["cfg"], g, staged["rpath"])


@pytest.mark.parametrize("n", [2_500, 2_048])
def test_map_reads_per_lane_thresholds(staged, n, monkeypatch):
    """min_score as an array, over map batches of 1,024 lanes with and
    without a tail batch: the JAX function pads the tail's thresholds
    with 1 << 30, the port pads nothing."""
    monkeypatch.setattr(jbuilder, "_library_mesh", lambda: None)
    g = tasmg.load_graph(staged["level2"])
    jg = jasmg.load_graph(staged["level2"])
    b1, l1, _, _, _ = next(tbuilder._iter_sorted_pairs(staged["rpath"], n))
    assert len(b1) == n
    rng = np.random.default_rng(n)
    thr = np.maximum(l1.astype(np.int64) - 30, 50)
    thr[rng.random(n) < 0.3] = 150      # only a perfect read passes
    jidx = jmm.EdgeMinimizerIndex.build(jg)
    idx = tmm.EdgeMinimizerIndex.build(g, device="cpu")
    want = jmm.map_reads(jidx, b1, l1, batch_size=1_024, graph=jg,
                         min_score=thr, with_hits=False)
    got = tmm.map_reads(idx, b1, l1, batch_size=1_024, graph=g,
                        min_score=thr, with_hits=False, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    loose = tmm.map_reads(idx, b1, l1, graph=g, with_hits=False,
                          device="cpu")[0]
    assert (got[0] >= 0).sum() < (loose >= 0).sum()   # the thresholds bit
    assert (got[0] >= 0).mean() > 0.5
