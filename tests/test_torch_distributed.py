"""The port's multi-process assembly3 (--dist-*, rank stripes merged on
rank 0) against the JAX package's multi-process branches, on the CPU
over Gloo, on tests/test_torch_assembly3.py's recipe (about 40 kbp, two
gaps, 18,000 barcoded pairs).

The reference is the JAX package's nproc > 1 branches of build_0,
assembly_basic and assembly3 run stage by stage by this file in one
process, the ranks' stripes in rank order: each rank's count stripe
(dist/count_rank<r>.npz), merged and built on the host with the JAX
package's committed C++ library (first-appearance node numbering), the
graph passes, the sort, the read-pair-count stripes (dist/rp_rank<r>.npz)
merged into the extension, the aux-info stripes (dist/aux_rank<r>.npz)
merged and applied, the scaffolding, each rank's stripe of the local
graphs and rank 0's bridging.

Held, exact:
  (a) in one process, for r in 0..n-1 at n = 2 and 3: the count stripes,
      get_read_pair_counts(stripe=) as dicts in order,
      aux_tables_striped as tables and candidate dicts, their merges and
      apply_aux_tables (barcodes, barcodes_scaf, barcodes_cov,
      candidates in their order), and prebuild_local_graphs_striped's
      cache files byte for byte; the archive reader's batch size is set
      to 1,500 pairs in both packages so that every rank owns batches,
      and once left at 131,072, where rank 1's stripe is empty;
  (b) `python -m turingassembler_tpu_torch assembly3 ... --device cpu
      --dist-coordinator ... --dist-nproc 2 --dist-pid {0,1}` in two
      fresh interpreters that never import jax: every file under -o but
      dist/ and the log byte for byte against the reference, and the
      dist/ tables array for array;
  (c) (slow) the JAX CLI itself with --dist-*, two processes: every file
      of the reference byte for byte.

(d) What an N-process run has in common with a 1-process run of the
port: neither the bytes of every file nor, in general, the sorted
contigs.  A 1-process run builds level 0 on the device, an N-process run
on the host with nodes numbered by first appearance (the JAX package's
branch): the same level-0 graph under other node numbers, so its FASTA
holds the same contigs.  The graph passes after it break ties by node
number, so from level 1 on the two runs may keep other variants of the
same sequence (phase 8's 65 kbp recipe does: same contig lengths, other
bases), and the merged aux info fills the barcode dicts in table order,
not batch order, which moves colliding barcodes in the aux-info graph's
serialised tables.  Held here: level 0's contigs, and both final
assemblies gapless and correct against the genome.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import pipeline as jpipe
from turingassembler_tpu.barcode import builder as jbuilder
from turingassembler_tpu.barcode import sort_read as jsort
from turingassembler_tpu.graph import build as jbuild
from turingassembler_tpu.graph.from_contigs import \
    graph_from_contigs as j_from_contigs
from turingassembler_tpu.graph.invariants import check_graph as jcheck
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.io.fasta import read_fasta as j_read_fasta
from turingassembler_tpu.kmer import count as jcount
from turingassembler_tpu.kmer.coverage import \
    recount_coverage_from_batches as j_recount
from turingassembler_tpu.localasm import bridge as jbridge
from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu.ops.sortops import np_merge_count_runs
from turingassembler_tpu.parallel.sharded_aux import \
    apply_aux_tables as j_apply_aux
from turingassembler_tpu.resolve.readpairs import \
    get_long_contigs_by_readpairs as j_extend
from turingassembler_tpu.scaffold.scaffolding import \
    scaffolding as j_scaffolding
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch.barcode import builder as tbuilder
from turingassembler_tpu_torch.barcode.sort_read import ReadPath
from turingassembler_tpu_torch.evaluate import evaluate_assembly
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.io.fasta import read_fasta
from turingassembler_tpu_torch.kmer.count import count_kedges_from_batches
from turingassembler_tpu_torch.localasm import bridge as tbridge
from turingassembler_tpu_torch.mapper import minimizers as tm
from turingassembler_tpu_torch.parallel.sharded_aux import \
    apply_aux_tables as t_apply_aux

from test_torch_assembly3 import (FINAL, local_caches, out_files,
                                  repeat_genome, write_library)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, MC, NPROC = 31, 2, 2
PATHS = "local_assembly_scaffold_path.txt"
SMALL_BATCH = 1_500


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def pair_arrays(d):
    return (np.array([[a, b] for a, b in d.keys()], np.int64).reshape(-1, 2),
            np.array(list(d.values()), np.int64))


def sum_pairs(into, keys, vals):
    """rank 0's key-sum of a rank's table, as the JAX branch does it"""
    for (a, b), v in zip(keys, vals):
        key = (int(a), int(b))
        into[key] = into.get(key, 0) + int(v)


def jax_nproc_reference(jc, n):
    """The JAX package's nproc > 1 branches of build_0, assembly_basic and
    assembly3, stage by stage, the ranks' stripes in rank order."""
    out, k = jc.out_dir, jc.k0
    dist = os.path.join(out, "dist")
    os.makedirs(dist)
    # build_0: every rank counts its stripe; rank 0 merges and builds on
    # the host (the C++ library numbers nodes by first appearance)
    for r in range(n):
        ke, c = jcount.count_kedges_from_batches(
            jpipe._striped(jpipe._genomic_batches(jc), r, n), k, min_count=1)
        np.savez(os.path.join(dist, f"count_rank{r}.npz"), kedges=ke,
                 counts=c)
    runs = []
    for r in range(n):
        z = np.load(os.path.join(dist, f"count_rank{r}.npz"))
        runs.append((z["kedges"], z["counts"].astype(np.int64)))
    ke, c = np_merge_count_runs(runs)
    keep = c >= jc.device.min_kmer_count
    assert jbuild._NATIVE_GRAPH is not None
    g = jbuild.build_graph_from_kedges(ke[keep], c[keep], k)
    jcheck(g, check_seq=False)
    jpipe.save_graph_info(g, out, "level_0")
    g = jpipe.build_1_2(jc, jpipe.build_0_1(jc, g))
    # rank 0 sorts; the others load level 2 after the sorted barrier
    rpath = jsort.sort_reads(jc)
    jsort.verify_read_archive(rpath, max_barcodes=256)
    level2 = jpipe.graph_path(out, k, "level_2")
    graphs = [g] + [jasmg.load_graph(level2) for _ in range(1, n)]
    assert int(g.alive_mask().sum()) > 2
    for r in range(n):
        rp = jbuilder.get_read_pair_counts(jc, graphs[r], rpath,
                                           stripe=(r, n))
        kk, vv = pair_arrays(rp)
        np.savez(os.path.join(dist, f"rp_rank{r}.npz"), k=kk, v=vv)
    rp_counts = {}
    for r in range(n):
        z = np.load(os.path.join(dist, f"rp_rank{r}.npz"))
        sum_pairs(rp_counts, z["k"], z["v"])
    ext = jpipe.graph_path(out, k, "extend", "fasta")
    j_extend(g, rp_counts, ext)
    seqs = [s for _, s in j_read_fasta(ext)]
    assert seqs
    g = j_recount(j_from_contigs(seqs, k), jpipe._genomic_batches(jc))
    jcheck(g, check_seq=False)
    jpipe.save_graph_info(g, out, "extend_graph")
    ext_graph = jpipe.graph_path(out, k, "extend_graph")
    graphs = [g] + [jasmg.load_graph(ext_graph) for _ in range(1, n)]
    for r in range(n):
        t, cands = jbuilder.aux_tables_striped(jc, graphs[r], rpath, (r, n))
        ck, cv = pair_arrays(cands)
        np.savez(os.path.join(dist, f"aux_rank{r}.npz"), s=t[0], e=t[1],
                 b=t[2], c=t[3], ck=ck, cv=cv)
    tables, cands_all = [], {}
    for r in range(n):
        z = np.load(os.path.join(dist, f"aux_rank{r}.npz"))
        tables.append((z["s"], z["e"], z["b"], z["c"]))
        sum_pairs(cands_all, z["ck"], z["cv"])
    j_apply_aux(g, jbuilder.merge_attach_tables(tables), cands_all)
    added = jpipe.graph_path(out, k, "added_barcode")
    jasmg.save_graph(g, added)
    scaf = j_scaffolding(jc, g, out)
    # every rank builds its stripe of the local graphs; rank 0 bridges
    graphs = [g] + [jasmg.load_graph(added) for _ in range(1, n)]
    for r in range(n):
        jbridge.prebuild_local_graphs_striped(jc, graphs[r], rpath, scaf,
                                              out, (r, n))
    return jbridge.build_bridge(jc, g, rpath, scaf)


def start_port_runs(d, files, out, single, n=NPROC):
    """The port's CLI as n ranks writing `out`, and as one process
    writing `single`, each in a fresh interpreter that must never import
    jax or the JAX package; started, not waited for."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in list(range(n)) + [None]:
        argv = ["turingassembler_tpu_torch", "assembly3", "-1", files[0],
                "-2", files[1], "-I", files[2], "-l", "ust", "-k0", str(K),
                "-mc", str(MC), "-t", "2", "--device", "cpu"]
        argv += (["-o", single] if r is None else
                 ["-o", out, "--dist-coordinator", f"127.0.0.1:{port}",
                  "--dist-nproc", str(n), "--dist-pid", str(r)])
        code = (
            "import runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "try:\n"
            "    runpy.run_module('turingassembler_tpu_torch',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith('jax.') or m == 'turingassembler_tpu'\n"
            "       or m.startswith('turingassembler_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
        env = {k_: v for k_, v in os.environ.items() if k_ not in
               ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait_all(procs, timeout=300):
    """(returncode, stdout, stderr) of each; kills them all on a timeout."""
    res = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            res.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return res


def small_jax_map_batches(monkeypatch):
    """The JAX mapper pads every call to its dispatch batch (65,536
    reads); 4,096 maps the same reads to the same edges (every read's map
    is its own) in a fraction of the time on the CPU."""
    monkeypatch.setattr(jm.map_reads, "__defaults__",
                        (4096,) + jm.map_reads.__defaults__[1:])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    files = write_library(d, repeat_genome())
    jc = jcfg.Config(k0=K, files_1=(files[0],), files_2=(files[1],),
                     files_I=(files[2],), n_threads=2,
                     out_dir=os.path.join(d, "jax"))
    jc = jc.replace(device=dataclasses.replace(jc.device, min_kmer_count=MC))
    out, single = os.path.join(d, "port"), os.path.join(d, "single")
    procs = start_port_runs(d, files, out, single)
    try:
        with pytest.MonkeyPatch.context() as mp:
            small_jax_map_batches(mp)
            jax_nproc_reference(jc, NPROC)
    finally:
        runs = wait_all(procs)
    cfg = tcfg.Config(k0=K, files_1=(files[0],), files_2=(files[1],),
                      files_I=(files[2],), n_threads=2, out_dir=out)
    ref = jc.out_dir
    return dict(dir=d, files=files, jcfg=jc, cfg=cfg, ref=ref, out=out,
                ranks=runs[:NPROC], single_run=runs[NPROC], single=single,
                rpath=ReadPath(*(os.path.join(ref, n) for n in
                                 ("R1.sorted.fq", "R2.sorted.fq",
                                  "barcode.idx"))),
                jrpath=jsort.ReadPath(*(os.path.join(ref, n) for n in
                                        ("R1.sorted.fq", "R2.sorted.fq",
                                         "barcode.idx"))))


def test_small_jax_map_batch_same_map(world):
    """The reference's one change to the JAX package's defaults, its
    mapper's dispatch batch (65,536 -> 4,096 reads), maps the fixture's
    archive the same: both reads of every pair, verified against the
    extension graph, give equal (edges, hits, starts) at both batches,
    and the port's map equals them."""
    ext = os.path.join(world["ref"], f"graph_k_{K}_extend_graph.bin")
    jg, tg = jasmg.load_graph(ext), tasmg.load_graph(ext)
    b1, l1, b2, l2, _ = next(iter(jbuilder._iter_sorted_pairs(
        world["jrpath"])))
    bases, lengths = np.concatenate([b1, b2]), np.concatenate([l1, l2])
    assert len(bases) == 36_000
    ji = jm.EdgeMinimizerIndex.build(jg)
    full = jm.map_reads(ji, bases, lengths, graph=jg)
    with pytest.MonkeyPatch.context() as mp:
        small_jax_map_batches(mp)
        assert jm.map_reads.__defaults__[0] == 4096
        small = jm.map_reads(ji, bases, lengths, graph=jg)
    port = tm.map_reads(tm.EdgeMinimizerIndex.build(tg, device="cpu"),
                        bases, lengths, graph=tg, device="cpu")
    for a, b, c in zip(full, small, port):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, a)
    assert (full[0] >= 0).mean() > 0.9


def not_dist(names):
    return [n for n in names if not n.startswith("dist" + os.sep)]


# ---------------------------------------------------------------------------
# (b) the port's CLI as two ranks
# ---------------------------------------------------------------------------

def test_two_rank_cli_same_files_as_jax_branches(world):
    for r, (rc, o, e) in enumerate(world["ranks"]):
        assert rc == 0, f"rank {r}:\n{e[-3000:]}"
        assert o.strip().endswith("clean"), o
    names = out_files(world["ref"])
    assert names == out_files(world["out"])
    files = not_dist(names)
    assert FINAL in files and len(local_caches(files)) == 2
    assert f"graph_k_{K}_extend_graph.bin" in files
    for name in files:
        want = file_bytes(os.path.join(world["ref"], name))
        assert len(want) > 0, name
        assert file_bytes(os.path.join(world["out"], name)) == want, name
    assert "rank 1 built 1 local gap graphs" in world["ranks"][1][2]
    assert "bridging done: dump=0 trivial=0 path=2 no-path=0" in \
        world["ranks"][0][2]


def test_two_rank_cli_dist_tables(world):
    names = sorted(n for n in out_files(world["ref"]) if n.startswith("dist"))
    assert names == [os.path.join("dist", f"{w}_rank{r}.npz")
                     for w in ("aux", "count", "rp") for r in range(NPROC)]
    for name in names:
        want = np.load(os.path.join(world["ref"], name))
        got = np.load(os.path.join(world["out"], name))
        assert sorted(got.files) == sorted(want.files), name
        for f in want.files:
            assert got[f].dtype == want[f].dtype, (name, f)
            np.testing.assert_array_equal(got[f], want[f], err_msg=name)
        # 18,000 pairs are one archive batch: rank 1 maps none
        assert all(len(want[f]) for f in want.files) == (
            "count" in name or "rank0" in name), name


def test_n_process_against_one_process(world):
    """(d): level 0's contigs, and two correct, gapless assemblies."""
    rc, o, e = world["single_run"]
    assert rc == 0 and o.strip().endswith("clean"), e[-3000:]

    def contigs(d, name):
        return sorted(s for _, s in read_fasta(os.path.join(d, name)))
    lv0 = f"graph_k_{K}_level_0.fasta"
    assert contigs(world["out"], lv0) == contigs(world["single"], lv0)
    genome = np.frombuffer(b"ACGT", np.uint8)[repeat_genome()] \
        .tobytes().decode()
    for d in (world["out"], world["single"]):
        got = [s for _, s in read_fasta(os.path.join(d, FINAL))]
        res = evaluate_assembly(got, genome)
        assert res.n_misassemblies == 0 and "N" not in got[0]
        assert res.genome_fraction > 0.97
        assert res.nga50 >= 0.9 * len(genome), res


# ---------------------------------------------------------------------------
# (a) the stripes in one process
# ---------------------------------------------------------------------------

# (ranks, archive batch): 18,000 pairs in 12 batches of 1,500, so every
# rank owns batches; or the default 131,072, one batch, rank 1's stripe
# empty
STRIPE_CASES = [(2, SMALL_BATCH), (3, SMALL_BATCH), (2, None)]


def set_archive_batch(monkeypatch, batch):
    """The archive reader's batch size, the same in both packages."""
    small_jax_map_batches(monkeypatch)
    if batch is not None:
        monkeypatch.setattr(tbuilder._iter_sorted_pairs, "__defaults__",
                            (batch, 256))
        monkeypatch.setattr(jbuilder._iter_sorted_pairs, "__defaults__",
                            (batch, 256, None))


@pytest.mark.parametrize("n", [2, 3])
def test_count_stripes(world, n):
    tc = world["cfg"]
    merged = []
    for r in range(n):
        want = jcount.count_kedges_from_batches(
            jpipe._striped(jpipe._genomic_batches(world["jcfg"]), r, n), K,
            min_count=1)
        got = count_kedges_from_batches(
            tpipe._striped(tpipe._genomic_batches(tc), r, n), K,
            min_count=1, device="cpu")
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert len(got[0])
        merged.append(got)
    for a, b in zip(np_merge_count_runs(merged), count_kedges_from_batches(
            tpipe._genomic_batches(tc), K, device="cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,archive_batch", STRIPE_CASES)
def test_read_pair_count_stripes(world, n, archive_batch, monkeypatch):
    set_archive_batch(monkeypatch, archive_batch)
    level2 = os.path.join(world["ref"], f"graph_k_{K}_level_2.bin")
    jg, tg = jasmg.load_graph(level2), tasmg.load_graph(level2)
    merged = {}
    sizes = []
    for stripe in [(r, n) for r in range(n)]:
        want = jbuilder.get_read_pair_counts(world["jcfg"], jg,
                                             world["jrpath"], stripe=stripe)
        got = tbuilder.get_read_pair_counts(world["cfg"], tg, world["rpath"],
                                            stripe=stripe, device="cpu")
        assert list(got.items()) == list(want.items())
        sizes.append(len(got))
        tpipe._sum_pairs(merged, *tpipe._pair_arrays(got))
    whole = tbuilder.get_read_pair_counts(world["cfg"], tg, world["rpath"],
                                          device="cpu")
    assert merged == whole
    if archive_batch is None:
        assert sizes[0] and not sizes[1]
    else:
        assert all(sizes)


@pytest.mark.parametrize("n,archive_batch", STRIPE_CASES)
def test_aux_stripes_and_merge(world, n, archive_batch, monkeypatch):
    set_archive_batch(monkeypatch, archive_batch)
    ext = os.path.join(world["ref"], f"graph_k_{K}_extend_graph.bin")
    jg, tg = jasmg.load_graph(ext), tasmg.load_graph(ext)
    jt, tt_, jc_all, tc_all = [], [], {}, {}
    for stripe in [(r, n) for r in range(n)]:
        jtab, jcand = jbuilder.aux_tables_striped(world["jcfg"], jg,
                                                  world["jrpath"], stripe)
        ttab, tcand = tbuilder.aux_tables_striped(world["cfg"], tg,
                                                  world["rpath"], stripe,
                                                  device="cpu")
        for a, b in zip(ttab, jtab):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert list(tcand.items()) == list(jcand.items())
        jt.append(jtab)
        tt_.append(ttab)
        sum_pairs(jc_all, *pair_arrays(jcand))
        tpipe._sum_pairs(tc_all, *tpipe._pair_arrays(tcand))
    if archive_batch is None:
        assert len(tt_[0][0]) and not len(tt_[1][0])
    jm = jbuilder.merge_attach_tables(jt)
    tm_ = tbuilder.merge_attach_tables(tt_)
    for a, b in zip(tm_, jm):
        np.testing.assert_array_equal(a, b)
    j_apply_aux(jg, jm, jc_all)
    t_apply_aux(tg, tm_, tc_all)
    for f in ("barcodes_scaf", "barcodes_cov"):
        assert [list(x.items()) for x in getattr(tg, f)] == \
            [list(x.items()) for x in getattr(jg, f)], f
    assert [[list(x.items()) for x in e] for e in tg.barcodes] == \
        [[list(x.items()) for x in e] for e in jg.barcodes]
    assert list(tg.candidates.items()) == list(jg.candidates.items())
    assert sum(map(len, tg.barcodes_scaf)) > 0 and tg.candidates


@pytest.mark.parametrize("n", [2, 3])
def test_prebuild_stripes(world, n, tmp_path):
    added = os.path.join(world["ref"], f"graph_k_{K}_added_barcode.bin")
    scaf = os.path.join(world["ref"], PATHS)
    jg, tg = jasmg.load_graph(added), tasmg.load_graph(added)
    built = []
    for r in range(n):
        jo, to = (str(tmp_path / f"{w}{r}") for w in ("jax", "port"))
        nj = jbridge.prebuild_local_graphs_striped(
            world["jcfg"], jg, world["jrpath"], scaf, jo, (r, n))
        nt = tbridge.prebuild_local_graphs_striped(
            world["cfg"], tg, world["rpath"], scaf, to, (r, n),
            device="cpu")
        assert nt == nj
        names = local_caches(out_files(jo)) if nj else []
        assert names == (local_caches(out_files(to)) if nt else [])
        for name in names:
            assert file_bytes(os.path.join(to, name)) == \
                file_bytes(os.path.join(jo, name))
            assert file_bytes(os.path.join(to, name)) == \
                file_bytes(os.path.join(world["ref"], name))
        built.append(nt)
    assert sum(built) == 2 and built[0] == 1


# ---------------------------------------------------------------------------
# (c) the JAX CLI's own multi-process run
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_reference_equals_jax_cli(world):
    """The in-process reference of this file against the JAX CLI with
    --dist-*, two processes (tests/test_distributed_pipeline.py's launch):
    every file but the log byte for byte, dist/ array for array."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(world["dir"], "jax_cli")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    f = world["files"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "turingassembler_tpu", "assembly3",
         "-1", f[0], "-2", f[1], "-I", f[2], "-l", "ust", "-k0", str(K),
         "-mc", str(MC), "-t", "2", "-o", out,
         "--dist-coordinator", f"localhost:{port}",
         "--dist-nproc", str(NPROC), "--dist-pid", str(r)],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(NPROC)]
    outs = [p.communicate(timeout=1200)[0].decode(errors="replace")
            for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
    names = out_files(world["ref"])
    assert names == out_files(out)
    for name in not_dist(names):
        assert file_bytes(os.path.join(out, name)) == \
            file_bytes(os.path.join(world["ref"], name)), name
    for name in set(names) - set(not_dist(names)):
        want, got = (np.load(os.path.join(d, name))
                     for d in (world["ref"], out))
        for k_ in want.files:
            np.testing.assert_array_equal(got[k_], want[k_])
