"""The port's sharded count, map and aux info (parallel/*) against the
JAX package's on conftest's 8-device virtual CPU mesh, and the port's
cross-process exchange in two processes over Gloo.

The port's mesh holds its shards on the CPU (several shards a device);
the JAX one holds one shard a virtual device.  Tolerance: exact
equality: the merged (kedges, counts) tables and every shard's own table
(the same hash routes a k-mer to the same shard), the dropped count at a
small capacity, (edges, hits, starts) of the map, verified and vote-only,
the aux-info attach tables and candidate dicts in their order.  The
two-process run (2 processes x 2 shards, tests/test_distributed.py's
layout) must give the single-process count.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.barcode import builder as jbuilder
from turingassembler_tpu.graph.from_contigs import \
    graph_from_contigs as j_from_contigs
from turingassembler_tpu.kmer.count import \
    count_kedges_from_reads as j_count
from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu.parallel import sharded_aux as jaux
from turingassembler_tpu.parallel import sharded_count as jsc
from turingassembler_tpu.parallel import sharded_map as jsm
from turingassembler_tpu.parallel.mesh import make_mesh as j_mesh
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode import builder as tbuilder
from turingassembler_tpu_torch.kmer.count import \
    count_kedges_from_reads as t_count
from turingassembler_tpu_torch.mapper import minimizers as tm
from turingassembler_tpu_torch.parallel import distributed as tdist
from turingassembler_tpu_torch.parallel import mesh as tmesh
from turingassembler_tpu_torch.parallel import sharded_aux as taux
from turingassembler_tpu_torch.parallel import sharded_count as tsc
from turingassembler_tpu_torch.parallel import sharded_map as tsm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 31


def count_reads(n_shards, seed=5):
    genome = jt.random_genome(3000, seed=seed)
    reads, lengths = jt.sim_reads(genome, coverage=30.0, read_len=100,
                                  seed=8)
    n = (len(reads) // n_shards) * n_shards
    return reads[:n], lengths[:n].astype(np.int32)


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_count_matches_jax(n_shards):
    reads, lengths = count_reads(n_shards)
    mesh = tmesh.make_mesh(n_shards, "cpu")
    assert (mesh.size, mesh.n_local, mesh.world) == (n_shards, n_shards, 1)
    got = tsc.sharded_count_to_host(reads, lengths, mesh, K)
    want = jsc.sharded_count_to_host(reads, lengths, j_mesh(n_shards), K)
    single = t_count(reads, lengths, K, batch_size=100_000, device="cpu")
    for a, b, c in zip(got, want, single):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got[0]) > 1000

    # shard by shard: the same k-mers own the same shard
    cap = int(2.2 * (len(reads) // n_shards) * (100 - K) / n_shards) + 64
    db, dl = tsc.device_put_sharded_batch(reads, lengths, mesh)
    uq, ct, nu, dropped, total = tsc.sharded_count_step(
        db, dl, mesh=mesh, k=K, cap_per_dest=cap)
    jb, jl = jsc.device_put_sharded_batch(reads, lengths, j_mesh(n_shards))
    ju, jc, jn, jd, jtot = jsc.sharded_count_step(
        jb, jl, mesh=j_mesh(n_shards), k=K, cap_per_dest=cap)
    ju, jc, jn = np.asarray(ju), np.asarray(jc), np.asarray(jn)
    per = ju.shape[0] // n_shards
    assert dropped == int(jd) == 0 and total == int(jtot)
    for d in range(n_shards):
        assert nu[d] == int(jn[d]) > 0
        np.testing.assert_array_equal(uq[d].numpy(),
                                      ju[d * per:d * per + nu[d]])
        np.testing.assert_array_equal(ct[d].numpy(),
                                      jc[d * per:d * per + nu[d]])


def test_sharded_count_overflow_detected():
    reads, lengths = count_reads(2, seed=1)
    reads, lengths = reads[:40], lengths[:40]
    mesh = tmesh.make_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="dropped"):
        tsc.sharded_count_to_host(reads, lengths, mesh, K, cap_per_dest=8)
    db, dl = tsc.device_put_sharded_batch(reads, lengths, mesh)
    *_, dropped, total = tsc.sharded_count_step(db, dl, mesh=mesh, k=K,
                                                cap_per_dest=8)
    jb, jl = jsc.device_put_sharded_batch(reads, lengths, j_mesh(2))
    *_, jd, jtot = jsc.sharded_count_step(jb, jl, mesh=j_mesh(2), k=K,
                                          cap_per_dest=8)
    assert dropped == int(jd) > 0 and total == int(jtot)


def test_mesh_places_shards_round_robin():
    mesh = tmesh.make_mesh(4, ["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.first == 0 and mesh.replicate(torch.ones(2))[0].sum() == 2
    x = [torch.arange(4 * 3).reshape(4, 3) + 100 * s for s in range(4)]
    recv = mesh.all_to_all(x)
    for d in range(4):
        for j in range(4):
            np.testing.assert_array_equal(recv[d][j].numpy(),
                                          x[j][d].numpy())
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, ["cpu", "cuda"])


def test_nccl_mesh_refuses_ranks_sharing_a_gpu():
    tmesh.check_nccl_devices([("h", [0]), ("h", [1])])
    tmesh.check_nccl_devices([("h", [0]), ("h2", [0])])
    with pytest.raises(RuntimeError, match="one GPU a rank"):
        tmesh.check_nccl_devices([("h", [0]), ("h", [0])])
    with pytest.raises(RuntimeError, match="ranks 0 and 2"):
        tmesh.check_nccl_devices([("h", [0, 0]), ("h", [1]), ("h", [0])])


def test_single_process_runtime():
    assert tdist.dist_info() == (0, 1)
    tdist.barrier("nothing to wait for")
    assert tdist.shard_files_for_process(["a", "b", "c"]) == ["a", "b", "c"]
    assert tdist.rank_device("cuda") == torch.device("cuda")
    assert tdist.rank_device("cpu") == torch.device("cpu")
    tdist.init_distributed()            # no launcher: nothing to join
    assert tdist.dist_info() == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        tdist.init_distributed(num_processes=2)
    assert tbuilder._library_mesh("cpu") is None
    # a named GPU maps on that GPU alone, never on a mesh of all of them
    assert tbuilder._library_mesh("cuda:1") is None


# ---------------------------------------------------------------------------
# the map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def contigs():
    """tests/test_sharded_map.py's three contigs, the JAX index and the
    port's copies; substitution reads and mid-read indel reads (the
    latter reach the DP)."""
    genome = jt.random_genome(12000, seed=21)
    jg = j_from_contigs([jt.codes_to_str(genome[:5000]),
                         jt.codes_to_str(genome[5000:9000]),
                         jt.codes_to_str(genome[9000:])], 45)
    ji = jm.EdgeMinimizerIndex.build(jg)
    a, la = jt.sim_reads(genome, coverage=6.0, read_len=100,
                         error_rate=0.01, seed=22, pad_to=104)
    b, lb = tt.sim_indel_reads(genome, 300, read_len=100, seed=23,
                               pad_to=104, lo=30, hi=70)
    reads = np.concatenate([a, b])
    lengths = np.concatenate([la, lb]).astype(np.int32)
    perm = np.random.default_rng(24).permutation(len(reads))
    return dict(jg=jg, ji=ji, tg=convert.graph(jg),
                ti=convert.minimizer_index(ji), reads=reads[perm],
                lengths=lengths[perm])


@pytest.mark.parametrize("n_shards,verified", [(2, False), (2, True),
                                               (8, False), (8, True)])
def test_sharded_map_matches_jax(contigs, n_shards, verified):
    c = contigs
    reads, lengths = c["reads"], c["lengths"]
    mesh = tmesh.make_mesh(n_shards, "cpu")
    jg, tg = (c["jg"], c["tg"]) if verified else (None, None)
    want = jsm.map_reads_sharded(c["ji"], reads, lengths, j_mesh(n_shards),
                                 batch_size=512, graph=jg)
    single = jm.map_reads(c["ji"], reads, lengths, batch_size=512, graph=jg)
    got = tm.map_reads(c["ti"], reads, lengths, batch_size=512, graph=tg,
                       mesh=mesh, device="cpu")
    direct = tsm.map_reads_sharded(c["ti"], reads, lengths, mesh,
                                   batch_size=512, graph=tg)
    for a, b, s, d in zip(got, want, single, direct):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s)
        np.testing.assert_array_equal(a, d)
    assert (got[0] >= 0).mean() > 0.5


def test_sharded_map_dp_runs_on_the_shards(contigs, monkeypatch):
    """The verified map sends the lanes its gapless bound rejects to the
    DP on their shards: one call a shard that has any."""
    c = contigs
    calls = []
    real = tm._dp_verify_rest
    monkeypatch.setattr(tm, "_dp_verify_rest",
                        lambda *a, **kw: calls.append(len(a[6]))
                        or real(*a, **kw))
    mesh = tmesh.make_mesh(4, "cpu")
    tm.map_reads(c["ti"], c["reads"], c["lengths"], batch_size=1024,
                 graph=c["tg"], mesh=mesh, device="cpu")
    assert len(calls) == 4 and min(calls) > 0


def test_sharded_map_uneven_tail(contigs):
    """N not a multiple of the (rounded) batch: tests/test_sharded_map.py's
    case, 8 shards, batch 500 (rounds to 504), three reads short."""
    c = contigs
    n = len(c["reads"]) - 3
    reads, lengths = c["reads"][:n], c["lengths"][:n]
    mesh = tmesh.make_mesh(8, "cpu")
    for jg, tg in ((None, None), (c["jg"], c["tg"])):
        want = jsm.map_reads_sharded(c["ji"], reads, lengths, j_mesh(8),
                                     batch_size=500, graph=jg)
        got = tsm.map_reads_sharded(c["ti"], reads, lengths, mesh,
                                    batch_size=500, graph=tg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # fewer reads than shards: some shards get none
    got = tsm.map_reads_sharded(c["ti"], reads[:5], lengths[:5], mesh,
                                batch_size=500, graph=c["tg"])
    want = jm.map_reads(c["ji"], reads[:5], lengths[:5], graph=c["jg"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the aux info
# ---------------------------------------------------------------------------

def aux_pairs():
    """tests/test_distributed.py's aux case: two contigs of an 8 kbp
    genome, 256 FR pairs of 100 bp at fragment 280, molecule tags."""
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 8000).astype(np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    jg = j_from_contigs([acgt[genome[:4500]].tobytes().decode(),
                         acgt[genome[4500:]].tobytes().decode()], 45)
    n_pairs, frag, rl = 256, 280, 100
    starts = rng.integers(0, len(genome) - frag, n_pairs)
    b1 = np.stack([genome[s:s + rl] for s in starts]).astype(np.uint8)
    b2r = np.stack([genome[s + frag - rl:s + frag] for s in starts])
    b2 = (3 - b2r)[:, ::-1].astype(np.uint8)
    ln = np.full(n_pairs, rl, np.int32)
    return jg, b1, ln, np.ascontiguousarray(b2), ln.copy(), \
        (starts // 40).astype(np.uint64)


def test_aux_tables_local_matches_jax():
    jg, b1, l1, b2, l2, bcs = aux_pairs()
    ji = jm.EdgeMinimizerIndex.build(jg)
    tg, ti = convert.graph(jg), convert.minimizer_index(ji)
    want = jaux.aux_tables_local(jg, ji, b1, l1, b2, l2, bcs, mesh=j_mesh(2))
    single = jaux.aux_tables_local(jg, ji, b1, l1, b2, l2, bcs, mesh=None)
    for mesh in (tmesh.make_mesh(2, "cpu"), None):
        got = taux.aux_tables_local(tg, ti, b1, l1, b2, l2, bcs, mesh=mesh,
                                    device="cpu")
        for ref in (want, single):
            for a, b in zip(got[0], ref[0]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert list(got[1].items()) == list(ref[1].items())
    assert len(got[0][0]) > 100 and got[1]

    # folded into the graph: dicts equal in their order
    jd, td = jg.clone(), tg.clone()
    jaux.apply_aux_tables(jd, *want)
    taux.apply_aux_tables(td, *got)
    assert td.barcodes == jd.barcodes
    assert [list(d.items()) for e in td.barcodes for d in e] == \
        [list(d.items()) for e in jd.barcodes for d in e]
    assert [list(d.items()) for d in td.barcodes_scaf] == \
        [list(d.items()) for d in jd.barcodes_scaf]
    assert [list(d.items()) for d in td.barcodes_cov] == \
        [list(d.items()) for d in jd.barcodes_cov]
    assert list(td.candidates.items()) == list(jd.candidates.items())
    assert jbuilder.N_ATTACH_STORES == tbuilder.N_ATTACH_STORES


# ---------------------------------------------------------------------------
# two processes x two shards over Gloo
# ---------------------------------------------------------------------------

N_PROC, SHARDS_PER_PROC, READ_LEN, K2 = 2, 2, 64, 21


def _worker_reads():
    genome = tt.random_genome(3000, seed=7)
    reads, lens = tt.sim_reads(genome, coverage=8, read_len=READ_LEN,
                               seed=8)
    d = N_PROC * SHARDS_PER_PROC
    b = (len(reads) // (d * N_PROC)) * (d * N_PROC)
    return reads[:b], lens[:b].astype(np.int32)


def _worker(pid: int, port: int, tmp: str) -> None:
    """One rank: rank 0 joins with explicit arguments, rank 1 through
    torchrun's environment.  Each places its half of the batch on its two
    shards; one step routes k-mers across the process border; each rank
    dumps its shards' tables, and rank 0 merges them."""
    if pid == 0:
        tdist.init_distributed(f"127.0.0.1:{port}", N_PROC, 0)
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(N_PROC), RANK=str(pid))
        tdist.init_distributed()
    assert tdist.dist_info() == (pid, N_PROC)
    reads, lens = _worker_reads()
    B = len(reads)
    lo, hi = pid * (B // N_PROC), (pid + 1) * (B // N_PROC)
    mesh = tmesh.make_mesh(N_PROC * SHARDS_PER_PROC, "cpu")
    assert (mesh.n_local, mesh.first) == (SHARDS_PER_PROC,
                                         pid * SHARDS_PER_PROC)
    gb, gl = tdist.global_read_batch(reads[lo:hi], lens[lo:hi], mesh)
    d = mesh.size
    cap = int(2.5 * (B // d) * (READ_LEN - K2) / d) + 64
    uniq, counts, n_unique, dropped, total = tsc.sharded_count_step(
        gb, gl, mesh=mesh, k=K2, cap_per_dest=cap)
    assert dropped == 0 and total > 0
    for s in range(mesh.n_local):
        np.savez(os.path.join(tmp, f"shard_{mesh.first + s}.npz"),
                 uniq=uniq[s].numpy().astype(np.uint32),
                 counts=counts[s].numpy())
    tdist.barrier("shards_dumped")
    # the host wrapper over the global batch gives every rank the table
    kedges, cnts = tsc.sharded_count_to_host(reads, lens, mesh, K2)
    if pid == 0:
        from turingassembler_tpu_torch.ops.sortops import np_merge_count_runs
        runs = []
        for s in range(d):
            z = np.load(os.path.join(tmp, f"shard_{s}.npz"))
            runs.append((z["uniq"], z["counts"].astype(np.int64)))
        merged = np_merge_count_runs(runs)
        single = t_count(reads, lens, K2, device="cpu")
        for a, b, c in zip(merged, single, (kedges, cnts)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        np.savez(os.path.join(tmp, "merged.npz"), kedges=merged[0],
                 counts=merged[1])
    tdist.barrier("merged")
    try:
        tdist.barrier(f"rank {pid}")       # desynchronised stage streams
    except RuntimeError as e:
        assert "barrier" in str(e)
    else:
        raise AssertionError("barriers of different names passed")


def test_two_process_two_shard_count(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i),
         str(port), str(tmp_path)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(N_PROC)]
    outs = [p.communicate(timeout=240)[0].decode(errors="replace")
            for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    z = np.load(os.path.join(tmp_path, "merged.npz"))
    reads, lens = _worker_reads()
    want = j_count(reads, lens, K2, engine="np")
    np.testing.assert_array_equal(z["kedges"], want[0])
    np.testing.assert_array_equal(z["counts"], want[1])
    assert len(z["kedges"]) > 100


if __name__ == "__main__" and len(sys.argv) >= 5 and sys.argv[1] == "--worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
