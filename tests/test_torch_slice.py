"""The port's whole slice against the JAX package, stage by stage:
count -> level-0 build -> minimizer index -> DP-verified map, on a small
error-laden workload.  Plus the port's import hygiene, its copy of the
simulator, and its refusal to fall back to the CPU.

Tolerance: exact equality at every stage (all outputs are integers).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.device_build import build_graph_on_device
from turingassembler_tpu.kmer.megasort import count_reads_device, pull_rows
from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.graph import device_build as tdb
from turingassembler_tpu_torch.kmer import megasort as tms
from turingassembler_tpu_torch.mapper import minimizers as tm

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_stage_by_stage():
    k = 31
    genome = jt.random_genome(30_000, seed=90)
    reads, lengths = jt.sim_reads(genome, coverage=12, read_len=100,
                                  seed=91, error_rate=0.004, pad_to=104)
    ir, il = tt.sim_indel_reads(genome, 300, read_len=100, seed=92,
                                pad_to=104, lo=30, hi=70)
    reads = np.concatenate([reads, ir])
    lengths = np.concatenate([lengths, il]).astype(np.int32)

    # count (min count 2, as the -mc filter would)
    u, c, n = count_reads_device(reads, lengths, k, chunk_reads=2048,
                                 out_cap_log2=17)
    import jax.numpy as jnp
    from turingassembler_tpu.kmer.megasort import _filter_min_count_device
    u, c, n = _filter_min_count_device(u, c, jnp.asarray(n, jnp.int32), 2)
    n = int(n)
    tu, tc, tn, shipped = tms.count_reads_device(
        reads, lengths, k, return_chunks=True, device="cpu")
    tu, tc = tms._filter_min_count_device(tu, tc, 2)
    assert tn > n == tu.shape[0]
    np.testing.assert_array_equal(pull_rows(u, n).astype(np.int64),
                                  tu.numpy())
    np.testing.assert_array_equal(pull_rows(c, n), tc.numpy())

    # level-0 build
    gj = build_graph_on_device(u, c, n, k)
    gt = tdb.build_graph_on_device(tu, tc, n, k, device="cpu")
    for f in ("edge_source", "edge_target", "edge_rc", "edge_count",
              "seq_off", "seq_data", "node_rc"):
        np.testing.assert_array_equal(getattr(gj, f), getattr(gt, f),
                                      err_msg=f)

    # minimizer index
    ij = jm.EdgeMinimizerIndex.build(gj)
    it = tm.EdgeMinimizerIndex.build(gt, device="cpu")
    for f in ("keys", "edge", "pos", "count"):
        np.testing.assert_array_equal(getattr(ij, f), getattr(it, f))

    # DP-verified map of the same reads, from the count's device tensors
    je, jh, js = jm.map_reads(ij, reads, lengths, graph=gj, batch_size=4096)
    te, th, ts = tm.map_reads(it, reads, lengths, graph=gt, shipped=shipped,
                              device="cpu")
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(jh, th)
    np.testing.assert_array_equal(js, ts)
    assert (te >= 0).mean() > 0.8
    assert (te[-300:] >= 0).mean() > 0.8     # indel reads pass the DP


def test_testing_copy_same_arrays():
    for seed in (0, 7):
        g = jt.random_genome(5_000, seed=seed)
        np.testing.assert_array_equal(g, tt.random_genome(5_000, seed=seed))
        np.testing.assert_array_equal(jt.revcomp(g), tt.revcomp(g))
        for kw in (dict(coverage=3, read_len=100, seed=seed + 1),
                   dict(coverage=2, read_len=150, seed=seed + 2,
                        error_rate=0.01, pad_to=152),
                   dict(coverage=2, read_len=80, seed=seed + 3,
                        circular=True)):
            a = jt.sim_reads(g, **kw)
            b = tt.sim_reads(g, **kw)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[1].dtype == b[1].dtype


def test_sim_indel_reads_carry_one_indel():
    g = tt.random_genome(2_000, seed=3)
    reads, lengths = tt.sim_indel_reads(g, 200, read_len=60, seed=4,
                                        pad_to=64, lo=20, hi=40)
    assert reads.shape == (200, 64) and (lengths == 60).all()
    assert (reads[:, 60:] == 255).all() and (reads[:, :60] < 4).all()
    fw = bytes(g).find
    rc = bytes(tt.revcomp(g).copy()).find
    for r in reads[:, :60]:
        # the first 20 and last 20 bases each match the genome exactly
        head, tail = bytes(r[:20]), bytes(r[40:])
        assert (fw(head) >= 0 and fw(tail) >= 0) or \
            (rc(head) >= 0 and rc(tail) >= 0)
        assert fw(bytes(r)) < 0 and rc(bytes(r)) < 0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import turingassembler_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'turingassembler_tpu'\n"
        "       or m.startswith('turingassembler_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('turingassembler_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from turingassembler_tpu_torch.device import resolve_device
    from turingassembler_tpu_torch.ops import dp
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    reads = np.zeros((2, 60), np.uint8)
    lengths = np.full(2, 60, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tms.count_reads_device(reads, lengths, 31)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dp.affine_scores(reads, lengths, reads, lengths, dp.SCORING_BWA)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdb.build_graph_on_device(torch.zeros((1, 2), dtype=torch.int64),
                                  torch.ones(1, dtype=torch.int32), 1, 31)
