"""Port parity: graph/device_build.py of turingassembler_tpu_torch against
the JAX package's build_graph_on_device on the same k-edge table.

Tolerance: exact equality of every AsmGraph array (edge_source,
edge_target, edge_rc, edge_count, seq_off, seq_data, node_rc and the
adjacency CSR).
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.device_build import build_graph_on_device
from turingassembler_tpu.kmer.megasort import count_reads_device
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch.graph import device_build as tdb

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ARRAYS = ("edge_source", "edge_target", "edge_rc", "edge_count", "seq_off",
          "seq_data", "node_rc", "adj_off", "adj_list")


def _both(reads, lengths, k, **jax_kw):
    u, c, n = count_reads_device(reads, lengths.astype(np.int32), k,
                                 chunk_reads=512, out_cap_log2=17)
    gj = build_graph_on_device(u, c, n, k, **jax_kw)
    tu, tc, tn = convert.kmer_table(u, c, n, device="cpu")
    gt = tdb.build_graph_on_device(tu, tc, tn, k, device="cpu")
    assert gt.ksize == gj.ksize
    for f in ARRAYS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    return gj


@pytest.mark.parametrize("seed,k,err", [(21, 45, 0.0), (22, 31, 0.02),
                                        (23, 21, 0.005), (24, 63, 0.01)])
def test_build_error_laden_branching(seed, k, err):
    """Errors branch the graph into many short unitigs: shared nodes make
    duplicate keys in the successor/predecessor scatters."""
    g = jt.random_genome(8_000, seed=seed)
    reads, lengths = jt.sim_reads(g, coverage=8, read_len=100,
                                  seed=seed + 1, error_rate=err)
    gj = _both(reads, lengths, k)
    if err:
        assert gj.n_e > 20


def test_build_repeats():
    rng = np.random.default_rng(5)
    rep = rng.integers(0, 4, 300, dtype=np.uint8)
    parts = [rng.integers(0, 4, 600, dtype=np.uint8) for _ in range(4)]
    genome = np.concatenate([parts[0], rep, parts[1], rep, parts[2], rep,
                             parts[3]])
    reads, lengths = jt.sim_reads(genome, coverage=12, read_len=80, seed=6)
    assert _both(reads, lengths, 21).n_e > 2


def test_build_circular_unitig():
    """A circular genome is one pure cycle per strand: _break_cycles."""
    g = jt.random_genome(3_000, seed=31)
    g = np.concatenate([g, g[:79]])
    reads, lengths = jt.sim_reads(g, coverage=10, read_len=80, seed=32)
    gj = _both(reads, lengths, 21)
    assert gj.n_e == 2


def test_build_palindrome_and_homopolymer():
    """A palindromic (k+1)-mer puts its two directed lanes on one source
    key, and a poly-A run longer than k makes a k-edge its own successor
    (the self-successor guard)."""
    rng = np.random.default_rng(7)
    k = 21
    half = rng.integers(0, 4, (k + 1) // 2, dtype=np.uint8)
    pal = np.concatenate([half, (3 - half)[::-1]])       # rc(pal) == pal
    genome = np.concatenate([rng.integers(0, 4, 400, dtype=np.uint8), pal,
                             rng.integers(0, 4, 400, dtype=np.uint8),
                             np.zeros(40, np.uint8),
                             rng.integers(0, 4, 400, dtype=np.uint8)])
    reads, lengths = jt.sim_reads(genome, coverage=15, read_len=90, seed=8)
    _both(reads, lengths, k)


def test_build_head_cap_retry():
    """The JAX build overflows a 512-unitig head table and retries wider
    (560 unitigs); the port sizes its arrays from the data."""
    g = jt.random_genome(2_000, seed=43)
    reads, lengths = jt.sim_reads(g, coverage=8, read_len=100, seed=44,
                                  error_rate=0.01)
    gj = _both(reads, lengths, 31, head_cap=512)
    assert gj.n_e > 512


def test_build_empty_table():
    g = tdb.build_graph_on_device(torch.zeros((0, 2), dtype=torch.int64),
                                  torch.zeros(0, dtype=torch.int32), 0, 31,
                                  device="cpu")
    assert g.n_e == 0 and g.n_v == 0
