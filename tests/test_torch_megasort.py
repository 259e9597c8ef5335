"""Port parity: kmer/megasort.py of turingassembler_tpu_torch against the
JAX package's count on the same reads.

Tolerance: exact equality of (uniq[:n], counts[:n], n).  The JAX table
is sentinel-padded to a capacity; the port's is sized to n.
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.kmer import megasort as jms
from turingassembler_tpu_torch.kmer import megasort as tms

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _reads(seed, genome=12_000, coverage=6, read_len=100, err=0.004,
           pad_to=None):
    g = jt.random_genome(genome, seed=seed)
    reads, lengths = jt.sim_reads(g, coverage=coverage, read_len=read_len,
                                  seed=seed + 1, error_rate=err,
                                  pad_to=pad_to)
    return reads, lengths.astype(np.int32)


def _jax_table(reads, lengths, k, **kw):
    kw.setdefault("out_cap_log2", 17)
    u, c, n = jms.count_reads_device(reads, lengths, k, chunk_reads=512, **kw)
    return (jms.pull_rows(u, n).astype(np.int64),
            jms.pull_rows(c, n).astype(np.int64), n)


def _assert_same(jax_tab, port_tab):
    ju, jc, jn = jax_tab
    tu, tc, tn = port_tab
    assert jn == tn
    np.testing.assert_array_equal(ju, tu[:tn].numpy())
    np.testing.assert_array_equal(jc, tc[:tn].numpy().astype(np.int64))


def test_count_reads_device_k45():
    reads, lengths = _reads(11, pad_to=104)
    _assert_same(_jax_table(reads, lengths, 45),
                 tms.count_reads_device(reads, lengths, 45, chunk_reads=512,
                                        device="cpu"))


@pytest.mark.parametrize("k", [31, 63])
def test_count_validity_key_widths_with_all_t_read(k):
    """2(k+1) % 32 == 0: the all-T (k+1)-mer equals the JAX package's
    sentinel.  Plus N bases and truncated reads (invalid lanes)."""
    reads, lengths = _reads(12 + k, genome=6_000)
    reads[0, :100] = 3
    reads[1, :100] = 3
    reads[2, 40] = 4
    reads[3, 70:] = 255
    lengths[3] = 70
    jax_tab = _jax_table(reads, lengths, k)
    # the all-T windows count under their canonical form, all-A
    assert (jax_tab[0][0] == 0).all() and jax_tab[1][0] >= 2 * (100 - k)
    _assert_same(jax_tab, tms.count_reads_device(reads, lengths, k,
                                                 device="cpu"))


def test_count_two_flush_windows_merge():
    reads, lengths = _reads(13, genome=8_000)
    jax_tab = _jax_table(reads, lengths, 45, flush_lanes=20_000)
    port = tms.count_reads_device(reads, lengths, 45, chunk_reads=128,
                                  flush_lanes=20_000, device="cpu")
    _assert_same(jax_tab, port)


def test_count_flush_windows_share_keys():
    """Every window holds the same reads' k-mers, so the merge must sum
    counts of keys present in both runs."""
    reads, lengths = _reads(14, genome=3_000, coverage=4, err=0.0)
    reads = np.concatenate([reads, reads, reads])
    lengths = np.concatenate([lengths, lengths, lengths])
    window = len(reads) // 3
    port = tms.count_reads_device(reads, lengths, 31, chunk_reads=window,
                                  flush_lanes=1, device="cpu")
    _assert_same(_jax_table(reads, lengths, 31), port)
    one = tms.count_reads_device(reads[:window], lengths[:window], 31,
                                 device="cpu")
    np.testing.assert_array_equal(port[1].numpy(), 3 * one[1].numpy())


def test_count_out_cap_overflow_retry():
    """The JAX count overflows a 2^10 output table and retries wider; the
    port sizes its table from the data and must give the same table."""
    reads, lengths = _reads(15, genome=20_000, err=0.01)
    jax_tab = _jax_table(reads, lengths, 45, out_cap_log2=10)
    assert jax_tab[2] > 4 * 1024
    _assert_same(jax_tab, tms.count_reads_device(reads, lengths, 45,
                                                 device="cpu"))


def test_filter_min_count_device():
    import jax.numpy as jnp
    reads, lengths = _reads(16, genome=6_000, err=0.02)
    u, c, n = jms.count_reads_device(reads, lengths, 45, chunk_reads=512,
                                     out_cap_log2=17)
    fu, fc, fn = jms._filter_min_count_device(u, c, jnp.asarray(n, jnp.int32),
                                              2)
    fn = int(fn)
    tu, tc, tn = tms.count_reads_device(reads, lengths, 45, device="cpu")
    gu, gc = tms._filter_min_count_device(tu, tc, 2)
    assert 0 < fn < n and gu.shape[0] == fn
    np.testing.assert_array_equal(np.asarray(fu)[:fn].astype(np.int64),
                                  gu.numpy())
    np.testing.assert_array_equal(np.asarray(fc)[:fn], gc.numpy())


@pytest.mark.parametrize("min_count", [1, 2])
def test_count_kedges_megasort_batches(min_count):
    reads, lengths = _reads(17, genome=8_000, err=0.01)

    def batches():
        for i in range(0, len(reads), 300):
            yield reads[i:i + 300], lengths[i:i + 300]

    jk, jc = jms.count_kedges_megasort(batches(), 31, min_count=min_count,
                                       max_lanes=1 << 14)
    tk, tc = tms.count_kedges_megasort(batches(), 31, min_count=min_count,
                                       max_lanes=1 << 14, device="cpu")
    assert tk.dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(jk), tk)
    np.testing.assert_array_equal(np.asarray(jc, np.int64), tc)
    du, dc, dn = tms.count_kedges_megasort_device(batches(), 31,
                                                  min_count=min_count,
                                                  device="cpu")
    assert dn == len(tk)
    np.testing.assert_array_equal(du.numpy(), tk.astype(np.int64))


def test_return_chunks_reuse():
    reads, lengths = _reads(18, genome=5_000)
    u0, c0, n0, shipped = tms.count_reads_device(reads, lengths, 45,
                                                 return_chunks=True,
                                                 device="cpu")
    assert shipped[0].dtype == torch.uint8 and shipped[0].shape == reads.shape
    u1, c1, n1 = tms.count_reads_device(None, None, 45, shipped=shipped,
                                        device="cpu")
    assert n0 == n1
    assert torch.equal(u0, u1) and torch.equal(c0, c1)
