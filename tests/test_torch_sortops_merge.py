"""The port's device sort and merge (ops/sortops.py device half,
ops/merge.py) against the JAX package's on the same seeded inputs.

Keys are drawn from a small alphabet so that runs repeat; limbs go to the
port as int64 values, to JAX as uint32.  Tolerance: exact equality of
whole arrays, the JAX padding included (unique_counts' trash slot N-1,
zero counts and SENTINEL rows past n_unique), and of n_unique.
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu.ops import merge as jmerge
from turingassembler_tpu.ops import sortops as jso
from turingassembler_tpu_torch.ops import merge as tmerge
from turingassembler_tpu_torch.ops import sortops as tso

torch.set_num_threads(1)

SENT = 0xFFFFFFFF


def T(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)


def same(jax_arr, t):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.numpy())


def keys(rng, n, nl, alphabet=6):
    return rng.integers(0, alphabet, (n, nl)).astype(np.uint32)


def sorted_unique(rng, n, nl, alphabet=6):
    """n sorted unique keys, a random subset of the drawn ones."""
    u = np.unique(keys(rng, 3 * n + 1, nl, alphabet), axis=0)
    return u[np.sort(rng.choice(len(u), min(n, len(u)), replace=False))]


def padded_run(rng, cap, n, nl):
    """A sorted unique run of n keys, SENTINEL-padded to cap rows, with
    counts 1..8 and 0 on the padding."""
    k = sorted_unique(rng, n, nl, alphabet=20)
    out = np.full((cap, nl), SENT, np.uint32)
    out[:len(k)] = k
    c = np.zeros(cap, np.int32)
    c[:len(k)] = rng.integers(1, 9, len(k))
    return out, c


@pytest.mark.parametrize("N,nl,p_valid", [(1000, 3, 0.8), (257, 1, 0.5),
                                          (64, 2, 1.0), (9, 7, 0.0),
                                          (1, 2, 1.0)])
def test_sort_unique_count(N, nl, p_valid):
    rng = np.random.default_rng(N + nl)
    x = keys(rng, N, nl)
    v = rng.random(N) < p_valid
    ju, jc, jn = jso.sort_unique_count(x, v)
    tu, tc, tn = tso.sort_unique_count(T(x), torch.from_numpy(v))
    same(ju, tu)
    same(jc, tc)
    assert int(jn) == int(tn)


def test_sort_by_limbs_and_unique_counts():
    rng = np.random.default_rng(3)
    x = keys(rng, 500, 2)
    w = rng.integers(1, 5, 500).astype(np.int32)
    js, jw = jso.sort_by_limbs(x, w)
    ts, tw = tso.sort_by_limbs(T(x), T(w))
    same(js, ts)
    same(jso.run_starts(js), tso.run_starts(ts))
    # equal keys may carry other weights in another order: compare sums
    ju, jc, jn = jso.unique_counts(js, weights=jw)
    tu, tc, tn = tso.unique_counts(ts, weights=tw)
    same(ju, tu)
    same(jc, tc)
    assert int(jn) == int(tn) == len(np.unique(x, axis=0))
    ju, jc, jn = jso.unique_counts(js)
    tu, tc, tn = tso.unique_counts(ts)
    same(ju, tu)
    same(jc, tc)


@pytest.mark.parametrize("M", [1, 2, 37, 500])
def test_searchsorted_limbs(M):
    rng = np.random.default_rng(M)
    table = sorted_unique(rng, M, 3, alphabet=16)
    assert len(table) == M
    q = np.concatenate([table[rng.integers(0, M, 200)],      # hits
                        keys(rng, 200, 3, alphabet=9)])       # mostly misses
    ji, jf = jso.searchsorted_limbs(table, q)
    ti, tf = tso.searchsorted_limbs(T(table), T(q))
    same(ji, ti)
    same(jf, tf)
    assert tf[:200].all() and not tf[200:].all()


def test_searchsorted_limbs_empty_table():
    """M = 0: the JAX gather refuses an empty table; the port finds
    nothing (count_span never asks, in either package)."""
    q = np.zeros((5, 2), np.uint32)
    with pytest.raises(TypeError):
        jso.searchsorted_limbs(np.zeros((0, 2), np.uint32), q)
    idx, found = tso.searchsorted_limbs(torch.zeros((0, 2), dtype=torch.int64),
                                        T(q))
    assert idx.shape == (5,) and not found.any()


@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_in(side):
    rng = np.random.default_rng(11)
    a, _ = padded_run(rng, 50, 30, 2)
    b, _ = padded_run(rng, 40, 35, 2)
    same(jmerge.rank_in(a, b, side), tmerge.rank_in(T(a), T(b), side))
    same(jmerge.rank_in(b, a, side), tmerge.rank_in(T(b), T(a), side))


@pytest.mark.parametrize("n,nu,m,mu,nl", [(40, 25, 30, 20, 2),
                                          (16, 16, 16, 0, 3),
                                          (8, 0, 8, 0, 1),
                                          (64, 63, 1, 1, 2)])
def test_merge_runs(n, nu, m, mu, nl):
    rng = np.random.default_rng(n * m + nl)
    a, ca = padded_run(rng, n, nu, nl)
    b, cb = padded_run(rng, m, mu, nl)
    jk, jc, jn = jmerge.merge_runs(a, ca, b, cb)
    tk, tc, tn = tmerge.merge_runs(T(a), T(ca), T(b), T(cb))
    same(jk, tk)
    same(jc, tc)
    assert int(jn) == int(tn)


def test_device_count_accumulator_37_runs():
    rng = np.random.default_rng(37)
    jacc, tacc = jmerge.DeviceCountAccumulator(), tmerge.DeviceCountAccumulator()
    for i in range(37):
        k, c = padded_run(rng, 32, int(rng.integers(0, 33)), 2)
        jacc.add_run(k, c)
        tacc.add_run(T(k), T(c))
    assert [r[0].shape[0] for r in tacc.runs] == \
        [r[0].shape[0] for r in jacc.runs]
    jk, jc = jacc.finalize()
    tk, tc = tacc.finalize()
    assert tk.dtype == jk.dtype and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert len(tk) > 100
    assert tmerge.DeviceCountAccumulator().finalize()[0].shape == (0, 0)
