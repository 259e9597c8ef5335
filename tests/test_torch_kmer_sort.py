"""Port parity: ops/kmer_sort.py (the count's device program, the kernels
of csrc/kmer_sort.cu) on the CPU against the JAX package's count on the
same seeded reads, and the host side of the card's sort.

On the CPU every entry runs its plain version; the card's kernels are held
against those by chip_smoke.py.  Here:
  - extract_keys == JAX megasort._extract_chunk's valid lanes, sort_count
    == JAX _sort_count, merge_runs == JAX _merge_unique_runs, at k = 30,
    45, 63 (nl 2, 3, 4), on records with N bases, truncated reads, an
    all-T read and a one-window read, on a record with no valid window
    and on an empty one;
  - digit_plan takes every bit of the rows once; on k1-mer rows, for
    every k1 in 2..64, the passes that the single-bucket skip keeps are
    exactly the ceil(2 * k1 / 8) digits over the 2 * k1 used bits; a
    numpy model of the radix passes by that plan, single-bucket passes
    skipped, orders testing.kmer_sort_cases as numpy's lexsort;
  - sort_count, merge_runs and lex_order on kmer_sort_cases against numpy;
    lex_order keeps ties in input order;
  - no CPU call reaches the kernel build, and a tensor off the CPU never
    reaches a plain version (meta tensors, the build stubbed to raise),
    through the entries or the callers of lex_order.
Tolerance: exact equality everywhere (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.kmer import megasort as jms
from turingassembler_tpu.ops import kmers as jkm
from turingassembler_tpu_torch import _build
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.kmer import megasort as tms
from turingassembler_tpu_torch.ops import kmer_sort as ks
from turingassembler_tpu_torch.ops import limbs as tl
from turingassembler_tpu_torch.ops import sortops as tso

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

KS = (30, 45, 63)
L = 152


def _record(k, seed, n=48):
    """A record of n reads of width L with the count's edge cases: N
    bases, truncated reads (255 past their length), an all-T read and a
    read with exactly one window."""
    g = jt.random_genome(4_000, seed=seed)
    reads, lengths = jt.sim_reads(g, coverage=2, read_len=150,
                                  seed=seed + 1, error_rate=0.01, pad_to=L)
    reads, lengths = reads[:n].copy(), lengths[:n].astype(np.int32)
    rng = np.random.default_rng(seed)
    reads[rng.random(reads.shape) < 0.004] = 4
    reads[0, :150] = 3
    lengths[0] = 150
    for r, cut in ((1, 70), (2, k + 1), (3, k)):   # k + 1: one window
        reads[r, cut:] = 255
        lengths[r] = cut
    return reads, lengths


def _jax_rows(reads, lengths, k1):
    """JAX _extract_chunk's lanes, the valid ones in lane order, and the
    columns and n_valid as the JAX sort takes them."""
    cols, n_valid = jms._extract_chunk(jnp.asarray(reads),
                                       jnp.asarray(lengths), k1)
    _, _, valid = jkm.extract_canonical_kmers(jnp.asarray(reads),
                                              jnp.asarray(lengths), k1)
    lanes = np.stack([np.asarray(c) for c in cols], axis=1)
    return lanes[np.asarray(valid).reshape(-1)], cols, n_valid


def _jax_sort_count(cols, n_valid, k1):
    u, c, n = jms._sort_count(cols, n_valid, cols[0].shape[0], k1)
    n = int(n)
    return np.asarray(u)[:n].astype(np.int64), np.asarray(c)[:n]


def _port(x):
    return tuple(t.numpy() for t in x)


@pytest.mark.parametrize("k", KS)
def test_extract_sort_merge_equal_jax(k):
    k1 = k + 1
    reads, lengths = _record(k, seed=k)
    rows_j, cols, n_valid = _jax_rows(reads, lengths, k1)
    rows = ks.extract_keys(torch.as_tensor(reads), torch.as_tensor(lengths),
                           k1)
    assert rows.dtype == torch.int64 and int(n_valid) == rows.shape[0]
    np.testing.assert_array_equal(rows.numpy(), rows_j.astype(np.int64))
    assert tms._extract_chunk(torch.as_tensor(reads),
                              torch.as_tensor(lengths), k1).equal(rows)

    uj, cj = _jax_sort_count(cols, n_valid, k1)
    u, c = _port(ks.sort_count(rows))
    np.testing.assert_array_equal(u, uj)
    np.testing.assert_array_equal(c, cj)
    # the all-T read's windows count under their canonical form, all-A
    assert (u[0] == 0).all() and c[0] >= 150 - k

    # two halves' tables, merged
    half = len(reads) // 2
    tabs_j, tabs = [], []
    for sl in (slice(0, half), slice(half, None)):
        _, cols_h, nv_h = _jax_rows(reads[sl], lengths[sl], k1)
        cap = cols_h[0].shape[0]
        u_h, c_h, _ = jms._sort_count(cols_h, nv_h, cap, k1)
        tabs_j += [u_h, c_h]
        tabs += list(ks.sort_count(ks.extract_keys(
            torch.as_tensor(reads[sl]), torch.as_tensor(lengths[sl]), k1)))
    um, cm, nm = jms._merge_unique_runs(*tabs_j, tabs_j[0].shape[0]
                                        + tabs_j[2].shape[0])
    nm = int(nm)
    u2, c2 = _port(ks.merge_runs(*tabs))
    np.testing.assert_array_equal(u2, np.asarray(um)[:nm].astype(np.int64))
    np.testing.assert_array_equal(c2, np.asarray(cm)[:nm])
    np.testing.assert_array_equal(u2, u)           # == one count of both
    np.testing.assert_array_equal(c2, c)


@pytest.mark.parametrize("k", KS)
def test_record_without_windows(k):
    """No valid window (every read shorter than k + 1, or all N), and an
    empty record: no rows, an empty table, on both packages' terms."""
    k1 = k + 1
    reads, lengths = _record(k, seed=100 + k, n=8)
    lengths[:] = np.minimum(lengths, k)
    reads[4:, :] = 4
    lengths[4:] = L
    rows_j, cols, n_valid = _jax_rows(reads, lengths, k1)
    assert int(n_valid) == 0 and rows_j.shape == (0, tl.n_limbs(k1))
    rows = ks.extract_keys(torch.as_tensor(reads), torch.as_tensor(lengths),
                           k1)
    assert rows.shape == (0, tl.n_limbs(k1))
    uj, cj = _jax_sort_count(cols, n_valid, k1)
    u, c = _port(ks.sort_count(rows))
    assert uj.shape == u.shape == (0, tl.n_limbs(k1)) and len(cj) == len(c)
    empty = ks.extract_keys(torch.zeros((0, L), dtype=torch.uint8),
                            torch.zeros(0, dtype=torch.int32), k1)
    assert empty.shape == (0, tl.n_limbs(k1))
    u, c = ks.merge_runs(empty, torch.zeros(0, dtype=torch.int32), empty,
                         torch.zeros(0, dtype=torch.int32))
    assert u.shape == (0, tl.n_limbs(k1)) and c.dtype == torch.int32


def _live_passes(keys, plan):
    """The passes of the plan that the card runs on these rows: those
    whose digit takes two values or more."""
    return [p for p, (limb, shift, width) in enumerate(plan)
            if len(np.unique((keys[:, limb] >> shift)
                             & ((1 << width) - 1))) > 1]


@pytest.mark.parametrize("k1", list(range(2, 65)))
def test_digit_plan_covers_the_used_bits(k1):
    nl = tl.n_limbs(k1)
    plan = ks.digit_plan(nl)
    seen = []
    for limb, shift, width in plan:
        assert 1 <= width <= ks.RADIX_BITS and 0 <= shift <= 32 - width
        # bit b of limb l is key bit 32 * l + (31 - b), counted from the top
        seen += [32 * limb + 31 - b for b in range(shift, shift + width)]
    assert sorted(seen) == list(range(32 * nl))          # each once
    # least significant digit first: each pass's bits above the last's
    tops = [min(32 * limb + 31 - b for b in range(shift, shift + width))
            for limb, shift, width in plan]
    assert tops == sorted(tops, reverse=True)
    # on k1-mer rows (the bits past 2 * k1 are 0) the skip keeps exactly
    # the digits that hold a used bit, ceil(2 * k1 / 8) of them
    used = [p for p, (limb, shift, width) in enumerate(plan)
            if 32 * limb + 31 - (shift + width - 1) < 2 * k1]
    assert len(used) == -(-2 * k1 // 8)
    rows = np.random.default_rng(k1).integers(0, 1 << 32, (256, nl))
    last = 2 * k1 - 32 * (nl - 1)                # used bits of the last limb
    rows[:, -1] &= ((1 << last) - 1) << (32 - last)
    assert _live_passes(rows, plan) == used
    assert _radix_model(rows, plan).tolist() == _np_lexsort(rows).tolist()


def _radix_model(keys, plan):
    """The card's passes in numpy: a stable sort by each digit, least
    significant first, a digit with one bucket skipped."""
    order = np.arange(len(keys))
    for limb, shift, width in plan:
        d = (keys[order, limb] >> shift) & ((1 << width) - 1)
        if len(np.unique(d)) > 1:
            order = order[np.argsort(d, kind="stable")]
    return order


CASES = tt.kmer_sort_cases()


def _np_lexsort(keys):
    return np.lexsort(tuple(keys[:, l] for l in range(keys.shape[1] - 1,
                                                       -1, -1)))


@pytest.mark.parametrize("name", list(CASES))
def test_kmer_sort_cases_against_numpy(name):
    keys, w = CASES[name]
    nl = keys.shape[1]
    order = _np_lexsort(keys)
    np.testing.assert_array_equal(
        _radix_model(keys, ks.digit_plan(nl)), order)
    t = torch.as_tensor(keys)
    np.testing.assert_array_equal(ks.lex_order(t).numpy(), order)
    np.testing.assert_array_equal(tl.plain_lex_order(t).numpy(), order)
    uniq, inv, cnt = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    u, c = _port(ks.sort_count(t))
    np.testing.assert_array_equal(u, uniq)
    np.testing.assert_array_equal(c, cnt)
    half = len(keys) // 2
    wsum = np.zeros(len(uniq), np.int64)
    np.add.at(wsum, inv.reshape(-1), w)
    u, c = _port(ks.merge_runs(t[:half], torch.as_tensor(w[:half]),
                               t[half:], torch.as_tensor(w[half:])))
    np.testing.assert_array_equal(u, uniq)
    np.testing.assert_array_equal(c, wsum)


def test_lex_order_stable_with_ties():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 3, (5_000, 3)).astype(np.int64) * 0x7FFFFFFF
    perm = tl.plain_lex_order(torch.as_tensor(keys)).numpy()
    np.testing.assert_array_equal(perm, _np_lexsort(keys))
    # the int32 bit patterns of the same limbs sort as unsigned
    i32 = torch.as_tensor(keys.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(ks.lex_order(i32).numpy(), perm)


def _stub_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached")
    for name in ("build", "load", "_nvcc"):
        monkeypatch.setattr(_build, name, refuse)
    return refuse


def test_cpu_never_builds(monkeypatch):
    _stub_build(monkeypatch)
    reads, lengths = _record(45, seed=3, n=16)
    rows = ks.extract_keys(torch.as_tensor(reads), torch.as_tensor(lengths),
                           46)
    u, c = ks.sort_count(rows)
    ks.merge_runs(u, c, u, c)
    ks.lex_order(rows)
    uc, cc, n = tms.count_reads_device(reads, lengths, 45, flush_lanes=500,
                                       device="cpu")
    assert n == len(u) and torch.equal(uc, u) and torch.equal(cc, c)
    assert ks.COUNT.launches == 0


def test_off_cpu_tensors_go_to_the_kernel(monkeypatch):
    """A tensor that is not on the CPU is the kernel's (here the stubbed
    build raises): no entry hands it to its plain version."""
    _stub_build(monkeypatch)
    meta = torch.device("meta")
    rows = torch.zeros((10, 3), dtype=torch.int64, device=meta)
    cnt = torch.zeros(10, dtype=torch.int32, device=meta)
    calls = [
        lambda: ks.extract_keys(torch.zeros((4, L), dtype=torch.uint8,
                                            device=meta),
                                torch.zeros(4, dtype=torch.int32,
                                            device=meta), 46),
        lambda: ks.sort_count(rows),
        lambda: ks.merge_runs(rows, cnt, rows, cnt),
        lambda: ks.lex_order(rows),
        lambda: tso.sort_by_limbs(rows),
    ]
    for call in calls:
        with pytest.raises(AssertionError, match="kernel build"):
            call()
    # rows wider than the kernels take are refused before any build
    with pytest.raises(ValueError, match="nl <= 4"):
        ks.sort_count(torch.zeros((3, ks.MAX_NL + 1), dtype=torch.int64,
                                  device=meta))
