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
    through the entries or the callers of lex_order;
  - a tensor-code model of the card's sort_count route (the load's live
    digits, sort_plan, the partition passes, the bucket bounds,
    bucket_groups, the bucket kernel's distinct rows, their places by
    counting or by passes, their counts, the batched route for the
    buckets over capacity (gathered in group order, sorted as one
    segment, one run pass, each run placed back by its group),
    compaction) == JAX _sort_count on
    kmer_sort_cases and on extracted reads at k = 15, 31, 45, 63, at the
    kernel's block capacity and at a tiny one (both routes run);
    sort_plan for k1 in 2..64 at n below and above each digit threshold;
    bucket_groups' groups within capacity and one 256-bucket block;
  - a numpy model of the card's extraction (each read packed once into
    2-bit words with their reverse complements, a window's limbs by
    funnel shifts, validity from the invalid-base words) == JAX
    _extract_chunk on reads with code-4 bases, lengths under k1 and L no
    multiple of 16;
  - a tensor-code model of the card's lex_order route (the live digits,
    lex_plan, the partition passes carrying the index, the bounds, each
    bucket ranked by counting by a warp, on packed 64-bit keys when the
    digits below the partition fit, or by a block, counting or LSD
    passes, the LSD route over capacity) == JAX lax.sort((cols...,
    iota), num_keys=nl) on kmer_sort_cases and a small level-0 build's
    fingerprints, at the kernel's sizes and at tiny ones (every route
    runs); lex_plan for k1 in 2..64;
  - a tensor-code model of the card's merge_runs merge path (the tile
    borders' splits, each tile merged with ka's rows first on ties, runs
    marked across tile borders, the counts' prefix at each run, the order
    check) == JAX _merge_unique_runs on two halves' tables and == numpy
    on ascending inputs with runs longer than a tile of 64 rows, an empty
    side, one input below the other; the order check picks the LSD route
    for a descent inside a tile or at a tile border, the merge path for
    ascending inputs with or without equal rows;
  - on the card (skipped without one; it uses no JAX): sort_count on the
    yeast cell's shape of buckets over capacity == plain_sort_count, and
    the route's host syncs the same for 10 such buckets as for 2,000.
Mirror any edit of csrc/kmer_sort.cu's extraction, bucket, lex or merge
route in the models here.  Tolerance: exact equality everywhere
(integers).
"""

import functools

import jax
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


# ---------------------------------------------------------------------------
# the card's sort_count route, modelled in tensor code
# ---------------------------------------------------------------------------

def _digit(rows, plan, p):
    limb, shift, width = plan[p]
    return (rows[:, limb] >> shift) & ((1 << width) - 1)


def _live(rows, plan):
    """load_hist_kernel's histogram read as the host reads it: whether
    each digit takes two values or more."""
    return [len(torch.unique(_digit(rows, plan, p))) > 1
            for p in range(len(plan))]


def _lsd_order(rows, plan, passes):
    """Stable passes by each digit, least significant first (the LSD pass
    kernels, and bucket_kernel's passes over its list of row indices):
    the permutation."""
    order = torch.arange(len(rows))
    for p in passes:
        order = order[torch.argsort(_digit(rows[order], plan, p),
                                    stable=True)]
    return order


def _lsd(rows, plan, passes):
    return rows[_lsd_order(rows, plan, passes)]


# distinct rows of a group the bucket kernel places by counting
# (csrc/kmer_sort.cu:RANK_SORT)
RANK_SORT = 512


def _rank_order(rows):
    """Each distinct row's place: the number of rows before it."""
    lt = torch.zeros((len(rows), len(rows)), dtype=torch.bool)
    eq = torch.ones_like(lt)
    for limb in range(rows.shape[1]):
        a, b = rows[:, limb][:, None], rows[:, limb][None, :]
        lt |= eq & (a < b)
        eq &= a == b
    order = torch.empty(len(rows), dtype=torch.int64)
    order[lt.sum(dim=0)] = torch.arange(len(rows))
    return order


def _distinct(rows):
    """bucket_kernel's hash table: each distinct row once, with its count,
    listed as first seen (the kernel's list order is any)."""
    uq, inv, cnt = torch.unique(rows, dim=0, return_inverse=True,
                                return_counts=True)
    first = torch.full((len(uq),), len(rows)).scatter_reduce(
        0, inv, torch.arange(len(rows)), "amin")
    o = torch.argsort(first)
    return uq[o], cnt[o].to(torch.int32)


def _model_runs(s):
    """The run pass: (each run's key, its rows, its first row)."""
    new = torch.ones(len(s), dtype=torch.bool)
    new[1:] = (s[1:] != s[:-1]).any(dim=1)
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([len(s)])])
    return s[starts], (ends - starts).to(torch.int32), starts


def model_sort_count(keys, cap):
    """ops/kmer_sort.py:sort_count on a card, in tensor code, with a block
    capacity cap: (uniq, counts, routes)."""
    rows = torch.as_tensor(np.asarray(keys, dtype=np.int64))
    n, nl = rows.shape
    plan = ks.digit_plan(nl)
    part, rest = ks.sort_plan(_live(rows, plan), n, cap)
    rows = _lsd(rows, plan, part)                     # the partition passes
    if part:                                          # bounds_kernel
        prefix = torch.zeros(n, dtype=torch.int64)
        for p in reversed(part):
            prefix = prefix * ks.RADIX + _digit(rows, plan, p)
        starts = torch.searchsorted(
            prefix, torch.arange(ks.RADIX ** len(part) + 1))
        gs = ks.bucket_groups(starts.numpy(), cap)
    else:
        gs = np.array([0, n])
    routes = dict.fromkeys(ks.ROUTES["sort_count"], 0)
    routes["partition_passes"] = len(part)
    runs = {}                                 # a group's (keys, counts)
    over = []                                 # the groups over capacity
    for g in range(len(gs) - 1):
        seg = rows[gs[g]:gs[g + 1]]
        if len(seg) > cap:                    # left to the batched route
            over.append(g)
            routes["over_capacity"] += 1
            continue
        routes["bucket_groups"] += 1
        if len(seg) == 0:                             # no runs
            continue
        passes = list(rest)                           # bucket_kernel
        if part and _digit(seg[:1], plan, rest[-1]).item() == \
                _digit(seg[-1:], plan, rest[-1]).item():
            passes = passes[:-1]              # one bucket: the last pass goes
        dist, c = _distinct(seg)
        o = _rank_order(dist) if len(dist) <= RANK_SORT \
            else _lsd_order(dist, plan, passes)
        runs[g] = dist[o], c[o]
    if over:
        # the batched route: the groups over capacity gathered in group
        # order (gather_kernel), sorted as one segment on its live digits
        # (the LSD pass kernels), one run pass, each run back to the group
        # whose rows hold its first row (place_runs_kernel)
        off = np.cumsum([0] + [gs[g + 1] - gs[g] for g in over])
        seg = torch.cat([rows[gs[g]:gs[g + 1]] for g in over])
        live = _live(seg, plan)
        u, c, first = _model_runs(
            _lsd(seg, plan, [p for p in range(len(plan)) if live[p]]))
        # no run crosses a group: each group's first row starts a run
        assert set(off[:-1].tolist()) <= set(first.tolist())
        group = np.searchsorted(off, first.numpy(), side="right") - 1
        for j, g in enumerate(over):
            runs[g] = u[group == j], c[group == j]
    if not runs:
        return (torch.zeros((0, nl), dtype=torch.int64),
                torch.zeros(0, dtype=torch.int32), routes)
    # compaction: each group's runs, in group order
    return (torch.cat([runs[g][0] for g in sorted(runs)]),
            torch.cat([runs[g][1] for g in sorted(runs)]), routes)


@functools.lru_cache(maxsize=None)
def _jax_case_table(name):
    keys, _ = CASES[name]
    nl = keys.shape[1]
    cols = tuple(jnp.asarray(keys[:, l].astype(np.uint32)) for l in range(nl))
    return _jax_sort_count(cols, jnp.int32(len(keys)), 16 * nl)


TINY_CAP = 256


@pytest.mark.parametrize("cap", ["kernel", "tiny"])
@pytest.mark.parametrize("name", list(CASES))
def test_sort_count_model_on_cases_equals_jax(name, cap):
    keys, _ = CASES[name]
    nl = keys.shape[1]
    c = ks.BUCKET_CAPACITY[nl] if cap == "kernel" else TINY_CAP
    u, cnt, routes = model_sort_count(keys, c)
    uj, cj = _jax_case_table(name)
    np.testing.assert_array_equal(u.numpy(), uj)
    np.testing.assert_array_equal(cnt.numpy(), cj)
    assert routes["partition_passes"] <= ks.MAX_PARTITION
    # each case reaches the route it is named for at the kernel's capacity
    if cap == "kernel" and name == "one prefix over the capacity":
        assert routes["over_capacity"] == 1 and routes["partition_passes"]
    if cap == "kernel" and name == "all equal, large":
        assert routes == {"partition_passes": 0, "bucket_groups": 0,
                          "over_capacity": 1}
    if cap == "kernel" and name == "canonical-skewed prefixes":
        assert routes["over_capacity"] == 0 and routes["bucket_groups"] > 1
    # every prefix's repeated row puts its bucket over capacity, at both
    if name == "many prefixes over the capacity":
        assert routes["over_capacity"] == tt.OVER_CAPACITY_CASE[0]
        assert routes["partition_passes"] == 2
    # at the tiny capacity these take both routes (tiers of frequent keys)
    if cap == "tiny" and name in ("all ones, nl=2", "all ones, nl=4",
                                  "one prefix over the capacity"):
        assert routes["bucket_groups"] and routes["over_capacity"]


@pytest.mark.parametrize("cap", ["kernel", "tiny"])
@pytest.mark.parametrize("k", (15, 31, 45, 63))
def test_sort_count_model_on_reads_equals_jax(k, cap):
    k1 = k + 1
    reads, lengths = _record(k, seed=200 + k)
    rows_j, cols, n_valid = _jax_rows(reads, lengths, k1)
    # a record's 5,000 rows: 64 a block puts the all-T read's rows over
    c = ks.BUCKET_CAPACITY[tl.n_limbs(k1)] if cap == "kernel" else 64
    u, cnt, routes = model_sort_count(rows_j.astype(np.int64), c)
    uj, cj = _jax_sort_count(cols, n_valid, k1)
    np.testing.assert_array_equal(u.numpy(), uj)
    np.testing.assert_array_equal(cnt.numpy(), cj)
    if cap == "tiny":        # the all-T read's 150 - k all-A rows: over
        assert routes["over_capacity"] and routes["bucket_groups"]


@pytest.mark.parametrize("k1", list(range(2, 65)))
def test_sort_plan(k1):
    nl = tl.n_limbs(k1)
    plan = ks.digit_plan(nl)
    cap = ks.BUCKET_CAPACITY[nl]
    rows = np.random.default_rng(k1).integers(0, 1 << 32, (512, nl))
    last = 2 * k1 - 32 * (nl - 1)
    rows[:, -1] &= ((1 << last) - 1) << (32 - last)
    live = _live(torch.as_tensor(rows), plan)
    msd = [p for p in range(len(plan) - 1, -1, -1) if live[p]]
    one = cap // 4 * ks.RADIX                 # the mean bucket at one digit
    for n, d in ((1, 0), (cap, 0), (cap + 1, 1), (one, 1), (one + 1, 2),
                 (ks.MAX_ROWS, 2)):
        part, rest = ks.sort_plan(live, n, cap)
        d = min(d, len(msd))
        assert part == sorted(msd[:d]), (n, part)
        below = [p for p in range(len(plan)) if live[p] and p not in part]
        assert rest == below + part[:1]
        # the partition digits are the top live digits: every live digit
        # outside them is less significant
        assert all(p < min(part) for p in below) if part else True
    # no live digit (all rows equal): nothing to partition or sort
    assert ks.sort_plan([False] * len(plan), 10 ** 6, cap) == ([], [])


@pytest.mark.parametrize("d", (1, 2))
def test_bucket_groups(d):
    rng = np.random.default_rng(d)
    cap = 1024
    nb = ks.RADIX ** d
    size = rng.poisson(3 if d == 2 else 300, nb)
    size[rng.integers(0, nb, 20)] = rng.integers(cap // 2, 3 * cap, 20)
    size[rng.integers(0, nb, 200)] = 0
    starts = np.concatenate([[0], np.cumsum(size)])
    gs = ks.bucket_groups(starts, cap)
    assert gs[0] == 0 and gs[-1] == starts[-1] and (np.diff(gs) >= 0).all()
    assert np.isin(gs, starts).all()             # whole buckets
    for a, b in zip(gs[:-1], gs[1:]):
        if a == b:                               # empty: no rows to place
            continue
        first = np.searchsorted(starts, a, side="right") - 1
        last = np.searchsorted(starts, b, side="left") - 1
        while size[first] == 0:                  # empty buckets lead
            first += 1
        # one 256-bucket block of the prefix, and within capacity unless a
        # bucket alone
        assert first // ks.RADIX == last // ks.RADIX
        assert b - a <= cap or first == last, (a, b)
    # few groups are empty (a block's first bucket empty beside a big one)
    assert (np.diff(gs) == 0).sum() < len(gs) // 10


# ---------------------------------------------------------------------------
# the card's extraction, modelled in numpy
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _rev2(x):
    out = np.zeros_like(x)
    for i in range(16):
        out |= ((x >> (2 * i)) & 3) << (30 - 2 * i)
    return out


def _funnel_l(lo, hi, sh):
    """__funnelshift_l: the top 32 bits of (hi:lo) << sh, 0 <= sh < 32."""
    return ((hi << sh) | (lo >> (32 - sh))) & M32


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    return ((lo >> sh) | (hi << (32 - sh))) & M32


def model_extract(reads, lengths, k1):
    """extract_kernel's rows in numpy: (n, nl) int64 limbs in (read,
    window) order."""
    B, L = reads.shape
    nl = tl.n_limbs(k1)
    MW = L // 32 + 2
    PW = 2 * MW + 1
    P = L - k1 + 1
    c = reads.astype(np.int64)
    # word j + 1 of a read: bases 16 j .. 16 j + 15, j = -1 .. 2 MW - 1
    bases = np.zeros((B, 16 * PW), np.int64)
    bases[:, 16:16 + L] = np.where(c < 4, c, 0)
    fw = (bases.reshape(B, PW, 16) << (30 - 2 * np.arange(16))).sum(axis=2)
    rc = _rev2(~fw & M32)
    bad = np.zeros((B, 32 * MW), np.int64)
    bad[:, :L] = c >= 4
    badw = (bad.reshape(B, MW, 32) << np.arange(32)).sum(axis=2)
    p = np.arange(P)
    ok = p[None, :] + k1 <= lengths[:, None]
    for off in range(0, k1, 32):
        q = p + off
        bits = _funnel_r(badw[:, q >> 5], badw[:, (q >> 5) + 1], q & 31)
        ok &= bits & ((1 << min(32, k1 - off)) - 1) == 0
    used = 2 * k1 - 32 * (nl - 1)
    last = (M32 << (32 - used)) & M32
    fl, rl = [], []
    for limb in range(nl):
        qf = p + 16 * limb + 16
        fl.append(_funnel_l(fw[:, (qf >> 4) + 1], fw[:, qf >> 4],
                            2 * (qf & 15)))
        qr = p + k1 - 16 * limb
        rl.append(_funnel_r(rc[:, qr >> 4], rc[:, (qr >> 4) + 1],
                            2 * (qr & 15)))
    fl[-1] &= last
    rl[-1] &= last
    lt = np.zeros((B, P), bool)
    eq = np.ones((B, P), bool)
    for limb in range(nl):
        lt |= eq & (rl[limb] < fl[limb])
        eq &= rl[limb] == fl[limb]
    canon = np.stack([np.where(lt, r, f) for f, r in zip(fl, rl)], axis=2)
    return canon[ok]


def _odd_record(L, k1, seed, n=40):
    """Random reads of width L (no multiple of 16) with code-4 bases, reads
    shorter than k1, truncated reads (255 past their length)."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (n, L)).astype(np.uint8)
    reads[rng.random(reads.shape) < 0.01] = 4
    lengths = np.full(n, L, np.int32)
    lengths[:8] = rng.integers(0, k1, 8)                   # under k1
    lengths[8:16] = rng.integers(k1, L + 1, 8)
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 255
    reads[16, :] = 3                                       # all T
    return reads, lengths


@pytest.mark.parametrize("L", (77, 150))
@pytest.mark.parametrize("k1", (2, 16, 17, 31, 32, 46, 63, 64))
def test_extraction_model_equals_jax(k1, L):
    reads, lengths = _odd_record(L, k1, seed=k1 * 1000 + L)
    rows_j, _, n_valid = _jax_rows(reads, lengths, k1)
    rows = model_extract(reads, lengths, k1)
    assert rows.shape == (int(n_valid), tl.n_limbs(k1))
    np.testing.assert_array_equal(rows, rows_j.astype(np.int64))


# ---------------------------------------------------------------------------
# the card's lex_order route, modelled in tensor code
# ---------------------------------------------------------------------------

def _rank_buckets(rows, first, m):
    """Buckets of m rows each, starting at the rows first (k,): each
    bucket's order by counting, as lex_warp_kernel's warp_rank and
    lex_block_kernel's counting place a row (the rows with a smaller key
    and the equal rows before it): (k, m) positions in the bucket."""
    pos = torch.arange(m)
    out = []
    step = max(1, (1 << 22) // (m * m))
    for c0 in range(0, len(first), step):
        seg = rows[first[c0:c0 + step, None] + pos]             # (k, m, nl)
        lt = torch.zeros((len(seg), m, m), dtype=torch.bool)    # [., j, i]
        eq = torch.ones_like(lt)
        for limb in range(rows.shape[1]):
            a, b = seg[:, :, limb][:, :, None], seg[:, :, limb][:, None, :]
            lt |= eq & (a < b)
            eq &= a == b
        before = (lt | (eq & (pos[:, None] < pos[None, :]))).sum(dim=1)
        order = torch.empty_like(before)
        order.scatter_(1, before, pos.expand(len(seg), m))
        out.append(order)
    return torch.cat(out)


# digits below the partition, at most, that lex_warp_kernel packs into one
# 64-bit word (csrc/kmer_sort.cu:LEX_PACKED)
LEX_PACKED = 7


def _packed_keys(rows, plan, rest, pos):
    """lex_warp_kernel's packed_key: the digits of rest, most significant
    first, in 8-bit slots, then the row's position in its bucket, as the
    64-bit word's (high, low) 32-bit halves."""
    slots = [_digit(rows, plan, p) for p in reversed(rest)] + [pos]
    slots = [torch.zeros_like(pos)] * (8 - len(slots)) + slots
    hi, lo = torch.zeros_like(pos), torch.zeros_like(pos)
    for k in range(4):
        hi = hi * 256 + slots[k]
        lo = lo * 256 + slots[4 + k]
    return torch.stack([hi, lo], dim=1)


def model_lex_order(keys, cap, warp=ks.LEX_WARP):
    """ops/kmer_sort.py:lex_order on a card, in tensor code, with a block
    capacity cap and buckets of up to warp rows ranked by a warp (on
    packed_key words when the digits below the partition are few enough):
    (permutation, routes)."""
    rows = torch.as_tensor(np.asarray(keys, dtype=np.int64))
    n, nl = rows.shape
    plan = ks.digit_plan(nl)
    routes = dict.fromkeys(ks.ROUTES["lex_order"], 0)
    live = _live(rows, plan)
    if not any(live):                           # every row equal
        return torch.arange(n), routes
    part, rest = ks.lex_plan(live, n)
    order = _lsd_order(rows, plan, part)        # the passes carry the index
    rows = rows[order]
    if part:                                    # bounds_kernel
        prefix = torch.zeros(n, dtype=torch.int64)
        for p in reversed(part):
            prefix = prefix * ks.RADIX + _digit(rows, plan, p)
        starts = torch.searchsorted(
            prefix, torch.arange(ks.RADIX ** len(part) + 1))
    else:
        starts = torch.tensor([0, n])
    routes["partition_passes"] = len(part)
    first, size = starts[:-1], starts[1:] - starts[:-1]
    out = torch.empty(n, dtype=torch.int64)
    warp_rows = rows
    if len(rest) <= LEX_PACKED:                 # one compare a pair
        pos = torch.arange(n) - torch.repeat_interleave(first, size)
        warp_rows = _packed_keys(rows, plan, rest, pos)
    for m in torch.unique(size[(size > 0) & (size <= warp)]).tolist():
        f = first[size == m]                    # lex_warp_kernel
        o = _rank_buckets(warp_rows, f, m)
        out[f[:, None] + torch.arange(m)] = order[f[:, None] + o]
        routes["warp_buckets"] += len(f)
    for s, m in zip(first[size > warp].tolist(), size[size > warp].tolist()):
        seg = rows[s:s + m]
        if m <= cap:                            # lex_block_kernel
            o = _rank_buckets(seg, torch.tensor([0]), m)[0] \
                if m <= RANK_SORT else _lsd_order(seg, plan, rest)
            routes["block_buckets"] += 1
        else:                                   # over capacity: the LSD route
            seg_live = _live(seg, plan)
            o = _lsd_order(seg, plan,
                           [p for p in range(len(plan)) if seg_live[p]])
            routes["over_capacity"] += 1
        out[s:s + m] = order[s:s + m][o]
    return out, routes


def _jax_lex(keys):
    """JAX lax.sort((cols..., iota), num_keys=nl), stable: the
    permutation."""
    nl = keys.shape[1]
    cols = tuple(jnp.asarray(keys[:, l].astype(np.uint32)) for l in range(nl))
    out = jax.lax.sort(cols + (jnp.arange(len(keys), dtype=jnp.int32),),
                       num_keys=nl)
    return np.asarray(out[-1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_case_lex(name):
    return _jax_lex(CASES[name][0])


# a capacity and a warp size at which small inputs take every route
TINY_LEX = (600, 32)


@pytest.mark.parametrize("cap", ["kernel", "tiny"])
@pytest.mark.parametrize("name", list(CASES))
def test_lex_order_model_on_cases_equals_jax(name, cap):
    keys, _ = CASES[name]
    nl = keys.shape[1]
    c, warp = (ks.LEX_CAPACITY[nl], ks.LEX_WARP) if cap == "kernel" \
        else TINY_LEX
    perm, routes = model_lex_order(keys, c, warp)
    np.testing.assert_array_equal(perm.numpy(), _jax_case_lex(name))
    assert routes["partition_passes"] <= ks.MAX_PARTITION
    # each case reaches the route it is named for at the kernel's sizes
    if cap == "kernel" and name == "few values, large":
        assert routes == {"partition_passes": 2, "warp_buckets": 0,
                          "block_buckets": 0, "over_capacity": 3}
    if cap == "kernel" and name == "one prefix over the capacity":
        assert routes["over_capacity"] == 1 and routes["warp_buckets"]
    if cap == "kernel" and name == "all equal, large":
        assert not any(routes.values())
    if cap == "kernel" and name == "canonical-skewed prefixes":
        assert routes["over_capacity"] == routes["block_buckets"] == 0 \
            and routes["warp_buckets"] > 1
    if cap == "kernel" and name == "all ones, nl=2":   # 2,700 all-ones rows
        assert routes["block_buckets"] and not routes["over_capacity"]
    # at the tiny sizes these take every route
    if cap == "tiny" and name == "all ones, nl=2":
        assert routes["block_buckets"] and routes["over_capacity"]
    if cap == "tiny" and name == "ties with a payload":
        assert routes["warp_buckets"] and routes["block_buckets"]


def test_lex_order_model_on_build_fingerprints(monkeypatch):
    """The fingerprints of a small level-0 build (the main path's
    lex_order) through the model at the kernel's sizes and the tiny ones
    == JAX lax.sort == the port's lex_order on the CPU."""
    from turingassembler_tpu_torch.graph import device_build
    g = jt.random_genome(20_000, seed=4)
    reads, lengths = jt.sim_reads(g, coverage=10, read_len=150, seed=5,
                                  pad_to=L)
    u, c, n = tms.count_reads_device(reads, lengths, 45, device="cpu")
    captured = []
    kernel = ks.lex_order

    def grab(keys):
        captured.append(keys.clone())
        return kernel(keys)

    monkeypatch.setattr(ks, "lex_order", grab)
    device_build.build_graph_on_device(u, c, n, 45, device="cpu")
    fp = ks.as_limbs(captured[0]).numpy()    # int32 bit patterns
    assert fp.shape[1] == 2 and len(fp) > ks.LEX_MEAN * ks.RADIX
    want = _jax_lex(fp)
    np.testing.assert_array_equal(kernel(captured[0]).numpy(), want)
    for c_, warp in ((ks.LEX_CAPACITY[2], ks.LEX_WARP), TINY_LEX):
        perm, routes = model_lex_order(fp, c_, warp)
        np.testing.assert_array_equal(perm.numpy(), want)
        assert routes["partition_passes"] == 2 and routes["warp_buckets"]


@pytest.mark.parametrize("k1", list(range(2, 65)))
def test_lex_plan(k1):
    nl = tl.n_limbs(k1)
    plan = ks.digit_plan(nl)
    rows = np.random.default_rng(k1).integers(0, 1 << 32, (512, nl))
    last = 2 * k1 - 32 * (nl - 1)
    rows[:, -1] &= ((1 << last) - 1) << (32 - last)
    live = _live(torch.as_tensor(rows), plan)
    msd = [p for p in range(len(plan) - 1, -1, -1) if live[p]]
    one = ks.LEX_MEAN * ks.RADIX            # the mean bucket at one digit
    for n, d in ((1, 0), (ks.LEX_MEAN, 0), (ks.LEX_MEAN + 1, 1), (one, 1),
                 (one + 1, 2), (3_999_906, 2), (ks.MAX_ROWS, 2)):
        part, rest = ks.lex_plan(live, n)
        d = min(d, len(msd))
        assert part == sorted(msd[:d]), (n, part)
        # the rest: every live digit below the partition
        assert rest == [p for p in range(len(plan)) if live[p]
                        and p not in part]
        assert all(p < min(part) for p in rest) if part else True
        if d:                                # the mean bucket is small
            assert n <= ks.LEX_MEAN * ks.RADIX ** d or d == ks.MAX_PARTITION \
                or d == len(msd)
    # the level-0 build's 4 M fingerprints: buckets of about 61 rows
    assert 3_999_906 / ks.RADIX ** 2 < 64
    assert ks.lex_plan([False] * len(plan), 10 ** 6) == ([], [])


# ---------------------------------------------------------------------------
# the card's merge_runs merge path, modelled in tensor code
# ---------------------------------------------------------------------------

def _le(x, y):
    """x <= y row by row, limb 0 first."""
    lt = torch.zeros(len(x), dtype=torch.bool)
    eq = torch.ones(len(x), dtype=torch.bool)
    for limb in range(x.shape[1]):
        lt |= eq & (x[:, limb] < y[:, limb])
        eq &= x[:, limb] == y[:, limb]
    return lt | eq


def _merge_splits(ka, kb, tile, n_tiles):
    """merge_split_kernel: a binary search on each tile border's diagonal
    for the rows of ka among the merged rows before it (ties: ka's
    first)."""
    na, nb = len(ka), len(kb)
    d = (torch.arange(n_tiles + 1) * tile).clamp(max=na + nb)
    lo, hi = (d - nb).clamp(min=0), d.clamp(max=na)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) // 2
        le = _le(ka[mid.clamp(max=max(na - 1, 0))] if na else
                 torch.zeros((len(d), ka.shape[1]), dtype=torch.int64),
                 kb[(d - 1 - mid).clamp(0, max(nb - 1, 0))] if nb else
                 torch.zeros((len(d), ka.shape[1]), dtype=torch.int64))
        lo = torch.where(go & le, mid + 1, lo)
        hi = torch.where(go & ~le, mid, hi)
    return lo, d - lo


def _before(x, y, strict):
    """For each row of y: the rows of x below it (strict) or at most it."""
    lt = torch.zeros((len(x), len(y)), dtype=torch.bool)
    eq = torch.ones_like(lt)
    for limb in range(x.shape[1]):
        a, b = x[:, limb][:, None], y[:, limb][None, :]
        lt |= eq & (a < b)
        eq &= a == b
    return (lt if strict else lt | eq).sum(dim=0)


def model_merge_path(ka, ca, kb, cb, tile):
    """ops/kmer_sort.py:merge_runs' merge path on a card, in tensor code
    (merge_split_kernel, merge_kernel's count and write passes,
    run_counts_kernel), tile merged rows a tile: (uniq, counts, in_order).
    in_order False is the kernel's order flag (an input row below the one
    before it, within a tile's slice or at its border, or a tile whose
    slices would be negative): the wrapper then takes the LSD route."""
    ka = torch.as_tensor(np.asarray(ka, dtype=np.int64))
    kb = torch.as_tensor(np.asarray(kb, dtype=np.int64))
    ca = torch.as_tensor(np.asarray(ca)).long()
    cb = torch.as_tensor(np.asarray(cb)).long()
    n, nl = len(ka) + len(kb), ka.shape[1]
    n_tiles = -(-n // tile)
    a, b = _merge_splits(ka, kb, tile, n_tiles)
    in_order, tiles = True, []
    for t in range(n_tiles):
        a0, a1, b0, b1 = a[t].item(), a[t + 1].item(), b[t].item(), \
            b[t + 1].item()
        if a1 < a0 or b1 < b0:
            in_order = False
            continue
        for x, lo, hi in ((ka, a0, a1), (kb, b0, b1)):   # the order check
            seg = x[max(lo - 1, 0):hi]
            if len(seg) > 1 and not _le(seg[:-1], seg[1:]).all():
                in_order = False
        A, B = ka[a0:a1], kb[b0:b1]
        # the tile's merged rows: a row's place is its index plus the
        # other input's rows before it, ka's first on ties
        pa = torch.arange(len(A)) + _before(B, A, strict=True)
        pb = torch.arange(len(B)) + _before(A, B, strict=False)
        rows = torch.empty((len(A) + len(B), nl), dtype=torch.int64)
        w = torch.empty(len(A) + len(B), dtype=torch.int64)
        rows[pa], rows[pb], w[pa], w[pb] = A, B, ca[a0:a1], cb[b0:b1]
        # heads: rows that differ from the merged row before them, the
        # first against the larger of ka's and kb's rows before the tile
        prev = [x[i - 1:i] for x, i in ((ka, a0), (kb, b0)) if i > 0]
        if len(prev) == 2:
            prev = [prev[1] if _le(prev[0], prev[1]).item() else prev[0]]
        head = torch.ones(len(rows), dtype=torch.bool)
        head[1:] = (rows[1:] != rows[:-1]).any(dim=1)
        if prev:
            head[0] = (rows[0] != prev[0][0]).any()
        tiles.append((rows, w, head))
    if not in_order:
        return None, None, False
    # the scan of the tiles' run counts and count sums; the write pass puts
    # each run's key and the counts' prefix before it (S) at its place
    sums = torch.tensor([int(w.sum()) for _, w, _ in tiles])
    base = torch.cumsum(sums, 0) - sums
    uniq = torch.cat([rows[head] for rows, _, head in tiles])
    S = torch.cat([(torch.cumsum(w, 0) - w + base[t])[head]
                   for t, (_, w, head) in enumerate(tiles)])
    counts = torch.cat([S[1:], sums.sum().reshape(1)]) - S
    return uniq, counts.to(torch.int32), True


def _np_merge(ka, ca, kb, cb):
    keys = np.concatenate([ka, kb])
    w = np.concatenate([ca, cb]).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv.reshape(-1), w)
    return uniq, sums


@pytest.mark.parametrize("k", KS)
def test_merge_path_model_equals_jax(k):
    """Two halves' tables (JAX _sort_count), merged by the model at a tile
    of 64 rows and at the kernel's == JAX _merge_unique_runs."""
    k1 = k + 1
    reads, lengths = _record(k, seed=300 + k)
    half = len(reads) // 2
    tabs = []
    for sl in (slice(0, half), slice(half, None)):
        _, cols, nv = _jax_rows(reads[sl], lengths[sl], k1)
        tabs += list(_jax_sort_count(cols, nv, k1))
    um, cm, nm = jms._merge_unique_runs(
        *(jnp.asarray(x.astype(np.uint32) if x.ndim == 2 else x)
          for x in tabs), len(tabs[0]) + len(tabs[2]))
    nm = int(nm)
    for tile in (64, ks.MERGE_TILE):
        u, c, in_order = model_merge_path(*tabs, tile)
        assert in_order
        np.testing.assert_array_equal(u.numpy(),
                                      np.asarray(um)[:nm].astype(np.int64))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cm)[:nm])


def _merge_inputs(name, seed=9):
    """Ascending inputs (non-decreasing) with long runs of equal rows:
    12 keys over 2,501 rows."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 32, (12, 3), dtype=np.int64)
    base = base[_np_lexsort(base)]
    ka = base[np.sort(rng.integers(0, 12, 1_500))]
    kb = base[np.sort(rng.integers(0, 12, 1_001))]
    ca = rng.integers(1, 1000, len(ka)).astype(np.int32)
    cb = rng.integers(1, 1000, len(kb)).astype(np.int32)
    lo_a, lo_b = ka[:, 0] < base[6, 0], kb[:, 0] < base[6, 0]
    return {"long runs": (ka, ca, kb, cb),
            "one key, all rows": (ka[:1].repeat(700, 0), ca[:700],
                                  kb[:1].repeat(300, 0), cb[:300]),
            "empty a": (ka[:0], ca[:0], kb, cb),
            "empty b": (ka, ca, kb[:0], cb[:0]),
            "a below b": (ka[lo_a], ca[lo_a], kb[~lo_b], cb[~lo_b]),
            "b below a": (ka[~lo_a], ca[~lo_a], kb[lo_b], cb[lo_b]),
            "one row each": (ka[:1], ca[:1], kb[-1:], cb[-1:])}[name]


MERGE_CASES = ("long runs", "one key, all rows", "empty a", "empty b",
               "a below b", "b below a", "one row each")


@pytest.mark.parametrize("tile", (64, ks.MERGE_TILE))
@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_path_model_against_numpy(name, tile):
    ka, ca, kb, cb = _merge_inputs(name)
    uniq, sums = _np_merge(ka, ca, kb, cb)
    u, c, in_order = model_merge_path(ka, ca, kb, cb, tile)
    assert in_order
    np.testing.assert_array_equal(u.numpy(), uniq)
    np.testing.assert_array_equal(c.numpy(), sums)
    # the wrapper on the CPU (the plain version) agrees
    u, c = _port(ks.merge_runs(*(torch.as_tensor(x)
                                 for x in (ka, ca, kb, cb))))
    np.testing.assert_array_equal(u, uniq)
    np.testing.assert_array_equal(c, sums)
    if name == "long runs" and tile == 64:     # runs span several tiles
        assert ((len(ka) + len(kb)) / len(uniq)) > 3 * tile


def _route_inputs(name):
    """One-limb inputs for the route choice: ka = 0 .. 199, kb = 1,000 ..
    1,149 (ka below kb, so ka's slices are cut at multiples of the tile
    of 64 rows)."""
    ka = np.arange(200, dtype=np.int64)[:, None]
    kb = 1_000 + np.arange(150, dtype=np.int64)[:, None]
    if name == "ascending with equal rows":
        ka, kb = ka // 7, np.sort(np.concatenate([kb[:75], kb[:75]]), axis=0)
    elif name == "a descent at a tile border":
        ka[[63, 64]] = ka[[64, 63]]         # tile 0's last, tile 1's first
    elif name == "a descent inside a tile":
        kb[[10, 11]] = kb[[11, 10]]
    elif name == "interleaved, a descent in b":
        ka, kb = 2 * ka, 2 * np.arange(150, dtype=np.int64)[:, None] + 1
        kb[149] = 0
    ones = np.ones(max(len(ka), len(kb)), np.int32)
    return ka, ones[:len(ka)], kb, ones[:len(kb)]


@pytest.mark.parametrize("name", ("ascending", "ascending with equal rows",
                                  "a descent at a tile border",
                                  "a descent inside a tile",
                                  "interleaved, a descent in b"))
def test_merge_route_choice(name):
    """The count step's order flag picks the route: the merge path for
    ascending inputs (equal rows too), the LSD route for any row below the
    one before it in its own input, a tile border's included."""
    ka, ca, kb, cb = _route_inputs(name)
    a, _ = _merge_splits(torch.as_tensor(ka), torch.as_tensor(kb), 64,
                         -(-(len(ka) + len(kb)) // 64))
    if name == "a descent at a tile border":   # tile 1's slice of ka: 64..
        assert 64 in a.tolist()
    u, c, in_order = model_merge_path(ka, ca, kb, cb, 64)
    assert in_order == name.startswith("ascending")
    if in_order:
        uniq, sums = _np_merge(ka, ca, kb, cb)
        np.testing.assert_array_equal(u.numpy(), uniq)
        np.testing.assert_array_equal(c.numpy(), sums)


# ---------------------------------------------------------------------------
# On the card: sort_count's batched route for the buckets over capacity
# ---------------------------------------------------------------------------

def _lsd_span(rows):
    """ops/kmer_sort.py:sort_count(rows) under tracing: its result and the
    counts of its one `count.sort.lsd` span."""
    from turingassembler_tpu_torch import tracing
    tracing.clear()
    tracing.start()
    try:
        out = ks.sort_count(rows)
    finally:
        tracing.stop()
    spans = [r[6] for r in tracing.records() if r[2] == "count.sort.lsd"]
    tracing.clear()
    assert len(spans) == 1
    return out, spans[0]


@pytest.mark.card
def test_over_capacity_route_on_the_card():
    """At nl = 4, 2,000 prefixes each holding one row repeated 7,500 times
    beside 4,000 random rows (the yeast cell's shape, 23 M rows), and 10
    such prefixes among 1 M random rows: sort_count == plain_sort_count
    exactly, each such bucket through the batched route; the route's
    host syncs (its span's) are the same for 10 buckets over capacity and
    for 2,000, and at most 3: no loop over the buckets."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the route's kernels run on the "
                    "card")
    dev = torch.device("cuda")
    syncs = {}
    for n_over in (10, 2_000):
        rows = tt.over_capacity_rows(n_over, 7_500, 4_000, seed=n_over,
                                     device=dev)
        if n_over == 10:             # two partition digits, as at 2,000
            rows = torch.cat([rows, torch.randint(
                0, 1 << 32, (1_000_000, 4), dtype=torch.int64, device=dev)])
        before = ks.COUNT.counts["sort_count"]["over_capacity"]
        (u, c), span = _lsd_span(rows)
        assert ks.COUNT.counts["sort_count"]["over_capacity"] - before \
            == n_over == span["buckets"]
        assert span["rows"] >= n_over * 11_500
        pu, pc = ks.plain_sort_count(rows)
        assert torch.equal(u, pu) and torch.equal(c, pc)
        syncs[n_over] = span["syncs"]
        del rows, u, c, pu, pc
    assert syncs[10] == syncs[2_000] <= 3
