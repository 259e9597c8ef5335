"""The minimizer map kernel (turingassembler_tpu_torch/csrc/mm_map.cu, wrapper
ops/mm_map.py) against the JAX package's mapper on the edge cases of
turingassembler_tpu_torch/testing.py:mm_map_cases.

(a) A numpy model of the kernel's own formulation equals JAX
_map_batch_verified, _map_batch, _gapless_bound_dev, minimizer_mask,
_cuckoo_probe, _vote_core and _compact_minimizer_rows: the read packed
once into 2-bit words and an invalid-base bitmask four codes at a time
(byte compare, byte reversal, a multiply for the bad bits), the limbs
by funnel shifts, each window's leftmost minimum of the key (hash << 32)
| position by the warp's sparse-table pass (lanes simulated), the first
MM_CAP marked positions, the probe of the one-record bucket table
(mm_map.bucket_records), the match-any count tally, the bound read from
the padded uint8 codes a word at a time (model_bound_words, also on
testing.mm_align_cases: every start alignment, code-4 bases, windows
that end on the pool's last byte), the rows compacted from per-row
counts and mark bitmasks.  (b) The wrapper on CPU tensors (the plain
versions) equals them too, and so does map_reads with a scalar and a
per-read threshold.  (c) The wrapper refuses what the kernel does not
take, and the entry points raise for "cuda" without a GPU.  (d) The CPU
path never looks for nvcc and counts no launch.  (e) The device pool is
cached per array identity, and threads get one pool; the card's padded
layout holds the codes alone for the remainder DP.

Tolerance: exact equality; every output is an integer or a flag.
"""

import threading
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu_torch import _build, tracing
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.mapper import minimizers as tm
from turingassembler_tpu_torch.ops import mm_map

torch.set_num_threads(1)

K, W = tm.MM_K, tm.MM_W
MT, MM = 1, -2                    # dp.SCORING_BWA's match and mismatch
M32 = np.uint32(0xFFFFFFFF)
SENT = 0x7FFFFFFF


# ---------------------------------------------------------------------------
# the numpy model of csrc/mm_map.cu
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _hash_key(l0, l1):
    """hash_key: hash_limbs of two limbs at its default seed, uint32."""
    h = np.full(l0.shape, 0x9E3779B9, np.uint32)
    for x in (l0, l1):
        x = _rotl(x * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)
        h = _rotl(h ^ x, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    return _fmix(h)


def _cuckoo(q0, q1, salt, mask, which):
    # one-element arrays: uint32 arrays wrap without a warning
    q0, q1 = np.array([q0], np.uint32), np.array([q1], np.uint32)
    salt = np.array([salt], np.uint32)
    if which == 0:
        x = (q0 ^ (q1 * np.uint32(0x9E3779B1))) + salt
    else:
        x = (q1 ^ (q0 * np.uint32(0x85EBCA77))) + \
            (salt ^ np.uint32(0x5BD1E995))
    return int((_fmix(x) & np.uint32(mask))[0])


def _ballot(bits):
    """(B, 32) bools -> (B,) uint64 masks, bit i from lane i."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)


def model_pack(rows):
    """pack_row over rows (B, L): (words (B, L/16 + 3), bad (B, L/32 + 2))
    uint64 holding uint32, a word of 16 codes four codes at a time as the
    kernel packs them: the byte compare (codes >= 4), the byte reversal
    and two shifts, the multiply that gathers four bad bits; the codes
    past the row (here a pattern of 2 and 7, the kernel's stale buffer)
    masked off."""
    B, L = rows.shape
    nw = -(-L // 16)
    x = np.tile(np.array([2, 7], np.uint32), 8 * nw)[None, :].repeat(B, 0)
    x[:, :L] = rows
    x = x.reshape(B, nw, 4, 4)
    m32 = np.uint64(0xFFFFFFFF)
    v = sum(x[..., i].astype(np.uint64) << np.uint64(8 * i) for i in range(4))
    big = sum(np.where(x[..., i] > 3, np.uint64(0xFF) << np.uint64(8 * i),
                       np.uint64(0)) for i in range(4))
    y = v & ~big & np.uint64(0x03030303)
    # __byte_perm(y, 0, 0x0123): the four bytes reversed
    r = sum(((y >> np.uint64(8 * i)) & np.uint64(0xFF))
            << np.uint64(8 * (3 - i)) for i in range(4))
    u = r | (r >> np.uint64(6))
    byte = (u & np.uint64(0xF)) | ((u >> np.uint64(12)) & np.uint64(0xF0))
    sh = np.array([24, 16, 8, 0], np.uint64)
    word = np.bitwise_or.reduce(byte << sh, axis=2)
    bits = ((((big & np.uint64(0x01010101)) * np.uint64(0x01020408)) & m32)
            >> np.uint64(24)) << (np.uint64(4) * np.arange(4, dtype=np.uint64))
    bits = np.bitwise_or.reduce(bits, axis=2)
    n_in = L - 16 * np.arange(nw)
    part = n_in < 16
    word[:, part] &= (m32 << np.uint64(32 - 2 * n_in[part])) & m32
    bits[:, part] &= (np.uint64(1) << n_in[part].astype(np.uint64)) - \
        np.uint64(1)
    words = np.zeros((B, L // 16 + 3), np.uint64)
    words[:, :nw] = word
    half = np.zeros((B, 2 * (L // 32 + 2)), np.uint64)
    half[:, :nw] = bits
    return words, half[:, 0::2] | (half[:, 1::2] << np.uint64(16))


def model_window(words, bad, p, k=K):
    """window_at at positions p (P,) of packed rows: (l0, l1, clean), each
    (B, P), by the funnel shifts."""
    m32 = np.uint64(0xFFFFFFFF)
    q, s = p >> 4, (2 * (p & 15)).astype(np.uint64)

    def funnel_l(lo, hi, sh):     # upper 32 bits of (hi:lo) << sh
        return (((hi << np.uint64(32)) | lo) << sh) >> np.uint64(32) & m32

    l0 = funnel_l(words[:, q + 1], words[:, q], s)
    l1 = funnel_l(words[:, q + 2], words[:, q + 1], s) \
        & ((m32 << np.uint64(64 - 2 * k)) & m32)
    b = (((bad[:, (p >> 5) + 1] << np.uint64(32)) | bad[:, p >> 5])
         >> (p & 31).astype(np.uint64)) & m32
    kmask = m32 if k == 32 else np.uint64((1 << k) - 1)
    return l0.astype(np.uint32), l1.astype(np.uint32), (b & kmask) == 0


def model_elect(lo, hi, c, n_win, w=W):
    """elect for chunk c of B rows: lo, hi (B, 32) uint64 keys of the
    lanes; returns (here, next) (B,) uint64 masks.  Lanes are columns; a
    shuffle reads the column of its source lane."""
    lane = np.arange(32)
    a, b = lo.copy(), hi.copy()
    d = 1
    while 2 * d <= w:
        src = (lane + d) & 31
        xa, xb = a[:, src], b[:, src]
        wrap = lane + d >= 32
        a = np.minimum(a, np.where(wrap, xb, xa))
        b = np.where(wrap, b, np.minimum(b, xb))
        d *= 2
    off = w - d
    src = (lane + off) & 31
    m = np.minimum(a, np.where(lane + off >= 32, b[:, src], a[:, src]))
    at = np.where(32 * c + lane < n_win[:, None],
                  (m & np.uint64(0xFFFFFFFF)).astype(np.int64) - 32 * c, -1)
    one = np.uint64(1)
    here = np.where((at >= 0) & (at < 32), one << np.clip(at, 0, 31).astype(
        np.uint64), 0)
    nxt = np.where(at >= 32, one << np.clip(at - 32, 0, 31).astype(np.uint64),
                   0)
    return (np.bitwise_or.reduce(here.astype(np.uint64), axis=1),
            np.bitwise_or.reduce(nxt.astype(np.uint64), axis=1))


def model_marks(rows, lengths, k=K, w=W):
    """The kernel's marks of rows (B, L): (limb 0, limb 1, marks), each (B,
    P), P = L - k + 1 window positions; marks of chunk c are (carry from
    chunk c - 1 | elected here) & the chunk's valid positions."""
    rows = np.atleast_2d(rows)
    lengths = np.atleast_1d(np.asarray(lengths))
    B, L = rows.shape
    P = L - k + 1
    words, bad = model_pack(rows)
    nch = -(-P // 32)
    p_all = np.arange(32 * nch + 32)
    l0, l1, clean = model_window(words, bad, np.minimum(p_all, P - 1), k)
    valid = clean & (p_all < P)[None, :] & \
        (p_all[None, :] + k <= lengths[:, None])
    h = np.where(valid, _hash_key(l0, l1), M32).astype(np.uint64)
    keys = (h << np.uint64(32)) | p_all.astype(np.uint64)
    w_len = lengths.astype(np.int64) - k - w + 2
    n_win = np.where((L - k - w + 2 <= 0) | (w_len <= 0), 0,
                     np.minimum(w_len, P))
    marks = np.zeros((B, 32 * nch), bool)
    carry = np.zeros(B, np.uint64)
    for c in range(nch):
        here, nxt = model_elect(keys[:, 32 * c:32 * c + 32],
                                keys[:, 32 * c + 32:32 * c + 64], c, n_win, w)
        here = np.where(32 * c < n_win, here, 0).astype(np.uint64)
        nxt = np.where(32 * c < n_win, nxt, 0).astype(np.uint64)
        mk = (carry | here) & _ballot(valid[:, 32 * c:32 * c + 32])
        carry = nxt
        marks[:, 32 * c:32 * c + 32] = \
            (mk[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1) > 0
    return l0[:, :P], l1[:, :P], marks[:, :P]


def model_probe(rec, salt, q0, q1):
    """The kernel's probe of the bucket records (NB, 16): b1's record, b2's
    only on a miss, the first matching slot.  (found, edge + 1 or 0,
    pos)."""
    r = rec.view(np.uint32).reshape(len(rec), 4, 4)
    for which in (0, 1):
        slots = r[_cuckoo(q0, q1, salt, len(rec) - 1, which)]
        for t in range(4):
            if slots[t, 0] == q0 and slots[t, 1] == q1:
                return True, int(slots[t, 2]), int(slots[t, 3])
    return False, 0, 0


def model_vote(edge, start):
    """The match-any tally of the slots' (edge, start), SENT for a slot
    that is no hit: (best_edge, best_hits, est_start, edges at the best
    count, hits)."""
    edge, start = np.asarray(edge, np.int64), np.asarray(start, np.int64)
    hit = edge != SENT
    cnt = np.array([(edge == e).sum() if h else 0 for e, h in zip(edge, hit)],
                   np.int64)
    best = int(cnt.max(initial=0))
    tot = int(hit.sum())
    n_best = int((cnt == best).sum()) // best if best > 0 else 0
    be, bs = -1, -1
    if n_best == 1 and (100 * best >= 85 * tot or tot <= 2):
        be = int(edge[cnt == best].max())
        bs = int(start[edge == be].min())
    return be, best, bs, n_best, tot


def model_bound(codes, off, edge, start, q, n):
    """gapless: the read's on-edge span [lo, hi) of positions, each code
    against the pool's uint8 code under it."""
    e = max(int(edge), 0)
    o, elen = int(off[e]), int(off[e + 1] - off[e])
    start, L = int(start), len(q)
    lo = min(-start, L) if start < 0 else 0
    hi = min(int(n), min(max(elen - start, 0), L))
    j = np.arange(lo, max(hi, lo))
    nm = int((q[j].astype(np.int64) == codes[o + start + j]).sum())
    non = max(hi - lo, 0)
    return nm * MT + (non - nm) * MM, non > 0 and edge >= 0


def bound_group(L):
    """csrc/mm_map.cu:bound_group: lanes a query in the bound entry."""
    g = 1
    while g < 32 and 64 * g < L:
        g *= 2
    return g


def _vcmpeq4(a, b):
    """__vcmpeq4: 0xFF in each byte where a's and b's bytes are equal."""
    return sum(0xFF << (8 * i) for i in range(4)
               if (a >> (8 * i)) & 0xFF == (b >> (8 * i)) & 0xFF)


def _word_matches(q, t, j, lo, hi):
    """word_matches: 8 x the equal bytes of query word q (codes j..j+3)
    and pool word t inside [lo, hi)."""
    if j + 4 <= lo or j >= hi:
        return 0
    m = 0xFFFFFFFF
    if j < lo:
        m = (m << (8 * (lo - j))) & 0xFFFFFFFF
    if j + 4 > hi:
        m &= 0xFFFFFFFF >> (8 * (j + 4 - hi))
    return bin(_vcmpeq4(q, t) & m).count("1")


def model_bound_words(codes, off, edge, start, q, n, G=32, c=0, fill=0):
    """gapless() by its lanes, a group of G: lane r takes the span's
    8-code steps (lo >> 3) + r, + G, ... of [lo, hi); a step's pool
    codes are three aligned word loads of the padded pool (mm_map.
    padded_codes: POOL_PAD bytes of 0xF each side, its first code at an
    address c mod 4 past a word boundary) and two funnel shifts; per-byte
    compares, the masks at lo and hi, __popc, the group's sum / 8.  The
    query row's bytes past L are `fill` (the shared buffer's leftovers).
    Asserts every load stays inside the padded pool."""
    pad = mm_map.POOL_PAD
    e = max(int(edge), 0)
    o, elen = int(off[e]), int(off[e + 1] - off[e])
    start, L = int(start), len(q)
    lo = min(-start, L) if start < 0 else 0
    hi = min(int(n), min(max(elen - start, 0), L))
    buf = np.concatenate([np.full(pad, 0xF, np.uint8),
                          np.asarray(codes, np.uint8),
                          np.full(pad, 0xF, np.uint8)])
    qrow = np.full(8 * (-(-L // 8)), fill, np.uint8)
    qrow[:L] = q
    qw = qrow.view("<u4")
    bits, end = 0, hi if hi > lo else 0
    for r in range(G):
        for j in range(8 * ((lo >> 3) + r), end, 8 * G):
            p = c + pad + o + start + j      # code j's pool byte, address
            a = (p & ~3) - c                  # its aligned word, in buf
            assert 0 <= a and a + 12 <= len(buf), (edge, start, j)
            w = [int(x) for x in buf[a:a + 12].view("<u4")]
            sh = 8 * (p & 3)
            for h in range(2):
                t = ((w[h + 1] << 32 | w[h]) >> sh) & 0xFFFFFFFF
                bits += _word_matches(int(qw[j // 4 + h]), t, j + 4 * h,
                                      lo, hi)
    nm, non = bits >> 3, max(hi - lo, 0)
    return nm * MT + (non - nm) * MM, non > 0 and edge >= 0


def model_map(bases, lengths, rec, salt, pool=None, thr=None):
    """map_kernel read by read: (best_edge, best_hits, est_start[, bound,
    fast]) and the diagnostics (marked positions, edges at the best count,
    singleton hits) of each read."""
    out = {f: [] for f in ("be", "best", "bs", "bound", "fast", "n_marked",
                           "n_best", "tot")}
    l0, l1, mark = model_marks(bases, lengths)
    for b in range(len(bases)):
        seq, n = bases[b], int(lengths[b])
        slots = np.flatnonzero(mark[b])[:mm_map.MM_CAP]   # the first cap marks
        edge, start = [], []
        for p in slots:
            found, ev, pos = model_probe(rec, salt, l0[b, p], l1[b, p])
            hit = found and ev > 0
            edge.append(ev - 1 if hit else SENT)
            start.append(pos - int(p) if hit else mm_map.BIG)
        be, best, bs, n_best, tot = model_vote(edge, start)
        for f, v in (("be", be), ("best", best), ("bs", bs),
                     ("n_marked", int(mark[b].sum())), ("tot", tot),
                     ("n_best", n_best)):
            out[f].append(v)
        if pool is not None:                  # the warp's 32 lanes
            bound, feas = model_bound_words(*pool, be, bs, seq, n,
                                            fill=b % 256)
            out["bound"].append(bound)
            out["fast"].append(feas and bound >= thr[b])
    return {f: np.asarray(v) for f, v in out.items()}


def model_rows(rows, lengths, k=K, w=W):
    """The rows entry: the marks pass's per-row mark bitmask and count,
    then each row's offset (the counts before it) and its marks' rows in
    bit order: (n, 4) int64 (l0, l1, row, position)."""
    l0, l1, mark = model_marks(rows, lengths, k, w)
    counts = mark.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    out = np.zeros((int(offsets[-1]), 4), np.int64)
    for b in range(len(rows)):
        p = np.flatnonzero(mark[b])
        out[offsets[b]:offsets[b + 1]] = np.stack(
            [l0[b, p], l1[b, p], np.full(len(p), b), p], axis=1)
    return out


# ---------------------------------------------------------------------------
# the cases, the index and the JAX references
# ---------------------------------------------------------------------------

G, CASES = tt.mm_map_cases(seed=3)


@pytest.fixture(scope="module")
def world():
    g, cases = G, CASES
    idx = tm.EdgeMinimizerIndex.build(g, device="cpu")
    hkeys, vals, salt = idx.hash_tables()
    pk = mm_map.pack_pool_nibbles(g.seq_data)
    return dict(g=g, cases=cases, idx=idx, hkeys=hkeys, vals=vals, salt=salt,
                rec=mm_map.bucket_records(hkeys, vals), pk=pk,
                codes=g.seq_data, off=g.seq_off.astype(np.int64))


def _names(entry):
    return [n for n, (e, _) in CASES.items() if e == entry]


def _reads_of(entry, arrays):
    """The (bases, lengths) of a case."""
    return (arrays[0], arrays[1]) if entry in ("map", "rows") \
        else (arrays[2], arrays[3])


# the cases wide enough for a vote (MM_CAP window positions)
VOTE_CASES = [n for n, (e, a) in CASES.items()
              if _reads_of(e, a)[0].shape[1] - K + 1 >= mm_map.MM_CAP]


def _u32(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def jax_map(world, bases, lengths, thr):
    args = (jnp.asarray(bases), jnp.asarray(lengths), _u32(world["hkeys"]),
            _u32(world["vals"]), jnp.uint32(world["salt"]))
    vote = jm._map_batch(*args, K, W)
    ver = jm._map_batch_verified(
        *args, _u32(world["pk"]), jnp.asarray(world["off"].astype(np.int32)),
        jnp.asarray(thr.astype(np.int32)), K, W, MT, MM)
    return [np.asarray(x) for x in vote], [np.asarray(x) for x in ver]


def jax_bound(world, edges, starts, bases, lengths):
    out = jm._gapless_bound_dev(
        jnp.asarray(world["pk"].astype(np.uint32)),
        jnp.asarray(world["off"].astype(np.int32)),
        jnp.asarray(edges.astype(np.int32)),
        jnp.asarray(starts.astype(np.int32)), jnp.asarray(bases),
        jnp.asarray(lengths), MT, MM, jm.RESCORE_PAD)
    return [np.asarray(x) for x in out]


def _eq(want, got, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert want.shape == got.shape, what
    np.testing.assert_array_equal(want.astype(np.int64),
                                  got.astype(np.int64), err_msg=what)


def test_cases_reach_every_edge(world):
    """The edge cases hold what they are for: Ns, reads too short for a
    window, more than MM_CAP minimizers, ties, head and tail overhangs,
    unmapped and gated reads, per-read thresholds, both bound branches."""
    cases = world["cases"]
    seen = Counter()
    for name in _names("map"):
        bases, lengths, thr = cases[name][1]
        m = model_map(bases, lengths, world["rec"], world["salt"],
                      (world["codes"], world["off"]), thr)
        seen["N"] += int(((bases == 4).any(1)).sum())
        seen["short"] += int((lengths < K + W - 1).sum())
        seen["overflow"] += int((m["n_marked"] > mm_map.MM_CAP).sum())
        seen["two slot sets"] += int((np.minimum(m["n_marked"], mm_map.MM_CAP)
                                      > 32).sum())
        seen["tie"] += int((m["n_best"] > 1).sum())
        seen["gated"] += int(((m["n_best"] == 1) & (m["be"] < 0)).sum())
        seen["negative start"] += int((m["bs"] < -1).sum())
        seen["mapped"] += int((m["be"] >= 0).sum())
        seen["fast"] += int(m["fast"].sum())
        seen["slow"] += int(((m["be"] >= 0) & ~m["fast"]).sum())
        seen["thresholds"] = max(seen["thresholds"], len(np.unique(thr)))
    for what in ("N", "short", "overflow", "two slot sets", "tie", "gated",
                 "negative start", "fast", "slow"):
        assert seen[what] >= 3, (what, seen)
    assert seen["mapped"] > 300 and seen["thresholds"] > 50, seen
    assert (world["idx"].count > 1).any()           # shared minimizers
    wide = -(-(cases["wide queries"][1][2].shape[1] + 7) // 8) + 1
    assert wide > mm_map.POOL_PAD_W >= -(-(152 + 7) // 8) + 1


@pytest.mark.parametrize("name", _names("map"))
def test_map_model_and_wrapper_equal_jax(world, name):
    bases, lengths, thr = world["cases"][name][1]
    (jv, jver) = jax_map(world, bases, lengths, thr)
    m = model_map(bases, lengths, world["rec"], world["salt"],
                  (world["codes"], world["off"]), thr)
    for i, f in enumerate(("be", "best", "bs")):
        _eq(jv[i], m[f], f"model {f}")
        _eq(jver[i], m[f], f"model verified {f}")
    _eq(jver[3], m["bound"], "model bound")
    _eq(jver[4], m["fast"], "model fast")
    # (b) the wrapper on CPU tensors: the plain versions
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    hk, vals, salt = world["idx"].device_tables("cpu")
    args = (t(bases), t(lengths), hk, vals, salt, K, W)
    vote = mm_map.map_batch(*args)
    ver = mm_map.map_batch(*args, t(world["pk"]), t(world["off"]), t(thr),
                           MT, MM)
    assert [x.dtype for x in ver] == [torch.int64] * 4 + [torch.bool]
    for i in range(3):
        _eq(jv[i], vote[i], f"wrapper vote {i}")
    for i in range(5):
        _eq(jver[i], ver[i], f"wrapper verified {i}")
    # into int32 arrays, as map_reads has it, with one scalar threshold
    out = [torch.full((len(bases),), -7, dtype=torch.int32) for _ in range(4)]
    out.append(torch.zeros(len(bases), dtype=torch.bool))
    got = mm_map.map_batch(*args, t(world["pk"]), t(world["off"]), 40, MT,
                           MM, out=out)
    assert all(a is b for a, b in zip(got, out))
    _, j40 = jax_map(world, bases, lengths, np.full(len(bases), 40, np.int64))
    for i in range(5):
        _eq(j40[i], out[i], f"wrapper into int32, scalar threshold {i}")


@pytest.mark.parametrize("name", VOTE_CASES)
def test_vote_model_equals_jax(world, name):
    """The match-any tally of the model (a slot's count is its edge's
    slots; (slots at the best count) / best edges at it) equals JAX
    _vote_core on the reads, queries and segment rows of every case wide
    enough for MM_CAP slots."""
    bases, lengths = _reads_of(*world["cases"][name])
    want = jm._map_batch(jnp.asarray(bases), jnp.asarray(lengths),
                         _u32(world["hkeys"]), _u32(world["vals"]),
                         jnp.uint32(world["salt"]), K, W)    # _vote_core
    m = model_map(bases, lengths, world["rec"], world["salt"])
    for i, f in enumerate(("be", "best", "bs")):
        _eq(np.asarray(want[i]), m[f], f"model vote {f}")


def _dense_tables(seed=11):
    """Host cuckoo tables near the greedy placement's limit (1,500 keys in
    1,024 buckets of 4), so some keys sit in b2, their b1 full."""
    rng = np.random.default_rng(seed)
    M = 1_500
    k0 = rng.choice(1 << 32, M, replace=False).astype(np.int64)
    k1 = rng.integers(0, 4, M).astype(np.int64) << 30
    edge = rng.integers(0, 50, M).astype(np.int64)
    pos = rng.integers(0, 10_000, M).astype(np.int64)
    count = rng.integers(1, 3, M).astype(np.int64)
    out = tm._try_build_cuckoo(k0, k1, edge, pos, count, 1_024)
    assert out is not None
    absent = np.stack([rng.integers(0, 1 << 32, 300),
                       rng.integers(0, 4, 300) << 30], axis=1)
    return out, np.stack([k0, k1], axis=1), absent


@pytest.mark.parametrize("tables", ["edge-case index", "dense"])
def test_bucket_records_probe_equals_jax(world, tables):
    """The layout function's records, probed as the kernel probes them (b1's
    record, b2's only on a miss, the first matching slot), equal JAX
    _cuckoo_probe on the host tables: every key, keys in b2, keys whose b1
    is full, absent keys."""
    if tables == "dense":
        (hkeys, vals, salt), keys, absent = _dense_tables()
    else:
        hkeys, vals, salt = world["hkeys"], world["vals"], world["salt"]
        keys = world["idx"].keys.astype(np.int64)
        rng = np.random.default_rng(5)
        absent = np.stack([rng.integers(0, 1 << 32, 300),
                           rng.integers(0, 4, 300) << 30], axis=1)
    absent = absent[~(absent[:, None, :] == keys[None, :, :]).all(2).any(1)]
    q = np.concatenate([keys, absent]).astype(np.uint32)
    rec = mm_map.bucket_records(hkeys, vals)
    assert rec.shape == (len(hkeys), 16) and rec.dtype == np.int32
    je, jp, jf = (np.asarray(x) for x in jm._cuckoo_probe(
        _u32(hkeys), _u32(vals), jnp.uint32(salt), jnp.asarray(q)))
    got = [model_probe(rec, salt, a, b) for a, b in q]
    found = np.array([g[0] for g in got])
    _eq(jf, found, "found")
    _eq(je, [g[1] - 1 if g[0] else -1 for g in got], "edge_sing")
    _eq(jp[jf], [g[2] for g in got if g[0]], "pos")
    assert found[:len(keys)].all() and not found[len(keys):].any()
    mask = len(hkeys) - 1
    b1 = np.array([_cuckoo(a, b, salt, mask, 0) for a, b in keys])
    in_b1 = ((hkeys[b1, 0::2] == keys[:, :1]) &
             (hkeys[b1, 1::2] == keys[:, 1:])).any(1)
    b1_full = (hkeys[b1, 0::2] != 0xFFFFFFFF).all(1) & ~in_b1
    if tables == "dense":
        assert (~in_b1).sum() >= 20 and b1_full.sum() >= 20, \
            ((~in_b1).sum(), b1_full.sum())


@pytest.mark.parametrize("name", _names("bound"))
def test_bound_model_and_wrapper_equal_jax(world, name):
    edges, starts, bases, lengths = world["cases"][name][1]
    want = jax_bound(world, edges, starts, bases, lengths)
    model = np.array([model_bound(world["codes"], world["off"], e, s, q, n)
                      for e, s, q, n in zip(edges, starts, bases, lengths)])
    _eq(want[0], model[:, 0], "model bound")
    _eq(want[1], model[:, 1], "model feas")
    words = np.array([model_bound_words(
        world["codes"], world["off"], e, s, q, n, bound_group(len(q)))
        for e, s, q, n in zip(edges, starts, bases, lengths)])
    _eq(want[0], words[:, 0], "word model bound")
    _eq(want[1], words[:, 1], "word model feas")
    assert model[:, 1].sum() > len(edges) // 4
    assert (model[:, 0] > 20).sum() > 10
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    got = mm_map.gapless_bound(t(world["pk"]), t(world["off"]), t(edges),
                               t(starts), t(bases), t(lengths), MT, MM)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    _eq(want[0], got[0], "wrapper bound")
    _eq(want[1], got[1], "wrapper feas")


def test_bound_from_codes_at_the_pool_ends(world):
    """The bound read from the uint8 codes equals JAX _gapless_bound_dev on
    edge 0 and the last edge, with head and tail overhangs: the pool's
    first and last bytes."""
    g, off = world["g"], world["off"]
    rng = np.random.default_rng(21)
    last, L = g.n_e - 1, 152
    edges, starts = [], []
    for e in (0, last):
        elen = int(off[e + 1] - off[e])
        for s in (-L + 1, -60, -1, 0, 7, elen - L, elen - 80, elen - 1,
                  elen + 3):
            edges.append(e)
            starts.append(s)
    edges, starts = np.array(edges, np.int64), np.array(starts, np.int64)
    n = len(edges)
    bases = np.full((n, L), 255, np.uint8)
    lengths = rng.integers(L - 10, L + 1, n).astype(np.int32)
    for i, (e, s) in enumerate(zip(edges, starts)):
        j = np.arange(L)
        t = s + j
        on = (t >= 0) & (t < off[e + 1] - off[e]) & (j < lengths[i])
        bases[i, :lengths[i]] = rng.integers(0, 4, lengths[i])
        bases[i, on] = g.seq_data[off[e] + t[on]]
        flip = rng.random(L) < 0.05
        bases[i, flip & (j < lengths[i])] = 4
    want = jax_bound(world, edges, starts, bases, lengths)
    got = np.array([model_bound(world["codes"], off, e, s, q, ln)
                    for e, s, q, ln in zip(edges, starts, bases, lengths)])
    _eq(want[0], got[:, 0], "bound")
    _eq(want[1], got[:, 1], "feas")
    assert (got[:, 0] > 0).sum() > n // 2


ALIGN_G, ALIGN_CASES = tt.mm_align_cases(seed=5)


@pytest.fixture(scope="module")
def align_world():
    g = ALIGN_G
    return dict(g=g, pk=mm_map.pack_pool_nibbles(g.seq_data), codes=g.seq_data,
                off=g.seq_off.astype(np.int64))


@pytest.mark.parametrize("L", tt.MM_ALIGN_WIDTHS)
def test_bound_words_model_equals_jax_at_every_alignment(align_world, L):
    """The word model (model_bound_words: the kernel's word loads at the
    pool's real byte alignment, the funnel shift, the per-byte compare,
    the masks at lo and hi and at the pool's last byte) equals
    model_bound and JAX _gapless_bound_dev on queries of width L at all
    16 start alignments against the pool, with code-4 bases in the query
    and in the pool, and on windows that end on the pool's last byte:
    for the bound entry's group and the map's 32 lanes, the pool's first
    byte at each address mod 4, and any bytes past L in the query row.
    The wrapper on the CPU returns the same int32 bound."""
    w = align_world
    codes, off = w["codes"], w["off"]
    edges, starts, bases, lengths = ALIGN_CASES[f"aligned queries L={L}"][1]
    want = jax_bound(w, edges, starts, bases, lengths)
    rows = list(zip(edges, starts, bases, lengths))
    ref = np.array([model_bound(codes, off, *x) for x in rows])
    _eq(want[0], ref[:, 0], "model_bound")
    _eq(want[1], ref[:, 1], "model_bound feas")
    for G in sorted({bound_group(L), 32}):
        for c in range(4):
            got = np.array([model_bound_words(codes, off, *x, G=G, c=c,
                                              fill=(7 * c + i) % 256)
                            for i, x in enumerate(rows)])
            _eq(want[0], got[:, 0], f"word model bound, G={G}, c={c}")
            _eq(want[1], got[:, 1], f"word model feas, G={G}, c={c}")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    got = mm_map.gapless_bound(t(w["pk"]), t(off), t(edges), t(starts),
                               t(bases), t(lengths), MT, MM)
    assert got[0].dtype == torch.int32
    _eq(want[0], got[0], "wrapper bound")
    _eq(want[1], got[1], "wrapper feas")
    # the cases hold what they are for
    e = np.maximum(edges, 0)
    elen = off[e + 1] - off[e]
    lo = np.where(starts < 0, np.minimum(-starts, L), 0)
    hi = np.minimum(lengths, np.clip(elen - starts, 0, L))
    span = hi > lo
    first = (off[e] + starts + lo)[span & (edges >= 0)]
    assert len(np.unique(first % 16)) == 16
    ends_last = span & (off[e] + starts + hi == len(codes)) & (edges >= 0)
    assert ends_last.sum() >= min(4, L)
    j = np.arange(L)[None, :]
    on = (j >= lo[:, None]) & (j < hi[:, None]) & (edges >= 0)[:, None]
    pool_at = codes[np.clip(off[e][:, None] + starts[:, None] + j, 0,
                            len(codes) - 1)]
    assert (on & (pool_at == 4) & (bases == 4)).sum() >= 1
    if L >= 150:
        assert (on & (pool_at == 4) & (bases != 4)).sum() >= 1
        assert (on & (pool_at != 4) & (bases == 4)).sum() >= 1


def test_map_at_pool_end_equals_jax(align_world):
    """Reads on the pool's last edge, ending on the pool's last byte (a
    code 4), short of it or past it: the model (the word bound with the
    warp's 32 lanes) and the wrapper on the CPU equal JAX
    _map_batch_verified, and the voted spans of some end on that byte."""
    w = align_world
    g = w["g"]
    idx = tm.EdgeMinimizerIndex.build(g, device="cpu")
    hkeys, vals, salt = idx.hash_tables()
    world = dict(w, hkeys=hkeys, vals=vals, salt=salt)
    bases, lengths, thr = ALIGN_CASES["reads at the pool's end"][1]
    _, jver = jax_map(world, bases, lengths, thr)
    m = model_map(bases, lengths, mm_map.bucket_records(hkeys, vals), salt,
                  (w["codes"], w["off"]), thr)
    for i, f in enumerate(("be", "best", "bs", "bound", "fast")):
        _eq(jver[i], m[f], f"model {f}")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    hk, vl, sl = idx.device_tables("cpu")
    ver = mm_map.map_batch(t(bases), t(lengths), hk, vl, sl, K, W,
                           t(w["pk"]), t(w["off"]), t(thr), MT, MM)
    for i in range(5):
        _eq(jver[i], ver[i], f"wrapper verified {i}")
    last = g.n_e - 1
    ends = (m["be"] == last) & (m["bs"] + lengths >= g.edge_len()[last])
    assert ends.sum() >= 8 and (m["be"] == last).sum() >= 48


def test_padded_pool_holds_the_codes_alone(world):
    """The card's pool layout, built on the CPU: padded_codes is a view of
    the codes alone with POOL_PAD bytes of 0xF before and after it in its
    storage; the pad check takes it and refuses a pool without the pad on
    either side; the remainder DP reads the same scores from the view as
    from the host codes (it sees the unpadded length)."""
    g, pad = world["g"], mm_map.POOL_PAD
    n = len(g.seq_data)
    codes = mm_map.padded_codes(g.seq_data, "cpu")
    assert codes.dtype == torch.uint8 and codes.shape == (n,)
    np.testing.assert_array_equal(codes.numpy(), g.seq_data)
    full = torch.empty(0, dtype=torch.uint8).set_(codes.untyped_storage())
    assert full.shape == (n + 2 * pad,) and codes.storage_offset() == pad
    assert (full[:pad] == 0xF).all() and (full[-pad:] == 0xF).all()
    mm_map.check_pool_pad(codes)
    for bad in (torch.as_tensor(g.seq_data), full[pad - 1:pad - 1 + n],
                full[pad + 1:pad + 1 + n]):
        with pytest.raises(ValueError, match="pad"):
            mm_map.check_pool_pad(bad)
    edges, starts, bases, lengths = world["cases"]["queries"][1]
    rest = np.flatnonzero(edges >= 0)
    args = (g.seq_off, edges, starts, bases, lengths, rest,
            tm.dp.SCORING_BWA)
    want = tm._dp_verify_rest(g.seq_data, *args, device="cpu")
    got = tm._dp_verify_rest(codes, *args, device="cpu")
    _eq(want, got, "remainder DP on the padded view")
    assert len(rest) > 100 and (want > 0).sum() > 20


def _edge_rows(seed=31):
    """Rows for the marks: codes >= 4 and 255 fill, a period-5 row whose
    repeated k-mers tie on hash inside each window, and rows too narrow
    for a window (L - k - w + 2 <= 0, or lengths under k + w - 1)."""
    rng = np.random.default_rng(seed)
    wide = rng.integers(0, 4, (6, 300)).astype(np.uint8)
    wide[0, rng.integers(0, 300, 12)] = 4
    wide[1, rng.integers(0, 300, 12)] = 7
    wide[2, 250:] = 255
    wide[3] = np.tile(rng.integers(0, 4, 5), 60)          # hash ties
    wide[4, :] = 4
    lw = np.array([300, 300, 250, 300, 300, K + W - 2], np.int32)
    narrow = rng.integers(0, 4, (3, K + W - 2)).astype(np.uint8)
    return {"Ns and 255 fill": (wide[:3], lw[:3]),
            "hash ties": (wide[3:4], lw[3:4]),
            "no window": (wide[4:], lw[4:]),
            "too narrow": (narrow, np.full(3, K + W - 2, np.int32))}


@pytest.mark.parametrize("kind", list(_edge_rows()))
def test_marks_model_equals_jax_minimizer_mask(kind):
    """The rolling pack and the sparse-table minimum of (hash << 32) |
    position equal JAX minimizer_mask's limbs and marks."""
    rows, lengths = _edge_rows()[kind]
    jk, _jh, jmm = (np.asarray(x) for x in jm.minimizer_mask(
        jnp.asarray(rows), jnp.asarray(lengths), K, W))
    l0, l1, mark = model_marks(rows, lengths)
    _eq(jk, np.stack([l0, l1], axis=2), "limbs")
    _eq(jmm, mark, "marks")
    if kind == "hash ties":
        h = _hash_key(l0[0], l1[0])
        assert len(np.unique(h[:50])) <= 5 and mark.sum() > 10


@pytest.mark.parametrize("name", _names("rows"))
def test_rows_model_and_wrapper_equal_jax(world, name):
    """The marks of the model equal JAX minimizer_mask's, and the rows
    compacted from per-row counts and mark bitmasks (the model), and by
    the wrapper on the CPU, equal JAX _compact_minimizer_rows's rows[:n]
    and n."""
    rows, lengths = world["cases"][name][1]
    jk, _jh, jmm = (np.asarray(x) for x in
                    jm.minimizer_mask(jnp.asarray(rows), jnp.asarray(lengths),
                                      K, W))
    l0, l1, mark = model_marks(rows, lengths)
    _eq(jk, np.stack([l0, l1], axis=2), "model limbs")
    _eq(jmm, mark, "model marks")
    cap = rows.shape[0] * (rows.shape[1] - K + 1)
    jrows, jn = jm._compact_minimizer_rows(jnp.asarray(rows),
                                           jnp.asarray(lengths), K, W, cap)
    want = np.asarray(jrows)[:int(jn)]
    _eq(want, model_rows(rows, lengths), "model rows")
    got = mm_map.minimizer_rows(torch.as_tensor(rows),
                                torch.as_tensor(lengths), K, W)
    assert got.dtype == torch.int64 and got.shape == (int(jn), 4)
    _eq(want, got, "wrapper rows")
    if rows.shape[1] > 1000:
        assert jmm.sum() > 300


def _pool_builds(calls):
    """Each of calls run in a thread of its own, all at once, with
    tracing on: (their results, the pool_builds counted on their
    spans)."""
    got, go = [None] * len(calls), threading.Barrier(len(calls))

    def worker(i):
        go.wait()
        with tracing.span("pool"):
            got[i] = calls[i]()

    tracing.clear()
    tracing.start()
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(calls))]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=60)
        assert not any(t_.is_alive() for t_ in threads)
    finally:
        tracing.stop()
    builds = sum(r[6].get("pool_builds", 0) for r in tracing.records())
    tracing.clear()
    return got, builds


def test_pool_cache_same_array_same_tensors(world):
    """(e) The same seq_data and seq_off give the very tensors of the first
    call; no second pool is made."""
    g = world["g"]
    dev = torch.device("cpu")
    first = tm._device_pool(g.seq_data, g.seq_off, dev)
    (again,), builds = _pool_builds(
        [lambda: tm._device_pool(g.seq_data, g.seq_off, dev)])
    assert builds == 0 and all(a is b for a, b in zip(again, first))
    _eq(mm_map.pack_pool_nibbles(g.seq_data), first[0], "packed pool")
    assert first[2] is g.seq_data         # the DP reads the host codes


def test_pool_cache_replaced_seq_data_new_pool(world):
    """(e) A graph that replaces its seq_data (as every graph module does)
    gets a new pool with the new codes; the old arrays keep theirs."""
    g = world["g"]
    dev = torch.device("cpu")
    old = tm._device_pool(g.seq_data, g.seq_off, dev)
    new_seq = g.seq_data.copy()
    new_seq[:50] = (new_seq[:50] + 1) % 4
    (new,), builds = _pool_builds(
        [lambda: tm._device_pool(new_seq, g.seq_off, dev)])
    assert builds == 1 and new[0] is not old[0]
    _eq(mm_map.pack_pool_nibbles(new_seq), new[0], "new pool")
    assert not torch.equal(new[0], old[0])
    assert tm._device_pool(g.seq_data, g.seq_off, dev)[0] is old[0]


def test_pool_cache_threads_get_one_pool(world):
    """(e) Threads mapping against one graph at once get one pool: one
    build, the same tensors in every thread."""
    g = world["g"]
    seq, off = g.seq_data.copy(), g.seq_off.copy()
    dev = torch.device("cpu")
    got, builds = _pool_builds(
        [lambda: tm._device_pool(seq, off, dev)] * 8)
    assert len(got) == 8 and builds == 1
    assert all(p[0] is got[0][0] and p[1] is got[0][1] for p in got)


@pytest.mark.parametrize("threshold", ["scalar", "per read"])
def test_map_reads_int32_equals_jax(world, threshold):
    """(b) map_reads (verified; accept and clamp on the device) returns
    int32 arrays equal to the JAX map_reads, with one scalar min_score and
    with an (N,) one."""
    g, idx = world["g"], world["idx"]
    bases, lengths, thr = world["cases"]["reads"][1]
    min_score = 60 if threshold == "scalar" else thr
    jidx = jm.EdgeMinimizerIndex(keys=idx.keys, edge=idx.edge, pos=idx.pos,
                                 count=idx.count, k=idx.k, w=idx.w)
    want = jm.map_reads(jidx, bases, lengths, batch_size=200, graph=g,
                        min_score=min_score)
    got = tm.map_reads(idx, bases, lengths, batch_size=200, graph=g,
                       min_score=min_score, device="cpu")
    for a, b in zip(want, got):
        assert b.dtype == np.int32
        _eq(a, b, f"map_reads, {threshold} threshold")
    assert (got[0] >= 0).sum() > 100 and (got[0] < 0).sum() > 50


def test_wrapper_refuses_bad_tensors(world):
    """(c) dtypes, shapes and parameters the kernel does not take raise
    before any launch, on either device."""
    bases, lengths, thr = world["cases"]["reads"][1]
    b, ln = torch.as_tensor(bases), torch.as_tensor(lengths)
    hk, vals, salt = world["idx"].device_tables("cpu")
    pk, off = torch.as_tensor(world["pk"]), torch.as_tensor(world["off"])
    with pytest.raises(ValueError, match="lengths"):
        mm_map.map_batch(b, ln.long(), hk, vals, salt, K, W)
    with pytest.raises(ValueError, match="bases"):
        mm_map.map_batch(b.long(), ln, hk, vals, salt, K, W)
    with pytest.raises(ValueError, match="disagree"):
        mm_map.map_batch(b, ln[:-1], hk, vals, salt, K, W)
    with pytest.raises(ValueError, match="power of two"):
        mm_map.map_batch(b, ln, hk[:-1], vals[:-4], salt, K, W)
    with pytest.raises(ValueError, match="hkeys"):
        mm_map.map_batch(b, ln, hk.int(), vals, salt, K, W)
    with pytest.raises(ValueError, match="k=16"):
        mm_map.map_batch(b, ln, hk, vals, salt, 16, W)
    with pytest.raises(ValueError, match="48 slots"):
        mm_map.map_batch(b[:, :63].contiguous(), ln, hk, vals, salt, K, W)
    with pytest.raises(ValueError, match="thr"):
        mm_map.map_batch(b, ln, hk, vals, salt, K, W, pk, off,
                         torch.as_tensor(thr[:-1]), MT, MM)
    with pytest.raises(ValueError, match="seq_off"):
        mm_map.map_batch(b, ln, hk, vals, salt, K, W, pk, off.int(),
                         torch.as_tensor(thr), MT, MM)
    e = torch.zeros(len(b), dtype=torch.int64)
    with pytest.raises(ValueError, match="starts"):
        mm_map.gapless_bound(pk, off, e, e.int(), b, ln, MT, MM)
    with pytest.raises(ValueError, match="contiguous"):
        mm_map.gapless_bound(pk, off, e, e, b[:, ::2], ln, MT, MM)
    with pytest.raises(ValueError, match="no 17-mer"):
        mm_map.minimizer_rows(b[:, :16].contiguous(), ln, K, W)
    meta = torch.empty((4, 152), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        mm_map.minimizer_rows(meta, torch.empty(4, dtype=torch.int32,
                                                device="meta"), K, W)


def test_entry_points_on_cuda_raise_without_gpu(world):
    """(c) map_reads, rescore_hits and the index build asked for the card
    raise when none is visible: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    bases, lengths, _ = world["cases"]["reads"][1]
    g = world["g"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.map_reads(world["idx"], bases, lengths, graph=g, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.EdgeMinimizerIndex.build(g, device="cuda")
    e = np.zeros(len(bases), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.rescore_hits(g.seq_data, g.seq_off, e, e, bases, lengths,
                        device="cuda")


def test_cpu_path_never_builds_and_counts_nothing(world, monkeypatch):
    """(d) map_reads (vote and verified), rescore_hits and the index build
    on the CPU take the plain versions: no nvcc, no library, no launch."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path looked for the kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    mm_map.COUNT.reset()
    g = world["g"]
    bases, lengths, thr = world["cases"]["reads"][1]
    idx = tm.EdgeMinimizerIndex.build(g, device="cpu")
    e, h, s = tm.map_reads(idx, bases, lengths, graph=g, min_score=thr,
                           device="cpu")
    ev, _, _ = tm.map_reads(idx, bases, lengths, device="cpu")
    tm.rescore_hits(g.seq_data, g.seq_off, ev, s, bases, lengths,
                    device="cpu")
    assert (e >= 0).sum() > 200 and (ev >= 0).sum() >= (e >= 0).sum()
    assert mm_map.COUNT.launches == 0 and mm_map.COUNT.shapes == []


def test_bench_twin_prints_no_mm_launch_on_cpu(monkeypatch, capsys):
    """(d) The bench twin prints its mm_map launches on a stderr line of
    their own: none on the CPU."""
    from turingassembler_tpu_torch import bench
    monkeypatch.setenv("TA_BENCH_GENOME", "20000")
    monkeypatch.setenv("TA_BENCH_BATCH", "256")
    monkeypatch.setenv("TA_BENCH_NBATCHES", "4")
    assert bench.main(["--device", "cpu"]) == 0
    err = capsys.readouterr().err.splitlines()
    assert [ln for ln in err if ln.startswith("mm_map shapes: ")] == \
        ["mm_map shapes: []"]
