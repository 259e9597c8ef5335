"""The minimizer map kernel (turingassembler_tpu_torch/csrc/mm_map.cu, wrapper
ops/mm_map.py) against the JAX package's mapper on the edge cases of
turingassembler_tpu_torch/testing.py:mm_map_cases.

(a) A numpy model of the kernel's own formulation (hash of each window
position, leftmost argmin over each complete window, the first MM_CAP
marked positions as the ballot compaction keeps them, the cuckoo probe,
a count tally in place of the row sort, the bound read one nibble an
on-edge position) equals JAX _map_batch_verified, _map_batch,
_gapless_bound_dev and minimizer_mask.  (b) The wrapper on CPU tensors
(the plain versions) equals them too.  (c) The wrapper refuses what the
kernel does not take, and the entry points raise for "cuda" without a
GPU.  (d) The CPU path never looks for nvcc and counts no launch.

Tolerance: exact equality; every output is an integer or a flag.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu_torch import _build
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.mapper import minimizers as tm
from turingassembler_tpu_torch.ops import mm_map

torch.set_num_threads(1)

K, W = tm.MM_K, tm.MM_W
MT, MM = 1, -2                    # dp.SCORING_BWA's match and mismatch
M32 = np.uint32(0xFFFFFFFF)


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
        x = (q1 ^ (q0 * np.uint32(0x85EBCA77))) + (salt ^ np.uint32(0x5BD1E995))
    return int((_fmix(x) & np.uint32(mask))[0])


def model_marks(seq, n, k=K, w=W):
    """pack_key and mark_minimizers on one row: (limb 0, limb 1, marks)
    over its P = L - k + 1 window positions."""
    L = len(seq)
    P = L - k + 1
    c = np.where(seq < 4, seq, 0).astype(np.uint32)
    win = sliding_window_view(c, k)
    sh0 = (30 - 2 * np.arange(16)).astype(np.uint32)
    sh1 = (62 - 2 * np.arange(16, k)).astype(np.uint32)
    l0 = np.bitwise_or.reduce(win[:, :16] << sh0, axis=1).astype(np.uint32)
    l1 = np.bitwise_or.reduce(win[:, 16:] << sh1, axis=1).astype(np.uint32)
    clean = (sliding_window_view(seq, k) < 4).all(axis=1)
    valid = clean & (np.arange(P) + k <= n)
    h = np.where(valid, _hash_key(l0, l1), M32)
    mark = np.zeros(P, bool)
    w_len = int(n) - k - w + 2
    n_win = 0 if L - k - w + 2 <= 0 or w_len <= 0 else min(w_len, P)
    if n_win:
        ext = np.concatenate([h, np.full(w, M32, np.uint32)])
        # np.argmin takes the first of equal minima: the leftmost
        best = np.arange(n_win) + sliding_window_view(ext, w)[:n_win].argmin(1)
        best = best[best < P]
        mark[best[valid[best]]] = True
    return l0, l1, mark


def model_bound(pk, off, edge, start, q, n, pad=8 * tm.POOL_PAD_W):
    """gapless: one nibble an on-edge position of the query."""
    e = max(int(edge), 0)
    o, elen = int(off[e]), int(off[e + 1] - off[e])
    j = np.arange(len(q))
    t = int(start) + j
    on = (t >= 0) & (t < elen) & (j < n)
    g = np.clip(o + t + pad, 0, 8 * len(pk) - 1)
    nib = (pk[g >> 3] >> (4 * (g & 7))) & 0xF
    non = int(on.sum())
    nm = int(((q.astype(np.int64) == nib) & on).sum())
    return nm * MT + (non - nm) * MM, non > 0 and edge >= 0


def model_map(bases, lengths, hkeys, vals, salt, pool=None, thr=None):
    """map_kernel read by read: (best_edge, best_hits, est_start[, bound,
    fast]) and the diagnostics (marked positions, edges at the best count,
    singleton hits) of each read."""
    mask = hkeys.shape[0] - 1
    out = {f: [] for f in ("be", "best", "bs", "bound", "fast", "n_marked",
                           "n_best", "tot")}
    for b in range(len(bases)):
        seq, n = bases[b], int(lengths[b])
        l0, l1, mark = model_marks(seq, n)
        slots = np.flatnonzero(mark)[:tm.MM_CAP]  # the ballot compaction
        hits = []
        for p in slots:
            q0, q1 = l0[p], l1[p]
            f = -1
            for which in (0, 1):
                bk = _cuckoo(q0, q1, salt, mask, which)
                row = hkeys[bk]
                match = [t for t in range(4) if row[2 * t] == q0
                         and row[2 * t + 1] == q1]
                if match:
                    f = bk * 4 + match[0]
                    break
            if f >= 0 and vals[f, 0] > 0:
                hits.append((int(vals[f, 0]) - 1, int(vals[f, 1]) - int(p)))
        tally = Counter(e for e, _ in hits)
        best = max(tally.values(), default=0)
        at_best = [e for e, c in tally.items() if c == best]
        tot = len(hits)
        be, bs = -1, -1
        if best > 0 and len(at_best) == 1 and (100 * best >= 85 * tot
                                               or tot <= 2):
            be = at_best[0]
            bs = min(s for e, s in hits if e == be)
        for f, v in (("be", be), ("best", best), ("bs", bs),
                     ("n_marked", int(mark.sum())), ("tot", tot),
                     ("n_best", len(at_best) if best else 0)):
            out[f].append(v)
        if pool is not None:
            bound, feas = model_bound(*pool, be, bs, seq, n)
            out["bound"].append(bound)
            out["fast"].append(feas and bound >= thr[b])
    return {f: np.asarray(v) for f, v in out.items()}


# ---------------------------------------------------------------------------
# the cases, the index and the JAX references
# ---------------------------------------------------------------------------

G, CASES = tt.mm_map_cases(seed=3)


@pytest.fixture(scope="module")
def world():
    g, cases = G, CASES
    idx = tm.EdgeMinimizerIndex.build(g, device="cpu")
    hkeys, vals, salt = idx.hash_tables()
    pk = tm._pack_pool_nibbles(g.seq_data)
    return dict(g=g, cases=cases, idx=idx, hkeys=hkeys, vals=vals, salt=salt,
                pk=pk, off=g.seq_off.astype(np.int64))


def _names(entry):
    return [n for n, (e, _) in CASES.items() if e == entry]


def jax_map(world, bases, lengths, thr):
    u32 = lambda a: jnp.asarray(np.asarray(a).astype(np.uint32))
    args = (jnp.asarray(bases), jnp.asarray(lengths), u32(world["hkeys"]),
            u32(world["vals"]), jnp.uint32(world["salt"]))
    vote = jm._map_batch(*args, K, W)
    ver = jm._map_batch_verified(
        *args, u32(world["pk"]), jnp.asarray(world["off"].astype(np.int32)),
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
        m = model_map(bases, lengths, world["hkeys"], world["vals"],
                      world["salt"], (world["pk"], world["off"]), thr)
        seen["N"] += int(((bases == 4).any(1)).sum())
        seen["short"] += int((lengths < K + W - 1).sum())
        seen["overflow"] += int((m["n_marked"] > tm.MM_CAP).sum())
        seen["tie"] += int((m["n_best"] > 1).sum())
        seen["gated"] += int(((m["n_best"] == 1) & (m["be"] < 0)).sum())
        seen["negative start"] += int((m["bs"] < -1).sum())
        seen["mapped"] += int((m["be"] >= 0).sum())
        seen["fast"] += int(m["fast"].sum())
        seen["slow"] += int(((m["be"] >= 0) & ~m["fast"]).sum())
        seen["thresholds"] = max(seen["thresholds"], len(np.unique(thr)))
    for what in ("N", "short", "overflow", "tie", "gated", "negative start",
                 "fast", "slow"):
        assert seen[what] >= 3, (what, seen)
    assert seen["mapped"] > 300 and seen["thresholds"] > 50, seen
    assert (world["idx"].count > 1).any()           # shared minimizers
    wide = -(-(cases["wide queries"][1][2].shape[1] + 7) // 8) + 1
    assert wide > tm.POOL_PAD_W >= -(-(152 + 7) // 8) + 1


@pytest.mark.parametrize("name", _names("map"))
def test_map_model_and_wrapper_equal_jax(world, name):
    bases, lengths, thr = world["cases"][name][1]
    (jv, jver) = jax_map(world, bases, lengths, thr)
    m = model_map(bases, lengths, world["hkeys"], world["vals"],
                  world["salt"], (world["pk"], world["off"]), thr)
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


@pytest.mark.parametrize("name", _names("bound"))
def test_bound_model_and_wrapper_equal_jax(world, name):
    edges, starts, bases, lengths = world["cases"][name][1]
    want = jax_bound(world, edges, starts, bases, lengths)
    model = np.array([model_bound(world["pk"], world["off"], e, s, q, n)
                      for e, s, q, n in zip(edges, starts, bases, lengths)])
    _eq(want[0], model[:, 0], "model bound")
    _eq(want[1], model[:, 1], "model feas")
    assert model[:, 1].sum() > len(edges) // 4
    assert (model[:, 0] > 20).sum() > 10
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    got = mm_map.gapless_bound(t(world["pk"]), t(world["off"]), t(edges),
                               t(starts), t(bases), t(lengths), MT, MM)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    _eq(want[0], got[0], "wrapper bound")
    _eq(want[1], got[1], "wrapper feas")


@pytest.mark.parametrize("name", _names("rows"))
def test_rows_model_and_wrapper_equal_jax(world, name):
    rows, lengths = world["cases"][name][1]
    jk, _jh, jmm = (np.asarray(x) for x in
                    jm.minimizer_mask(jnp.asarray(rows), jnp.asarray(lengths),
                                      K, W))
    for r in range(len(rows)):
        l0, l1, mark = model_marks(rows[r], lengths[r])
        _eq(jk[r], np.stack([l0, l1], axis=1), f"model limbs, row {r}")
        _eq(jmm[r], mark, f"model marks, row {r}")
    km, is_mm = mm_map.minimizer_rows(torch.as_tensor(rows),
                                      torch.as_tensor(lengths), K, W)
    assert km.dtype == torch.int64 and is_mm.dtype == torch.bool
    _eq(jk, km, "wrapper limbs")
    _eq(jmm, is_mm, "wrapper marks")
    if rows.shape[1] > 1000:
        assert jmm.sum() > 300


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
