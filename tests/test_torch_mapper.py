"""Port parity: mapper/minimizers.py of turingassembler_tpu_torch against
the JAX package's mapper, with the graph and index carried across by
convert.py so both map against identical state.

Tolerance: exact equality of every integer output (minimizer kmers,
hashes and marks, cuckoo tables, votes, gapless bounds, (edges, hits,
starts)).
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.device_build import build_graph_on_device
from turingassembler_tpu.kmer.megasort import count_reads_device
from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.mapper import minimizers as tm
from turingassembler_tpu_torch.ops import mm_map

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _eq(a, b):
    a = np.asarray(a).astype(np.int64)
    b = (b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
         ).astype(np.int64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world():
    """Two contigs (5 kb and 3 kb) assembled by the JAX package, the
    port's copies of graph and index, and the genome pieces."""
    g1 = jt.random_genome(5_000, seed=51)
    g2 = jt.random_genome(3_000, seed=52)
    r1, l1 = jt.sim_reads(g1, coverage=25, read_len=100, seed=53)
    r2, l2 = jt.sim_reads(g2, coverage=25, read_len=100, seed=54)
    reads = np.concatenate([r1, r2])
    lengths = np.concatenate([l1, l2]).astype(np.int32)
    u, c, n = count_reads_device(reads, lengths, 31, chunk_reads=1024,
                                 out_cap_log2=17)
    gj = build_graph_on_device(u, c, n, 31)
    assert gj.n_e == 4
    ij = jm.EdgeMinimizerIndex.build(gj)
    return dict(g1=g1, g2=g2, gj=gj, gt=convert.graph(gj), ij=ij,
                it=convert.minimizer_index(ij))


def _map_reads_mix(world, seed=60):
    """Substitution reads, mid-read indel reads, and reads overhanging
    both ends of contig 1 (noise beyond the edge)."""
    rng = np.random.default_rng(seed)
    g1, g2 = world["g1"], world["g2"]
    a, la = jt.sim_reads(g1, coverage=2, read_len=100, seed=seed,
                         error_rate=0.004, pad_to=104)
    b, lb = tt.sim_indel_reads(g2, 60, read_len=100, seed=seed + 1,
                               pad_to=104, lo=30, hi=70)
    RL = 100
    starts = np.concatenate([np.arange(-40, -9, 3),
                             np.arange(5000 - RL + 10, 5000 - RL + 41, 3)])
    c = np.full((len(starts), 104), 255, np.uint8)
    for i, s in enumerate(starts):
        lo, hi = max(s, 0), min(s + RL, 5000)
        c[i, :RL] = rng.integers(0, 4, RL)
        c[i, lo - s:hi - s] = g1[lo:hi]
    lc = np.full(len(starts), RL, np.int32)
    reads = np.concatenate([a, b, c])
    lengths = np.concatenate([la, lb, lc]).astype(np.int32)
    reads[3, 20] = 4                          # an N base
    return reads, lengths


def test_minimizer_mask_parity():
    rng = np.random.default_rng(1)
    B, L = 40, 130
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(20, L + 1, B).astype(np.int32)
    lengths[:2] = [L, 33]
    seqs[5, 50] = 4
    for i in range(B):
        seqs[i, lengths[i]:] = 255
    jk, jh, jmm = jm.minimizer_mask(seqs, lengths)
    tk, th, tmm = mm_map.minimizer_mask(_t(seqs), _t(lengths), tm.MM_K,
                                         tm.MM_W)
    _eq(jk, tk)
    _eq(jh, th)
    _eq(jmm, tmm)


def test_index_build_and_cuckoo_tables(world):
    it = tm.EdgeMinimizerIndex.build(world["gt"], device="cpu")
    ij = world["ij"]
    for f in ("keys", "edge", "pos", "count"):
        _eq(getattr(ij, f), getattr(it, f))
    assert it.keys.dtype == np.uint32
    jh, jv, js = ij.hash_tables()
    th, tv, ts = it.hash_tables()
    _eq(jh, th)
    _eq(jv, tv)
    assert int(js) == ts


def test_cuckoo_probe_parity(world):
    ij, it = world["ij"], world["it"]
    rng = np.random.default_rng(2)
    absent = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint64)
    absent[:, 1] &= 0xC0000000
    queries = np.concatenate([ij.keys, absent.astype(np.uint32)])
    import jax.numpy as jnp
    jh, jv, js = ij.device_tables()
    je, jp, jf = jm._cuckoo_probe(jh, jv, js, jnp.asarray(queries))
    hk, vals, salt = it.device_tables("cpu")
    te, tp, tf = mm_map.cuckoo_probe(hk, vals, salt,
                                     _t(queries.astype(np.int64)))
    _eq(jf, tf)
    _eq(je, te)
    f = np.asarray(jf)
    _eq(np.asarray(jp)[f], tp.numpy()[f])
    assert f[:len(ij.keys)].all()


def test_vote_core_parity(world):
    reads, lengths = _map_reads_mix(world)
    jh, jv, js = world["ij"].device_tables()
    jout = jm._map_batch(reads, lengths, jh, jv, js, 17, 17)
    hk, vals, salt = world["it"].device_tables("cpu")
    tout = mm_map.plain_vote(_t(reads), _t(lengths), hk, vals, salt, 17, 17)
    for a, b in zip(jout, tout):
        _eq(a, b)
    starts = np.asarray(jout[2])
    assert (starts[np.asarray(jout[0]) >= 0] < 0).any()   # signed starts


@pytest.mark.parametrize("Lq", [152, 8 * mm_map.POOL_PAD_W + 40])
def test_gapless_bound_parity(Lq):
    """Interior, head/tail overhang, short and unmapped lanes; the wide
    width takes the per-position gather."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    lens_e = [7, 300, 51, 1200, 64]
    seq_off = np.concatenate([[0], np.cumsum(lens_e)]).astype(np.int64)
    seq_data = rng.integers(0, 4, seq_off[-1]).astype(np.uint8)
    N = 256
    edges = rng.integers(-1, len(lens_e), N).astype(np.int32)
    starts = rng.integers(-Lq + 1, 1400, N).astype(np.int32)
    bases = rng.integers(0, 4, (N, Lq)).astype(np.uint8)
    lengths = rng.integers(0, Lq + 1, N).astype(np.int32)
    for i in range(0, N, 4):
        e = int(edges[i])
        if e >= 0:
            s = int(starts[i])
            for p in range(max(s, 0), min(s + int(lengths[i]), lens_e[e])):
                bases[i, p - s] = seq_data[seq_off[e] + p]
    jb, jf = jm._gapless_bound_dev(
        jnp.asarray(jm._pack_pool_nibbles(seq_data)),
        jnp.asarray(seq_off.astype(np.int32)), jnp.asarray(edges),
        jnp.asarray(starts), jnp.asarray(bases), jnp.asarray(lengths),
        1, -4, jm.RESCORE_PAD)
    pk, so, _ = tm._device_pool(seq_data, seq_off, torch.device("cpu"))
    _eq(jm._pack_pool_nibbles(seq_data), pk)
    tb, tf = mm_map.plain_gapless_bound(pk, so, _t(edges), _t(starts),
                                        _t(bases), _t(lengths), 1, -4)
    _eq(jf, tf)
    _eq(jb, tb)


def test_map_reads_verified_parity(world, monkeypatch):
    reads, lengths = _map_reads_mix(world)
    rest_sizes = []
    real = tm._dp_verify_rest

    def spy(*a, **kw):
        rest_sizes.append(len(a[6]))
        return real(*a, **kw)

    monkeypatch.setattr(tm, "_dp_verify_rest", spy)
    je, jh, js = jm.map_reads(world["ij"], reads, lengths, graph=world["gj"],
                              batch_size=128)
    te, th, ts = tm.map_reads(world["it"], reads, lengths, graph=world["gt"],
                              batch_size=128, device="cpu")
    assert rest_sizes and rest_sizes[0] >= 30      # the DP remainder ran
    for a, b in ((je, te), (jh, th), (js, ts)):
        assert b.dtype == np.int32
        _eq(a, b)
    assert (te >= 0).mean() > 0.9


def test_map_reads_vote_only_and_shipped(world):
    reads, lengths = _map_reads_mix(world, seed=70)
    je, jh, js = jm.map_reads(world["ij"], reads, lengths, batch_size=256)
    te, th, ts = tm.map_reads(world["it"], reads, lengths, batch_size=100,
                              device="cpu")
    for a, b in ((je, te), (jh, th), (js, ts)):
        _eq(a, b)
    shipped = (_t(reads), _t(lengths))
    se, sh, ss = tm.map_reads(world["it"], reads, lengths, graph=world["gt"],
                              shipped=shipped, with_hits=False, device="cpu")
    ve, vh, vs = tm.map_reads(world["it"], reads, lengths, graph=world["gt"],
                              device="cpu")
    _eq(se, ve)
    _eq(ss, vs)
    assert not sh.any()


def test_rescore_hits_parity(world):
    reads, lengths = _map_reads_mix(world, seed=80)
    jh, jv, js = world["ij"].device_tables()
    edges, _, starts = (np.asarray(x) for x in
                        jm._map_batch(reads, lengths, jh, jv, js, 17, 17))
    gj = world["gj"]
    for thr in (None, np.full(len(reads), 90)):
        ja, jsc = jm.rescore_hits(gj.seq_data, gj.seq_off, edges, starts,
                                  reads, lengths, min_score=thr)
        ta, tsc = tm.rescore_hits(gj.seq_data, gj.seq_off, edges, starts,
                                  reads, lengths, min_score=thr,
                                  device="cpu")
        _eq(ja, ta)
        _eq(jsc, tsc)


def _dp_rest_case(seed, Lq=104, N=160):
    """A pool of five edges, two of them shorter than a read, and reads
    placed at signed starts from far left of the edge to past its end:
    head overhang, tail overhang, both at once on the short edges, and
    lanes with nothing left on the edge (ql_t = 0).  Reads copy the edge
    where they lie on it, with an edit or a deleted base in some."""
    rng = np.random.default_rng(seed)
    lens_e = [7, 300, 51, 1200, 150]
    seq_off = np.concatenate([[0], np.cumsum(lens_e)]).astype(np.int64)
    seq_data = rng.integers(0, 4, seq_off[-1]).astype(np.uint8)
    edges = rng.integers(0, len(lens_e), N).astype(np.int32)
    elen = np.asarray(lens_e)[edges]
    lengths = rng.integers(60, 101, N).astype(np.int32)
    starts = rng.integers(-110, elen + 12).astype(np.int32)
    starts[:5] = [-100, -104, 0, -3, 7]          # ql_t = 0 when len <= 100
    edges[:5] = [1, 1, 0, 0, 0]
    lengths[:2] = 100
    bases = rng.integers(0, 4, (N, Lq)).astype(np.uint8)
    for i in range(N):
        e, s, n = int(edges[i]), int(starts[i]), int(lengths[i])
        lo, hi = max(s, 0), min(s + n, lens_e[e])
        if hi > lo:
            seg = seq_data[seq_off[e] + lo:seq_off[e] + hi].copy()
            if i % 3 == 1 and len(seg) > 20:     # one deleted base
                seg = np.delete(seg, len(seg) // 2)
            elif i % 3 == 2 and len(seg) > 4:    # two substitutions
                seg[rng.integers(0, len(seg), 2)] ^= 1
            bases[i, lo - s:lo - s + len(seg)] = seg
        bases[i, n:] = 255
    return seq_data, seq_off, edges, starts, bases, lengths


@pytest.mark.parametrize("pad", [tm.RESCORE_PAD, 5])
@pytest.mark.parametrize("held", ["host arrays", "tensors"])
def test_dp_verify_rest_windows_parity(held, pad):
    """The remainder DP with its windows cut by tensor operations against
    the JAX package's host window build, on the same lanes."""
    sd, so, edges, starts, bases, lengths = _dp_rest_case(seed=21)
    rest = np.flatnonzero(np.arange(len(edges)) % 7 != 6)
    elen = (so[1:] - so[:-1])[edges[rest]]
    s = starts[rest].astype(np.int64)
    n_on = np.minimum(lengths[rest], elen - s) - np.maximum(-s, 0)
    assert (n_on <= 0).sum() >= 3                      # ql_t = 0 lanes
    assert ((s < 0) & (n_on > 0)).sum() >= 10          # head overhang
    assert ((s + lengths[rest] > elen) & (n_on > 0)).sum() >= 10   # tail
    assert ((elen < lengths[rest]) & (n_on > 0)).sum() >= 10  # short edge
    want = jm._dp_verify_rest(sd, so, edges, starts, bases, lengths, rest,
                              (1, -2, 3, 1), pad)
    args = (sd, so, edges, starts, bases, lengths)
    if held == "tensors":
        args = tuple(_t(a) for a in args)
    got = tm._dp_verify_rest(*args, rest, (1, -2, 3, 1), pad, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    _eq(want, got)
    assert (got[n_on <= 0] == 0).all()
    assert (got > 40).sum() >= 30                      # real alignments


def test_dp_verify_rest_matches_per_lane_windows():
    """Each lane's score equals the plain DP on a window cut for that
    lane alone with Python slices."""
    from turingassembler_tpu_torch.ops import dp as tdp
    sd, so, edges, starts, bases, lengths = _dp_rest_case(seed=22, N=60)
    pad = tm.RESCORE_PAD
    rest = np.arange(len(edges))
    got = tm._dp_verify_rest(sd, so, edges, starts, bases, lengths, rest,
                             tdp.SCORING_BWA, device="cpu")
    for i in rest:
        e, s, n = int(edges[i]), int(starts[i]), int(lengths[i])
        elen = int(so[e + 1] - so[e])
        qlo = max(-s, 0)
        qhi = max(min(n, elen - s), qlo)
        if qhi == qlo:
            assert got[i] == 0
            continue
        s0 = min(max(s + qlo, 0), max(elen - 1, 0))
        w0, w1 = max(s0 - pad, 0), min(s0 + qhi - qlo + pad, elen)
        q = bases[i, qlo:qhi][None, :]
        t = sd[so[e] + w0:so[e] + w1][None, :]
        want = tdp.affine_scores(q, [qhi - qlo], t, [w1 - w0],
                                 tdp.SCORING_BWA, mode="fit", device="cpu")
        assert got[i] == want[0], i
