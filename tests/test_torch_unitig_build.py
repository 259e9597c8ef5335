"""Port parity: ops/unitig_build.py (the level-0 unitig build's device
program, the kernels of csrc/unitig_build.cu) on the CPU against the JAX
package's build on the same k-edge tables, and numpy models of the
kernels' algorithms against the plain versions.

On the CPU every entry runs its plain version; the card's kernels are held
against those by chip_smoke.py (phases 25-26).  Here, on
testing.unitig_build_cases (a circular genome, a palindromic k-edge beside
a poly-A run, a palindromic node, exact repeats, error-laden branching, k
= 15, 16, 31, 32, 45, 48, 63, one k-edge, none):
  - front_keys == JAX `_front` :71-86 and `_fingerprints` (the JAX
    package's ops, eager); link_nodes and rank_chains == JAX `_front`'s
    outputs on a table of capacity n (the same lanes); the cycle break and
    the second ranking == JAX `_break_cycles`; assemble_unitigs == JAX
    `_assemble`; the whole build == JAX build_graph_on_device;
  - numpy models of the kernels == the plain versions: front_kernel's
    uint32 arithmetic (murmur, reverse complement, orientation);
    link_nodes' run pass (node ids by the tiles' look-back, each run
    reduced by the tile it starts in, past the tile where it goes on: the
    byte-nibble adjacency by OR and its popcount degrees (== the plain
    `degrees`), the successors and the two highest rc lanes by max; a
    word a lane and a pred a key) and lane pass, also on made-up
    fingerprint collisions (testing.link_collision_cases) and with equal
    rows in any order; rank_chains' ruling set (the hashed
    samples, the walks packing (ruler, offset) words, promotions, the
    ruler rounds, the finish, the cycle lanes doubled; == JAX
    `_rank_chains`, also on random chains with short cycles holding no
    sample, cycles of samples, one chain, no predecessors, D = 2^m and
    2^m + 1, at strides 1 to 1,024), the cycle lanes' closed form;
    assemble_unitigs' scans, the sums grouped by warp then in a block's
    table (lo / hi 16-bit halves; one row add a unitig a tile), the pool
    writes, the ends and the renumbering (marks and a scan; ==
    torch.unique's inverse);
  - no CPU call reaches the kernel build, and a tensor off the CPU never
    reaches a plain version (meta tensors, the build stubbed to raise);
  - a build makes one stacked scalar pull (two after a cycle break) and
    two output pulls.
Mirror any edit of csrc/unitig_build.cu in the models here.  Tolerance:
exact equality everywhere (integers).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turingassembler_tpu.graph import device_build as jdb
from turingassembler_tpu.ops import kmers as jkm
from turingassembler_tpu.ops import limbs as jlb
from turingassembler_tpu_torch import _build
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch import tracing
from turingassembler_tpu_torch.graph import device_build as tdb
from turingassembler_tpu_torch.ops import kmer_sort as ks
from turingassembler_tpu_torch.ops import limbs as tl
from turingassembler_tpu_torch.ops import unitig_build as ub

torch.set_num_threads(1)

CASES = tt.unitig_build_cases()
LIVE = [name for name, (u, _, _) in CASES.items() if len(u)]
ARRAYS = ("edge_source", "edge_target", "edge_rc", "edge_count", "seq_off",
          "seq_data", "node_rc", "adj_off", "adj_list")
U32 = np.uint32
M32 = U32(0xFFFFFFFF)
SCAN_PER, SCAN_TILE = 8, 256 * 8       # csrc/unitig_build.cu's scan
THREADS = 256
RUN_TILE, RUN_FIRST = THREADS * 2, 32  # link_runs_kernel's tile, first step
LINK_SUCC = 1 << 30                    # a lane word's successor flag
UNVISITED, NO_RULER = -1, -2 ** 31    # rank_chains' markers
MAX_WALK_BITS = 10                     # a walk's offset bits at most
SUM_TILE, SUM_SLOTS, SUM_PROBES = 256 * 16, 1024, 4   # unitig_sums_kernel
POPC4 = np.array([bin(i).count("1") for i in range(16)], np.int64)


# ---------------------------------------------------------------------------
# the port's plain chain and the JAX functions, once a case
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port(name):
    """The plain entries in the build's order on the case's table."""
    u, c, k = CASES[name]
    tu, tc = torch.as_tensor(u), torch.as_tensor(c)
    fp, flags, info = ub.front_keys(tu, k)
    order = ks.lex_order(fp)
    sk, tk, lbase, prev = ub.link_nodes(fp, order, flags)
    head, dist, info = ub.rank_chains(prev, info.clone())
    n_cyc, n_e, _ = info.tolist()
    out = {"fp": fp, "flags": flags, "order": order, "src_key": sk,
           "tgt_key": tk, "lastbase": lbase, "prev_ptr": prev,
           "head_of": head, "dist": dist, "n_cyc": n_cyc, "n_e": n_e}
    if n_cyc:
        prev, head, dist = tdb._break_cycles(prev, head, info)
        out.update(broken=(prev, head, dist), n_e=info.tolist()[1])
    lanes = out.get("broken", (prev, head, dist))
    out["unitigs"] = ub.assemble_unitigs(tu, tc, sk, tk, lbase, lanes[1],
                                         lanes[2], k, out["n_e"])
    out["lanes"] = lanes
    return out


@functools.lru_cache(maxsize=None)
def _jax_front(name):
    """JAX _front on the case's table at capacity n: the port's lanes."""
    u, c, k = CASES[name]
    out = jdb._front(jnp.asarray(u.astype(np.uint32)), jnp.asarray(c),
                     jnp.asarray(len(u), jnp.int32), k)
    return tuple(np.asarray(x) for x in out)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_cases_hold_their_features():
    """Each named feature is in its table."""
    def rc_rows(u, k1):
        return tl.np_revcomp_limbs(u.astype(np.uint32), k1).astype(np.int64)

    u, _, k = CASES["palindromic k-edge and poly-A, k=21"]
    assert (rc_rows(u, k + 1) == u).all(axis=1).any()      # rc(e) == e
    assert (u == 0).all(axis=1).any()                        # poly-A k-edge
    u, _, k = CASES["palindromic node, k=20"]
    nodes = np.concatenate([np.asarray(x) for x in jkm.split_kedge(
        jnp.asarray(u.astype(np.uint32)), k)])
    assert (tl.np_revcomp_limbs(nodes, k) == nodes).all(axis=1).any()
    assert _port("circular, k=21")["n_cyc"] > 0
    assert _port("error-laden branching, k=31")["n_e"] > 100
    assert {tl.n_limbs(k) * 10 + tl.n_limbs(k + 1)
            for _, _, k in CASES.values()} >= {11, 12, 22, 23, 33, 34, 44}


# ---------------------------------------------------------------------------
# plain entries == the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LIVE)
def test_front_keys_vs_jax(name):
    """fp == JAX _fingerprints of the canonical prefix and suffix nodes;
    the flags == JAX's orientations and end bases."""
    u, _, k = CASES[name]
    ju = jnp.asarray(u.astype(np.uint32))
    pre, suf = jkm.split_kedge(ju, k)
    pre_rc, suf_rc = jlb.revcomp_limbs(pre, k), jlb.revcomp_limbs(suf, k)
    o_pre, o_suf = jlb.lex_lt(pre_rc, pre), jlb.lex_lt(suf_rc, suf)
    cpre = jnp.where(o_pre[:, None], pre_rc, pre)
    csuf = jnp.where(o_suf[:, None], suf_rc, suf)
    fpA, fpB = jdb._fingerprints(jnp.concatenate([cpre, csuf]))
    p = _port(name)
    fp = p["fp"].numpy().view(np.uint32)
    np.testing.assert_array_equal(fp[:, 0], np.asarray(fpA))
    np.testing.assert_array_equal(fp[:, 1], np.asarray(fpB))
    f = p["flags"].numpy().astype(np.int64)
    np.testing.assert_array_equal(f & 1, np.asarray(o_pre))
    np.testing.assert_array_equal((f >> 1) & 1, np.asarray(o_suf))
    np.testing.assert_array_equal((f >> 2) & 3,
                                  np.asarray(jkm.kedge_first_base(ju)))
    np.testing.assert_array_equal((f >> 4) & 3,
                                  np.asarray(jkm.kedge_last_base(ju, k)))


@pytest.mark.parametrize("name", LIVE)
def test_link_nodes_vs_jax(name):
    src_key, tgt_key, lastbase, prev_ptr = _jax_front(name)[:4]
    p = _port(name)
    for got, want in ((p["src_key"], src_key), (p["tgt_key"], tgt_key),
                      (p["lastbase"], lastbase), (p["prev_ptr"], prev_ptr)):
        assert got.dtype in (torch.int32, torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", LIVE)
def test_rank_chains_vs_jax(name):
    head_of, dist, n_cyc = _jax_front(name)[4:]
    p = _port(name)
    np.testing.assert_array_equal(p["head_of"].numpy(), head_of)
    np.testing.assert_array_equal(p["dist"].numpy(), dist)
    assert p["n_cyc"] == int(n_cyc)
    if not n_cyc:
        assert p["n_e"] == int((head_of == np.arange(len(head_of))).sum())


def test_break_cycles_vs_jax():
    """The circular case: two pure cycles broken at mirrored adjacencies,
    ranked again, == JAX _break_cycles; no cycle is left."""
    name = "circular, k=21"
    p = _port(name)
    assert p["n_cyc"] > 0
    want = jdb._break_cycles(jnp.asarray(p["prev_ptr"].numpy()),
                             jnp.asarray(p["head_of"].numpy()))
    for got, w in zip(p["broken"], want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    prev, head, _ = p["broken"]
    assert not (prev.numpy()[head.numpy()] >= 0).any()
    assert p["n_e"] == 2


@pytest.mark.parametrize("name", LIVE)
def test_assemble_vs_jax(name):
    u, c, k = CASES[name]
    p = _port(name)
    _, head_of, dist = p["lanes"]
    n, n_e = len(u), p["n_e"]
    seq_cap = (2 * n + k * n_e + 3) // 4 * 4
    out = jdb._assemble(
        jnp.asarray(u.astype(np.uint32)), jnp.asarray(c),
        jnp.asarray(n, jnp.int32), *(jnp.asarray(_np(x)) for x in (
            p["src_key"], p["tgt_key"], p["lastbase"], head_of, dist)),
        k, n_e, seq_cap)
    (n_edges, total, n_v2, packed, seq_len, ecount, edge_rc, edge_source,
     edge_target) = (np.asarray(x) for x in out)
    got = p["unitigs"]
    assert int(n_edges) == n_e and int(n_v2) == int(got.n_v.item())
    seq = ((packed[:, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3) \
        .reshape(-1)[:int(total)]
    np.testing.assert_array_equal(got.seq.numpy(), seq)
    np.testing.assert_array_equal(
        got.seq_off.numpy(), np.concatenate([[0], np.cumsum(seq_len)]))
    for g_, w_ in ((got.edge_count, ecount), (got.edge_rc, edge_rc),
                   (got.edge_source, edge_source),
                   (got.edge_target, edge_target)):
        np.testing.assert_array_equal(g_.numpy(), w_)


@pytest.mark.parametrize("name", list(CASES))
def test_build_vs_jax(name):
    """The whole build (CPU) == JAX build_graph_on_device, array for array
    (the JAX table padded to its power-of-two capacity)."""
    u, c, k = CASES[name]
    n = len(u)
    gt = tdb.build_graph_on_device(torch.as_tensor(u), torch.as_tensor(c), n,
                                   k, device="cpu")
    if not n:
        gj = jdb.build_graph_on_device(None, None, 0, k)
    else:
        cap = 1 << max((n - 1).bit_length(), 10)
        ju = np.full((cap, u.shape[1]), 0xFFFFFFFF, np.uint32)
        ju[:n] = u
        jc = np.zeros(cap, np.int32)
        jc[:n] = c
        gj = jdb.build_graph_on_device(jnp.asarray(ju), jnp.asarray(jc), n, k)
    assert gt.n_e == gj.n_e and gt.n_v == gj.n_v
    for f in ARRAYS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert a.shape == b.shape, f
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# numpy models of the kernels
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def model_murmur(c, seed):
    """front_kernel's murmur: uint32 products that wrap."""
    h = np.full(len(c), seed, np.uint32)
    for limb in range(c.shape[1]):
        x = c[:, limb] * U32(0xCC9E2D51)
        x = _rotl(x, 15) * U32(0x1B873593)
        h = _rotl(h ^ x, 13) * U32(5) + U32(0xE6546B64)
    h ^= h >> U32(16)
    h *= U32(0x85EBCA6B)
    h ^= h >> U32(13)
    h *= U32(0xC2B2AE35)
    return h ^ (h >> U32(16))


def _rev2(x):
    x = ((x & U32(0x33333333)) << U32(2)) | ((x >> U32(2)) & U32(0x33333333))
    x = ((x & U32(0x0F0F0F0F)) << U32(4)) | ((x >> U32(4)) & U32(0x0F0F0F0F))
    x = ((x & U32(0x00FF00FF)) << U32(8)) | ((x >> U32(8)) & U32(0x00FF00FF))
    return (x << U32(16)) | (x >> U32(16))


def _lex_lt(a, b):
    lt = np.zeros(len(a), bool)
    eq = np.ones(len(a), bool)
    for limb in range(a.shape[1]):
        lt |= eq & (a[:, limb] < b[:, limb])
        eq &= a[:, limb] == b[:, limb]
    return lt


def model_front(u, k):
    """front_kernel: (fp (2n, 2) uint32, flags (n,) uint8)."""
    x = u.astype(np.uint32)
    nl, nl1 = tl.n_limbs(k), tl.n_limbs(k + 1)
    pad, used = 32 * nl - 2 * k, 2 * k - 32 * (nl - 1)
    mask = M32 if used == 32 else U32((0xFFFFFFFF << (32 - used)) & 0xFFFFFFFF)
    first = x[:, 0] >> U32(30)
    last = (x[:, k // 16] >> U32(30 - 2 * (k % 16))) & U32(3)
    pre = x[:, :nl].copy()
    suf = x[:, :nl] << U32(2)
    for limb in range(nl):
        if limb + 1 < nl1:
            suf[:, limb] |= x[:, limb + 1] >> U32(30)
    pre[:, -1] &= mask
    suf[:, -1] &= mask

    def revcomp(y):
        r = _rev2(~y[:, ::-1])
        out = r.copy()
        if pad:
            out = r << U32(pad)
            out[:, :-1] |= r[:, 1:] >> U32(32 - pad)
        out[:, -1] &= mask
        return out

    fps, orient = [], []
    for node in (pre, suf):
        rc = revcomp(node)
        o = _lex_lt(rc, node)
        canon = np.where(o[:, None], rc, node)
        a = model_murmur(canon, 0x9E3779B9)
        a[a == M32] = M32 - U32(1)
        fps.append(np.stack([a, model_murmur(canon, 0x27D4EB2F)], axis=1))
        orient.append(o.astype(np.uint32))
    flags = orient[0] | orient[1] << U32(1) | first << U32(2) | last << U32(4)
    return np.concatenate(fps), flags.astype(np.uint8)


def model_scan(v):
    """The tiled look-back scan: the exclusive prefix of v, each block's
    offset the sum of the tiles before it, each thread's SCAN_PER values
    in order after its block's exclusive prefix of thread sums."""
    v = np.asarray(v, np.int64)
    n = len(v)
    pad = -n % SCAN_TILE
    tiles = np.concatenate([v, np.zeros(pad, np.int64)]).reshape(
        -1, SCAN_TILE // SCAN_PER, SCAN_PER)
    thread_sums = tiles.sum(axis=2)
    tile_off = np.concatenate([[0], np.cumsum(thread_sums.sum(axis=1))[:-1]])
    before = np.cumsum(thread_sums, axis=1) - thread_sums
    run = tile_off[:, None, None] + before[:, :, None] + \
        np.cumsum(tiles, axis=2) - tiles
    return run.reshape(-1)[:n]


def _lane_flags(flags, d, n):
    """link_runs_kernel's lane_flags: each lane's source orientation and
    last base."""
    rc = d >= n
    f = flags[np.where(rc, d - n, d)].astype(np.int64)
    return (np.where(rc, 1 - ((f >> 1) & 1), f & 1),
            np.where(rc, 3 - ((f >> 2) & 3), (f >> 4) & 3))


def model_link(fp, order, flags):
    """ub_link_launch: link_runs_kernel a tile of RUN_TILE positions at a
    time (the run starts, each run's slot among the tile's starts and its
    node id after the look-back's prefix; the tile's last run followed
    past the tile, RUN_FIRST positions then THREADS at a time; the slots'
    adjacency byte, highest lane and two highest rc lanes by orientation;
    each lane's word (source key | LINK_SUCC where it is its key's
    successor on a chain), written once, and each key's pred in node
    order), then link_lanes_kernel a k-edge at a time (prev_ptr its key's
    pred where the word has LINK_SUCC).  Returns (src_key, tgt_key,
    lastbase, prev_ptr, degs (2D,) by key, the positions each tile
    followed past its end)."""
    D = len(fp)
    n = D // 2
    s = fp[order]
    start = np.ones(D, bool)
    start[1:] = (s[1:] != s[:-1]).any(axis=1)
    word = np.zeros(D, np.int64)
    pred = np.full(2 * D, -3, np.int64)              # -3: never written
    written = np.zeros(D, np.int64)
    degs = np.zeros(2 * D, np.int64)
    past = []
    for j0 in range(0, D, RUN_TILE):
        j1 = min(j0 + RUN_TILE, D)
        runs = int(start[j0:j1].sum())
        r = np.cumsum(start[j0:j1]) - 1       # the slot; -1: an earlier run
        base = int(start[:j0].sum())          # the look-back's prefix
        pos, slot = np.arange(j0, j1)[r >= 0], r[r >= 0]
        ext, step = j1, RUN_FIRST
        while runs and j1 < D:
            c = int((s[ext:ext + step] == s[j1 - 1]).all(axis=1).sum())
            ext += c
            if c < step:
                break
            step = THREADS
        pos = np.concatenate([pos, np.arange(j1, ext)])
        slot = np.concatenate([slot, np.full(ext - j1, runs - 1)])
        past.append(ext - j1)
        d = order[pos]
        so, lb = _lane_flags(flags, d, n)
        rc = np.where(d >= n, d - n, d + n)
        adj = np.zeros(runs, np.int64)
        np.bitwise_or.at(adj, slot, 1 << (so * 4 + lb))
        succ = np.full((2, runs), -1, np.int64)
        np.maximum.at(succ, (so, slot), d)
        top = np.full((2, 2, runs), -1, np.int64)
        np.maximum.at(top, (so, 0, slot), rc)
        second = rc != top[so, 0, slot]
        np.maximum.at(top, (so[second], 1, slot[second]), rc[second])
        chain = (POPC4[adj & 15] == 1) & (POPC4[adj >> 4] == 1)   # run_chain
        word[d] = 2 * (base + slot) + so + \
            np.where(chain[slot] & (succ[so, slot] == d), LINK_SUCC, 0)
        written[d] += 1
        i = np.arange(2 * runs)                              # run_pred
        r_, o_ = i >> 1, i & 1
        first = top[1 - o_, 0, r_]
        pred[2 * base + i] = np.where(chain[r_], np.where(
            first != succ[o_, r_], first, top[1 - o_, 1, r_]), -1)
        nodes = base + np.arange(runs)
        degs[2 * nodes] = POPC4[adj & 15]
        degs[2 * nodes + 1] = POPC4[adj >> 4]
    assert (written == 1).all()
    f = flags.astype(np.int64)
    sk = word & (LINK_SUCC - 1)
    prev = np.where(word & LINK_SUCC, pred[sk], -1)
    assert (prev >= -1).all()
    tk = np.concatenate([sk[n:], sk[:n]]) ^ 1
    lbase = np.concatenate([(f >> 4) & 3, 3 - ((f >> 2) & 3)])
    return sk, tk, lbase.astype(np.uint8), prev, degs, past


def mix32(x):
    """csrc/unitig_build.cu's mix32 (murmur3's finalizer), uint32."""
    h = np.asarray(x).astype(np.uint32)
    h ^= h >> U32(16)
    h *= U32(0x85EBCA6B)
    h ^= h >> U32(13)
    h *= U32(0xC2B2AE35)
    return h ^ (h >> U32(16))


def ruler_lane(i, sh):
    """The sampled lane of ruler block i (lanes [i << sh, (i + 1) << sh))."""
    i = np.asarray(i, np.int64)
    return (i << sh) | (mix32(i) & U32((1 << sh) - 1)).astype(np.int64)


def is_ruler_lane(d, sh):
    d = np.asarray(d, np.int64)
    return (d & ((1 << sh) - 1)) == \
        (mix32(d >> sh) & U32((1 << sh) - 1)).astype(np.int64)


def walk_bits(D, n_r):
    """csrc's walk_bits: the offset bits of a lane's word."""
    for ob in range(MAX_WALK_BITS, 0, -1):
        if n_r + (D >> ob) + 1 + D <= 1 << (31 - ob):
            return ob
    return 0


def model_rank(prev, stride=ub.RANK_STRIDE, walks=None, promoted=None):
    """ub_rank_launch: the successors, the heads listed with their rows
    settled (rank_link_kernel); a walk from each head and each block's
    sample with a predecessor to the next sample or the chain's end,
    packing each lane's (ruler id << ob | offset) into its word, a ruler
    promoted after the offset 2^ob - 1 (rank_walk_kernel); Wyllie on the
    samples' and promoted rulers' rows until none is pending or the round
    cap (rank_rulers_kernel; in place on the card, which settles every
    chain's rows to the same values); each lane from its word and its
    ruler's row (rank_finish_kernel); the cycle lanes doubled R rounds
    among themselves (rank_cycles_kernel).  (head_of, dist, n_cyc, n_e);
    each walk's lane count appended to `walks`, the promoted rulers'
    count to `promoted` (the kernel's tally: len(walks), max(walks), the
    promoted, walk_bits)."""
    D = len(prev)
    sh = stride.bit_length() - 1
    d = np.arange(D)
    succ = np.full(D, -1, np.int64)
    succ[prev[prev >= 0]] = d[prev >= 0]
    n_r = -(-D // stride)
    ob = walk_bits(D, n_r)
    hbase = n_r + (D >> ob) + 1
    rs = np.full((hbase + D, 2), -7, np.int64)    # never read unwritten
    rs[d[(prev < 0) & is_ruler_lane(d, sh)] >> sh] = (NO_RULER, 0)
    if ruler_lane((D - 1) >> sh, sh) >= D:
        rs[(D - 1) >> sh] = (NO_RULER, 0)
    heads = d[prev < 0]
    rs[hbase + np.arange(len(heads))] = np.stack([~heads, 0 * heads], axis=1)
    word = np.full(D, UNVISITED, np.int64)
    starts = [(int(h), hbase + t) for t, h in enumerate(heads)]
    starts += [(int(r), i)
               for i, r in enumerate(ruler_lane(np.arange(n_r), sh))
               if r < D and prev[r] >= 0]
    extra = 0
    for start, ident in starts:
        word[start] = ident << ob
        cur, off, n_ = start, 1, 1
        while succ[cur] >= 0:
            x = int(succ[cur])
            if is_ruler_lane(x, sh):
                rs[x >> sh] = (ident, off)
                break
            if off > (1 << ob) - 1:
                rs[n_r + extra] = (ident, off)
                ident, off, extra = n_r + extra, 0, extra + 1
            word[x] = ident << ob | off
            cur, off, n_ = x, off + 1, n_ + 1
        if walks is not None:
            walks.append(n_)
    if promoted is not None:
        promoted.append(extra)
    live = np.r_[0:n_r + extra]
    assert (rs[live, 0] != -7).all(), "a ruler row no walk wrote"
    for _ in range(ub.rounds(hbase)):
        pend = live[rs[live, 0] >= 0]
        a = rs[rs[pend, 0]]
        rs[pend] = np.stack([a[:, 0], rs[pend, 1] + a[:, 1]], axis=1)
        if not (a[:, 0] >= 0).any():
            break
    cyc = word == UNVISITED
    g = rs[word[~cyc] >> ob]
    cyc[~cyc] = g[:, 0] >= 0
    head, dist = np.full(D, -7, np.int64), np.full(D, -7, np.int64)
    g = rs[word[~cyc] >> ob]
    head[~cyc], dist[~cyc] = ~g[:, 0], g[:, 1] + (word[~cyc] & ((1 << ob) - 1))
    R = ub.rounds(D)
    anc = prev.copy()
    for _ in range(R):
        nxt = anc.copy()
        nxt[cyc] = anc[anc[cyc]]
        anc = nxt
    head[cyc], dist[cyc] = anc[cyc], 1 << R
    return head, dist, int(cyc.sum()), int((head == d).sum())


def model_block_sums(u_of, c, n_e, atomics=None):
    """unitig_sums_kernel: a tile of SUM_TILE lanes at a time, each warp's
    lanes grouped by unitig (the counts' 16-bit halves summed), the
    groups' leaders in lane order into a SUM_SLOTS table (u's slot or a
    free one within SUM_PROBES, else straight to the row), the table into
    the rows.  (ulen, ecount); `atomics` (n_e,) counts the adds to each
    unitig's row."""
    D = len(u_of)
    ulen = np.zeros(n_e, np.int64)
    ecount = np.zeros(n_e, np.int64)
    adds = np.zeros(n_e, np.int64) if atomics is None else atomics

    def row_add(u, n_, cnt):
        ulen[u] += n_
        ecount[u] += cnt
        adds[u] += 1

    for t0 in range(0, D, SUM_TILE):
        u = u_of[t0:t0 + SUM_TILE]
        cc = c[t0:t0 + SUM_TILE]
        key = (np.arange(len(u)) // 32) * (n_e + 1) + u
        groups, first, inv = np.unique(key, return_index=True,
                                       return_inverse=True)
        lo = np.bincount(inv, weights=cc & 0xFFFF).astype(np.int64)
        hi = np.bincount(inv, weights=cc >> 16).astype(np.int64)
        size = np.bincount(inv)
        slot_key = np.full(SUM_SLOTS, -1, np.int64)
        slot_len = np.zeros(SUM_SLOTS, np.int64)
        slot_cnt = np.zeros(SUM_SLOTS, np.int64)
        for gi in np.argsort(first):
            gu, cnt = int(groups[gi] % (n_e + 1)), lo[gi] + (hi[gi] << 16)
            slot = gu & (SUM_SLOTS - 1)
            for _ in range(SUM_PROBES):
                if slot_key[slot] in (-1, gu):
                    slot_key[slot] = gu
                    slot_len[slot] += size[gi]
                    slot_cnt[slot] += cnt
                    break
                slot = (slot + 1) & (SUM_SLOTS - 1)
            else:
                row_add(gu, size[gi], cnt)
        for s in np.flatnonzero(slot_key >= 0):
            row_add(slot_key[s], slot_len[s], slot_cnt[s])
    return ulen, ecount


def model_assemble(u, counts, sk, tk, lbase, head, dist, k, n_e):
    """ub_assemble_launch: (seq_off, ecount, edge_rc, edge_source,
    edge_target, n_v, seq); seq_off by the look-back scan, the tail lanes
    listed, then the ends a unitig each, the endpoints renumbered by the
    marks and their scan."""
    D = len(head)
    n = D // 2
    d = np.arange(D)
    is_head = head == d
    u_all = np.full(D, -1, np.int64)
    u_all[is_head] = model_scan(is_head)[is_head]
    head_d = d[is_head]
    u_of = u_all[head]
    ulen, esum = model_block_sums(u_of, counts[d % n].astype(np.int64), n_e)
    seq_off = np.empty(n_e + 1, np.int64)
    seq_off[:n_e] = model_scan(k + ulen)
    seq_off[n_e] = seq_off[n_e - 1] + k + ulen[-1]
    seq = np.full(D + k * n_e, 255, np.uint8)
    seq[(seq_off[u_of] + k + dist)[dist > 0]] = lbase[dist > 0]
    seq[seq_off[:-1] + k] = lbase[head_d]          # the head k-mer's warp
    tail = dist == ulen[u_of] - 1                  # write_seq_kernel's tails
    assert np.bincount(u_of[tail], minlength=n_e).max() == 1
    tail_d = np.full(n_e, -1, np.int64)
    tail_d[u_of[tail]] = d[tail]
    ecount = esum                                  # the ends, a unitig each
    edge_rc = u_all[head[np.where(tail_d < n, tail_d + n, tail_d - n)]]
    es, et = sk[head_d], tk[tail_d]
    q = np.arange(n_e * k)
    uu, j = q // k, q % k
    hd = head_d[uu]
    rc = hd >= n
    pos = np.where(rc, k - j, j)
    limb = u[np.where(rc, hd - n, hd), pos // 16]
    b = (limb >> (30 - 2 * (pos % 16))) & 3
    seq[seq_off[uu] + j] = np.where(rc, 3 - b, b)
    used = np.zeros(D, np.int64)
    used[es >> 1] = 1
    used[et >> 1] = 1
    nid = model_scan(used)
    src, tgt = 2 * nid[es >> 1] + (es & 1), 2 * nid[et >> 1] + (et & 1)
    return seq_off, ecount, edge_rc, src, tgt, 2 * int(used.sum()), seq


@pytest.mark.parametrize("nl", [1, 2, 3, 4])
def test_murmur_model(nl):
    """uint32 murmur == ops/limbs.py:hash_limbs (int64 pieces), with 0 and
    all-ones limbs, both seeds."""
    rng = np.random.default_rng(nl)
    c = rng.integers(0, 1 << 32, (5_000, nl), dtype=np.int64)
    c[:100] = 0
    c[100:200] = 0xFFFFFFFF
    for seed in (0x9E3779B9, 0x27D4EB2F):
        want = tl.hash_limbs(torch.as_tensor(c), seed=seed).numpy()
        np.testing.assert_array_equal(model_murmur(c.astype(np.uint32), seed),
                                      want)


@pytest.mark.parametrize("name", LIVE)
def test_front_model(name):
    u, _, k = CASES[name]
    fp, flags = model_front(u, k)
    p = _port(name)
    np.testing.assert_array_equal(p["fp"].numpy().view(np.uint32), fp)
    np.testing.assert_array_equal(p["flags"].numpy(), flags)


@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 10_000])
def test_scan_model(n):
    v = np.random.default_rng(n).integers(0, 50, n)
    np.testing.assert_array_equal(model_scan(v), np.cumsum(v) - v)


@pytest.mark.parametrize("name", LIVE)
def test_link_model(name):
    """The run pass (node ids by the tiles' look-back, each run's
    byte-nibble adjacency and its popcount degrees (== the plain
    degrees), its highest lanes, prev_ptr from them) and the lane pass ==
    plain link_nodes."""
    p = _port(name)
    fp, order, flags = p["fp"].numpy(), p["order"].numpy(), p["flags"].numpy()
    sk, tk, lbase, prev, degs, _ = model_link(fp, order, flags)
    for got, want in ((p["src_key"], sk), (p["tgt_key"], tk),
                      (p["lastbase"], lbase), (p["prev_ptr"], prev)):
        np.testing.assert_array_equal(got.numpy(), want)
    n = len(flags)
    node = np.empty(2 * n, np.int64)
    node[order] = np.cumsum(tl.run_starts(torch.as_tensor(fp[order]))
                            .numpy()) - 1
    want = ub.degrees(torch.as_tensor(node[:n]), torch.as_tensor(node[n:]),
                      p["flags"]).numpy()
    np.testing.assert_array_equal(degs, want)


# tables of at least 5,000 lanes whose fingerprints the collision cases
# remake
LINK_BASES = ("error-laden branching, k=31", "k=45", "circular, k=21")


@functools.lru_cache(maxsize=None)
def _collisions(base):
    p = _port(base)
    return tt.link_collision_cases(p["fp"].numpy(), p["flags"].numpy(),
                                   seed=len(base))


def _hold_link(fp, order, flags):
    """model_link == plain link_nodes on the given inputs; returns the
    positions each tile followed past its end."""
    want = ub.plain_link_nodes(torch.as_tensor(fp), torch.as_tensor(order),
                               torch.as_tensor(flags))
    got = model_link(fp, order, flags)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g, w.numpy())
    return got[5]


@pytest.mark.parametrize("case", tt.LINK_COLLISIONS)
@pytest.mark.parametrize("base", LINK_BASES)
def test_link_model_on_collisions(base, case):
    """Made-up fingerprint collisions (runs of 9-40 lanes with repeated
    (orientation, base) pairs, merged nodes, one run of 5,000 lanes, every
    row equal, k-edges their own successors): the run pass == plain
    link_nodes; runs are finished past their tile by the tile they start
    in, the long ones past more than one tile."""
    fp = _collisions(base)[case]
    order = ks.lex_order(torch.as_tensor(fp)).numpy()
    past = _hold_link(fp, order, _port(base)["flags"].numpy())
    if case in ("runs of 9-40 lanes", "one run of 5,000 lanes",
                "every row equal"):     # runs of 2 to 4 may fit the tiles
        assert max(past) > (0 if case == "runs of 9-40 lanes" else RUN_TILE)
    u = fp.view(U32)
    assert (np.unique(u, axis=0, return_counts=True)[1].max() >=
            {"runs of 9-40 lanes": 9, "nodes merged in pairs": 3,
             "one run of 5,000 lanes": 5_000, "every row equal": len(fp),
             "k-edges their own successors": 3}[case])


@pytest.mark.parametrize("case", ["runs of 9-40 lanes",
                                  "one run of 5,000 lanes"])
def test_link_model_any_order_of_equal_rows(case):
    """Equal rows in any order (the sorted order's runs shuffled): the
    same outputs as the stable order's."""
    base = LINK_BASES[0]
    fp = _collisions(base)[case]
    flags = _port(base)["flags"].numpy()
    order = ks.lex_order(torch.as_tensor(fp)).numpy()
    s = fp[order]
    run = np.cumsum(np.concatenate([[True], (s[1:] != s[:-1]).any(axis=1)]))
    shuffled = order[np.lexsort((np.random.default_rng(1).random(len(fp)),
                                 run))]
    assert (shuffled != order).any()
    want = model_link(fp, order, flags)
    _hold_link(fp, shuffled, flags)
    got = model_link(fp, shuffled, flags)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", LIVE)
def test_rank_model(name):
    """The ruling set (the walks, the ruler rounds, the finish, the cycle
    lanes doubled) == plain rank_chains == JAX _rank_chains on the same
    lanes, the cycle lanes alike."""
    p = _port(name)
    prev = p["prev_ptr"].numpy().astype(np.int64)
    head, dist, n_cyc, n_e = model_rank(prev)
    np.testing.assert_array_equal(p["head_of"].numpy(), head)
    np.testing.assert_array_equal(p["dist"].numpy(), dist)
    assert (p["n_cyc"], p["n_e"] if not n_cyc else n_e) == (n_cyc, n_e)
    jh, jd = jdb._rank_chains(jnp.asarray(prev.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(jh), head)
    np.testing.assert_array_equal(np.asarray(jd), dist)


@pytest.mark.parametrize("D,n_cycles,seed", [(2, 0, 1), (3, 1, 2),
                                             (1024, 0, 3), (1025, 3, 4),
                                             (5_000, 40, 5), (65_537, 2, 6)])
def test_rank_model_on_permutations(D, n_cycles, seed):
    """Lanes cut from a random permutation into chains (one of 2^m + 1
    lanes, the deepest a round count reaches) and pure cycles: the
    ruling-set model == plain == JAX _rank_chains; chain lanes at their
    true head and distance."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(D)
    prev = np.full(D, -1, np.int64)
    cuts = np.sort(rng.choice(np.arange(1, D), size=min(D - 1, 9),
                              replace=False)) if D > 2 else np.array([1])
    bounds = [0, *cuts.tolist(), D]
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg = perm[a:b]
        prev[seg[1:]] = seg[:-1]
        if i < n_cycles and b - a > 1:
            prev[seg[0]] = seg[-1]              # close a pure cycle
    head, dist, n_cyc, _ = model_rank(prev)
    got_h, got_d, info = ub.plain_rank_chains(torch.as_tensor(
        prev.astype(np.int32)))
    np.testing.assert_array_equal(got_h.numpy(), head)
    np.testing.assert_array_equal(got_d.numpy(), dist)
    assert int(info[0]) == n_cyc
    jh, jd = jdb._rank_chains(jnp.asarray(prev.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(jh), head)
    np.testing.assert_array_equal(np.asarray(jd), dist)
    on_chain = prev[head] < 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        seg = perm[a:b]
        if on_chain[seg[0]]:
            assert (head[seg] == seg[0]).all()
            assert (dist[seg] == np.arange(b - a)).all()
    assert n_cyc == int((~on_chain).sum())


def _hold_rank(prev, strides=(1, 4, ub.RANK_STRIDE, 64, 1024)):
    """plain rank_chains == JAX _rank_chains == the model at each stride
    on prev; chain lanes at their true head and distance, cycle lanes at
    distance 2^R.  (head_of, dist, cycle lanes)."""
    D = len(prev)
    got_h, got_d, info = ub.plain_rank_chains(torch.as_tensor(
        prev.astype(np.int32)))
    head, dist = got_h.numpy(), got_d.numpy()
    jh, jd = jdb._rank_chains(jnp.asarray(prev.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(jh), head)
    np.testing.assert_array_equal(np.asarray(jd), dist)
    for stride in strides:
        h, dd, n_cyc, n_e = model_rank(prev, stride)
        np.testing.assert_array_equal(h, head, err_msg=f"stride {stride}")
        np.testing.assert_array_equal(dd, dist, err_msg=f"stride {stride}")
        assert (n_cyc, n_e) == (int(info[0]), int(info[1]))
    # the chains, walked from their heads
    want_h, want_d = np.full(D, -1), np.full(D, -1)
    succ = np.full(D, -1)
    succ[prev[prev >= 0]] = np.flatnonzero(prev >= 0)
    for h in np.flatnonzero(prev < 0):
        cur, k = h, 0
        while cur >= 0:
            want_h[cur], want_d[cur] = h, k
            cur, k = succ[cur], k + 1
    chain = want_h >= 0
    np.testing.assert_array_equal(head[chain], want_h[chain])
    np.testing.assert_array_equal(dist[chain], want_d[chain])
    assert (dist[~chain] == 1 << ub.rounds(D)).all()
    assert int(info[0]) == int((~chain).sum())
    return head, dist, ~chain


def _close(prev, lanes):
    """prev_ptr along `lanes` in order, closed into a pure cycle."""
    prev[lanes] = np.roll(lanes, 1)


def _random_chains(D, rng, cuts):
    perm = rng.permutation(D)
    prev = np.full(D, -1, np.int64)
    prev[perm[1:]] = perm[:-1]
    prev[perm[np.sort(rng.choice(np.arange(1, D), cuts, replace=False))]] = -1
    return prev


@pytest.mark.parametrize("case", [
    "short cycles holding no ruler", "a cycle of rulers only",
    "one chain of D lanes", "every lane a head", "D = 2^12", "D = 2^12 + 1",
    "D = 2^16", "self loops", "a walk past 2^ob lanes"])
def test_rank_model_shapes(case):
    """The ruling set's hard shapes, model == plain == JAX: cycles shorter
    than the stride with no sampled lane (no walk reaches them), a cycle
    whose every lane is a sample (its rulers stay pending), one chain
    through every lane (the ruler rounds' longest list), no
    predecessors, power-of-two lane counts and one past, one-lane
    cycles, a head followed by more than 2^ob lanes that are no sample
    (promotions at the kernel's stride)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    sh = ub.RANK_STRIDE.bit_length() - 1
    if case == "short cycles holding no ruler":
        D = 3_000
        prev = _random_chains(D, rng, 40)
        plain = rng.permutation(np.flatnonzero(~is_ruler_lane(np.arange(D),
                                                              sh)))
        for i in range(5):                   # 5 cycles of 2..15 lanes
            cyc = plain[20 * i:20 * i + 2 + 3 * i]
            prev[np.isin(prev, cyc)] = -1        # their successors: heads
            _close(prev, cyc)
        assert not is_ruler_lane(np.flatnonzero(_hold_rank(prev)[2]),
                                 sh).any()
    elif case == "a cycle of rulers only":
        D = 4_000
        prev = _random_chains(D, rng, 30)
        cyc = ruler_lane(rng.permutation(D // ub.RANK_STRIDE)[:37], sh)
        prev[np.isin(prev, cyc)] = -1
        _close(prev, cyc)
        on_cycle = _hold_rank(prev, (ub.RANK_STRIDE,))[2]
        np.testing.assert_array_equal(np.flatnonzero(on_cycle), np.sort(cyc))
    elif case == "one chain of D lanes":
        prev = _random_chains(20_000, rng, 0)
        walks = []
        model_rank(prev, ub.RANK_STRIDE, walks)
        assert sum(walks) == 20_000
        _hold_rank(prev)
    elif case == "every lane a head":
        prev = np.full(2_049, -1, np.int64)
        head, dist, _ = _hold_rank(prev)
        assert (head == np.arange(2_049)).all() and (dist == 0).all()
    elif case == "self loops":
        D = 1_000
        prev = _random_chains(D, rng, 10)
        lanes = np.array([int(ruler_lane(3, sh)), 101 if not is_ruler_lane(
            101, sh) else 102])
        prev[np.isin(prev, lanes)] = -1
        prev[lanes] = lanes
        assert _hold_rank(prev)[2].sum() == 2
    elif case == "a walk past 2^ob lanes":
        D = 4_000
        ob = walk_bits(D, -(-D // ub.RANK_STRIDE))
        prev = _random_chains(D, rng, 20)
        plain = rng.permutation(np.flatnonzero(~is_ruler_lane(np.arange(D),
                                                              sh)))
        run = plain[:(1 << ob) + 77]
        prev[np.isin(prev, run)] = -1        # their successors: heads
        prev[run[0]] = -1
        prev[run[1:]] = run[:-1]
        walks, promoted = [], []
        model_rank(prev, ub.RANK_STRIDE, walks, promoted)
        assert max(walks) == len(run) and promoted[0] >= 1
        _hold_rank(prev)
    else:
        D = {"D = 2^12": 4_096, "D = 2^12 + 1": 4_097,
             "D = 2^16": 65_536}[case]
        prev = _random_chains(D, rng, 9)
        perm = rng.permutation(D)
        for a in range(0, 60, 20):           # three cycles of 20
            cyc = perm[a:a + 20]
            prev[np.isin(prev, cyc)] = -1
            _close(prev, cyc)
        _hold_rank(prev)


@pytest.mark.parametrize("D,L", [(7, 7), (100, 3), (1_025, 1_025),
                                 (5_000, 12), (65_537, 5)])
def test_cycle_lane_contract(D, L):
    """plain_rank_chains on a pure cycle of L lanes beside chains: each
    cycle lane's head is the lane 2^R steps back along prev_ptr (R =
    rounds(D)), modulo the cycle, and its distance 2^R; info[0] counts
    the cycle's lanes."""
    rng = np.random.default_rng(L)
    perm = rng.permutation(D)
    prev = np.full(D, -1, np.int64)
    cyc, rest = perm[:L], perm[L:]
    _close(prev, cyc)
    prev[rest[1:]] = rest[:-1]
    head, dist, info = ub.plain_rank_chains(torch.as_tensor(
        prev.astype(np.int32)))
    R = ub.rounds(D)
    back = cyc[(np.arange(L) - (1 << R)) % L]
    np.testing.assert_array_equal(head.numpy()[cyc], back)
    assert (dist.numpy()[cyc] == 1 << R).all()
    assert int(info[0]) == L


@pytest.mark.parametrize("stride", [1, 2, 16, 64, 1024])
def test_ruler_lanes(stride):
    """One sampled lane a block of `stride` lanes, inside it; is_ruler_lane
    agrees; on one random chain of 65,536 lanes every lane is walked once,
    the longest walk stays short, walks past 1,024 lanes promote rulers,
    and the model == plain."""
    sh = stride.bit_length() - 1
    D = 65_536
    i = np.arange(D // stride)
    r = ruler_lane(i, sh)
    assert ((r >> sh) == i).all()
    marks = is_ruler_lane(np.arange(D), sh)
    np.testing.assert_array_equal(np.flatnonzero(marks), r)
    walks, promoted = [], []
    prev = _random_chains(D, np.random.default_rng(stride), 0)
    head, dist, _, _ = model_rank(prev, stride, walks, promoted)
    assert sum(walks) == D
    assert max(walks) <= stride * 40
    assert (promoted[0] > 0) == (max(walks) > 1 << MAX_WALK_BITS)
    if stride == 1024:
        assert promoted[0] > 0
    got_h, got_d, _ = ub.plain_rank_chains(torch.as_tensor(
        prev.astype(np.int32)))
    np.testing.assert_array_equal(head, got_h.numpy())
    np.testing.assert_array_equal(dist, got_d.numpy())


def test_rank_stride_is_the_kernels():
    """The wrapper's RANK_STRIDE, which the models and chip_smoke.py take,
    is csrc's ruler block, 1 << RANK_SHIFT lanes."""
    src = (_build.CSRC / "unitig_build.cu").read_text()
    shift = int(src.split("constexpr int RANK_SHIFT = ")[1].split(";")[0])
    assert 1 << shift == ub.RANK_STRIDE


def test_link_constants_are_the_kernels():
    """model_link's tile, first step and word flag are csrc's."""
    src = (_build.CSRC / "unitig_build.cu").read_text()

    def const(name):
        return src.split(f"constexpr int {name} = ")[1].split(";")[0]
    assert int(const("THREADS")) == THREADS
    assert int(const("RUN_PER")) * THREADS == RUN_TILE
    assert int(const("RUN_FIRST")) == RUN_FIRST
    assert const("LINK_SUCC") == f"1 << {LINK_SUCC.bit_length() - 1}"


def test_rank_walks_refused():
    """The walks tally is the kernel's: CPU lanes refuse it, and a tally
    that is not (4,) int32 on the lanes' device is refused before any
    build."""
    with pytest.raises(ValueError, match="plain version makes none"):
        ub.rank_chains(torch.full((8,), -1, dtype=torch.int32),
                       walks=torch.zeros(4, dtype=torch.int32))
    lanes = torch.zeros(64, dtype=torch.int32, device="meta")
    for bad in (torch.zeros(3, dtype=torch.int32, device="meta"),
                torch.zeros(4, dtype=torch.int64, device="meta"),
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="walks must be"):
            ub.rank_chains(lanes, walks=bad)


@pytest.mark.parametrize("name", LIVE)
def test_assemble_model(name):
    u, c, k = CASES[name]
    p = _port(name)
    _, head, dist = (x.numpy().astype(np.int64) for x in p["lanes"])
    want = model_assemble(u, c, p["src_key"].numpy().astype(np.int64),
                          p["tgt_key"].numpy().astype(np.int64),
                          p["lastbase"].numpy(), head, dist, k, p["n_e"])
    got = p["unitigs"]
    for g_, w_ in zip((got.seq_off, got.edge_count, got.edge_rc,
                       got.edge_source, got.edge_target), want[:5]):
        np.testing.assert_array_equal(g_.numpy(), w_)
    assert int(got.n_v.item()) == want[5]
    np.testing.assert_array_equal(got.seq.numpy(), want[6])


@pytest.mark.parametrize("n_e,spread", [(2, "mixed"), (2, "halves"),
                                        (50_000, "mixed")])
def test_block_sums_row_adds(n_e, spread):
    """Two unitigs over 3 tiles and a bit, their lanes mixed (the bench's
    shape: a genome-long unitig a strand) or in two halves: one add a
    unitig's row a tile, where warp aggregation sent one a warp.  50,000
    unitigs: slots collide and spill to the rows; sums exact."""
    rng = np.random.default_rng(n_e)
    D = 3 * SUM_TILE + 77
    u_of = rng.integers(0, n_e, D) if spread == "mixed" else \
        (np.arange(D) >= D // 2).astype(np.int64)
    c = rng.integers(1, 1 << 31, D)
    adds = np.zeros(n_e, np.int64)
    ulen, ecount = model_block_sums(u_of, c, n_e, adds)
    np.testing.assert_array_equal(ulen, np.bincount(u_of, minlength=n_e))
    want = np.zeros(n_e, np.int64)
    np.add.at(want, u_of, c)
    np.testing.assert_array_equal(ecount, want)
    if n_e == 2:
        assert adds.sum() <= 2 * 4 and adds.sum() < D // 32
    else:
        assert adds.sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_sums_model(seed):
    """Counts up to 2^31 - 1 summed by 16-bit halves in warp groups, the
    groups in the block's table == bincount, lengths too; one row add a
    unitig a tile."""
    rng = np.random.default_rng(seed)
    n_e = [1, 7, 300][seed]
    u_of = np.sort(rng.integers(0, n_e, 4_000)) if seed else \
        np.zeros(4_000, np.int64)
    c = rng.integers(1, 1 << 31, 4_000)
    adds = np.zeros(n_e, np.int64)
    ulen, ecount = model_block_sums(u_of, c, n_e, adds)
    np.testing.assert_array_equal(ulen, np.bincount(u_of, minlength=n_e))
    want = np.zeros(n_e, np.int64)
    np.add.at(want, u_of, c)
    np.testing.assert_array_equal(ecount, want)
    assert adds.max() == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_renumber_marks_scan(seed):
    """Marks of the used node ids + an exclusive scan == torch.unique's
    sorted inverse; n_v twice the used ids."""
    rng = np.random.default_rng(seed)
    D = [10, 1_000, 5_000, 40_000][seed]
    ids = rng.integers(0, D, (2, rng.integers(1, D)))
    used = np.zeros(D, np.int64)
    used[ids.reshape(-1)] = 1
    nid = model_scan(used)
    u, inv = torch.unique(torch.as_tensor(ids.reshape(-1)), sorted=True,
                          return_inverse=True)
    np.testing.assert_array_equal(nid[ids.reshape(-1)], inv.numpy())
    assert 2 * int(used.sum()) == 2 * len(u)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_rounds():
    for D in [*range(1, 3000), 2 ** 20, 2 ** 20 + 1, 2 ** 29 - 1]:
        assert ub.rounds(D) == max(1, int(np.ceil(np.log2(max(D, 2)))) + 1)


def _stub_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached")
    for name in ("build", "load", "_nvcc"):
        monkeypatch.setattr(_build, name, refuse)


def test_cpu_never_builds(monkeypatch):
    _stub_build(monkeypatch)
    ub.COUNT.reset()
    for name in ("circular, k=21", "k=63", "one k-edge, k=31"):
        u, c, k = CASES[name]
        g = tdb.build_graph_on_device(torch.as_tensor(u), torch.as_tensor(c),
                                      len(u), k, device="cpu")
        assert g.n_e >= 1
    assert ub.COUNT.launches == 0


def test_off_cpu_tensors_go_to_the_kernel(monkeypatch):
    """A tensor that is not on the CPU is the kernel's (here the stubbed
    build raises): no entry hands it to its plain version."""
    _stub_build(monkeypatch)
    meta = torch.device("meta")
    n, k = 10, 45
    rows = torch.zeros((n, 3), dtype=torch.int64, device=meta)
    lanes = torch.zeros(2 * n, dtype=torch.int32, device=meta)
    calls = [
        lambda: ub.front_keys(rows, k),
        lambda: ub.link_nodes(torch.zeros((2 * n, 2), dtype=torch.int32,
                                          device=meta),
                              torch.zeros(2 * n, dtype=torch.int64,
                                          device=meta),
                              torch.zeros(n, dtype=torch.uint8, device=meta)),
        lambda: ub.rank_chains(lanes),
        lambda: ub.assemble_unitigs(
            rows, torch.zeros(n, dtype=torch.int32, device=meta), lanes,
            lanes, torch.zeros(2 * n, dtype=torch.uint8, device=meta), lanes,
            lanes, k, 3),
    ]
    for call in calls:
        with pytest.raises(AssertionError, match="kernel build"):
            call()
    # tables the kernels do not take are refused before any build
    with pytest.raises(ValueError, match="k-edges"):
        ub.front_keys(torch.zeros((0, 3), dtype=torch.int64, device=meta), k)
    with pytest.raises(ValueError, match="1 <= k <= 63"):
        ub.front_keys(torch.zeros((4, 5), dtype=torch.int64, device=meta), 64)
    with pytest.raises(ValueError, match="int64"):
        ub.front_keys(rows.int(), k)


def test_limbs_out_of_range_raise():
    u, c, k = CASES["k=45"]
    bad = u.copy()
    bad[3, 1] = 1 << 32
    with pytest.raises(ValueError, match="outside"):
        tdb.build_graph_on_device(torch.as_tensor(bad), torch.as_tensor(c),
                                  len(u), k, device="cpu")


@pytest.mark.parametrize("name,syncs", [("k=45", 3), ("circular, k=21", 4)])
def test_build_syncs(name, syncs):
    """One stacked scalar pull (two after a cycle break), two output
    pulls: the syncs the `build` span and its children count."""
    u, c, k = CASES[name]
    tracing.clear()
    tracing.start()
    try:
        tdb.build_graph_on_device(torch.as_tensor(u), torch.as_tensor(c),
                                  len(u), k, device="cpu")
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    (root,) = [r for r in recs if r[2] == "build"]
    assert sum(r[6].get("syncs", 0) for r in recs) == syncs
    assert root[6]["cycle_breaks"] == (syncs == 4)
