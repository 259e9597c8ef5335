"""De Bruijn graph construction from counted canonical (k+1)-mers, on
the host (a copy of turingassembler_tpu/graph/build.py).  Chains are
ranked by the serial chain walk `ta_list_rank` of the port's host
library native/graph_kernels.cpp, and nodes are numbered by np.unique,
or in order of first appearance by its `ta_unique_ids`, as the JAX
package's C++ library numbers them; the numpy versions
(`_pointer_double_to_head_np`, `_first_seen_ids_np`) are the tests'
reference.  pipeline.build_0 feeds it the table of a spilled count, and
localasm/local.py the per-gap tables; both take the first-appearance
numbering, which is the JAX package's host build as it ships.

Replaces the reference's kmhash-based build (src/kmer_build.c:78-649):

  reference                               | here
  ----------------------------------------+------------------------------
  kmhash CAS-insert of k-mers, adjacency  | sorted unique node-key table,
  nibbles via atomic OR                   | adjacency bits via scatter-OR
  per-thread unitig walkers following     | "next" pointers between
  (1,1) nodes (build_graph_worker :421)   | directed k-edges + pointer
                                          | doubling (log-step, data-par)
  RC edge pairing by sequence re-check    | rc pairing by construction
  (:624-641)                              | (directed k-edge involution)

Every (k+1)-mer ("k-edge") connects its prefix k-mer to its suffix
k-mer.  A *directed k-mer* is (canonical node id, orient) with orient 0
if the string equals the canonical form.  A *directed k-edge* is one of
the two orientations of a canonical k-edge: ids [0, n) = canonical
orientation, [n, 2n) = reverse complement.  Unitigs are maximal chains
of directed k-edges through (in=1, out=1) interior k-mers; they come in
RC pairs exactly like the reference's edges.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build
from ..ops import limbs as lb
from .structs import AsmGraph


def _void_view(a: np.ndarray) -> np.ndarray:
    """Row-wise void view for multi-column searchsorted/unique."""
    a = np.ascontiguousarray(a)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


def _np_fingerprint64(limbs: np.ndarray) -> np.ndarray:
    """64-bit mix of a limb row (two independent 32-bit murmur-style
    mixes packed into one uint64)."""
    def mix(seed):
        h = np.full(len(limbs), seed, np.uint32)
        for l in range(limbs.shape[1]):
            x = limbs[:, l].copy()
            x *= np.uint32(0xCC9E2D51)
            x = (x << np.uint32(15)) | (x >> np.uint32(17))
            x *= np.uint32(0x1B873593)
            h ^= x
            h = (h << np.uint32(13)) | (h >> np.uint32(19))
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
        return h
    return (mix(np.uint32(0x9E3779B9)).astype(np.uint64) << np.uint64(32)) \
        | mix(np.uint32(0x27D4EB2F)).astype(np.uint64)


_I32P = ctypes.POINTER(ctypes.c_int32)


def _graph_lib() -> ctypes.CDLL:
    lib = _build.load_host("graph_kernels")
    lib.ta_list_rank.argtypes = [_I32P, ctypes.c_int64, _I32P, _I32P]
    lib.ta_list_rank.restype = None
    lib.ta_unique_ids.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_int64, ctypes.c_int64, _I32P]
    lib.ta_unique_ids.restype = ctypes.c_int64
    return lib


def _pointer_double_to_head(prev: np.ndarray):
    """Given functional `prev` pointers (-1 = head; no two elements with
    one prev), return (head index, distance) int32 for every element,
    breaking cycles at their min element: the serial chain walk
    `ta_list_rank`, O(n) (the reference's own formulation,
    src/kmer_build.c:469-492)."""
    n = len(prev)
    prev32 = np.ascontiguousarray(prev, np.int32)
    head_of = np.empty(n, np.int32)
    dist = np.empty(n, np.int32)
    _graph_lib().ta_list_rank(prev32.ctypes.data_as(_I32P), n,
                              head_of.ctypes.data_as(_I32P),
                              dist.ctypes.data_as(_I32P))
    return head_of, dist


def _pointer_double_to_head_np(prev: np.ndarray):
    """_pointer_double_to_head by pointer doubling over a shrinking
    unconverged frontier, O(log n) gather rounds (the JAX package's
    fallback when its C++ chain walk is absent; the two give the same
    head_of and dist)."""
    n = len(prev)
    prev = prev.astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    for _round in range(3):  # at most 2 rounds needed (cycles then done)
        is_head = prev < 0
        anc = np.where(is_head, idx, prev)
        dist = (~is_head).astype(np.int32)
        # element i is converged once anc[i] is a head; converged entries
        # are frozen (their anc/dist are final and safe to read), so each
        # jump round touches only the shrinking unconverged frontier
        active = np.flatnonzero(~is_head & ~is_head[anc]).astype(np.int32)
        for _ in range(steps):
            if not len(active):
                break
            a = anc[active]
            dist[active] += dist[a]
            anc[active] = anc[a]
            active = active[~is_head[anc[active]]]
        if not len(active):
            return anc, dist
        # cycles: break at the minimum element (rc-consistent breaks are
        # applied by the caller, which knows the rc pairing)
        cyc = active
        val = idx.copy()
        nxt = prev.copy()
        for _ in range(steps):
            val[cyc] = np.minimum(val[cyc], val[nxt[cyc]])
            nxt[cyc] = nxt[nxt[cyc]]
        reps = np.unique(val[cyc])
        prev = prev.copy()
        prev[reps] = -1
    raise AssertionError("pointer doubling failed to converge")


def rc_consistent_cycle_heads(prev_ptr: np.ndarray, cyc: np.ndarray,
                              n: int) -> np.ndarray:
    """Heads for pure cycles such that fw/rc cycle copies break at
    mirrored adjacencies.

    A circular unitig appears as two directed-kedge cycles (the fw copy
    and its rc).  Breaking each at its own min element yields rc unitigs
    that are *rotations* of each other, violating the graph invariant
    source(rc(e)) == rc(target(e)).  Fix: key every incoming adjacency
    (prev(d) -> d) by min(enc(prev(d), d), enc(rc(d), rc(prev(d)))) —
    invariant under the rc mirror — and break every cycle at its minimum
    adjacency.  A palindromic self-rc cycle gets two breaks, producing a
    valid rc pair of chains.

    prev_ptr: (2n,) int; cyc: indices of on-cycle elements; n: #kedges
    (directed ids [0,n) fw / [n,2n) rc).  Returns head indices."""
    D = 2 * n
    rcd = lambda d: np.where(d < n, d + n, d - n)
    d = cyc.astype(np.int64)
    p = prev_ptr[d].astype(np.int64)
    e1 = p * D + d
    e2 = rcd(d) * D + rcd(p)
    key = np.minimum(e1, e2)
    # min-doubling over each cycle
    val = key.copy()
    # local successor within the subset: map global prev -> subset slot
    slot = np.full(D, -1, np.int64)
    slot[d] = np.arange(len(d))
    nxt = slot[prev_ptr[d]]
    steps = max(1, int(np.ceil(np.log2(max(len(d), 2)))) + 1)
    for _ in range(steps):
        val = np.minimum(val, val[nxt])
        nxt = nxt[nxt]
    return d[key == val]


def _first_seen_ids(fp: np.ndarray):
    """(ids (n,) int64, m): dense ids of uint64 keys numbered in order of
    first appearance, by `ta_unique_ids` (a linear-probing table of the
    JAX package's capacity: the smallest power of two >= 2n, at least
    16), whose all-ones empty-slot key stands for the all-ones key minus
    one."""
    n = len(fp)
    keys = np.ascontiguousarray(fp, np.uint64)
    ids = np.empty(n, np.int32)
    cap = 1 << max(int(np.ceil(np.log2(max(2 * n, 2)))), 4)
    m = _graph_lib().ta_unique_ids(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, cap,
        ids.ctypes.data_as(_I32P))
    return ids.astype(np.int64), int(m)


def _first_seen_ids_np(fp: np.ndarray):
    """_first_seen_ids by np.unique: the ids ranked by first index."""
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    key = np.where(fp == top, top - np.uint64(1), fp)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    return rank[inv.ravel()], len(uniq)


def build_graph_from_kedges(kedges: np.ndarray, counts: np.ndarray, k: int,
                            first_seen: bool = False) -> AsmGraph:
    """kedges: (n, n_limbs(k+1)) uint32 sorted unique canonical (k+1)-mers;
    counts: (n,) int64.  Returns the level-0 assembly graph.  Nodes are
    numbered in sorted fingerprint order, or with first_seen in order of
    first appearance (see the module docstring)."""
    n = len(kedges)
    if n == 0:
        return AsmGraph(ksize=k)

    # ------------------------------------------------------------------
    # derive prefix/suffix canonical node keys (pure bitwise limb ops —
    # no per-base decode of the full table)
    first = lb.np_base_at(kedges, 0)
    last = lb.np_base_at(kedges, k)

    pre, suf = lb.np_split_kedge(kedges, k)
    pre_rc = lb.np_revcomp_limbs_fast(pre, k)
    suf_rc = lb.np_revcomp_limbs_fast(suf, k)
    o_pre = lb.np_lex_lt(pre_rc, pre)               # True: canonical is RC
    o_suf = lb.np_lex_lt(suf_rc, suf)
    cpre = np.where(o_pre[:, None], pre_rc, pre)
    csuf = np.where(o_suf[:, None], suf_rc, suf)

    # unique canonical k-mers -> dense ids.  Node identity only ever
    # feeds adjacency/successor bookkeeping (sequences come from the
    # k-edges), so nodes are identified by a 64-bit fingerprint of the
    # canonical k-mer: one uint64 np.unique instead of a multi-limb
    # lexsort — ~3x faster at 10M+ rows.  Collision odds ~(2n)^2/2^65,
    # the same guarantee class as the counting tables.
    allk = np.concatenate([cpre, csuf], axis=0)
    fp = _np_fingerprint64(allk)
    if first_seen:
        inv, m = _first_seen_ids(fp)
    else:
        uniq, inv = np.unique(fp, return_inverse=True)
        m = len(uniq)
        inv = inv.astype(np.int64)
    node_pre = inv[:n]
    node_suf = inv[n:]

    # ------------------------------------------------------------------
    # adjacency nibbles: out-edges of directed k-mer (i, o) at slot i*8+o*4+b
    # (reference adjacency nibble layout: fw bits 0-3, rv bits 4-7,
    #  src/kmer_build.c:78-129)
    adj = np.zeros(m * 8, bool)
    adj[node_pre * 8 + o_pre * 4 + last] = True
    adj[node_suf * 8 + (1 - o_suf.astype(np.int64)) * 4 + (3 - first)] = True
    adj = adj.reshape(m, 2, 4)
    degs = adj.sum(axis=2)                          # (m, 2) out-degree per orient

    # ------------------------------------------------------------------
    # directed k-edges: [0,n) canonical orient, [n,2n) rc orient
    o_pre_i = o_pre.astype(np.int64)
    o_suf_i = o_suf.astype(np.int64)
    src_node = np.concatenate([node_pre, node_suf])
    src_or = np.concatenate([o_pre_i, 1 - o_suf_i])
    tgt_node = np.concatenate([node_suf, node_pre])
    tgt_or = np.concatenate([o_suf_i, 1 - o_pre_i])
    lastbase = np.concatenate([last, 3 - first]).astype(np.uint8)

    src_key = (src_node * 2 + src_or).astype(np.int32)
    tgt_key = (tgt_node * 2 + tgt_or).astype(np.int32)

    # unique successor lookup: a directed k-mer key with out-degree 1 has
    # exactly one out-k-edge, so a plain scatter (last-writer-wins for the
    # filtered-out multi-degree keys) replaces the argsort+searchsorted
    succ_of_key = np.full(2 * m, -1, np.int32)
    succ_of_key[src_key] = np.arange(2 * n, dtype=np.int32)
    # target (i,o) continues iff outdeg(i,o)==1 and indeg(i,o)==1
    t_out = degs[tgt_node, tgt_or]
    t_in = degs[tgt_node, 1 - tgt_or]
    can_continue = (t_out == 1) & (t_in == 1)
    nxt = np.where(can_continue, succ_of_key[tgt_key], np.int32(-1))
    # never continue into self (degenerate palindromic self-successor)
    nxt = np.where(nxt == np.arange(2 * n, dtype=np.int32), np.int32(-1), nxt)

    # head condition: source k-mer is not an interior (1,1) k-mer
    s_out = degs[src_node, src_or]
    s_in = degs[src_node, 1 - src_or]
    prev_exists = (s_out == 1) & (s_in == 1)
    # guard: prev must actually exist and not be self
    prv = np.full(2 * n, -1, np.int64)
    has_next = nxt >= 0
    prv[nxt[has_next]] = np.flatnonzero(has_next)
    prev_ptr = np.where(prev_exists & (prv >= 0), prv, -1)

    head_of, dist = _pointer_double_to_head(prev_ptr)
    # pure cycles (circular unitigs): re-break fw/rc copies consistently
    cyc = np.flatnonzero(prev_ptr[head_of] >= 0)
    if len(cyc):
        prev_ptr = prev_ptr.copy()
        prev_ptr[rc_consistent_cycle_heads(prev_ptr, cyc, n)] = -1
        head_of, dist = _pointer_double_to_head(prev_ptr)

    # ------------------------------------------------------------------
    # unitig (edge) assembly
    heads = head_of == np.arange(2 * n)
    head_ids = np.flatnonzero(heads)
    n_edges = len(head_ids)
    u_index = np.full(2 * n, -1, np.int64)
    u_index[head_ids] = np.arange(n_edges)
    u_of = u_index[head_of]                          # unitig id per directed k-edge

    # chain length = kedges per unitig (each directed k-edge belongs to
    # exactly one unitig) — bincount beats the per-element ufunc.at
    ulen_kedges = np.bincount(u_of, minlength=n_edges).astype(np.int64)
    seq_len = k + 1 + (ulen_kedges - 1)              # = k + ulen
    seq_off = np.concatenate([[0], np.cumsum(seq_len)]).astype(np.int64)
    total = int(seq_off[-1])
    seq_data = np.zeros(total, np.uint8)

    # head contributes its first k bases; every directed k-edge its last
    # base.  Only head k-edges need decoding to bases (a small subset).
    e_of_d = np.concatenate([np.arange(n), np.arange(n)])
    head_e = e_of_d[head_ids]
    head_is_rc = head_ids >= n
    kb_heads = lb.np_unpack_limbs(kedges[head_e], k + 1)
    rkb_heads = (3 - kb_heads)[:, ::-1]
    head_firstk = np.where(head_is_rc[:, None], rkb_heads[:, :k], kb_heads[:, :k])
    base_idx = seq_off[:-1][:, None] + np.arange(k)[None, :]
    seq_data[base_idx.ravel()] = head_firstk.astype(np.uint8).ravel()
    seq_data[seq_off[u_of] + k + dist] = lastbase

    # counts: sum of k-edge counts along the unitig
    ecount = np.bincount(u_of, weights=counts[e_of_d],
                         minlength=n_edges).astype(np.int64)

    # rc pairing: rc unitig of u = unitig of rc(tail(u))
    tails = np.flatnonzero(nxt < 0)
    # every unitig has exactly one tail after cycle breaking? cycles were
    # broken on prev only; their tail is the element whose next is the new
    # head.  Fix: tail of u = element with dist == ulen-1.
    tail_mask = dist == (ulen_kedges[u_of] - 1)
    tail_d = np.zeros(n_edges, np.int64)
    tail_d[u_of[tail_mask]] = np.flatnonzero(tail_mask)
    rc_d = np.where(tail_d < n, tail_d + n, tail_d - n)
    edge_rc = u_of[rc_d]

    # ------------------------------------------------------------------
    # nodes: endpoint directed k-mers get ids 2j (orient 0) / 2j+1
    # (reference fw id 2i / rv id 2i+1, src/kmer_build.c:553-565)
    src_d = head_ids
    e_src_key = src_key[src_d]                       # per unitig source (i*2+o)
    e_tgt_key = tgt_key[tail_d]
    used_nodes = np.unique(np.concatenate([e_src_key, e_tgt_key]) // 2)
    node_of = np.full(m, -1, np.int64)
    node_of[used_nodes] = np.arange(len(used_nodes))
    n_v = 2 * len(used_nodes)

    def dir_node(key):
        return node_of[key // 2] * 2 + (key & 1)

    edge_source = dir_node(e_src_key)
    edge_target = dir_node(e_tgt_key)
    node_rc = (np.arange(n_v, dtype=np.int64) ^ 1)

    g = AsmGraph(ksize=k)
    g.node_rc = node_rc
    g.edge_source = edge_source
    g.edge_target = edge_target
    g.edge_rc = edge_rc
    g.edge_count = ecount
    g.seq_off = seq_off
    g.seq_data = seq_data
    g.rebuild_adjacency()
    return g
