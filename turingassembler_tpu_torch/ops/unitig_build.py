"""The level-0 unitig build's device program: the CUDA kernels
csrc/unitig_build.cu and their wrapper.

Replaces the jitted JAX device code of the level-0 build
(turingassembler_tpu/graph/device_build.py, XLA, not Pallas), four entries
in the order graph/device_build.py calls them:
  - front_keys: k-edge rows -> the (2n, 2) node fingerprints and a byte a
    row of orientation flags and end bases (`_front` :71-86,
    `_fingerprints` :51-58); ops/kmer_sort.py:lex_order then sorts the
    fingerprints;
  - link_nodes: fingerprints, their order and the flags -> each directed
    lane's source and target keys, last base and chain predecessor
    (`_front` :90-143);
  - rank_chains: predecessors -> each lane's chain head and distance,
    with the lanes on pure cycles and the heads counted on the card
    (`_rank_chains` :150-186);
  - assemble_unitigs: the ranked lanes -> the unitig arrays and the base
    pool (`_assemble` :228-319).
Directed lanes are [0, n) in canonical orientation and [n, 2n)
reverse-complemented.  csrc/unitig_build.cu says how each computes the
plain version's integers; rank_chains ranks a ruling set (a sampled lane
in each block of RANK_STRIDE lanes) with no host sync.

On CPU tensors each entry runs its plain version (the tensor code the
level-0 build ran before the kernels); on CUDA tensors it launches the
kernels or raises.  The CPU path never builds or looks for nvcc.  Both
give the same dtypes: int32 fingerprints (bit patterns of the unsigned
mixes), keys, lanes and distances, uint8 flags and bases, int64 unitig
arrays.  info, an (3,) int32 tensor on the device, carries the scalars the
caller pulls in one sync: [the lanes on pure cycles, the heads (n_e),
1 when a k-edge limb lies outside [0, 2^32)].  COUNT records every launch
with its shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build, tracing
from .._build import I, LL, P
from . import kmer_sort as ks
from . import kmers as km
from . import limbs as lb

ENTRIES = ("front_keys", "link_nodes", "rank_chains", "assemble_unitigs")
MAX_K = 63                      # (k+1)-mers of at most 4 limbs
MAX_EDGES = (1 << 28) - 1       # D = 2n < 2^29: int32 keys and distances
RANK_STRIDE = 16                # lanes a ruler block (csrc's RANK_SHIFT)


def rounds(D: int) -> int:
    """Pointer-doubling rounds that rank any chain of D lanes:
    ceil(log2 D) + 1."""
    return (max(D, 2) - 1).bit_length() + 1


# Launches of each entry and each launch's shape (CUDA path only):
# ("front_keys", n, k), ("link_nodes", n), ("rank_chains", D),
# ("assemble_unitigs", n, k, n_e).
COUNT = _build.LaunchCount(dict.fromkeys(ENTRIES, ()))

LIB = _build.Kernels("unitig_build", {
    "ub_front_launch": [P, LL, I, P, P, P],
    "ub_link_launch": [P, P, P, LL, P, P, P, P, P],
    "ub_rank_launch": [P, LL, I, P, P, P, P, P],
    "ub_assemble_launch": [P, P, LL, I, I, P, P, P, P, P, LL, P, P, P],
}, {"ub_link_scratch_bytes": ([LL], LL), "ub_rank_scratch_bytes": ([LL], LL),
    "ub_assemble_scratch_bytes": ([LL, LL], LL)})


@dataclass
class Unitigs:
    """assemble_unitigs' outputs: `ints` (5 n_e + 2,) int64 holds seq_off
    (n_e + 1), edge_count, edge_rc, edge_source, edge_target (n_e each)
    and n_v, in that order (the views below); seq the (total,) uint8 base
    pool.  to_host pulls both (two syncs)."""
    ints: torch.Tensor
    seq: torch.Tensor
    n_e: int

    def _part(self, i: int) -> torch.Tensor:
        n_e = self.n_e
        start = 0 if i == 0 else n_e + 1 + (i - 1) * n_e
        return self.ints[start:start + (n_e + 1 if i == 0 else n_e)]

    seq_off = property(lambda self: self._part(0))
    edge_count = property(lambda self: self._part(1))
    edge_rc = property(lambda self: self._part(2))
    edge_source = property(lambda self: self._part(3))
    edge_target = property(lambda self: self._part(4))
    n_v = property(lambda self: self.ints[-1:])

    def to_host(self):
        """(ints, seq) as numpy arrays."""
        tracing.host_sync(2)
        return self.ints.cpu().numpy(), self.seq.cpu().numpy()


def _new_unitigs(n_e: int, total: int, dev) -> Unitigs:
    return Unitigs(torch.empty(5 * n_e + 2, dtype=torch.int64, device=dev),
                   torch.empty(total, dtype=torch.uint8, device=dev), n_e)


# ---------------------------------------------------------------------------
# plain versions (tensor code, any device; the CPU path)
# ---------------------------------------------------------------------------

def _fingerprints(limbs: torch.Tensor):
    """Two independent 32-bit mixes of node k-mers (int64 values); fpA's
    0xFFFFFFFF is remapped as the JAX package does (it reserves the value
    for invalid lanes), so the node order matches."""
    fpA = lb.hash_limbs(limbs)
    fpB = lb.hash_limbs(limbs, seed=0x27D4EB2F)
    fpA = torch.where(fpA == lb.M32, lb.M32 - 1, fpA)
    return fpA, fpB


def plain_front_keys(uniq: torch.Tensor, k: int):
    """(fp (2n, 2) int32 bit patterns of (fpA, fpB): rows [0, n) the
    prefix nodes', [n, 2n) the suffix nodes'; flags (n,) uint8: o_pre |
    o_suf << 1 | first << 2 | last << 4; info (3,) int32 with info[2] the
    limb range flag)."""
    u = uniq
    first = km.kedge_first_base(u)
    last = km.kedge_last_base(u, k)
    pre, suf = km.split_kedge(u, k)
    pre_rc = lb.revcomp_limbs(pre, k)
    suf_rc = lb.revcomp_limbs(suf, k)
    o_pre = lb.lex_lt(pre_rc, pre).long()
    o_suf = lb.lex_lt(suf_rc, suf).long()
    cpre = torch.where(o_pre[:, None] == 1, pre_rc, pre)
    csuf = torch.where(o_suf[:, None] == 1, suf_rc, suf)
    fpA, fpB = _fingerprints(torch.cat([cpre, csuf]))
    fp = ks.to_i32(torch.stack([fpA, fpB], dim=1))
    flags = (o_pre | o_suf << 1 | first << 2 | last << 4).to(torch.uint8)
    info = torch.zeros(3, dtype=torch.int32, device=u.device)
    info[2] = ((u < 0) | (u > lb.M32)).any().to(torch.int32)
    return fp, flags, info


def _flag_bits(flags: torch.Tensor):
    """(o_pre, o_suf, first, last) of front_keys' flag bytes, int64."""
    f = flags.long()
    return f & 1, (f >> 1) & 1, (f >> 2) & 3, (f >> 4) & 3


def degrees(node_pre: torch.Tensor, node_suf: torch.Tensor,
            flags: torch.Tensor) -> torch.Tensor:
    """(2D,) out-degree of each (node, orientation) key node * 2 + orient:
    the adjacency bits node*8 + orient*4 + base (fw bits 0-3, rv bits
    4-7) that the k-edges set, summed four at a time."""
    D = 2 * node_pre.shape[0]
    o_pre, o_suf, first, last = _flag_bits(flags)
    adj = torch.zeros(8 * D, dtype=torch.bool, device=node_pre.device)
    adj[node_pre * 8 + o_pre * 4 + last] = True
    adj[node_suf * 8 + (1 - o_suf) * 4 + (3 - first)] = True
    return adj.view(2 * D, 4).sum(dim=1)


def plain_link_nodes(fp: torch.Tensor, order: torch.Tensor,
                     flags: torch.Tensor):
    """(src_key, tgt_key (2n,) int32, lastbase (2n,) uint8, prev_ptr (2n,)
    int32).  Node ids number the runs of the sorted fingerprints; scatters
    with duplicate indices resolve to the highest lane, which is what the
    JAX package's in-order scatter leaves (the adjacency bits see
    duplicates otherwise, all writing True)."""
    n = flags.shape[0]
    D = 2 * n
    dev = fp.device
    seg = torch.cumsum(lb.run_starts(fp[order]), 0) - 1
    node = torch.empty(D, dtype=torch.int64, device=dev)
    node[order] = seg
    node_pre, node_suf = node[:n], node[n:]
    o_pre, o_suf, first, last = _flag_bits(flags)
    degs = degrees(node_pre, node_suf, flags)

    src_node = torch.cat([node_pre, node_suf])
    src_or = torch.cat([o_pre, 1 - o_suf])
    tgt_node = torch.cat([node_suf, node_pre])
    tgt_or = torch.cat([o_suf, 1 - o_pre])
    lastbase = torch.cat([last, 3 - first]).to(torch.uint8)
    src_key = src_node * 2 + src_or
    tgt_key = tgt_node * 2 + tgt_or
    d_idx = torch.arange(D, device=dev)

    succ = torch.full((2 * D,), -1, dtype=torch.int64, device=dev)
    succ.scatter_reduce_(0, src_key, d_idx, "amax")
    can = (degs[tgt_key] == 1) & (degs[tgt_node * 2 + (1 - tgt_or)] == 1)
    nxt = torch.where(can, succ[tgt_key], -1)
    nxt = torch.where(nxt == d_idx, -1, nxt)      # palindromic self-successor

    prev_exists = (degs[src_key] == 1) & \
        (degs[src_node * 2 + (1 - src_or)] == 1)
    has = nxt >= 0
    prv = torch.full((D,), -1, dtype=torch.int64, device=dev)
    prv.scatter_reduce_(0, nxt[has], d_idx[has], "amax")
    prev_ptr = torch.where(prev_exists & (prv >= 0), prv, -1)
    return (src_key.int(), tgt_key.int(), lastbase, prev_ptr.int())


def plain_rank_chains(prev_ptr: torch.Tensor, info=None):
    """(head_of, dist (D,) int32, info) by Wyllie pointer doubling, at
    most rounds(D) rounds; stops once no lane's ancestor moved (a host
    sync a round).  info[0] = the lanes whose head has a predecessor (on a
    pure cycle), info[1] = the heads."""
    D = prev_ptr.shape[0]
    dev = prev_ptr.device
    d_idx = torch.arange(D, device=dev)
    prev = prev_ptr.long()
    anc = torch.where(prev < 0, d_idx, prev)
    dist = (prev >= 0).long()
    for _ in range(rounds(D)):
        step = dist[anc]
        dist = dist + step
        anc = anc[anc]
        if not bool((step > 0).any()):
            break
    if info is None:
        info = torch.zeros(3, dtype=torch.int32, device=dev)
    info[0] = (prev[anc] >= 0).sum()
    info[1] = (anc == d_idx).sum()
    return anc.int(), dist.int(), info


def plain_assemble_unitigs(uniq, counts, src_key, tgt_key, lastbase,
                           head_of, dist, k: int, n_e: int) -> Unitigs:
    """Chains -> unitig arrays + base pool (n_e unitigs: the heads)."""
    n = uniq.shape[0]
    dev = uniq.device
    d_idx = torch.arange(2 * n, device=dev)
    head_of, dist = head_of.long(), dist.long()
    is_head = head_of == d_idx
    head_d = torch.nonzero(is_head).squeeze(1)     # unitig id order
    u_of = (torch.cumsum(is_head, 0) - 1)[head_of]  # unitig id per lane

    ulen = torch.bincount(u_of, minlength=n_e)
    out = _new_unitigs(n_e, 2 * n + k * n_e, dev)
    ecount = out.edge_count
    ecount.zero_()
    ecount.index_add_(0, u_of, torch.cat([counts, counts]).long())
    seq_off = out.seq_off
    seq_off[0] = 0
    seq_off[1:] = torch.cumsum(k + ulen, 0)

    # head k-mer of each unitig, then one last base per lane
    head_e = torch.where(head_d < n, head_d, head_d - n)
    kb = lb.unpack_limbs(uniq[head_e], k + 1)
    head_firstk = torch.where((head_d >= n)[:, None],
                              (3 - kb).flip(1)[:, :k], kb[:, :k])
    seq = out.seq
    seq[(seq_off[:-1, None] + torch.arange(k, device=dev)).reshape(-1)] = \
        head_firstk.reshape(-1)
    seq[seq_off[u_of] + k + dist] = lastbase

    # rc pairing: rc unitig of u = unitig of rc(tail(u))
    tail = dist == ulen[u_of] - 1
    tail_d = torch.empty(n_e, dtype=torch.int64, device=dev)
    tail_d[u_of[tail]] = d_idx[tail]
    rc_d = torch.where(tail_d < n, tail_d + n, tail_d - n)
    out.edge_rc.copy_(u_of[rc_d])

    # endpoint nodes -> dense ids in ascending old node id
    e_src = src_key[head_d].long()
    e_tgt = tgt_key[tail_d].long()
    used, inv = torch.unique(torch.cat([e_src // 2, e_tgt // 2]),
                             sorted=True, return_inverse=True)
    out.edge_source.copy_(inv[:n_e] * 2 + (e_src & 1))
    out.edge_target.copy_(inv[n_e:] * 2 + (e_tgt & 1))
    out.n_v.fill_(2 * used.shape[0])
    return out


# ---------------------------------------------------------------------------
# the entries: plain on the CPU, the kernels on a card
# ---------------------------------------------------------------------------

def _check_table(uniq: torch.Tensor, k: int) -> int:
    n = uniq.shape[0]
    if uniq.dim() != 2 or uniq.dtype != torch.int64 \
            or not 1 <= k <= MAX_K or uniq.shape[1] != lb.n_limbs(k + 1):
        raise ValueError(f"unitig_build: uniq must be (n, nl) int64 limbs of "
                         f"(k+1)-mers with 1 <= k <= {MAX_K}, got "
                         f"{uniq.dtype} {tuple(uniq.shape)} at k={k}")
    if not 1 <= n <= MAX_EDGES:
        raise ValueError(f"unitig_build: {n} k-edges, not in 1..{MAX_EDGES}")
    return n


def _lanes(x: torch.Tensor, D: int, dtype, what: str) -> torch.Tensor:
    if x.shape != (D,) or x.dtype != dtype:
        raise ValueError(f"unitig_build: {what} must be ({D},) {dtype}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def front_keys(uniq: torch.Tensor, k: int):
    """k-edge rows (n, nl) int64 limbs of (k+1)-mers -> (fp (2n, 2) int32,
    flags (n,) uint8, info (3,) int32): the prefix and suffix nodes'
    fingerprints (prefix rows first) as ops/kmer_sort.py:lex_order takes
    them, the orientation flags and end bases of each row, and info[2] = 1
    when a limb lies outside [0, 2^32) (info[:2] zero)."""
    if uniq.device.type == "cpu":
        return plain_front_keys(uniq, k)
    n = _check_table(uniq, k)
    dev = uniq.device
    uniq = uniq.contiguous()
    fp = torch.empty((2 * n, 2), dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    info = torch.zeros(3, dtype=torch.int32, device=dev)
    LIB.launch("ub_front_launch", dev, uniq.data_ptr(), n, k, fp.data_ptr(),
               flags.data_ptr(), info.data_ptr())
    COUNT.add("front_keys", n, k)
    return fp, flags, info


def link_nodes(fp: torch.Tensor, order: torch.Tensor, flags: torch.Tensor):
    """fp (2n, 2) int32, order (2n,) int64 (lex_order of fp), flags (n,)
    uint8 -> (src_key, tgt_key (2n,) int32: node * 2 + orientation of each
    directed lane's source and target; lastbase (2n,) uint8; prev_ptr
    (2n,) int32: the lane before each on its chain, or -1)."""
    if fp.device.type == "cpu":
        return plain_link_nodes(fp, order, flags)
    n = flags.shape[0]
    D = 2 * n
    if not 1 <= n <= MAX_EDGES or fp.shape != (D, 2) \
            or fp.dtype != torch.int32 or flags.dtype != torch.uint8:
        raise ValueError(f"unitig_build: fp ({D}, 2) int32 and flags ({n},) "
                         f"uint8, got {fp.dtype} {tuple(fp.shape)}, "
                         f"{flags.dtype} {tuple(flags.shape)}")
    dev = fp.device
    fp, flags = fp.contiguous(), flags.contiguous()
    order = _lanes(order, D, torch.int64, "order")
    # the bytes the entry carves its temporaries from
    scratch = torch.empty(LIB.query("ub_link_scratch_bytes", n),
                          dtype=torch.uint8, device=dev)
    src_key, tgt_key, prev_ptr = (torch.empty(D, dtype=torch.int32,
                                              device=dev) for _ in range(3))
    lastbase = torch.empty(D, dtype=torch.uint8, device=dev)
    LIB.launch("ub_link_launch", dev, fp.data_ptr(), order.data_ptr(),
               flags.data_ptr(), n, scratch.data_ptr(), src_key.data_ptr(),
               tgt_key.data_ptr(), lastbase.data_ptr(), prev_ptr.data_ptr())
    COUNT.add("link_nodes", n)
    return src_key, tgt_key, lastbase, prev_ptr


def rank_chains(prev_ptr: torch.Tensor, info=None, walks=None):
    """prev_ptr (D,) int32 -> (head_of, dist (D,) int32, info): for a lane
    on a chain its head and distance from it; for a lane on a pure cycle
    the lane 2^R steps back and 2^R (R = rounds(D)), as the plain
    version's rounds leave them.  info (3,) int32 (a new one when None)
    gets info[0] = the lanes on pure cycles, info[1] = the heads (n_e once
    no cycle is left).  On a card: the heads and a sampled lane in each
    block of RANK_STRIDE lanes walk to the next sample, the samples are
    ranked, then the lanes; no host sync.  walks, for measurements: None,
    or a zeroed (4,) int32 tensor on the lanes' card that gets the
    kernel's walks, its longest walk in lanes, the rulers its long walks
    promoted and the offset bits a lane's word gives a walk (the plain
    version makes no walks, so CPU lanes refuse it)."""
    if prev_ptr.device.type == "cpu":
        if walks is not None:
            raise ValueError("unitig_build: walks are the kernel's; the "
                             "plain version makes none")
        return plain_rank_chains(prev_ptr, info)
    D = prev_ptr.shape[0]
    if not 1 <= D <= 2 * MAX_EDGES:
        raise ValueError(f"unitig_build: {D} lanes, not in 1..{2 * MAX_EDGES}")
    dev = prev_ptr.device
    prev_ptr = _lanes(prev_ptr, D, torch.int32, "prev_ptr")
    if info is None:
        info = torch.zeros(3, dtype=torch.int32, device=dev)
    if info.shape != (3,) or info.dtype != torch.int32 or info.device != dev:
        raise ValueError("unitig_build: info must be (3,) int32 on the lanes' "
                         "device")
    if walks is not None and (walks.shape != (4,) or walks.dtype != torch.int32
                              or walks.device != dev):
        raise ValueError("unitig_build: walks must be (4,) int32 on the "
                         "lanes' device")
    scratch = torch.empty(LIB.query("ub_rank_scratch_bytes", D),
                          dtype=torch.uint8, device=dev)
    head_of = torch.empty(D, dtype=torch.int32, device=dev)
    dist = torch.empty(D, dtype=torch.int32, device=dev)
    LIB.launch("ub_rank_launch", dev, prev_ptr.data_ptr(), D, rounds(D),
               scratch.data_ptr(), head_of.data_ptr(), dist.data_ptr(),
               info.data_ptr(), None if walks is None else walks.data_ptr())
    COUNT.add("rank_chains", D)
    return head_of, dist, info


def assemble_unitigs(uniq, counts, src_key, tgt_key, lastbase, head_of,
                     dist, k: int, n_e: int) -> Unitigs:
    """The ranked lanes -> Unitigs: n_e unitigs (the heads, numbered in
    lane order), each k + its lanes' bases long in the pool (its head's
    first k bases, then a last base a lane), its count the sum of its
    k-edges' counts, its reverse-complement partner and its endpoint
    nodes renumbered densely in ascending node order; n_v twice their
    number."""
    if uniq.device.type == "cpu":
        return plain_assemble_unitigs(uniq, counts, src_key, tgt_key,
                                      lastbase, head_of, dist, k, n_e)
    n = _check_table(uniq, k)
    D = 2 * n
    if not 1 <= n_e <= D:
        raise ValueError(f"unitig_build: {n_e} unitigs for {D} lanes")
    dev = uniq.device
    uniq = uniq.contiguous()
    counts = _lanes(counts, n, torch.int32, "counts")
    src_key, tgt_key, head_of, dist = (
        _lanes(x, D, torch.int32, what) for x, what in
        ((src_key, "src_key"), (tgt_key, "tgt_key"), (head_of, "head_of"),
         (dist, "dist")))
    lastbase = _lanes(lastbase, D, torch.uint8, "lastbase")
    scratch = torch.empty(LIB.query("ub_assemble_scratch_bytes", n, n_e),
                          dtype=torch.uint8, device=dev)
    out = _new_unitigs(n_e, D + k * n_e, dev)
    LIB.launch("ub_assemble_launch", dev, uniq.data_ptr(), counts.data_ptr(),
               n, uniq.shape[1], k, src_key.data_ptr(), tgt_key.data_ptr(),
               lastbase.data_ptr(), head_of.data_ptr(), dist.data_ptr(), n_e,
               scratch.data_ptr(), out.ints.data_ptr(), out.seq.data_ptr())
    COUNT.add("assemble_unitigs", n, k, n_e)
    return out
