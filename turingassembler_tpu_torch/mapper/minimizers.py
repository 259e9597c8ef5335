"""Minimizer edge index and DP-verified read->edge map (port of
turingassembler_tpu/mapper/minimizers.py; over the shards of a mesh
through parallel/sharded_map.py).

Scheme (reference src/minimizers/minimizers.c): k=17, w=17, forward
strand only; the leftmost minimum-hash k-mer of each window is a
minimizer; the edge index keeps per minimizer its first (edge, pos) and
an occurrence count, and only singletons vote; a read maps to its
argmax edge, unmapped when tied or under the 85% confidence gate.  With
a graph, every voted hit is verified: the gapless score at the voted
offset accepts most reads on the device, and the rest go to the full
affine-gap DP (ops/dp.py, the CUDA kernel on the card).

Hashes and limbs are int64 values in [0, 2^32) (ops/limbs.py).  The
cuckoo tables are built on the host with numpy int64 and probed on the
device with the same mixer, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph.structs import AsmGraph
from ..ops import dp
from ..ops import kmers as kmod
from ..ops import limbs as lb

MM_K = 17       # MINIMIZERS_KMER (reference src/attribute.h:21)
MM_W = 17       # MINIMIZERS_WINDOW (reference src/attribute.h:20)
NL = lb.n_limbs(MM_K)  # 2 limbs
MM_CAP = 48     # minimizer slots per read (a 150 bp read has ~16)
CUCKOO_CAP = 4  # slots per cuckoo bucket
RESCORE_PAD = 16   # target-window slack around the voted start
POOL_PAD_W = 32    # sentinel words around the nibble-packed pool
BIG = 1 << 30


def minimizer_mask(bases: torch.Tensor, lengths: torch.Tensor,
                   k: int = MM_K, w: int = MM_W):
    """Minimizer positions of each forward-strand sequence.

    bases (B, L) uint8 codes (>= 4 invalid), lengths (B,).  Returns
    (kmers (B, P, NL) int64, hashes (B, P) int64, is_mm (B, P) bool),
    P = L - k + 1; is_mm marks positions that are the leftmost window
    minimum of at least one complete window inside the read.

    Position p is the leftmost minimum of window i iff every hash in
    [i, p) is strictly greater and every hash in (p, i+w) is >=; with
    the capped runs of strictly-greater hashes to the left (Lrun) and of
    >= hashes to the right (Rrun), some complete in-read window elects p
    iff max(p - Lrun, 0) <= min(p + Rrun - w + 1, W_len - 1)."""
    B, L = bases.shape
    P = L - k + 1
    dev = bases.device
    km = kmod._pack_windows(bases, k)
    valid = kmod.window_validity(bases, lengths, k)
    h = torch.where(valid, lb.hash_limbs(km), lb.M32)
    if L - k - w + 2 <= 0:
        return km, h, torch.zeros((B, P), dtype=torch.bool, device=dev)

    def run(cmp, left: bool):
        cnt = torch.zeros((B, P), dtype=torch.int32, device=dev)
        alive = torch.ones((B, P), dtype=torch.bool, device=dev)
        pad = torch.full((B, w - 1), lb.M32, dtype=torch.int64, device=dev)
        ext = torch.cat([pad, h], 1) if left else torch.cat([h, pad], 1)
        for d in range(1, w):
            other = ext[:, w - 1 - d:w - 1 - d + P] if left else ext[:, d:d + P]
            alive &= cmp(other, h)
            cnt += alive
        return cnt

    lrun = run(torch.gt, True)
    rrun = run(torch.ge, False)
    pos = torch.arange(P, device=dev)[None, :]
    w_len = lengths.long()[:, None] - k - w + 2
    lo = torch.maximum(torch.clamp(pos - lrun, min=0), pos - w + 1)
    hi = torch.minimum(torch.minimum(pos + rrun - w + 1, w_len - 1), pos)
    return km, h, (lo <= hi) & (w_len > 0) & valid


# ---------------------------------------------------------------------
# Cuckoo lookup: a 4-slot-per-bucket 2-choice table resolves a key in at
# most 2 bucket-row gathers + 1 value-row gather, with the values
# pre-fused to what the vote needs: (edge+1 if singleton else 0, pos).
# ---------------------------------------------------------------------

def _cuckoo_h(q0, q1, salt: int, mask: int, which: int):
    """Bucket hash over both key limbs; `which` selects the table.  Works
    on numpy and torch int64 arrays alike, bit-exact."""
    if which == 0:
        x = (q0 ^ lb.mul32(q1, 0x9E3779B1)) + salt
    else:
        x = (q1 ^ lb.mul32(q0, 0x85EBCA77)) + (salt ^ 0x5BD1E995)
    return lb.fmix32(x & lb.M32) & mask


def build_cuckoo_tables(keys: np.ndarray, edge: np.ndarray,
                        pos: np.ndarray, count: np.ndarray):
    """(hkeys (NB, 8) int64, vals (NB*4, 2) int64, salt int) on the host.

    Greedy 2-choice placement over alternating rounds; a salt bump and
    table doublings retry a pathological layout, and RuntimeError is
    raised once those are exhausted.  Empty slots hold 0xFFFFFFFF in
    both limbs, which no real minimizer key (second limb's low 30 bits
    zero) matches."""
    M = len(keys)
    if M == 0:
        return (np.full((256, 2 * CUCKOO_CAP), lb.M32, np.int64),
                np.zeros((256 * CUCKOO_CAP, 2), np.int64), 0)
    k0 = keys[:, 0].astype(np.int64)
    k1 = keys[:, 1].astype(np.int64)
    nb0 = 1 << max(int(np.ceil(np.log2(max(M, 2) * 2))), 8)
    for nb in (nb0, nb0 * 2, nb0 * 4):
        out = _try_build_cuckoo(k0, k1, edge, pos, count, nb)
        if out is not None:
            return out
    raise RuntimeError("cuckoo table build failed at load 0.03")


def _try_build_cuckoo(k0, k1, edge, pos, count, nb: int):
    M = len(k0)
    mask = nb - 1
    for salt_i in range(4):
        salt = (0xA5A5A5A5 + 0x9E3779B9 * salt_i) & lb.M32
        h1 = _cuckoo_h(k0, k1, salt, mask, 0)
        h2 = _cuckoo_h(k0, k1, salt, mask, 1)
        fill = np.zeros(nb, np.int64)
        bucket = np.full(M, -1, np.int64)
        slot = np.full(M, -1, np.int64)
        un = np.arange(M)
        for r in range(12):
            if len(un) == 0:
                break
            cand = (h1 if r % 2 == 0 else h2)[un]
            order = np.argsort(cand, kind="stable")
            cs = cand[order]
            newg = np.concatenate([[True], cs[1:] != cs[:-1]])
            gstart = np.maximum.accumulate(
                np.where(newg, np.arange(len(cs)), 0))
            rank = np.arange(len(cs)) - gstart
            ok = rank < (CUCKOO_CAP - fill[cs])
            pidx = un[order[ok]]
            bucket[pidx] = cs[ok]
            slot[pidx] = fill[cs[ok]] + rank[ok]
            np.add.at(fill, cs[ok], 1)
            un = un[order[~ok]]
        if len(un) == 0:
            hkeys = np.full((nb, 2 * CUCKOO_CAP), lb.M32, np.int64)
            hkeys[bucket, 2 * slot] = k0
            hkeys[bucket, 2 * slot + 1] = k1
            vals = np.zeros((nb * CUCKOO_CAP, 2), np.int64)
            fidx = bucket * CUCKOO_CAP + slot
            vals[fidx, 0] = np.where(count == 1, edge + 1, 0)
            vals[fidx, 1] = pos
            return hkeys, vals, salt
    return None


def _cuckoo_probe(hkeys: torch.Tensor, vals: torch.Tensor, salt: int,
                  queries: torch.Tensor):
    """Device probe: (edge_sing (Q,) [-1 when the key is absent or not a
    singleton], pos (Q,), found (Q,) bool)."""
    mask = hkeys.shape[0] - 1
    q0, q1 = queries[:, 0], queries[:, 1]
    b1 = _cuckoo_h(q0, q1, salt, mask, 0)
    b2 = _cuckoo_h(q0, q1, salt, mask, 1)
    r1, r2 = hkeys[b1], hkeys[b2]
    m = torch.cat([(r1[:, 0::2] == q0[:, None]) & (r1[:, 1::2] == q1[:, None]),
                   (r2[:, 0::2] == q0[:, None]) & (r2[:, 1::2] == q1[:, None])],
                  dim=1)
    found = m.any(dim=1)
    s = m.to(torch.int8).argmax(dim=1)          # first matching slot
    fidx = torch.where(s < CUCKOO_CAP, b1 * CUCKOO_CAP + s,
                       b2 * CUCKOO_CAP + (s - CUCKOO_CAP))
    v = vals[fidx]
    return torch.where(found, v[:, 0] - 1, -1), v[:, 1], found


def _compact_minimizer_rows(mat: torch.Tensor, elen: torch.Tensor,
                            k: int, w: int) -> torch.Tensor:
    """minimizer_mask + ascending compaction of the marked positions:
    (n, NL + 2) int64 rows of key limbs, segment row, in-segment
    position."""
    km, _h, is_mm = minimizer_mask(mat, elen, k, w)
    B, P, nl = km.shape
    flat = torch.nonzero(is_mm.reshape(-1)).squeeze(1)
    return torch.cat([km.reshape(-1, nl)[flat], (flat // P)[:, None],
                      (flat % P)[:, None]], dim=1)


@dataclass
class EdgeMinimizerIndex:
    """Sorted minimizer table over all live edges of a graph (host)."""
    keys: np.ndarray        # (M, NL) uint32 sorted unique minimizer k-mers
    edge: np.ndarray        # (M,) int32 first edge containing the key
    pos: np.ndarray         # (M,) int32 position on that edge
    count: np.ndarray       # (M,) int32 total occurrences
    k: int = MM_K
    w: int = MM_W
    _dev: Dict[str, tuple] = field(default_factory=dict)
    _hash: Optional[tuple] = None

    def hash_tables(self):
        """Host cuckoo tables (hkeys, vals, salt), built once."""
        if self._hash is None:
            self._hash = build_cuckoo_tables(self.keys, self.edge,
                                             self.pos, self.count)
        return self._hash

    def device_tables(self, device: str | torch.device = "cuda"):
        """(hkeys, vals, salt) with the tables on `device`, cached."""
        dev = resolve_device(device)
        if str(dev) not in self._dev:
            hkeys, vals, salt = self.hash_tables()
            self._dev[str(dev)] = (torch.as_tensor(hkeys).to(dev),
                                   torch.as_tensor(vals).to(dev), salt)
        return self._dev[str(dev)]

    SEG = 4096     # content window positions per device row
    SEG_B = 256    # rows per device batch

    @classmethod
    def build(cls, g: AsmGraph, k: int = MM_K, w: int = MM_W, *,
              device: str | torch.device = "cuda") -> "EdgeMinimizerIndex":
        """Index every live edge (reference mm_index_edges).

        Edges are cut into fixed-width segments overlapping by w+k-2, so
        every window lies in exactly one segment; a minimizer marked from
        two adjacent segments is an exact duplicate (key, edge, pos) row
        and is dropped before the run-length count."""
        dev = resolve_device(device)
        SEG, B = cls.SEG, cls.SEG_B
        Wd = SEG + k + w - 2
        span = k + w - 1
        lens = g.edge_len()
        segs_e, segs_s = [], []
        for e in np.flatnonzero(g.alive_mask()):
            n_pos = int(lens[e]) - span + 1
            for i in range(-(-n_pos // SEG) if n_pos > 0 else 0):
                segs_e.append(int(e))
                segs_s.append(i * SEG)
        all_rows = []
        for i in range(0, len(segs_e), B):
            ce = np.asarray(segs_e[i:i + B], np.int64)
            cs = np.asarray(segs_s[i:i + B], np.int64)
            mat = np.full((len(ce), Wd), 255, np.uint8)
            elen = np.zeros(len(ce), np.int32)
            for j, (e, s) in enumerate(zip(ce, cs)):
                part = g.get_seq(e)[s:s + Wd]
                mat[j, :len(part)] = part
                elen[j] = len(part)
            packed = _compact_minimizer_rows(
                torch.as_tensor(mat).to(dev), torch.as_tensor(elen).to(dev),
                k, w).cpu().numpy()
            if len(packed):
                jj = packed[:, NL]
                all_rows.append(np.concatenate(
                    [packed[:, :NL], ce[jj, None],
                     cs[jj, None] + packed[:, NL + 1:]], axis=1))
        if not all_rows:
            z = np.zeros(0, np.int32)
            return cls(np.zeros((0, NL), np.uint32), z, z.copy(), z.copy(),
                       k, w)
        rows = np.concatenate(all_rows)
        rows = rows[np.lexsort(tuple(rows[:, c]
                                     for c in reversed(range(NL + 2))))]
        uniq_row = np.ones(len(rows), bool)
        uniq_row[1:] = np.any(rows[1:] != rows[:-1], axis=1)
        rows = rows[uniq_row]
        starts = np.ones(len(rows), bool)
        starts[1:] = np.any(rows[1:, :NL] != rows[:-1, :NL], axis=1)
        idx = np.flatnonzero(starts)
        counts = np.diff(np.append(idx, len(rows))).astype(np.int32)
        return cls(keys=rows[idx, :NL].astype(np.uint32),
                   edge=rows[idx, NL].astype(np.int32),
                   pos=rows[idx, NL + 1].astype(np.int32),
                   count=counts, k=k, w=w)


def _vote_core(bases, lengths, hkeys, vals, salt: int, k: int, w: int):
    """Per-read best-edge vote.  Returns (best_edge (B,) [-1 if unmapped
    or ambiguous], best_hits (B,), est_start (B,) signed), int64.

    Each read's minimizer positions are compacted to MM_CAP slots (a row
    sort), looked up in the cuckoo table, and the singleton hits are
    tallied per edge by sorting each row by edge and run-length counting
    along it.  The sort need not be stable: the start estimate is the
    minimum over the run."""
    B = bases.shape[0]
    dev = bases.device
    km, _h, is_mm = minimizer_mask(bases, lengths, k, w)
    P = km.shape[1]
    p_or_big = torch.where(is_mm, torch.arange(P, device=dev)[None, :], BIG)
    sp = torch.sort(p_or_big, dim=1).values[:, :MM_CAP]
    cval = sp < P
    spc = torch.clamp(sp, max=P - 1)
    ckg = torch.gather(km, 1, spc[:, :, None].expand(-1, -1, NL))
    ck = torch.where(cval[:, :, None], ckg, lb.M32).reshape(-1, NL)
    cp = torch.where(cval, spc, 0).reshape(-1)

    edge_sing, pos_v, _found = _cuckoo_probe(hkeys, vals, salt, ck)
    sing = cval.reshape(-1) & (edge_sing >= 0)
    SENT = 0x7FFFFFFF
    ce = torch.where(sing, edge_sing, SENT).reshape(B, MM_CAP)
    # SIGNED start: negative when the read overhangs the edge head
    cs = torch.where(sing, pos_v - cp, BIG).reshape(B, MM_CAP)

    se, order = torch.sort(ce, dim=1)
    ss = torch.gather(cs, 1, order)
    jj = torch.arange(MM_CAP, device=dev)[None, :].expand(B, -1)
    newrun = torch.ones_like(se, dtype=torch.bool)
    newrun[:, 1:] = se[:, 1:] != se[:, :-1]
    run_start = torch.cummax(torch.where(newrun, jj, -1), dim=1).values
    is_end = torch.ones_like(se, dtype=torch.bool)
    is_end[:, :-1] = se[:, :-1] != se[:, 1:]
    validrun = se != SENT
    runlen = torch.where(is_end & validrun, jj - run_start + 1, 0)
    best = runlen.amax(dim=1)
    n_best = ((runlen == best[:, None]) & (runlen > 0)).sum(dim=1)
    # run-min of the start estimate: segmented doubling min along the row
    m = ss
    off = 1
    while off < MM_CAP:
        shifted = torch.cat([torch.full((B, off), BIG, dtype=m.dtype,
                                        device=dev), m[:, :-off]], dim=1)
        m = torch.where(jj - off >= run_start, torch.minimum(m, shifted), m)
        off <<= 1
    pick = is_end & validrun & (runlen == best[:, None]) & \
        (n_best == 1)[:, None] & (best > 0)[:, None]
    best_edge = torch.where(pick, se, -1).amax(dim=1)
    best_start = torch.where(pick, m, BIG).amin(dim=1)
    # confidence gate (RATIO_OF_CONFIDENT=0.85, MIN_NUMBER_SINGLETON=2)
    tot = validrun.sum(dim=1)
    conf = (best * 100 >= 85 * tot) | (tot <= 2)
    be = torch.where(conf, best_edge, -1)
    return be, best, torch.where(be >= 0, best_start, -1)


def _verified_core(bases, lengths, hkeys, vals, salt, seq_pk, seq_off, thr,
                   k: int, w: int, mt: int, mm: int):
    """Vote + gapless verification on the device.  Returns (best_edge,
    best_hits, est_start, bound, fast); `fast` lanes are accepted without
    the DP."""
    be, best, bs = _vote_core(bases, lengths, hkeys, vals, salt, k, w)
    bound, feas = _gapless_bound_dev(seq_pk, seq_off, be, bs, bases,
                                     lengths, mt, mm)
    return be, best, bs, bound, feas & (bound >= thr)


def _pack_pool_nibbles(seq_data: np.ndarray) -> np.ndarray:
    """4-bit-pack a base-code pool into 32-bit words (8 codes a word,
    lowest nibble first) with POOL_PAD_W sentinel words (0xF nibbles,
    never equal to a read code) at both ends.  int64 host array."""
    n = len(seq_data)
    nw = -(-n // 8)
    buf = np.full(8 * nw, 0xF, np.int64)
    buf[:n] = seq_data
    words = (buf.reshape(nw, 8) << (4 * np.arange(8, dtype=np.int64))).sum(1)
    pad = np.full(POOL_PAD_W, lb.M32, np.int64)
    return np.concatenate([pad, words, pad])


def _device_pool(seq_data: np.ndarray, seq_off: np.ndarray,
                 device: torch.device):
    """(nibble-packed pool, seq_off) on `device`."""
    return (torch.as_tensor(_pack_pool_nibbles(seq_data)).to(device),
            torch.as_tensor(np.asarray(seq_off, np.int64)).to(device))


def _on_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`a`, a host array or a tensor on any device, as a `dtype` tensor
    on `device` (no copy when it is one already)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def _gapless_bound_dev(seq_pk, seq_off, edges, starts, bases, lengths,
                       mt: int, mm: int):
    """Score of the gapless alignment at the voted (signed) offset over
    the on-edge overlap only: query bases past either edge end are
    clipped, not penalized (the reference's clip acceptance, asm_reg2aln,
    src/barcode_builder.c:497-563).

    Each lane's target window is contiguous in the nibble-packed pool,
    so one word-aligned window of W words is gathered per lane, shifted
    down by the start's nibble offset and unpacked.  Queries wider than
    the sentinel pad gather one nibble per position instead.

    Returns (bound (N,), feas (N,) bool); feas lanes have a non-empty
    on-edge overlap, so bound lower-bounds the clipped DP optimum."""
    N, Lq = bases.shape
    dev = bases.device
    W = -(-(Lq + 7) // 8) + 1
    nwords = seq_pk.shape[0]
    e = torch.clamp(edges.long(), min=0)
    elen = seq_off[e + 1] - seq_off[e]
    j = torch.arange(Lq, device=dev)[None, :]
    tpos = starts.long()[:, None] + j
    on_edge = (tpos >= 0) & (tpos < elen[:, None]) & \
        (j < lengths.long()[:, None])
    if W > POOL_PAD_W:
        gb = torch.clamp(seq_off[e][:, None] + tpos + 8 * POOL_PAD_W,
                         0, 8 * nwords - 1)
        tch = (seq_pk[gb >> 3] >> (4 * (gb & 7))) & 0xF
    else:
        b = torch.clamp(seq_off[e] + starts.long() + 8 * POOL_PAD_W,
                        0, 8 * (nwords - W))
        win = seq_pk[(b >> 3)[:, None] + torch.arange(W, device=dev)[None, :]]
        sh = (4 * (b & 7))[:, None]
        nxt = torch.cat([win[:, 1:], torch.zeros_like(win[:, :1])], dim=1)
        wal = (win >> sh) | ((nxt << (32 - sh)) & lb.M32)
        nib = (wal[:, :, None] >> (4 * torch.arange(8, device=dev))) & 0xF
        tch = nib.reshape(N, 8 * W)[:, :Lq]
    nmatch = ((bases.long() == tch) & on_edge).sum(dim=1)
    n_on = on_edge.sum(dim=1)
    bound = nmatch * mt + (n_on - nmatch) * mm
    return bound, (n_on > 0) & (edges >= 0)


def rescore_hits(seq_data: np.ndarray, seq_off: np.ndarray,
                 edges: np.ndarray, starts: np.ndarray,
                 bases: np.ndarray, lengths: np.ndarray,
                 scoring=None, min_score=None, pad: int = RESCORE_PAD, *,
                 device: str | torch.device = "cuda"):
    """Verify voted hits with the alignment DP (reference asm_reg2aln ->
    ksw_global2; reads under score 50 are dropped).

    A lane whose gapless alignment at the voted offset already clears
    its threshold is accepted without the DP (a gapless alignment is
    feasible, so its score lower-bounds the DP optimum); every other
    mapped lane gets the full DP.  min_score: scalar or (N,).
    Returns (accept (N,) bool, scores (N,) int32); unmapped lanes are
    False/0, fast-path lanes report the gapless bound."""
    dev = resolve_device(device)
    scoring = dp.SCORING_BWA if scoring is None else scoring
    min_score = dp.MIN_MAP_SCORE if min_score is None else min_score
    N = len(bases)
    accept = np.zeros(N, bool)
    scores = np.zeros(N, np.int32)
    mapped = edges >= 0
    if not mapped.any():
        return accept, scores
    sd, sod = _device_pool(seq_data, seq_off, dev)
    edges_d = _on_device(edges, torch.int64, dev)
    starts_d = _on_device(starts, torch.int64, dev)
    bases_d = _on_device(bases, torch.uint8, dev)
    lens_d = _on_device(lengths, torch.int64, dev)
    bound_d, feas_d = _gapless_bound_dev(
        sd, sod, edges_d, starts_d, bases_d, lens_d,
        int(scoring[0]), int(scoring[1]))
    bound = bound_d.cpu().numpy()
    thr_all = np.broadcast_to(np.asarray(min_score), (N,))
    fast = feas_d.cpu().numpy() & (bound >= thr_all) & mapped
    scores[fast] = bound[fast]
    accept[fast] = True
    rest = np.flatnonzero(mapped & ~fast)
    if len(rest):
        sc = _dp_verify_rest(seq_data, sod, edges_d, starts_d, bases_d,
                             lens_d, rest, scoring, pad, device=dev)
        scores[rest] = sc
        accept[rest] = sc >= thr_all[rest]
    return accept, scores


def _dp_verify_rest(seq_data, seq_off, edges, starts, bases, lengths,
                    rest, scoring, pad: int = RESCORE_PAD, *,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Full affine-gap DP ("fit") for the lanes in `rest`.  Query bases
    overhanging either edge end are trimmed first, so only the on-edge
    part must align.

    Every array may be a host array or a tensor; what is not on `device`
    yet is copied there once (seq_data as uint8 codes), and the target
    windows and trimmed queries are cut there, so a caller that holds
    the reads and the votes on the device moves only `rest` in and the
    scores out.  Returns (len(rest),) int32 host scores."""
    dev = resolve_device(device)
    sd = _on_device(seq_data, torch.uint8, dev)
    so = _on_device(seq_off, torch.int64, dev)
    r = _on_device(rest, torch.int64, dev)
    Lq = bases.shape[1]
    e = _on_device(edges, torch.int64, dev)[r]
    qlen = _on_device(lengths, torch.int64, dev)[r]
    elen = so[e + 1] - so[e]
    s0s = _on_device(starts, torch.int64, dev)[r]
    qlo = torch.clamp(-s0s, min=0)                       # head-overhang trim
    qhi = torch.maximum(torch.minimum(qlen, elen - s0s), qlo)  # tail trim
    ql_t = qhi - qlo
    s0 = torch.minimum(torch.clamp(s0s + qlo, min=0),
                       torch.clamp(elen - 1, min=0))     # on-edge start
    w0 = torch.clamp(s0 - pad, min=0)
    w1 = torch.minimum(s0 + ql_t + pad, elen)
    Lt = Lq + 2 * pad
    j = torch.arange(Lt, device=dev)[None, :]
    idx = torch.clamp((so[e] + w0)[:, None] + j, max=len(sd) - 1)
    t = torch.where(j < (w1 - w0)[:, None], sd[idx], 255)
    # per-row left shift by qlo (trim the head overhang off the query)
    qidx = torch.clamp(qlo[:, None] + j[:, :Lq], max=Lq - 1)
    q = torch.gather(_on_device(bases, torch.uint8, dev)[r], 1, qidx)
    sc = dp.affine_scores_tensors(q, ql_t, t, w1 - w0, scoring, mode="fit")
    return torch.where(ql_t > 0, sc, 0).to(torch.int32).cpu().numpy()


def map_reads(index: EdgeMinimizerIndex, bases: np.ndarray,
              lengths: np.ndarray, batch_size: int = 65536,
              graph: AsmGraph | None = None, min_score=None,
              shipped: Tuple[torch.Tensor, torch.Tensor] | None = None,
              with_hits: bool = True, *, mesh=None,
              device: str | torch.device = "cuda"):
    """Map a read matrix; returns (edge (N,) int32 [-1 unmapped],
    n_hits (N,) int32, est_start (N,) int32).

    graph: when given, every voted hit is verified (gapless bound on the
    device, the DP for the rest) and rejects are demoted to unmapped.
    shipped: the (bases, lengths) tensors of these reads already on the
    device (count_reads_device(return_chunks=True)); the host `bases`
    and `lengths` then only give the number of reads.
    with_hits=False returns zeros for n_hits.
    mesh: a mesh of more than one shard (parallel/mesh.py) maps the
    reads split over this process's shards on their devices instead of
    on `device` (parallel/sharded_map.py, equal bit for bit)."""
    if mesh is not None and mesh.size > 1:
        from ..parallel.sharded_map import map_reads_sharded
        return map_reads_sharded(index, bases, lengths, mesh,
                                 batch_size=batch_size, graph=graph,
                                 min_score=min_score, with_hits=with_hits)
    dev = resolve_device(device)
    N = len(bases)
    edges = np.full(N, -1, np.int32)
    hits = np.zeros(N, np.int32)
    starts = np.full(N, -1, np.int32)
    if len(index.keys) == 0 or N == 0:
        return edges, hits, starts
    if min_score is None:
        min_score = dp.MIN_MAP_SCORE
    thr_all = np.broadcast_to(np.asarray(min_score, np.int64), (N,))
    hkeys, vals, salt = index.device_tables(dev)
    if shipped is None:
        shipped = (_on_device(bases, torch.uint8, dev),
                   _on_device(lengths, torch.int32, dev))
    bases_d, lens_d = shipped[0][:N], shipped[1][:N]
    verified = graph is not None
    if verified:
        sd, sod = _device_pool(graph.seq_data, graph.seq_off, dev)
        mt, mm = int(dp.SCORING_BWA[0]), int(dp.SCORING_BWA[1])
        thr_d = torch.as_tensor(np.array(thr_all)).to(dev)
    outs = []
    for i in range(0, N, batch_size):
        rb, lb_ = bases_d[i:i + batch_size], lens_d[i:i + batch_size]
        if verified:
            out = _verified_core(rb, lb_, hkeys, vals, salt, sd, sod,
                                 thr_d[i:i + batch_size], index.k, index.w,
                                 mt, mm)
            outs.append((out[0], out[1], out[2], out[4]))
        else:
            outs.append(_vote_core(rb, lb_, hkeys, vals, salt, index.k,
                                   index.w))
    edges_d = torch.cat([o[0] for o in outs])
    starts_d = torch.cat([o[2] for o in outs])
    edges = edges_d.to(torch.int32).cpu().numpy()
    if with_hits:
        hits = torch.cat([o[1] for o in outs]).to(torch.int32).cpu().numpy()
    starts = starts_d.to(torch.int32).cpu().numpy()
    if verified:
        fast = torch.cat([o[3] for o in outs]).cpu().numpy()
        accept = fast & (edges >= 0)
        rest = np.flatnonzero((edges >= 0) & ~fast)
        if len(rest):
            sc = _dp_verify_rest(graph.seq_data, sod, edges_d, starts_d,
                                 bases_d, lens_d, rest, dp.SCORING_BWA,
                                 device=dev)
            accept[rest] = sc >= thr_all[rest]
        edges = np.where(accept, edges, -1)
    # public starts are BWA-pos style: clamped >= 0 on mapped lanes
    starts = np.where(edges >= 0, np.maximum(starts, 0), -1).astype(np.int32)
    return edges.astype(np.int32), hits, starts
