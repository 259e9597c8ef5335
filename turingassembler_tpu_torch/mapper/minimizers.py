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

On the card the minimizer marks, probe, vote and gapless bound of a
batch are one launch of the csrc/mm_map.cu kernel (ops/mm_map.py), and
the index build's marks another; CPU tensors take its plain versions,
which live beside it, as do the tables' and the pool's device layouts.

Hashes and limbs are int64 values in [0, 2^32) (ops/limbs.py).  The
cuckoo tables are built on the host with numpy int64 and probed on the
device with the same mixer, bit for bit.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..graph.structs import AsmGraph
from ..ops import dp
from ..ops import limbs as lb
from ..ops import mm_map
from ..ops.mm_map import CUCKOO_CAP, cuckoo_hash

MM_K = 17       # MINIMIZERS_KMER (reference src/attribute.h:21)
MM_W = 17       # MINIMIZERS_WINDOW (reference src/attribute.h:20)
NL = lb.n_limbs(MM_K)  # 2 limbs
RESCORE_PAD = 16   # target-window slack around the voted start


# ---------------------------------------------------------------------
# Cuckoo lookup: a 4-slot-per-bucket 2-choice table resolves a key in at
# most 2 bucket-row gathers + 1 value-row gather, with the values
# pre-fused to what the vote needs: (edge+1 if singleton else 0, pos).
# ---------------------------------------------------------------------

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
        h1 = cuckoo_hash(k0, k1, salt, mask, 0)
        h2 = cuckoo_hash(k0, k1, salt, mask, 1)
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
        """(hkeys, vals, salt) on `device` in the layout its map takes
        (mm_map.device_tables), made once a device."""
        dev = resolve_device(device)
        if str(dev) not in self._dev:
            hkeys, vals, salt = self.hash_tables()
            self._dev[str(dev)] = (*mm_map.device_tables(hkeys, vals, dev),
                                   salt)
        return self._dev[str(dev)]

    SEG = 4096     # content window positions per device row
    SEG_B = 256    # rows per device batch

    @classmethod
    def segment_batches(cls, g: AsmGraph, k: int = MM_K, w: int = MM_W):
        """The build's device batches: (edge (n,), segment start (n,),
        rows (n, SEG + k + w - 2) uint8 codes with 255 past each part,
        lengths (n,) int32) for n <= SEG_B segments at a time."""
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
        for i in range(0, len(segs_e), B):
            ce = np.asarray(segs_e[i:i + B], np.int64)
            cs = np.asarray(segs_s[i:i + B], np.int64)
            mat = np.full((len(ce), Wd), 255, np.uint8)
            elen = np.zeros(len(ce), np.int32)
            for j, (e, s) in enumerate(zip(ce, cs)):
                part = g.get_seq(e)[s:s + Wd]
                mat[j, :len(part)] = part
                elen[j] = len(part)
            yield ce, cs, mat, elen

    @classmethod
    def build(cls, g: AsmGraph, k: int = MM_K, w: int = MM_W, *,
              device: str | torch.device = "cuda") -> "EdgeMinimizerIndex":
        """Index every live edge (reference mm_index_edges).

        Edges are cut into fixed-width segments overlapping by w+k-2, so
        every window lies in exactly one segment; a minimizer marked from
        two adjacent segments is an exact duplicate (key, edge, pos) row
        and is dropped before the run-length count."""
        dev = resolve_device(device)
        all_rows = []
        for ce, cs, mat, elen in cls.segment_batches(g, k, w):
            packed = mm_map.minimizer_rows(
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


_POOL_CACHE: dict = {}   # (ids, device) -> (weakrefs, device_pool's)
_POOL_LOCK = threading.Lock()


def _device_pool(seq_data: np.ndarray, seq_off: np.ndarray,
                 device: torch.device):
    """(pool, seq_off, the codes the remainder DP reads) of a graph in
    the layout its map takes on `device` (mm_map.device_pool).  Cached
    per (seq_data, seq_off) array identity, as the JAX package's
    _device_pool caches its packed pool: the graph modules replace
    seq_data and never edit it in place.  The bridge maps from worker
    threads, so the cache takes a lock; it is cleared past 8 entries.  A
    miss counts pool_builds on the span open."""
    key = (id(seq_data), id(seq_off), str(device))
    with _POOL_LOCK:
        hit = _POOL_CACHE.get(key)
        if hit is not None and hit[0][0]() is seq_data \
                and hit[0][1]() is seq_off:
            return hit[1]
        dev = mm_map.device_pool(seq_data, seq_off, device)
        if len(_POOL_CACHE) >= 8:
            _POOL_CACHE.clear()
        _POOL_CACHE[key] = ((weakref.ref(seq_data), weakref.ref(seq_off)),
                            dev)
        tracing.add(pool_builds=1)
        return dev


def _on_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`a`, a host array or a tensor on any device, as a `dtype` tensor
    on `device` (no copy when it is one already)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


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
    sd, sod, codes = _device_pool(seq_data, seq_off, dev)
    edges_d = _on_device(edges, torch.int64, dev)
    starts_d = _on_device(starts, torch.int64, dev)
    bases_d = _on_device(bases, torch.uint8, dev)
    lens_d = _on_device(lengths, torch.int32, dev)
    bound_d, feas_d = mm_map.gapless_bound(
        sd, sod, edges_d, starts_d, bases_d, lens_d,
        int(scoring[0]), int(scoring[1]))
    bound = bound_d.cpu().numpy()
    thr_all = np.broadcast_to(np.asarray(min_score), (N,))
    fast = feas_d.cpu().numpy() & (bound >= thr_all) & mapped
    scores[fast] = bound[fast]
    accept[fast] = True
    rest = np.flatnonzero(mapped & ~fast)
    if len(rest):
        sc = _dp_verify_rest(codes, sod, edges_d, starts_d, bases_d, lens_d,
                             rest, scoring, pad, device=dev)
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
    tracing.host_sync()
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
    with tracing.span("map", reads=len(bases)):
        out = _map_on(resolve_device(device), index, bases, lengths,
                      batch_size, graph, min_score, shipped, with_hits)
        if tracing.enabled():
            tracing.add(mapped=int(np.count_nonzero(out[0] >= 0)))
    return out


def _map_on(dev, index, bases, lengths, batch_size, graph, min_score,
            shipped, with_hits):
    """map_reads on one device, its time divided among the spans map.ship
    (the reads' copy: bytes, pageable), map.vote (the map_batch launches;
    pool_builds on a pool cache miss), map.dp (the DP of the voted lanes
    the gapless bound did not accept: pairs) and map.pull (the outputs)."""
    N = len(bases)
    edges = np.full(N, -1, np.int32)
    hits = np.zeros(N, np.int32)
    starts = np.full(N, -1, np.int32)
    if len(index.keys) == 0 or N == 0:
        return edges, hits, starts
    if min_score is None:
        min_score = dp.MIN_MAP_SCORE
    hkeys, vals, salt = index.device_tables(dev)
    if shipped is None:
        # pageable: a host array, or a CPU tensor not pinned
        host = not isinstance(bases, torch.Tensor) or \
            bases.device.type == "cpu"
        pinned = isinstance(bases, torch.Tensor) and \
            (bases.device.type != "cpu" or bases.is_pinned())
        with tracing.span("map.ship", bytes=bases.nbytes + lengths.nbytes,
                          pageable=int(not pinned)):
            if host and dev.type != "cpu":
                tracing.host_sync(2)            # a blocking copy waits
            shipped = (_on_device(bases, torch.uint8, dev),
                       _on_device(lengths, torch.int32, dev))
    bases_d, lens_d = shipped[0][:N], shipped[1][:N]
    verified = graph is not None
    # the kernel writes each batch straight into the (N,) arrays
    out = [torch.empty(N, dtype=torch.int32, device=dev) for _ in range(3)]
    with tracing.span("map.vote"):
        if verified:
            sd, sod, codes = _device_pool(graph.seq_data, graph.seq_off,
                                          dev)
            mt, mm = int(dp.SCORING_BWA[0]), int(dp.SCORING_BWA[1])
            thr_h = np.asarray(min_score, np.int64)
            if thr_h.ndim and dev.type != "cpu":
                tracing.host_sync()             # a blocking copy waits
            thr = int(thr_h) if thr_h.ndim == 0 else torch.as_tensor(
                np.broadcast_to(thr_h, (N,)).astype(np.int32)).to(dev)
            out += [torch.empty(N, dtype=torch.int32, device=dev),
                    torch.empty(N, dtype=torch.bool, device=dev)]
        for i in range(0, N, batch_size):
            sl = slice(i, i + batch_size)
            if verified:
                mm_map.map_batch(bases_d[sl], lens_d[sl], hkeys, vals, salt,
                                 index.k, index.w, sd, sod,
                                 thr if isinstance(thr, int) else thr[sl],
                                 mt, mm, out=[o[sl] for o in out])
            else:
                mm_map.map_batch(bases_d[sl], lens_d[sl], hkeys, vals, salt,
                                 index.k, index.w, out=[o[sl] for o in out])
    edges_d, hits_d, starts_d = out[:3]
    if verified:
        # fast lanes are accepted; the rest of the mapped lanes go to the
        # DP; the accept and the clamp below stay on the device
        with tracing.span("map.dp"):
            accept_d = out[4]
            tracing.host_sync()
            rest = torch.nonzero((edges_d >= 0) & ~accept_d).squeeze(1)
            tracing.add(pairs=len(rest))
            if len(rest):
                sc = _dp_verify_rest(codes, sod, edges_d, starts_d, bases_d,
                                     lens_d, rest, dp.SCORING_BWA,
                                     device=dev)
                if isinstance(thr, int):
                    thr_rest = thr
                else:
                    tracing.host_sync()
                    thr_rest = thr[rest].cpu().numpy()
                if dev.type != "cpu":
                    tracing.host_sync()         # a blocking copy waits
                accept_d[rest] = torch.as_tensor(sc >= thr_rest).to(dev)
            edges_d = torch.where(accept_d, edges_d, -1)
    # public starts are BWA-pos style: clamped >= 0 on mapped lanes
    starts_d = torch.where(edges_d >= 0, torch.clamp(starts_d, min=0), -1)
    with tracing.span("map.pull"):
        tracing.host_sync(2 + with_hits)
        if with_hits:
            hits = hits_d.cpu().numpy()
        return edges_d.cpu().numpy(), hits, starts_d.cpu().numpy()
