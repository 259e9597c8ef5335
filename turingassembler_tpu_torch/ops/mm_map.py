"""Minimizer map: the CUDA kernel csrc/mm_map.cu, its wrapper, and its plain
versions and device layouts.

Replaces the jitted JAX device program of the minimizer mapper
(turingassembler_tpu/mapper/minimizers.py, XLA, not Pallas): the whole
read->edge vote of a batch, minimizer_mask + compaction to MM_CAP slots +
cuckoo_probe + plain_vote, with the gapless bound plain_gapless_bound
when verified (`_map_batch_verified`, `_map_batch`); the gapless bound
alone (the bridge's rescore_hits); and the index build's minimizer rows,
marked and compacted (`_compact_minimizer_rows`).  Three entries of one
source, one entry a call:
  - map_batch: a warp a read; returns (best_edge, best_hits,
    est_start[, bound, fast]);
  - gapless_bound: a group of lanes a query; (bound int32, feas);
  - minimizer_rows: a block a segment row, a marks pass and a write
    pass; the (n, 4) rows of the marked positions, ascending.
csrc/mm_map.cu says how each computes the plain version's integers
without its row sorts.

The kernel and the plain versions take the tables and the pool in their
own layouts, which device_tables and device_pool make from the host
arrays for a device (mapper/minimizers.py caches them):
  - tables: the plain version's int64 hkeys (NB, 8) and vals (NB*4, 2);
    the kernel's bucket records (NB, 16) int32 (bucket_records), vals
    None;
  - pool: the plain version's nibble-packed int64 words
    (pack_pool_nibbles); the kernel's uint8 codes (the graph's seq_data)
    with POOL_PAD bytes before and after them in their storage
    (padded_codes).
The plain versions are the tensor functions below (minimizer_mask,
cuckoo_probe, plain_vote, plain_verified, plain_gapless_bound,
plain_minimizer_rows).  On CPU tensors the wrapper runs them; on CUDA
tensors it launches the kernel or raises.  map_batch's kernel returns
int32 where its plain versions return int64: the values are equal.
COUNT records every launch as (entry, B, L, verified); the bridge maps
from its worker threads, so it takes a lock.

Hashes and limbs are int64 values in [0, 2^32) (ops/limbs.py).  The
cuckoo tables are built on the host with numpy int64 and probed on the
device with the same mixer, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._build import I, LL, P
from . import kmers as kmod
from . import limbs as lb

MIN_K, MAX_K = 17, 32         # the keys are two limbs (the cuckoo tables')
MAX_W = 32                    # the windows of one sparse-table pass
POOL_PAD = 16                 # bytes of the card's pool before and after
MM_CAP = 48     # minimizer slots per read (a 150 bp read has ~16)
CUCKOO_CAP = 4  # slots per cuckoo bucket
POOL_PAD_W = 32    # sentinel words around the nibble-packed pool
BIG = 1 << 30
NL = lb.n_limbs(MAX_K)   # key limbs: 2

# Kernel launches, each as (entry, B, L, verified) (CUDA path only).
COUNT = _build.LaunchCount(dict.fromkeys(
    ("map_batch", "gapless_bound", "minimizer_rows"), ()))

LIB = _build.Kernels("mm_map", {
    "mm_map_batch_launch": [P, P, LL, I, I, I, P, LL, LL, I, I, I, P, P, P,
                            I, I, I, P, P, P, P, P],
    "mm_gapless_bound_launch": [P, P, P, P, LL, I, P, P, I, I, P, P],
    "mm_minimizer_rows_launch": [P, P, LL, I, I, I, P, P, P, P],
})


# ---------------------------------------------------------------------------
# plain versions (tensor code, any device; the CPU path)
# ---------------------------------------------------------------------------

def minimizer_mask(bases: torch.Tensor, lengths: torch.Tensor,
                   k: int, w: int):
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
            other = ext[:, w - 1 - d:w - 1 - d + P] if left \
                else ext[:, d:d + P]
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


def cuckoo_hash(q0, q1, salt: int, mask: int, which: int):
    """Bucket hash over both key limbs; `which` selects the table.  Works
    on numpy and torch int64 arrays alike, bit-exact."""
    if which == 0:
        x = (q0 ^ lb.mul32(q1, 0x9E3779B1)) + salt
    else:
        x = (q1 ^ lb.mul32(q0, 0x85EBCA77)) + (salt ^ 0x5BD1E995)
    return lb.fmix32(x & lb.M32) & mask


def cuckoo_probe(hkeys: torch.Tensor, vals: torch.Tensor, salt: int,
                 queries: torch.Tensor):
    """Device probe: (edge_sing (Q,) [-1 when the key is absent or not a
    singleton], pos (Q,), found (Q,) bool)."""
    mask = hkeys.shape[0] - 1
    q0, q1 = queries[:, 0], queries[:, 1]
    b1 = cuckoo_hash(q0, q1, salt, mask, 0)
    b2 = cuckoo_hash(q0, q1, salt, mask, 1)
    r1, r2 = hkeys[b1], hkeys[b2]
    m = torch.cat([(r[:, 0::2] == q0[:, None]) & (r[:, 1::2] == q1[:, None])
                   for r in (r1, r2)], dim=1)
    found = m.any(dim=1)
    s = m.to(torch.int8).argmax(dim=1)          # first matching slot
    fidx = torch.where(s < CUCKOO_CAP, b1 * CUCKOO_CAP + s,
                       b2 * CUCKOO_CAP + (s - CUCKOO_CAP))
    v = vals[fidx]
    return torch.where(found, v[:, 0] - 1, -1), v[:, 1], found


def plain_minimizer_rows(mat: torch.Tensor, elen: torch.Tensor,
                         k: int, w: int) -> torch.Tensor:
    """minimizer_rows' plain version: minimizer_mask + ascending
    compaction of the marked positions, (n, NL + 2) int64 rows of key
    limbs, segment row, in-segment position."""
    km, _h, is_mm = minimizer_mask(mat, elen, k, w)
    B, P, nl = km.shape
    flat = torch.nonzero(is_mm.reshape(-1)).squeeze(1)
    return torch.cat([km.reshape(-1, nl)[flat], (flat // P)[:, None],
                      (flat % P)[:, None]], dim=1)


def plain_vote(bases, lengths, hkeys, vals, salt: int, k: int, w: int):
    """map_batch's plain version without a pool: the per-read best-edge
    vote.  Returns (best_edge (B,) [-1 if unmapped or ambiguous],
    best_hits (B,), est_start (B,) signed), int64.

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

    edge_sing, pos_v, _found = cuckoo_probe(hkeys, vals, salt, ck)
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


def plain_verified(bases, lengths, hkeys, vals, salt, seq_pk, seq_off, thr,
                   k: int, w: int, mt: int, mm: int):
    """map_batch's plain version with a pool: vote + gapless
    verification.  Returns (best_edge, best_hits, est_start, bound,
    fast); `fast` lanes are accepted without the DP."""
    be, best, bs = plain_vote(bases, lengths, hkeys, vals, salt, k, w)
    bound, feas = plain_gapless_bound(seq_pk, seq_off, be, bs, bases,
                                      lengths, mt, mm)
    return be, best, bs, bound, feas & (bound >= thr)


def plain_gapless_bound(seq_pk, seq_off, edges, starts, bases, lengths,
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


# ---------------------------------------------------------------------------
# the device layouts of the tables and the pool
# ---------------------------------------------------------------------------

def pack_pool_nibbles(seq_data: np.ndarray) -> np.ndarray:
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


def bucket_records(hkeys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The kernel's table from the host cuckoo tables: one 64-byte record
    a bucket, slot t's (k0, k1, edge + 1 or 0, pos) as uint32 in words
    4t..4t+3.  hkeys (NB, 8) and vals (NB * 4, 2) as build_cuckoo_tables
    makes them; returns (NB, 16) int32 holding the uint32 bits."""
    nb = hkeys.shape[0]
    if hkeys.shape != (nb, 2 * CUCKOO_CAP) \
            or vals.shape != (nb * CUCKOO_CAP, 2):
        raise ValueError(f"mm_map: hkeys (NB, 8) and vals (NB * 4, 2), got "
                         f"{hkeys.shape}, {vals.shape}")
    for name, a in (("hkeys", hkeys), ("vals", vals)):
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError(f"mm_map: {name} must hold uint32 values")
    rec = np.empty((nb, CUCKOO_CAP, 4), np.uint32)
    rec[:, :, 0] = hkeys[:, 0::2]
    rec[:, :, 1] = hkeys[:, 1::2]
    rec[:, :, 2:] = vals.reshape(nb, CUCKOO_CAP, 2)
    return rec.reshape(nb, 4 * CUCKOO_CAP).view(np.int32)


def padded_codes(seq_data: np.ndarray, device) -> torch.Tensor:
    """The card's pool: the graph's uint8 codes on `device`, a view of
    len(seq_data) codes into a buffer with POOL_PAD bytes (0xF) before
    and after them.  The kernel's word loads reach into the pad; the
    view, as the remainder DP reads it, holds the codes alone."""
    n = len(seq_data)
    buf = torch.full((n + 2 * POOL_PAD,), 0xF, dtype=torch.uint8,
                     device=device)
    codes = buf[POOL_PAD:POOL_PAD + n]
    codes.copy_(torch.as_tensor(np.ascontiguousarray(seq_data, np.uint8)))
    return codes


def check_pool_pad(codes: torch.Tensor) -> None:
    """codes has POOL_PAD readable bytes before and after it in its
    storage (padded_codes), which the kernel's word loads need."""
    at = codes.storage_offset() * codes.element_size()
    after = codes.untyped_storage().nbytes() - at - codes.nbytes
    if at < POOL_PAD or after < POOL_PAD:
        raise ValueError(f"mm_map: the card's pool needs {POOL_PAD} bytes "
                         f"of pad before and after its codes, got {at} and "
                         f"{after} (use padded_codes)")


def device_tables(hkeys: np.ndarray, vals: np.ndarray, device):
    """The host cuckoo tables (build_cuckoo_tables') in the layout the map
    takes on `device`: (hkeys, vals) int64 tensors for the plain version
    on the CPU; on a card the kernel's bucket records (bucket_records)
    and vals None."""
    if device.type == "cuda":
        return torch.as_tensor(bucket_records(hkeys, vals)).to(device), None
    return torch.as_tensor(hkeys), torch.as_tensor(vals)


def device_pool(seq_data: np.ndarray, seq_off: np.ndarray, device):
    """A graph's pool in the layout the map takes on `device`: (pool,
    seq_off int64 on the device, the codes the remainder DP reads).  On
    the CPU the nibble-packed int64 words of pack_pool_nibbles, and the
    DP reads seq_data itself; on a card the uint8 codes (padded_codes: a
    view of the codes alone in a buffer padded for the kernel's word
    loads), which the DP reads too."""
    if device.type == "cuda":
        # on-edge codes (< 16) equal the plain version's nibbles, so the
        # kernel's bound reads the codes themselves
        if len(seq_data) and int(seq_data.max()) >= 16:
            raise ValueError("seq_data holds codes >= 16, which the "
                             "nibble-packed pool cannot hold")
        pool = codes = padded_codes(seq_data, device)
    else:
        pool, codes = torch.as_tensor(pack_pool_nibbles(seq_data)), seq_data
    off = torch.as_tensor(np.asarray(seq_off, np.int64)).to(device)
    return pool, off, codes


# ---------------------------------------------------------------------------
# the entries: plain on the CPU, the kernel on a card
# ---------------------------------------------------------------------------

def _check(dev: torch.device, **named) -> None:
    """Each name=(tensor, dtype, dims) is a contiguous tensor of dtype
    with that many dimensions on dev."""
    for name, (x, dt, nd) in named.items():
        if x.device != dev or x.dtype != dt or x.dim() != nd \
                or not x.is_contiguous():
            raise ValueError(f"mm_map: {name} must be a contiguous {nd}-D "
                             f"{dt} tensor on {dev}, got {x.dim()}-D "
                             f"{x.dtype} on {x.device}")


def _check_reads(bases, lengths) -> None:
    _check(bases.device, bases=(bases, torch.uint8, 2),
           lengths=(lengths, torch.int32, 1))
    if lengths.shape[0] != bases.shape[0]:
        raise ValueError("mm_map: bases (B, L) and lengths (B,) disagree")


def _check_k(k: int, w: int) -> None:
    if not MIN_K <= k <= MAX_K or not 1 <= w <= MAX_W:
        raise ValueError(f"mm_map: k={k}, w={w}: the kernel takes "
                         f"{MIN_K} <= k <= {MAX_K} and 1 <= w <= {MAX_W}")


def _check_pool(dev, seq_pk, seq_off) -> None:
    """The pool in the layout of dev: nibble-packed int64 words on the
    CPU, uint8 codes with their pad on a card; seq_off int64 with an
    edge."""
    dt = torch.uint8 if dev.type == "cuda" else torch.int64
    _check(dev, seq_pk=(seq_pk, dt, 1), seq_off=(seq_off, torch.int64, 1))
    if seq_off.shape[0] < 2 or seq_pk.shape[0] < 1:
        raise ValueError("mm_map: the pool needs a word and an edge")
    if dev.type == "cuda":
        check_pool_pad(seq_pk)


def _on_card(bases: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises for any other device."""
    if bases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mm_map: unsupported device {bases.device}")
    return bases.device.type == "cuda"


def _check_tables(dev, hkeys, vals) -> int:
    """The tables in the layout of dev; returns the bucket count NB."""
    nb = hkeys.shape[0]
    if dev.type == "cuda":
        _check(dev, hkeys=(hkeys, torch.int32, 2))
        if vals is not None or hkeys.shape[1] != 4 * CUCKOO_CAP:
            raise ValueError("mm_map: on a card the tables are the bucket "
                             "records (NB, 16) int32 and vals None")
        if hkeys.data_ptr() % 64:
            raise ValueError("mm_map: the bucket records must be 64-byte "
                             "aligned")
    else:
        _check(dev, hkeys=(hkeys, torch.int64, 2), vals=(vals, torch.int64, 2))
        if hkeys.shape[1] != 2 * CUCKOO_CAP \
                or tuple(vals.shape) != (nb * CUCKOO_CAP, 2):
            raise ValueError("mm_map: hkeys (NB, 8) and vals (NB * 4, 2), "
                             f"got {tuple(hkeys.shape)}, {tuple(vals.shape)}")
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"mm_map: the tables need a power of two of "
                         f"buckets, got {nb}")
    return nb


def map_batch(bases, lengths, hkeys, vals, salt: int, k: int, w: int,
              seq_pk=None, seq_off=None, thr=None, mt: int = 0,
              mm: int = 0, out=None):
    """The vote of a batch of reads, and with a pool (seq_pk, seq_off) the
    gapless bound at the voted offset too (the JAX _map_batch_verified;
    _map_batch without it).

    bases (B, L) uint8 codes, lengths (B,) int32; hkeys, vals the cuckoo
    tables of `salt` in the layout of the bases' device (module note);
    the verified form takes the pool (seq_pk, seq_off int64), the
    threshold thr (an int, or (B,) int32 / int64) and the match /
    mismatch scores mt, mm.  L - k + 1 must be at least MM_CAP (the plain
    version's compaction).  Returns (best_edge, best_hits, est_start)
    (B,), then (bound (B,), fast (B,) bool) when verified: plain_vote's
    and plain_verified's values, int64 from the plain versions, int32
    from the kernel.  out: tensors of those dtypes and shapes (int32 on
    a card) to write into instead, returned."""
    _check_reads(bases, lengths)
    _check_k(k, w)
    dev = bases.device
    card = _on_card(bases)
    nb = _check_tables(dev, hkeys, vals)
    B, L = bases.shape
    if L - k + 1 < MM_CAP:
        raise ValueError(f"mm_map: a width of {L} gives {L - k + 1} window "
                         f"positions, fewer than the {MM_CAP} slots a "
                         "read")
    verified = seq_pk is not None
    if verified:
        _check_pool(dev, seq_pk, seq_off)
        if isinstance(thr, torch.Tensor):
            if thr.device != dev or thr.dim() != 1 or thr.shape[0] != B \
                    or thr.dtype not in (torch.int32, torch.int64):
                raise ValueError("mm_map: thr must be an int or a (B,) "
                                 f"integer tensor on {dev}")
        else:
            thr = int(thr)
    if not card:
        res = (plain_verified(bases, lengths, hkeys, vals, salt, seq_pk,
                              seq_off, thr, k, w, mt, mm) if verified
               else plain_vote(bases, lengths, hkeys, vals, salt, k, w))
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    n_out = 5 if verified else 3
    if out is None:
        out = tuple(torch.empty(B, dtype=torch.int32 if i < 4 else torch.bool,
                                device=dev) for i in range(n_out))
    if len(out) != n_out:
        raise ValueError(f"mm_map: out holds {len(out)} tensors, the entry "
                         f"writes {n_out}")
    for i, o in enumerate(out):
        _check(dev, out=(o, torch.int32 if i < 4 else torch.bool, 1))
        if o.shape[0] != B:
            raise ValueError("mm_map: out (B,) disagrees with bases")
    if B == 0:
        return tuple(out)
    thr_ptr, thr_all = None, 0
    if verified:
        if isinstance(thr, torch.Tensor):
            thr = thr.to(torch.int32).contiguous()
            thr_ptr = thr.data_ptr()
        else:
            thr_all = thr
    pool = (seq_pk.data_ptr(), seq_off.data_ptr()) if verified \
        else (None, None)
    ptrs = [o.data_ptr() for o in out] + [None] * (5 - n_out)
    LIB.launch("mm_map_batch_launch", dev, bases.data_ptr(),
               lengths.data_ptr(), B, L, k, w, hkeys.data_ptr(), nb, int(salt),
               MM_CAP, BIG, int(verified), *pool, thr_ptr, thr_all, mt,
               mm, *ptrs)
    COUNT.add("map_batch", B, L, verified)
    return tuple(out)


def gapless_bound(seq_pk, seq_off, edges, starts, bases, lengths, mt: int,
                  mm: int):
    """Score of the gapless alignment of each query at its edge and
    signed start over the on-edge positions (the JAX
    _gapless_bound_dev).  seq_pk, seq_off: the pool in the layout of the
    bases' device (module note); edges and starts (N,) int64, bases (N, L)
    uint8, lengths (N,) int32.  Returns (bound (N,) int32, feas (N,)
    bool), as the JAX function does."""
    _check_reads(bases, lengths)
    dev = bases.device
    card = _on_card(bases)
    _check_pool(dev, seq_pk, seq_off)
    _check(dev, edges=(edges, torch.int64, 1), starts=(starts, torch.int64, 1))
    N, L = bases.shape
    if edges.shape[0] != N or starts.shape[0] != N:
        raise ValueError("mm_map: edges and starts (N,) disagree with bases")
    if not card:
        bound, feas = plain_gapless_bound(seq_pk, seq_off, edges, starts,
                                            bases, lengths, mt, mm)
        return bound.to(torch.int32), feas
    bound = torch.empty(N, dtype=torch.int32, device=dev)
    feas = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return bound, feas
    LIB.launch("mm_gapless_bound_launch", dev, bases.data_ptr(),
               lengths.data_ptr(), edges.data_ptr(), starts.data_ptr(), N, L,
               seq_pk.data_ptr(), seq_off.data_ptr(), mt, mm, bound.data_ptr(),
               feas.data_ptr())
    COUNT.add("gapless_bound", N, L, True)
    return bound, feas


def minimizer_rows(bases, lengths, k: int, w: int):
    """The minimizers of segment rows, compacted (the JAX
    _compact_minimizer_rows as the index build calls it): bases (B, L)
    uint8 codes with L >= k, lengths (B,) int32.  Returns (n, 4) int64
    rows (key limb 0, limb 1, segment row, in-segment position) of the
    marked positions, ascending by row then position."""
    _check_reads(bases, lengths)
    _check_k(k, w)
    B, L = bases.shape
    if L < k:
        raise ValueError(f"mm_map: rows of width {L} hold no {k}-mer")
    if not _on_card(bases):
        return plain_minimizer_rows(bases, lengths, k, w)
    dev = bases.device
    if B == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    P = L - k + 1
    marks = torch.empty((B, -(-P // 32)), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    rows = torch.empty((B * P, 4), dtype=torch.int64, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    LIB.launch("mm_minimizer_rows_launch", dev, bases.data_ptr(),
               lengths.data_ptr(), B, L, k, w, marks.data_ptr(),
               counts.data_ptr(), rows.data_ptr(), n.data_ptr())
    COUNT.add("minimizer_rows", B, L, False)
    return rows[:int(n.item())]
