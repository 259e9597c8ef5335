"""The k-mer count's device program: the CUDA kernels csrc/kmer_sort.cu and
their wrapper.

Replaces the jitted JAX device code of the sort-based count
(turingassembler_tpu/kmer/megasort.py, XLA, not Pallas):
  - extract_keys: reads -> the canonical (k+1)-mer rows of their valid
    windows (`_extract_chunk` + ops/kmers.py:extract_canonical_kmers);
  - sort_count: sort limb rows and run-length count them (`_sort_count`);
  - merge_runs: merge two (keys, counts) runs, summing the counts of equal
    keys (`_merge_unique_runs`; here any number of equal rows);
  - lex_order: the stable lexicographic permutation of limb rows (JAX
    `lax.sort` with `num_keys`; plain: ops/limbs.py:plain_lex_order).
csrc/kmer_sort.cu says how: extraction in one launch (each read packed
once into 2-bit words, a window's limbs by funnel shifts, the block's
offset by a decoupled look-back); sort_count as a prefix partition (the
LSD passes on the top live digits, sort_plan) plus a bucket sort-and-count
in shared memory (bucket_groups), the buckets over the block's capacity
gathered into one segment, sorted by the LSD passes and their runs put
back by group (one batched route, whatever their number); lex_order as
the same prefix partition carrying the row index (lex_plan: buckets of
tens of rows), each bucket ranked by counting, by a warp up to LEX_WARP
rows, by a block (counting or LSD passes in shared memory) up to
LEX_CAPACITY, the LSD route beyond; merge_runs as a merge path over its
two ascending inputs (diagonal splits, a tile merged in shared memory,
runs marked and summed across tile borders), the LSD route (a stable LSD
radix sort of SoA uint32 limbs in 8-bit digits, digit_plan, a pass
skipped where its digit has one bucket, then a run pass) when the kernel
finds an input out of order.

On CPU tensors each entry runs its plain version (the tensor code of
kmer/megasort.py and ops/limbs.py:plain_lex_order); on CUDA tensors it
launches the kernels or raises.  The CPU path never builds or looks for
nvcc.  Outputs: extract_keys gives (n, nl) int64 limbs on the CPU and
int32 bit patterns of the same limbs on a card (half the bytes for the
window the count gathers; sort_count and merge_runs take either);
sort_count and merge_runs give (uniq (n, nl) int64 ascending, counts (n,)
int32) on both; lex_order an int64 permutation.  int64 limbs must lie
in [0, 2^32): the card raises on any other value.  COUNT records every
launch with its shape, and the routes of sort_count, lex_order and
merge_runs (ROUTES), which also land on the span open.  Each entry syncs
with the host once or twice (the rows or runs it made; the live digits
that decide the passes; merge_runs' order flag; lex_order's buckets over
capacity), sort_count three times more when buckets go over capacity
(the segment's live digits, its runs, the unique rows again), however
many they are, and lex_order once more for each bucket over capacity.
tracing.py counts each sync on the span open (host_sync) and times
sort_count's route for the buckets over capacity, up to its last sync,
as `count.sort.lsd`.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from .. import _build, tracing
from .._build import I, LL, P
from . import kmers as km
from . import limbs as lb

RADIX_BITS = 8            # a pass's digit (csrc/kmer_sort.cu says why)
RADIX = 1 << RADIX_BITS
MAX_NL = 4                # the kernels' widest row (k1 <= 64)
MAX_ROWS = (1 << 31) - 1  # rows a sort takes (32-bit digit offsets)
TILE = 4096               # keys a block of the sort and run passes
# rows a block of the bucket kernel holds, by nl (csrc/kmer_sort.cu:
# bucket_capacity; sort_count checks it against the built kernel)
BUCKET_CAPACITY = {1: 16384, 2: 13408, 3: 10720, 4: 8928}
# rows a block of lex_order's bucket kernel holds, by nl (csrc/kmer_sort.cu:
# lex_capacity; lex_order checks it against the built kernel)
LEX_CAPACITY = {1: 16384, 2: 16384, 3: 13408, 4: 10720}
LEX_WARP = 256            # rows a warp of lex_order ranks: a bucket at most
LEX_MEAN = 128            # lex_order's partition aims its mean bucket here
MAX_PARTITION = 2         # partition digits at most (65,536 buckets)
MERGE_TILE = 2048         # merged rows a tile of merge_runs' merge path
# merge_runs' flags (the count step's meta[2])
MERGE_DESCENT, MERGE_WIDE = 1, 2
# each entry's routes on the card (its counts in COUNT)
ROUTES = {"extract_keys": (),
          "sort_count": ("partition_passes", "bucket_groups", "over_capacity"),
          "lex_order": ("partition_passes", "warp_buckets", "block_buckets",
                        "over_capacity"),
          "merge_runs": ("merge_path", "lsd")}

# Launches of each entry and each launch's shape (CUDA path only):
# ("extract_keys", B, L, k1), ("sort_count", n, nl),
# ("merge_runs", na, nb, nl), ("lex_order", n, nl); and the routes, by
# entry (ROUTES): sort_count's partition passes, the groups of buckets
# its bucket kernel took, the buckets over capacity that took the LSD
# route; lex_order's partition passes, the buckets ranked by a warp, by
# a block, over capacity (the LSD route); merge_runs' calls that took the
# merge path or, an input out of order, the LSD route.
COUNT = _build.LaunchCount(ROUTES)

LIB = _build.Kernels("kmer_sort", {
    "ks_extract_launch": [P, P, LL, I, I, P, P, P],
    "ks_load_launch": [P, P, LL, LL, I, I, LL, P, P, I, P, I, P, P, P],
    "ks_sort_passes_launch": [P, P, P, P, LL, I, P, P, I, P, P],
    "ks_bounds_launch": [P, LL, I, P, I, P],
    "ks_groups_launch": [P, LL, LL, I, P, P],
    "ks_bucket_launch": [P, LL, I, P, P, I, P, I, I, P, P, P],
    "ks_gather_launch": [P, LL, I, P, LL, P, P],
    "ks_place_runs_launch": [P, P, P, LL, I, P, P, LL, P, P],
    "ks_compact_count_launch": [P, P, P],
    "ks_compact_write_launch": [P, P, LL, I, P, P, P, P, P],
    "ks_runs_count_launch": [P, P, LL, I, P, P],
    "ks_runs_write_launch": [P, P, LL, I, P, P, LL, P, P, P],
    "ks_lex_buckets_launch": [P, LL, I, P, P, LL, I, P, I, P, P, P, P],
    "ks_merge_count_launch": [P, P, LL, LL, I, I, P, P, P, P, P],
    "ks_merge_write_launch": [P, P, LL, LL, I, I, P, P, P, P, P, LL, P, P,
                              P],
}, {"ks_sort_scratch_words": ([LL], LL), "ks_bucket_capacity": ([I], I),
    "ks_lex_capacity": ([I], I), "ks_merge_tile": ([], I)})


def _check_built(what: str, entry: str, want: int, *arg: int) -> None:
    """Raise unless the built kernel's constant equals the wrapper's."""
    got = LIB.query(entry, *arg)
    if got != want:
        raise RuntimeError(f"kmer_sort: the kernel's {what} is {got}, not "
                           f"{want}")


def _ints(values) -> ctypes.Array:
    """A host int array for a C entry (the plan, the pass flags)."""
    return (ctypes.c_int * max(len(values), 1))(*values)


# ---------------------------------------------------------------------------
# the digit plan (host side)
# ---------------------------------------------------------------------------

def digit_plan(nl: int) -> List[Tuple[int, int, int]]:
    """The LSD passes of a sort of (n, nl) limb rows on all their bits:
    (limb, shift, width) each, least significant digit first, RADIX_BITS
    wide.  A pass whose digit is the same in every row (one bucket in the
    load's histogram) is skipped on the card, so bits that are 0 in every
    row, such as the low 4 of a 46-mer's last limb, cost no pass of their
    own."""
    return [(limb, shift, RADIX_BITS) for limb in range(nl - 1, -1, -1)
            for shift in range(0, 32, RADIX_BITS)]


def sort_plan(live, n: int, cap: int):
    """sort_count's plan on the card.  live: for each digit of
    digit_plan(nl) (least significant first), whether it takes two values
    or more in the rows (the load's XOR words); n rows; cap a block's
    capacity.  Returns (part, rest), indices into digit_plan(nl), least
    significant first:
      - part, the partition digits: the most significant live digits, none
        when the rows fit one block (n <= cap), else as many as keep the
        mean bucket n / 256^d under a quarter of the capacity, at most
        MAX_PARTITION.  A stable LSD sort on them groups the rows by their
        prefix, ascending, since the digits above them are the same in
        every row;
      - rest, the bucket kernel's digits: every live digit below the
        partition, then the partition's least significant digit (a group
        of buckets shares the digits above it, so this one orders its
        buckets)."""
    msd = [p for p in range(len(live) - 1, -1, -1) if live[p]]
    d = 0
    if n > cap and msd:
        d = 1
        while d < min(MAX_PARTITION, len(msd)) \
                and n > (cap / 4) * RADIX ** d:
            d += 1
    part = sorted(msd[:d])
    rest = [p for p in range(len(live)) if live[p] and p not in part]
    return part, rest + part[:1]


def lex_plan(live, n: int):
    """lex_order's plan on the card.  live: for each digit of
    digit_plan(nl), whether it takes two values or more in the rows; n
    rows.  Returns (part, rest), indices into digit_plan(nl), least
    significant first:
      - part, the partition digits: the most significant live digits, as
        many as bring the mean bucket n / 256^d to LEX_MEAN rows or fewer,
        at most MAX_PARTITION (none when n <= LEX_MEAN: one bucket, which a
        warp ranks).  Every row is kept, so the buckets are small: tens of
        rows, each ranked by a warp (61 at the level-0 build's 4 M
        fingerprints);
      - rest, the digits of a bucket's LSD passes in a block: every live
        digit below the partition (a bucket's rows share the others)."""
    msd = [p for p in range(len(live) - 1, -1, -1) if live[p]]
    d = 0
    while d < min(MAX_PARTITION, len(msd)) and n > LEX_MEAN * RADIX ** d:
        d += 1
    part = sorted(msd[:d])
    return part, [p for p in range(len(live)) if live[p] and p not in part]


def bucket_groups(starts, cap: int) -> np.ndarray:
    """The bucket kernel's groups, as csrc/kmer_sort.cu:groups_kernel
    forms them on the card: starts (256^d + 1,) the first row of each
    bucket of the partitioned rows (ascending, starts[-1] = n).  Returns
    the groups' first rows and n, (G + 1,) int64 (a group may be empty).
    With T = cap // 2, a bucket of more than T rows is a group alone (over
    cap rows: the LSD route); smaller ones group while their first rows
    fall in one T-row window and one 256-bucket block of the prefix, so a
    group holds at most 2 T <= cap rows and its buckets differ only in the
    partition's least significant digit."""
    starts = np.asarray(starts, dtype=np.int64)
    t = max(cap // 2, 1)
    size = np.diff(starts)
    big = size > t
    win = starts[:-1] // t
    cut = np.empty(len(size), dtype=bool)
    cut[1:] = big[1:] | big[:-1] | (win[1:] != win[:-1])
    cut[::RADIX] = True
    return np.append(starts[:-1][cut], starts[-1])


# ---------------------------------------------------------------------------
# plain versions (tensor code, any device; the CPU path)
# ---------------------------------------------------------------------------

def as_limbs(x: torch.Tensor) -> torch.Tensor:
    """Rows of int64 limbs, or int32 bit patterns of limbs (a card's
    extract_keys), as int64 values in [0, 2^32)."""
    return x.long() & lb.M32 if x.dtype == torch.int32 else x


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits (the
    card's row format)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def plain_extract_keys(bases: torch.Tensor, lengths: torch.Tensor,
                       k1: int) -> torch.Tensor:
    """(n_valid, nl) int64 limbs of the valid canonical k1-mer windows, in
    ascending (read, window) order."""
    canon, _, valid = km.extract_canonical_kmers(bases, lengths, k1)
    return canon[valid]


def plain_lex_order(keys: torch.Tensor) -> torch.Tensor:
    """ops/limbs.py:plain_lex_order on int64 limbs (int32 bit patterns
    taken as unsigned)."""
    return lb.plain_lex_order(as_limbs(keys))


def plain_sort_count(keys: torch.Tensor):
    """(uniq (n, nl) int64 ascending, counts (n,) int32)."""
    keys = as_limbs(keys)
    s = keys[plain_lex_order(keys)]
    tracing.host_sync()
    starts = torch.nonzero(lb.run_starts(s)).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([s.shape[0]])])
    return s[starts], (ends - starts).to(torch.int32)


def plain_merge_runs(ka, ca, kb, cb):
    """Concat + re-sort; equal keys get the sum of their counts."""
    keys = torch.cat([as_limbs(ka), as_limbs(kb)])
    w = torch.cat([ca, cb])
    perm = plain_lex_order(keys)
    s, sw = keys[perm], w[perm]
    new = lb.run_starts(s)
    seg = torch.cumsum(new, 0) - 1
    uniq = s[new]
    counts = torch.zeros(uniq.shape[0], dtype=torch.int32, device=s.device)
    counts.index_add_(0, seg, sw.to(torch.int32))
    return uniq, counts


# ---------------------------------------------------------------------------
# the entries: plain on the CPU, the kernels on a card
# ---------------------------------------------------------------------------

def _check_rows(what: str, x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in (torch.int32, torch.int64) \
            or not 1 <= x.shape[1] <= MAX_NL:
        raise ValueError(f"kmer_sort: {what} must be (n, nl) int32 or int64 "
                         f"limbs with nl <= {MAX_NL}, got {x.dim()}-D "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"kmer_sort: {x.shape[0]} rows, more than "
                         f"{MAX_ROWS}")
    return x.contiguous()


def extract_keys(bases: torch.Tensor, lengths: torch.Tensor,
                 k1: int) -> torch.Tensor:
    """The canonical k1-mer rows of every valid window of a read record:
    bases (B, L) uint8 codes (>= 4 invalid or padding), lengths (B,)
    int32; rows in ascending (read, window) order, (n, nl) int64 limbs on
    the CPU, their int32 bit patterns on a card."""
    if bases.device.type == "cpu":
        return plain_extract_keys(bases, lengths, k1)
    nl = lb.n_limbs(k1)
    if bases.dtype != torch.uint8 or bases.dim() != 2 \
            or lengths.shape != bases.shape[:1] \
            or not 1 <= k1 <= 16 * MAX_NL:
        raise ValueError(f"kmer_sort: bases (B, L) uint8, lengths (B,) and "
                         f"1 <= k1 <= {16 * MAX_NL}, got {bases.dtype} "
                         f"{tuple(bases.shape)}, {tuple(lengths.shape)}, "
                         f"k1={k1}")
    dev = bases.device
    B, L = bases.shape
    if B == 0 or L < k1:
        return torch.empty((0, nl), dtype=torch.int32, device=dev)
    bases = bases.contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B * (L - k1 + 1), nl), dtype=torch.int32, device=dev)
    # the blocks' look-back status words and the block ticket
    scratch = torch.empty(B + 1, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    LIB.launch("ks_extract_launch", dev, bases.data_ptr(), lengths.data_ptr(),
               B, L, k1, scratch.data_ptr(), total.data_ptr(), out.data_ptr())
    COUNT.add("extract_keys", B, L, k1)
    tracing.host_sync()
    return out[:int(total.item())]


def _load(rows: Tuple[torch.Tensor, ...], plan, pay_mode: int,
          pays: Tuple[torch.Tensor, ...] = (), soa=None, counts=True):
    """Load rows on the card as SoA uint32 limbs: one or two (n_i, nl)
    segments of one dtype, or soa = (keys (nl, N) int32 SoA, r0, n): its
    rows r0 .. r0 + n.  pay_mode 0: no payload, 1: pays (int32, split as
    the rows), 2: the row index.  Returns (keys (2, nl, n) int32, the rows
    in keys[0]; pay (2, n) int32 or None; the histogram of every digit of
    the plan, or None without counts; for each digit of the plan, whether
    it takes two values or more).  Raises when an int64 limb lies outside
    [0, 2^32)."""
    if soa is not None:
        src, r0, n = soa
        a = b = src[:, r0:]
        dev, nl, na, stride = src.device, src.shape[0], n, src.shape[1]
    else:
        a = rows[0]
        b = rows[1] if len(rows) > 1 else rows[0]
        dev, nl, na, stride = a.device, a.shape[1], a.shape[0], 0
        n = na + (rows[1].shape[0] if len(rows) > 1 else 0)
    keys = torch.empty((2, nl, n), dtype=torch.int32, device=dev)
    pay = torch.empty((2, n), dtype=torch.int32, device=dev) \
        if pay_mode else None
    # the digit counts of every pass (with counts), a flag (an int64 limb
    # had high bits), each limb's OR of row ^ row 0
    npass = len(plan) if counts else 0
    hist = torch.empty(npass * RADIX + 1 + nl, dtype=torch.int32, device=dev)
    pa = pays[0] if pays else None
    pb = pays[1] if len(pays) > 1 else pa
    LIB.launch("ks_load_launch", dev, a.data_ptr(), b.data_ptr(), na, n, nl,
               int(a.dtype == torch.int64), stride,
               pa.data_ptr() if pa is not None else None,
               pb.data_ptr() if pb is not None else None, pay_mode,
               _ints([v for step in plan for v in step]), npass,
               keys[0].data_ptr(),
               pay[0].data_ptr() if pay is not None else None, hist.data_ptr())
    tracing.host_sync()
    wide, *diff = hist[npass * RADIX:].tolist()
    if wide:
        raise ValueError("kmer_sort: int64 limbs must lie in [0, 2^32)")
    return keys, pay, (hist if counts else None), _live(diff, plan)


def _live(diff, plan) -> List[bool]:
    """For each digit of the plan, whether it takes two values or more in
    rows whose limbs' OR of row ^ the first row is diff (host ints)."""
    return [(diff[limb] >> shift) & ((1 << width) - 1) != 0
            for limb, shift, width in plan]


def _passes(keys: torch.Tensor, pay, plan, run, hist):
    """The LSD passes of the plan whose run flag is set, on _load's
    buffers (hist None: each pass totals its digits from its tile counts):
    the sorted SoA keys (nl, n) int32 and the payload (n,) or None."""
    nl, n = keys.shape[1:]
    dev = keys.device
    scratch = torch.empty(LIB.query("ks_sort_scratch_words", n),
                          dtype=torch.int32, device=dev)
    LIB.launch("ks_sort_passes_launch", dev, keys[0].data_ptr(),
               keys[1].data_ptr(),
               pay[0].data_ptr() if pay is not None else None,
               pay[1].data_ptr() if pay is not None else None, n, nl,
               _ints([v for step in plan for v in step]),
               _ints([int(r) for r in run]), len(plan),
               hist.data_ptr() if hist is not None else None,
               scratch.data_ptr())
    out = sum(map(bool, run)) % 2
    return keys[out], (pay[out] if pay is not None else None)


def _radix(rows: Tuple[torch.Tensor, ...], plan, pay_mode: int,
           pays: Tuple[torch.Tensor, ...] = (), soa=None):
    """Load rows (as _load takes them) and sort them by the plan's passes
    on the card, a pass whose digit takes one value skipped.  Returns the
    sorted SoA keys (nl, n) int32 and the payload (n,) int32 or None."""
    keys, pay, hist, live = _load(rows, plan, pay_mode, pays, soa)
    return _passes(keys, pay, plan, live, hist)


def _runs(keys: torch.Tensor, pay: torch.Tensor | None):
    """Run-length pass over sorted SoA keys (nl, n): (uniq (n_u, nl) int64,
    counts (n_u,) int32), a count the rows of a run or their payload's
    sum."""
    return _run_table(keys, pay)[:2]


def _run_table(keys: torch.Tensor, pay: torch.Tensor | None):
    """_runs' (uniq, counts) and the payload's exclusive prefix at each
    run, (n_u,) int64: without a payload, each run's first row."""
    dev = keys.device
    nl, n = keys.shape
    n_tiles = -(-n // TILE)
    tiles = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    pay_p = pay.data_ptr() if pay is not None else None
    LIB.launch("ks_runs_count_launch", dev, keys.data_ptr(), pay_p, n, nl,
               tiles.data_ptr(), totals.data_ptr())
    tracing.host_sync()
    n_u = int(totals[0].item())
    uniq = torch.empty((n_u, nl), dtype=torch.int64, device=dev)
    counts = torch.empty(n_u, dtype=torch.int32, device=dev)
    starts = torch.empty(n_u, dtype=torch.int64, device=dev)
    LIB.launch("ks_runs_write_launch", dev, keys.data_ptr(), pay_p, n, nl,
               tiles.data_ptr(), totals.data_ptr(), n_u, uniq.data_ptr(),
               counts.data_ptr(), starts.data_ptr())
    return uniq, counts, starts


def _bounds(src: torch.Tensor, plan, part) -> torch.Tensor:
    """The first row of each bucket of SoA keys (nl, n) grouped by the
    partition digits part (ascending prefix): (256^d + 1,) int32."""
    nl, n = src.shape
    starts = torch.empty(RADIX ** len(part) + 1, dtype=torch.int32,
                         device=src.device)
    LIB.launch("ks_bounds_launch", src.device, src.data_ptr(), n, nl,
               _ints([v for p in reversed(part) for v in plan[p][:2]]),
               len(part), starts.data_ptr())
    return starts


def _over_capacity(src: torch.Tensor, part, plan, info: torch.Tensor,
                   run_keys: torch.Tensor, run_counts: torch.Tensor,
                   gruns: torch.Tensor, rows: int) -> None:
    """sort_count's route for the groups over the bucket kernel's
    capacity, all of them at once: the same launches and host syncs for
    one group or ten thousand.  src (nl, n) the partitioned SoA rows;
    info as ks_groups_launch fills it (the groups over capacity, in group
    order, and their rows' total, rows, which the host has read).  Their
    rows are gathered into one segment, in group order, with each limb's
    XOR against the first row (a sync: the live digits), sorted by the
    LSD passes on every live digit (the partition's too, so each group's
    rows stay where the gather put them) and run-length counted (a sync);
    each run goes to its group's first row plus its rank among the
    group's runs, in run_keys and run_counts, and each group's run count
    to gruns, as the bucket kernel writes a group's.  No partition digit:
    the one group is every row, all equal, and the run pass reads src."""
    dev = src.device
    nl, n = src.shape
    if part:
        seg = torch.empty((2, nl, rows), dtype=torch.int32, device=dev)
        diff = torch.empty(nl, dtype=torch.int32, device=dev)
        LIB.launch("ks_gather_launch", dev, src.data_ptr(), n, nl,
                   info.data_ptr(), rows, seg[0].data_ptr(), diff.data_ptr())
        tracing.host_sync()
        keys = _passes(seg, None, plan, _live(diff.tolist(), plan), None)[0]
    else:
        keys = src
    uniq, counts, starts = _run_table(keys, None)
    LIB.launch("ks_place_runs_launch", dev, uniq.data_ptr(), counts.data_ptr(),
               starts.data_ptr(), uniq.shape[0], nl, info.data_ptr(),
               run_keys.data_ptr(), n, run_counts.data_ptr(), gruns.data_ptr())


def sort_count(keys: torch.Tensor):
    """Sort limb rows (n, nl) (int64 limbs, or their int32 bit patterns on
    a card) and run-length count them: (uniq (n_u, nl) int64 ascending,
    counts (n_u,) int32).  On a card: load, partition (sort_plan),
    bucket bounds and groups (bucket_groups), the bucket kernel, one
    batched route for every bucket over capacity (_over_capacity),
    compaction; two host syncs (the live digits, the unique rows), and
    three more when buckets go over capacity, however many."""
    if keys.device.type == "cpu":
        return plain_sort_count(keys)
    keys = _check_rows("keys", keys)
    n, nl = keys.shape
    dev = keys.device
    if n == 0:
        return (torch.empty((0, nl), dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    cap = BUCKET_CAPACITY[nl]
    _check_built(f"bucket capacity at nl={nl}", "ks_bucket_capacity", cap, nl)
    plan = digit_plan(nl)
    buf, _, _, live = _load((keys,), plan, 0, counts=False)
    part, rest = sort_plan(live, n, cap)
    src, run_keys = buf[len(part) % 2], buf[1 - len(part) % 2]
    nb, starts = 1, None                 # no partition: one bucket
    if part:
        _passes(buf, None, plan, [p in part for p in range(len(plan))], None)
        nb = RADIX ** len(part)
        starts = _bounds(src, plan, part)
    # the groups (bucket_groups), formed on the card: info = [G, groups
    # over capacity, unique rows, the rows of the groups over capacity,
    # (g, r0, r1, offset in their gathered segment) of each, in order]
    gstart = torch.empty(nb + 1, dtype=torch.int32, device=dev)
    info = torch.empty(4 + 4 * nb, dtype=torch.int64, device=dev)
    LIB.launch("ks_groups_launch", dev,
               starts.data_ptr() if starts is not None else None, nb, n, cap,
               gstart.data_ptr(), info.data_ptr())
    run_counts = torch.empty(n, dtype=torch.int32, device=dev)
    gruns = torch.empty(nb, dtype=torch.int64, device=dev)
    goff = torch.empty(nb, dtype=torch.int64, device=dev)
    LIB.launch("ks_bucket_launch", dev, src.data_ptr(), n, nl,
               gstart.data_ptr(), info.data_ptr(), cap,
               _ints([v for p in rest for v in plan[p]]), len(rest),
               int(bool(part)), run_keys.data_ptr(), run_counts.data_ptr(),
               gruns.data_ptr())
    LIB.launch("ks_compact_count_launch", dev, gruns.data_ptr(),
               info.data_ptr(), goff.data_ptr())
    tracing.host_sync()
    G, n_over, n_u, rows = info[:4].tolist()
    if n_over:
        # the span closes after the unique rows' sync, which follows the
        # route's last launch: its wall covers the route's device work
        with tracing.span("count.sort.lsd", buckets=n_over, rows=rows):
            _over_capacity(src, part, plan, info, run_keys, run_counts,
                           gruns, rows)
            LIB.launch("ks_compact_count_launch", dev, gruns.data_ptr(),
                       info.data_ptr(), goff.data_ptr())
            tracing.host_sync()
            n_u = int(info[2].item())
    uniq = torch.empty((n_u, nl), dtype=torch.int64, device=dev)
    counts = torch.empty(n_u, dtype=torch.int32, device=dev)
    LIB.launch("ks_compact_write_launch", dev, run_keys.data_ptr(),
               run_counts.data_ptr(), n, nl, gstart.data_ptr(),
               goff.data_ptr(), info.data_ptr(), uniq.data_ptr(),
               counts.data_ptr())
    COUNT.add("sort_count", n, nl)
    COUNT.route("sort_count", partition_passes=len(part),
                bucket_groups=G - n_over, over_capacity=n_over)
    return uniq, counts


def merge_runs(ka, ca, kb, cb):
    """Merge two (keys (n_i, nl), counts (n_i,) int32) runs: every key
    once, ascending, with the sum of its counts in both (any number of
    equal rows).  On a card: the merge path when both inputs are ascending
    (non-decreasing; sort_count's and merge_runs' tables are), which the
    count step checks as it merges (one host sync: the runs and the
    order flag); else the LSD route."""
    if ka.device.type == "cpu":
        return plain_merge_runs(ka, ca, kb, cb)
    ka, kb = _check_rows("ka", ka), _check_rows("kb", kb)
    na, nb, nl = ka.shape[0], kb.shape[0], ka.shape[1]
    if kb.shape[1] != nl or kb.dtype != ka.dtype or ca.shape != (na,) \
            or cb.shape != (nb,) or ca.dtype != torch.int32 \
            or cb.dtype != torch.int32:
        raise ValueError("kmer_sort: merge_runs takes (ka (A, nl), ca (A,) "
                         "int32, kb (B, nl) of ka's dtype, cb (B,) int32)")
    if na + nb > MAX_ROWS:
        raise ValueError(f"kmer_sort: {na + nb} rows, more than {MAX_ROWS}")
    dev = ka.device
    if na + nb == 0:
        return (torch.empty((0, nl), dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    ca, cb = ca.contiguous(), cb.contiguous()
    _check_built("merge tile", "ks_merge_tile", MERGE_TILE)
    n_tiles = -(-(na + nb) // MERGE_TILE)
    splits = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    tiles = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    meta = torch.empty(3, dtype=torch.int64, device=dev)
    args = (ka.data_ptr(), kb.data_ptr(), na, nb, nl,
            int(ka.dtype == torch.int64), ca.data_ptr(), cb.data_ptr(),
            splits.data_ptr(), tiles.data_ptr(), meta.data_ptr())
    LIB.launch("ks_merge_count_launch", dev, *args)
    tracing.host_sync()
    n_u, _, flags = meta.tolist()
    if flags & MERGE_WIDE:
        raise ValueError("kmer_sort: int64 limbs must lie in [0, 2^32)")
    if flags & MERGE_DESCENT:            # an input out of order
        out = _runs(*_radix((ka, kb), digit_plan(nl), 1, (ca, cb)))
        route = "lsd"
    else:
        out = (torch.empty((n_u, nl), dtype=torch.int64, device=dev),
               torch.empty(n_u, dtype=torch.int32, device=dev))
        S = torch.empty(n_u, dtype=torch.int64, device=dev)
        LIB.launch("ks_merge_write_launch", dev, *args, n_u, out[0].data_ptr(),
                   out[1].data_ptr(), S.data_ptr())
        route = "merge_path"
    COUNT.add("merge_runs", na, nb, nl)
    COUNT.route("merge_runs", **{route: 1})
    return out


def lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) sorting rows (n, nl) of limbs lexicographically,
    limb 0 first, all 32 bits of every limb; rows with equal keys keep
    their input order.  On a card: the load with the row index (a host
    sync for the live digits), the partition passes of lex_plan, the
    buckets' bounds, a warp or a block a bucket (a host sync for the
    routes and the buckets over capacity), the LSD route for each of
    those."""
    if keys.device.type == "cpu":
        return plain_lex_order(keys)
    keys = _check_rows("keys", keys)
    n, nl = keys.shape
    dev = keys.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    cap = LEX_CAPACITY[nl]
    _check_built(f"lex capacity at nl={nl}", "ks_lex_capacity", cap, nl)
    plan = digit_plan(nl)
    buf, pay, _, live = _load((keys,), plan, 2, counts=False)
    part, rest = lex_plan(live, n)
    routes = dict.fromkeys(ROUTES["lex_order"], 0)
    if not any(live):                    # every row equal: input order
        out = pay[0].long()
    else:
        if part:
            _passes(buf, pay, plan, [p in part for p in range(len(plan))],
                    None)
        src, psrc = buf[len(part) % 2], pay[len(part) % 2]
        starts = _bounds(src, plan, part) if part else None
        nb = RADIX ** len(part)
        out = torch.empty(n, dtype=torch.int64, device=dev)
        info = torch.empty(3, dtype=torch.int64, device=dev)
        lists = torch.empty((2, nb, 2), dtype=torch.int64, device=dev)
        LIB.launch("ks_lex_buckets_launch", dev, src.data_ptr(), n, nl,
                   psrc.data_ptr(),
                   starts.data_ptr() if starts is not None else None, nb, cap,
                   _ints([v for p in rest for v in plan[p]]), len(rest),
                   out.data_ptr(), info.data_ptr(), lists[0].data_ptr(),
                   lists[1].data_ptr())
        tracing.host_sync()
        n_big, n_over, n_warp = info.tolist()
        if n_over:
            tracing.host_sync()
            for r0, r1 in lists[1, :n_over].tolist():
                _, p = _radix((), plan, 1, (psrc[r0:r1],),
                              soa=(src, r0, r1 - r0))
                out[r0:r1] = p
        routes.update(partition_passes=len(part), warp_buckets=n_warp,
                      block_buckets=n_big, over_capacity=n_over)
    COUNT.add("lex_order", n, nl)
    COUNT.route("lex_order", **routes)
    return out
