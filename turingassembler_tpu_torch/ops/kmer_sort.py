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
csrc/kmer_sort.cu says how: extraction by a count pass, a scan and a
write pass; a stable LSD radix sort of SoA uint32 limbs in 8-bit digits
(digit_plan), a pass skipped where its digit has one bucket (so a
k1-mer's always-0 low bits cost no pass); a run pass that writes the
unique rows and counts.

On CPU tensors each entry runs its plain version (the tensor code of
kmer/megasort.py and ops/limbs.py:plain_lex_order); on CUDA tensors it
launches the kernels or raises.  The CPU path never builds or looks for
nvcc.  Outputs: extract_keys gives (n, nl) int64 limbs on the CPU and
int32 bit patterns of the same limbs on a card (half the bytes for the
window the count gathers; sort_count and merge_runs take either);
sort_count and merge_runs give (uniq (n, nl) int64 ascending, counts (n,)
int32) on both; lex_order an int64 permutation.  int64 limbs must lie
in [0, 2^32): the card raises on any other value.  COUNT records every
launch with its shape; each entry syncs with the host once or twice (the
rows or runs it made, the histogram that decides the passes).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from .. import _build
from . import kmers as km
from . import limbs as lb

RADIX_BITS = 8            # a pass's digit (csrc/kmer_sort.cu says why)
RADIX = 1 << RADIX_BITS
MAX_NL = 4                # the kernels' widest row (k1 <= 64)
MAX_ROWS = (1 << 31) - 1  # rows a sort takes (32-bit digit offsets)
TILE = 4096               # keys a block of the sort and run passes
ENTRIES = ("extract_keys", "sort_count", "merge_runs", "lex_order")


@dataclass
class LaunchCount:
    """Launches of each entry and each launch's shape (CUDA path only):
    ("extract_keys", B, L, k1), ("sort_count", n, nl),
    ("merge_runs", na, nb, nl), ("lex_order", n, nl).  Safe to add to
    from several threads."""
    by_entry: dict = field(default_factory=lambda: dict.fromkeys(ENTRIES, 0))
    shapes: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    @property
    def launches(self) -> int:
        return sum(self.by_entry.values())

    def reset(self) -> None:
        with self.lock:
            self.by_entry = dict.fromkeys(ENTRIES, 0)
            self.shapes = []

    def add(self, entry: str, *shape: int) -> None:
        with self.lock:
            self.by_entry[entry] += 1
            self.shapes.append((entry, *shape))


COUNT = LaunchCount()

# pointers and the stream as c_void_p: an undeclared int argument would be
# passed as a 32-bit C int and cut the pointer
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "ks_extract_launch": [_P, _P, _LL, _I, _I, _P, _P, _P],
    "ks_load_launch": [_P, _P, _LL, _LL, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                       _P],
    "ks_sort_passes_launch": [_P, _P, _P, _P, _LL, _I, _P, _P, _I, _P, _P],
    "ks_runs_count_launch": [_P, _P, _LL, _I, _P, _P],
    "ks_runs_write_launch": [_P, _P, _LL, _I, _P, _P, _LL, _P, _P, _P],
}


def _fn(entry: str):
    fn = getattr(_build.load("kmer_sort"), entry)
    fn.argtypes = _ARGTYPES[entry] + [_P]      # ... then the stream
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, dev: torch.device, *args) -> None:
    """Call one C entry of csrc/kmer_sort.cu on dev's current stream."""
    fn = _fn(entry)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")


def _scratch_words(n: int) -> int:
    fn = _build.load("kmer_sort").ks_sort_scratch_words
    fn.argtypes, fn.restype = [_LL], _LL
    return fn(n)


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


# ---------------------------------------------------------------------------
# plain versions (tensor code, any device; the CPU path)
# ---------------------------------------------------------------------------

def as_limbs(x: torch.Tensor) -> torch.Tensor:
    """Rows of int64 limbs, or int32 bit patterns of limbs (a card's
    extract_keys), as int64 values in [0, 2^32)."""
    return x.long() & lb.M32 if x.dtype == torch.int32 else x


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
    block_rows = torch.empty(B + 1, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _launch("ks_extract_launch", dev, bases.data_ptr(), lengths.data_ptr(),
            B, L, k1, block_rows.data_ptr(), total.data_ptr(),
            out.data_ptr())
    COUNT.add("extract_keys", B, L, k1)
    return out[:int(total.item())]


def _radix(rows: Tuple[torch.Tensor, ...], plan, pay_mode: int,
           pays: Tuple[torch.Tensor, ...] = ()):
    """Load rows (one or two (n_i, nl) segments of one dtype) and sort them
    by the plan's passes on the card.  pay_mode 0: no payload, 1: pays
    (int32, split as the rows), 2: the row index.  Returns the sorted SoA
    keys (nl, n) int32 and the payload (n,) int32 or None.  Raises when
    an int64 limb lies outside [0, 2^32)."""
    a = rows[0]
    b = rows[1] if len(rows) > 1 else rows[0]
    dev, nl = a.device, a.shape[1]
    na = a.shape[0]
    n = na + (rows[1].shape[0] if len(rows) > 1 else 0)
    keys = torch.empty((2, nl, n), dtype=torch.int32, device=dev)
    pay = torch.empty((2, n), dtype=torch.int32, device=dev) \
        if pay_mode else None
    # the digit counts of every pass, then a flag: an int64 limb had high
    # bits
    hist = torch.empty(len(plan) * RADIX + 1, dtype=torch.int32, device=dev)
    flat = _ints([v for step in plan for v in step])
    pa = pays[0] if pays else None
    pb = pays[1] if len(pays) > 1 else pa
    _launch("ks_load_launch", dev, a.data_ptr(), b.data_ptr(), na, n, nl,
            int(a.dtype == torch.int64),
            pa.data_ptr() if pa is not None else None,
            pb.data_ptr() if pb is not None else None, pay_mode, flat,
            len(plan), keys[0].data_ptr(),
            pay[0].data_ptr() if pay is not None else None, hist.data_ptr())
    # a pass runs when its digit takes two buckets or more
    *run, wide = torch.cat([(hist[:-1].view(len(plan), RADIX) != 0)
                            .sum(dim=1) > 1, hist[-1:] != 0]).tolist()
    if wide:
        raise ValueError("kmer_sort: int64 limbs must lie in [0, 2^32)")
    scratch = torch.empty(_scratch_words(n), dtype=torch.int32, device=dev)
    _launch("ks_sort_passes_launch", dev, keys[0].data_ptr(),
            keys[1].data_ptr(),
            pay[0].data_ptr() if pay is not None else None,
            pay[1].data_ptr() if pay is not None else None, n, nl, flat,
            _ints([int(r) for r in run]), len(plan), hist.data_ptr(),
            scratch.data_ptr())
    out = sum(run) % 2
    return keys[out], (pay[out] if pay is not None else None)


def _runs(keys: torch.Tensor, pay: torch.Tensor | None):
    """Run-length pass over sorted SoA keys (nl, n): (uniq (n_u, nl) int64,
    counts (n_u,) int32), a count the rows of a run or their payload's
    sum."""
    dev = keys.device
    nl, n = keys.shape
    n_tiles = -(-n // TILE)
    tiles = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    pay_p = pay.data_ptr() if pay is not None else None
    _launch("ks_runs_count_launch", dev, keys.data_ptr(), pay_p, n, nl,
            tiles.data_ptr(), totals.data_ptr())
    n_u = int(totals[0].item())
    uniq = torch.empty((n_u, nl), dtype=torch.int64, device=dev)
    counts = torch.empty(n_u, dtype=torch.int32, device=dev)
    starts = torch.empty(n_u, dtype=torch.int64, device=dev)
    _launch("ks_runs_write_launch", dev, keys.data_ptr(), pay_p, n, nl,
            tiles.data_ptr(), totals.data_ptr(), n_u, uniq.data_ptr(),
            counts.data_ptr(), starts.data_ptr())
    return uniq, counts


def sort_count(keys: torch.Tensor):
    """Sort limb rows (n, nl) (int64 limbs, or their int32 bit patterns on
    a card) and run-length count them: (uniq (n_u, nl) int64 ascending,
    counts (n_u,) int32)."""
    if keys.device.type == "cpu":
        return plain_sort_count(keys)
    keys = _check_rows("keys", keys)
    n, nl = keys.shape
    if n == 0:
        return (torch.empty((0, nl), dtype=torch.int64, device=keys.device),
                torch.empty(0, dtype=torch.int32, device=keys.device))
    s, _ = _radix((keys,), digit_plan(nl), 0)
    out = _runs(s, None)
    COUNT.add("sort_count", n, nl)
    return out


def merge_runs(ka, ca, kb, cb):
    """Merge two (keys (n_i, nl), counts (n_i,) int32) runs: every key
    once, ascending, with the sum of its counts in both (any number of
    equal rows)."""
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
    if na + nb == 0:
        return (torch.empty((0, nl), dtype=torch.int64, device=ka.device),
                torch.empty(0, dtype=torch.int32, device=ka.device))
    s, w = _radix((ka, kb), digit_plan(nl), 1,
                  (ca.contiguous(), cb.contiguous()))
    out = _runs(s, w)
    COUNT.add("merge_runs", na, nb, nl)
    return out


def lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) sorting rows (n, nl) of limbs lexicographically,
    limb 0 first, all 32 bits of every limb; rows with equal keys keep
    their input order."""
    if keys.device.type == "cpu":
        return plain_lex_order(keys)
    keys = _check_rows("keys", keys)
    n, nl = keys.shape
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=keys.device)
    _, perm = _radix((keys,), digit_plan(nl), 2)
    COUNT.add("lex_order", n, nl)
    return perm.long()
