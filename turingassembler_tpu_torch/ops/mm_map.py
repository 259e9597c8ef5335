"""Minimizer map: the CUDA kernel csrc/mm_map.cu and its wrapper.

Replaces the jitted JAX device program of the minimizer mapper
(turingassembler_tpu/mapper/minimizers.py, XLA, not Pallas): the whole
read->edge vote of a batch, minimizer_mask + compaction to MM_CAP slots +
_cuckoo_probe + _vote_core, with the gapless bound _gapless_bound_dev
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
own layouts, which EdgeMinimizerIndex.device_tables and
minimizers._device_pool give for each device:
  - tables: the plain version's int64 hkeys (NB, 8) and vals (NB*4, 2);
    the kernel's bucket records (NB, 16) int32 (bucket_records), vals
    None;
  - pool: the plain version's nibble-packed int64 words; the kernel's
    uint8 codes (the graph's seq_data) with POOL_PAD bytes before and
    after them in their storage (padded_codes).
The plain versions are the tensor functions of mapper/minimizers.py
(minimizer_mask, _vote_core, _verified_core, _gapless_bound_dev,
_compact_minimizer_rows).  On CPU tensors the wrapper runs them; on CUDA
tensors it launches the kernel or raises.  map_batch's kernel returns
int32 where its plain versions return int64: the values are equal.
COUNT records every launch with its shape (B, L, entry, verified); the
bridge maps from its worker threads, so it takes a lock.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _build

MIN_K, MAX_K = 17, 32         # the keys are two limbs (the cuckoo tables')
MAX_W = 32                    # the windows of one sparse-table pass
POOL_PAD = 16                 # bytes of the card's pool before and after


@dataclass
class LaunchCount:
    """Kernel launches and each launch's (B, L, entry, verified) (CUDA
    path only).  Safe to add to from several threads."""
    launches: int = 0
    shapes: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def reset(self) -> None:
        with self.lock:
            self.launches = 0
            self.shapes = []

    def add(self, B: int, L: int, entry: str, verified: bool) -> None:
        with self.lock:
            self.launches += 1
            self.shapes.append((B, L, entry, verified))


COUNT = LaunchCount()

# pointers and the stream as c_void_p: an undeclared int argument would be
# passed as a 32-bit C int and cut the pointer
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "mm_map_batch_launch": [_P, _P, _LL, _I, _I, _I, _P, _LL, _LL, _I, _I,
                            _I, _P, _P, _P, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P],
    "mm_gapless_bound_launch": [_P, _P, _P, _P, _LL, _I, _P, _P, _I, _I,
                                _P, _P, _P],
    "mm_minimizer_rows_launch": [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _P,
                                 _P],
}


def bucket_records(hkeys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The kernel's table from the host cuckoo tables: one 64-byte record
    a bucket, slot t's (k0, k1, edge + 1 or 0, pos) as uint32 in words
    4t..4t+3.  hkeys (NB, 8) and vals (NB * 4, 2) as build_cuckoo_tables
    makes them; returns (NB, 16) int32 holding the uint32 bits."""
    from ..mapper.minimizers import CUCKOO_CAP as SLOTS
    nb = hkeys.shape[0]
    if hkeys.shape != (nb, 2 * SLOTS) or vals.shape != (nb * SLOTS, 2):
        raise ValueError(f"mm_map: hkeys (NB, 8) and vals (NB * 4, 2), got "
                         f"{hkeys.shape}, {vals.shape}")
    for name, a in (("hkeys", hkeys), ("vals", vals)):
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError(f"mm_map: {name} must hold uint32 values")
    rec = np.empty((nb, SLOTS, 4), np.uint32)
    rec[:, :, 0] = hkeys[:, 0::2]
    rec[:, :, 1] = hkeys[:, 1::2]
    rec[:, :, 2:] = vals.reshape(nb, SLOTS, 2)
    return rec.reshape(nb, 4 * SLOTS).view(np.int32)


def _launch(entry: str, dev: torch.device, *args) -> None:
    """Call one C entry of csrc/mm_map.cu on dev's current stream."""
    fn = getattr(_build.load("mm_map"), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")


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
    from ..mapper.minimizers import CUCKOO_CAP as SLOTS
    nb = hkeys.shape[0]
    if dev.type == "cuda":
        _check(dev, hkeys=(hkeys, torch.int32, 2))
        if vals is not None or hkeys.shape[1] != 4 * SLOTS:
            raise ValueError("mm_map: on a card the tables are the bucket "
                             "records (NB, 16) int32 and vals None")
        if hkeys.data_ptr() % 64:
            raise ValueError("mm_map: the bucket records must be 64-byte "
                             "aligned")
    else:
        _check(dev, hkeys=(hkeys, torch.int64, 2), vals=(vals, torch.int64, 2))
        if hkeys.shape[1] != 2 * SLOTS or tuple(vals.shape) != (nb * SLOTS,
                                                                  2):
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
    (B,), then (bound (B,), fast (B,) bool) when verified: _vote_core's
    and _verified_core's values, int64 from the plain versions, int32
    from the kernel.  out: tensors of those dtypes and shapes (int32 on
    a card) to write into instead, returned."""
    from ..mapper import minimizers as mz   # the plain versions
    _check_reads(bases, lengths)
    _check_k(k, w)
    dev = bases.device
    card = _on_card(bases)
    nb = _check_tables(dev, hkeys, vals)
    B, L = bases.shape
    if L - k + 1 < mz.MM_CAP:
        raise ValueError(f"mm_map: a width of {L} gives {L - k + 1} window "
                         f"positions, fewer than the {mz.MM_CAP} slots a "
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
        res = (mz._verified_core(bases, lengths, hkeys, vals, salt, seq_pk,
                                 seq_off, thr, k, w, mt, mm) if verified
               else mz._vote_core(bases, lengths, hkeys, vals, salt, k, w))
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
    _launch("mm_map_batch_launch", dev, bases.data_ptr(),
            lengths.data_ptr(), B, L, k, w, hkeys.data_ptr(), nb, int(salt),
            mz.MM_CAP, mz.BIG, int(verified), *pool, thr_ptr, thr_all, mt,
            mm, *ptrs)
    COUNT.add(B, L, "map_batch", verified)
    return tuple(out)


def gapless_bound(seq_pk, seq_off, edges, starts, bases, lengths, mt: int,
                  mm: int):
    """Score of the gapless alignment of each query at its edge and
    signed start over the on-edge positions (the JAX
    _gapless_bound_dev).  seq_pk, seq_off: the pool in the layout of the
    bases' device (module note); edges and starts (N,) int64, bases (N, L)
    uint8, lengths (N,) int32.  Returns (bound (N,) int32, feas (N,)
    bool), as the JAX function does."""
    from ..mapper import minimizers as mz
    _check_reads(bases, lengths)
    dev = bases.device
    card = _on_card(bases)
    _check_pool(dev, seq_pk, seq_off)
    _check(dev, edges=(edges, torch.int64, 1), starts=(starts, torch.int64, 1))
    N, L = bases.shape
    if edges.shape[0] != N or starts.shape[0] != N:
        raise ValueError("mm_map: edges and starts (N,) disagree with bases")
    if not card:
        bound, feas = mz._gapless_bound_dev(seq_pk, seq_off, edges, starts,
                                            bases, lengths, mt, mm)
        return bound.to(torch.int32), feas
    bound = torch.empty(N, dtype=torch.int32, device=dev)
    feas = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return bound, feas
    _launch("mm_gapless_bound_launch", dev, bases.data_ptr(),
            lengths.data_ptr(), edges.data_ptr(), starts.data_ptr(), N, L,
            seq_pk.data_ptr(), seq_off.data_ptr(), mt, mm, bound.data_ptr(),
            feas.data_ptr())
    COUNT.add(N, L, "gapless_bound", True)
    return bound, feas


def minimizer_rows(bases, lengths, k: int, w: int):
    """The minimizers of segment rows, compacted (the JAX
    _compact_minimizer_rows as the index build calls it): bases (B, L)
    uint8 codes with L >= k, lengths (B,) int32.  Returns (n, 4) int64
    rows (key limb 0, limb 1, segment row, in-segment position) of the
    marked positions, ascending by row then position."""
    from ..mapper import minimizers as mz
    _check_reads(bases, lengths)
    _check_k(k, w)
    B, L = bases.shape
    if L < k:
        raise ValueError(f"mm_map: rows of width {L} hold no {k}-mer")
    if not _on_card(bases):
        return mz._compact_minimizer_rows(bases, lengths, k, w)
    dev = bases.device
    if B == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    P = L - k + 1
    marks = torch.empty((B, -(-P // 32)), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    rows = torch.empty((B * P, 4), dtype=torch.int64, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("mm_minimizer_rows_launch", dev, bases.data_ptr(),
            lengths.data_ptr(), B, L, k, w, marks.data_ptr(),
            counts.data_ptr(), rows.data_ptr(), n.data_ptr())
    COUNT.add(B, L, "minimizer_rows", False)
    return rows[:int(n.item())]
