"""Minimizer map: the CUDA kernel csrc/mm_map.cu and its wrapper.

Replaces the jitted JAX device program of the minimizer mapper
(turingassembler_tpu/mapper/minimizers.py, XLA, not Pallas): the whole
read->edge vote of a batch, minimizer_mask + compaction to MM_CAP slots +
_cuckoo_probe + _vote_core, with the gapless bound _gapless_bound_dev
when verified (`_map_batch_verified`, `_map_batch`); the gapless bound
alone (the bridge's rescore_hits); and minimizer_mask of the index
build's segment rows (`_compact_minimizer_rows`).  Three entries of one
source, one launch a call:
  - map_batch: a warp a read; returns the plain version's (best_edge,
    best_hits, est_start[, bound, fast]), int64 and bool;
  - gapless_bound: a warp a query; (bound, feas);
  - minimizer_rows: a block a segment row; (key limbs (B, P, 2) int64,
    is_mm (B, P) bool).
csrc/mm_map.cu says how each computes the plain version's integers
without its row sorts.

The plain versions are the tensor functions of mapper/minimizers.py
(minimizer_mask, _vote_core, _verified_core, _gapless_bound_dev).  On CPU
tensors the wrapper runs them; on CUDA tensors it launches the kernel or
raises.  COUNT records every launch with its shape (B, L, entry,
verified); the bridge maps from its worker threads, so it takes a lock.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field

import torch

from .. import _build

MIN_K, MAX_K = 17, 32         # the keys are two limbs (the cuckoo tables')


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
    "mm_map_batch_launch": [_P, _P, _LL, _I, _I, _I, _P, _LL, _P, _LL, _I,
                            _LL, _I, _P, _LL, _P, _LL, _P, _I, _I,
                            _P, _P, _P, _P, _P, _P],
    "mm_gapless_bound_launch": [_P, _P, _P, _P, _LL, _I, _P, _LL, _P, _LL,
                                _I, _I, _P, _P, _P],
    "mm_minimizer_rows_launch": [_P, _P, _LL, _I, _I, _I, _P, _P, _P],
}


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
    if not MIN_K <= k <= MAX_K or w < 1:
        raise ValueError(f"mm_map: k={k}, w={w}: the kernel takes "
                         f"{MIN_K} <= k <= {MAX_K} and w >= 1")


def _check_pool(dev, seq_pk, seq_off) -> None:
    _check(dev, seq_pk=(seq_pk, torch.int64, 1),
           seq_off=(seq_off, torch.int64, 1))
    if seq_off.shape[0] < 2 or seq_pk.shape[0] < 1:
        raise ValueError("mm_map: the pool needs a word and an edge")


def _on_card(bases: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises for any other device."""
    if bases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mm_map: unsupported device {bases.device}")
    return bases.device.type == "cuda"


def map_batch(bases, lengths, hkeys, vals, salt: int, k: int, w: int,
              seq_pk=None, seq_off=None, thr=None, mt: int = 0,
              mm: int = 0):
    """The vote of a batch of reads, and with a pool (seq_pk, seq_off) the
    gapless bound at the voted offset too (the JAX _map_batch_verified;
    _map_batch without it).

    bases (B, L) uint8 codes, lengths (B,) int32; hkeys (NB, 8) and vals
    (NB * 4, 2) int64 cuckoo tables of `salt` (NB a power of two); the
    verified form takes the nibble-packed pool seq_pk and seq_off (int64),
    thresholds thr (B,) int64 and the match / mismatch scores mt, mm.
    L - k + 1 must be at least MM_CAP (the plain version's compaction).
    Returns (best_edge, best_hits, est_start) (B,) int64, then (bound
    (B,) int64, fast (B,) bool) when verified: _vote_core's and
    _verified_core's outputs."""
    from ..mapper import minimizers as mz   # the plain versions
    _check_reads(bases, lengths)
    _check_k(k, w)
    dev = bases.device
    _check(dev, hkeys=(hkeys, torch.int64, 2), vals=(vals, torch.int64, 2))
    nb = hkeys.shape[0]
    if nb < 1 or nb & (nb - 1) or hkeys.shape[1] != 2 * mz.CUCKOO_CAP \
            or tuple(vals.shape) != (nb * mz.CUCKOO_CAP, 2):
        raise ValueError("mm_map: hkeys (NB, 8) with NB a power of two and "
                         f"vals (NB * 4, 2), got {tuple(hkeys.shape)}, "
                         f"{tuple(vals.shape)}")
    B, L = bases.shape
    if L - k + 1 < mz.MM_CAP:
        raise ValueError(f"mm_map: a width of {L} gives {L - k + 1} window "
                         f"positions, fewer than the {mz.MM_CAP} slots a "
                         "read")
    verified = seq_pk is not None
    if verified:
        _check_pool(dev, seq_pk, seq_off)
        _check(dev, thr=(thr, torch.int64, 1))
        if thr.shape[0] != B:
            raise ValueError("mm_map: thr (B,) disagrees with bases")
    if not _on_card(bases):
        if verified:
            return mz._verified_core(bases, lengths, hkeys, vals, salt,
                                     seq_pk, seq_off, thr, k, w, mt, mm)
        return mz._vote_core(bases, lengths, hkeys, vals, salt, k, w)
    if hkeys.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("mm_map: hkeys and vals must be 16-byte aligned")
    outs = [torch.empty(B, dtype=torch.int64, device=dev) for _ in range(3)]
    if verified:
        outs += [torch.empty(B, dtype=torch.int64, device=dev),
                 torch.empty(B, dtype=torch.bool, device=dev)]
    if B == 0:
        return tuple(outs)
    pool = (seq_pk.data_ptr(), seq_pk.shape[0], seq_off.data_ptr(),
            8 * mz.POOL_PAD_W, thr.data_ptr()) if verified \
        else (None, 0, None, 0, None)
    ptrs = [o.data_ptr() for o in outs] + [None] * (5 - len(outs))
    _launch("mm_map_batch_launch", dev, bases.data_ptr(),
            lengths.data_ptr(), B, L, k, w, hkeys.data_ptr(), nb,
            vals.data_ptr(), int(salt), mz.MM_CAP, mz.BIG, int(verified),
            *pool, mt, mm, *ptrs)
    COUNT.add(B, L, "map_batch", verified)
    return tuple(outs)


def gapless_bound(seq_pk, seq_off, edges, starts, bases, lengths, mt: int,
                  mm: int):
    """Score of the gapless alignment of each query at its edge and
    signed start over the on-edge positions (the JAX
    _gapless_bound_dev).  seq_pk, seq_off int64 (the nibble-packed pool),
    edges and starts (N,) int64, bases (N, L) uint8, lengths (N,) int32.
    Returns (bound (N,) int64, feas (N,) bool)."""
    from ..mapper import minimizers as mz
    _check_reads(bases, lengths)
    dev = bases.device
    _check_pool(dev, seq_pk, seq_off)
    _check(dev, edges=(edges, torch.int64, 1), starts=(starts, torch.int64, 1))
    N, L = bases.shape
    if edges.shape[0] != N or starts.shape[0] != N:
        raise ValueError("mm_map: edges and starts (N,) disagree with bases")
    if not _on_card(bases):
        return mz._gapless_bound_dev(seq_pk, seq_off, edges, starts, bases,
                                     lengths, mt, mm)
    bound = torch.empty(N, dtype=torch.int64, device=dev)
    feas = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return bound, feas
    _launch("mm_gapless_bound_launch", dev, bases.data_ptr(),
            lengths.data_ptr(), edges.data_ptr(), starts.data_ptr(), N, L,
            seq_pk.data_ptr(), seq_pk.shape[0], seq_off.data_ptr(),
            8 * mz.POOL_PAD_W, mt, mm, bound.data_ptr(), feas.data_ptr())
    COUNT.add(N, L, "gapless_bound", True)
    return bound, feas


def minimizer_rows(bases, lengths, k: int, w: int):
    """Minimizer marks of segment rows (the JAX minimizer_mask as the
    index build calls it): bases (B, L) uint8 codes with L >= k, lengths
    (B,) int32.  Returns (kmers (B, P, 2) int64, is_mm (B, P) bool), P =
    L - k + 1."""
    from ..mapper import minimizers as mz
    _check_reads(bases, lengths)
    _check_k(k, w)
    B, L = bases.shape
    if L < k:
        raise ValueError(f"mm_map: rows of width {L} hold no {k}-mer")
    if not _on_card(bases):
        km, _h, is_mm = mz.minimizer_mask(bases, lengths, k, w)
        return km, is_mm
    P = L - k + 1
    km = torch.empty((B, P, 2), dtype=torch.int64, device=bases.device)
    is_mm = torch.empty((B, P), dtype=torch.bool, device=bases.device)
    if B == 0:
        return km, is_mm
    _launch("mm_minimizer_rows_launch", bases.device, bases.data_ptr(),
            lengths.data_ptr(), B, L, k, w, km.data_ptr(), is_mm.data_ptr())
    COUNT.add(B, L, "minimizer_rows", False)
    return km, is_mm
