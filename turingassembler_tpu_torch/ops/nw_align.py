"""Affine-gap alignment score: the CUDA kernel csrc/nw_align.cu and its
wrapper.

Replaces the Pallas TPU kernel turingassembler_tpu/ops/pallas_align.py
(`banded_affine_score`, body `_nw_kernel`), the repository's only TPU
kernel.  Same function: a full-width Gotoh score per (query, target)
pair, "global" or "fit" (see ops/align.py, its plain version).  Callers,
both through ops/dp.py: the mapper's remainder DP ("fit", BWA scoring,
uniform windows) and the align-bubble check of resolve/basic.py
("global", bubble scoring, ragged lengths under 1000, one launch for
all candidate pairs of a pass).

What bounds it on an H100: 32-bit integer instruction slots.  A pair
costs qlen * (tlen + 1) DP cells, counted at OPS_PER_CELL = 11 plain
integer operations each (substitution select 2, E 3, diagonal 2, F 3,
H 1); its bytes (two uint8 rows in, one int32 out) are negligible.  The
kernel is a warp per pair: each lane owns a strip of S neighbouring columns in
registers, the lanes run an anti-diagonal wavefront that hands H and F
to the right neighbour with two warp shuffles a step, F is closed
sequentially inside the strip, and a cell is three DPX instructions
(`__viaddmax_s32`), a max, an add and the substitution select.  There
is no block barrier.  Targets wider than 32 * S columns are walked in
column tiles with the boundary H and F carried per row in shared
memory.  Its cost over the bound is the wavefront's fill and drain (31
steps a tile), the shuffles, and lanes past tlen in the last tile.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field

import torch

from .. import _build
from .align import affine_global_score_batch

OPS_PER_CELL = 11
STRIPS = (2, 4, 6, 8, 12, 16)     # strip widths S compiled into the kernel
MAX_WARPS = 8                     # pairs a block, at most
FILL_BLOCKS = 264                 # two blocks on each of an H100's 132 SMs
MAX_SHARED = 232_448              # bytes of shared memory a block can use


@dataclass
class LaunchCount:
    """Launches of the kernel, pairs they scored and each launch's
    (B, Lq, Lt) (CUDA path only).  Safe to add to from several threads
    (the bridge stage launches from its worker threads)."""
    launches: int = 0
    pairs: int = 0
    shapes: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def reset(self) -> None:
        with self.lock:
            self.launches = 0
            self.pairs = 0
            self.shapes = []

    def add(self, B: int, Lq: int, Lt: int) -> None:
        with self.lock:
            self.launches += 1
            self.pairs += B
            self.shapes.append((B, Lq, Lt))


COUNT = LaunchCount()


def _lib():
    fn = _build.load("nw_align").nw_align_launch
    # pointers and the stream as c_void_p: an undeclared int argument
    # would be passed as a 32-bit C int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, qlen, t, tlen):
    dev = q.device
    for name, x, dt, nd in (("q", q, torch.uint8, 2), ("t", t, torch.uint8, 2),
                            ("qlen", qlen, torch.int32, 1),
                            ("tlen", tlen, torch.int32, 1)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
        if x.dtype != dt or x.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D {dt}, got "
                             f"{x.dim()}-D {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = q.shape[0]
    if t.shape[0] != B or qlen.shape[0] != B or tlen.shape[0] != B:
        raise ValueError("q, t, qlen and tlen must share the batch size")


def launch_plan(B: int, Lq: int, Lt: int, strip: int | None = None):
    """(strip width S, pairs a block, shared bytes a block) for a launch.

    S: of the compiled widths, the one with the least
    ceil(Lt / (32 * S)) * (S + 2): column tiles times the cost of a
    step, which is S cells and about two cells' worth of shuffles and
    bookkeeping; the wider of two that tie.
    Pairs a block: as many as leave FILL_BLOCKS blocks, at most
    MAX_WARPS, and no more than fit in shared memory.  A warp needs Lq
    bytes (rounded up to 8) for its query and, when Lt > 32 * S,
    8 * (Lq + 1) bytes for the tile carry: past MAX_SHARED for one warp
    (Lq of about 25,800 with tiles) the shape is refused."""
    if strip is None:
        strip = min(STRIPS, key=lambda s: (-(-Lt // (32 * s)) * (s + 2), -s))
    elif strip not in STRIPS:
        raise ValueError(f"strip must be one of {STRIPS}, got {strip}")
    carry = 8 * (Lq + 1) if Lt > 32 * strip else 0
    per_warp = carry + -(-max(Lq, 1) // 8) * 8
    if per_warp > MAX_SHARED:
        raise ValueError(f"query width {Lq} exceeds the kernel's shared "
                         "memory carry")
    warps = max(1, min(MAX_WARPS, B // FILL_BLOCKS,
                       MAX_SHARED // per_warp))
    return strip, warps, warps * per_warp


def banded_affine_score(q: torch.Tensor, qlen: torch.Tensor,
                        t: torch.Tensor, tlen: torch.Tensor,
                        match: int = 1, mismatch: int = -2, go: int = 3,
                        ge: int = 1, mode: str = "global", *,
                        _strip: int | None = None) -> torch.Tensor:
    """Affine-gap score per pair.  q (B, Lq) uint8, t (B, Lt) uint8 codes
    (255 padding, codes >= 4 always mismatch), qlen/tlen (B,) int32 with
    0 <= qlen <= Lq and 0 <= tlen <= Lt; go >= 0.  Returns (B,) int32.
    `_strip` overrides launch_plan's strip width (for the kernel's own
    checks)."""
    if mode not in ("global", "fit"):
        raise ValueError(f"mode must be 'global' or 'fit', got {mode!r}")
    if go < 0:
        raise ValueError(f"gap open must be >= 0, got {go}: the kernel "
                         "closes horizontal gaps sequentially")
    _check(q, qlen, t, tlen)
    if q.device.type == "cpu":
        return affine_global_score_batch(q, qlen, t, tlen, match, mismatch,
                                         go, ge, mode)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Lq = q.shape
    Lt = t.shape[1]
    strip, warps, _ = launch_plan(B, Lq, Lt, _strip)
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                    tlen.data_ptr(), out.data_ptr(), B, Lq, Lt, match,
                    mismatch, go, ge, int(mode == "fit"), strip, warps,
                    stream)
    if rc != 0:
        raise RuntimeError(f"nw_align kernel launch failed: CUDA error {rc}")
    COUNT.add(B, Lq, Lt)
    return out
