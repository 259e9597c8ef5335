"""Affine-gap alignment score: the CUDA kernel csrc/nw_align.cu and its
wrapper.

Replaces the Pallas TPU kernel turingassembler_tpu/ops/pallas_align.py
(`banded_affine_score`, body `_nw_kernel`), the repository's only TPU
kernel.  Same function: a full-width Gotoh score per (query, target)
pair, "global" or "fit" (see ops/align.py, its plain version).

What bounds it on an H100: 32-bit integer ALU work.  A pair costs about
qlen * (tlen + 1) DP cells of ~11 integer operations each (substitution
select 2, E 3, b 2, scan add 1 and max 1, F 1, H 1); its bytes (two
uint8 rows in, one int32 out) are negligible.  The design keeps every
DP value in registers and shared memory (one thread per target column,
the in-row gap chain as a block max-scan), so no DP state touches
device memory, and stops each block at its own qlen and tlen.  Its cost
over the bound is the scan's shuffles and two block barriers per row.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from .align import affine_global_score_batch

OPS_PER_CELL = 11
MAX_THREADS = 256


@dataclass
class LaunchCount:
    """Launches of the kernel and pairs they scored (CUDA path only)."""
    launches: int = 0
    pairs: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.pairs = 0


COUNT = LaunchCount()


def _lib():
    fn = _build.load("nw_align").nw_align_launch
    # pointers and the stream as c_void_p: an undeclared int argument
    # would be passed as a 32-bit C int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
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


def banded_affine_score(q: torch.Tensor, qlen: torch.Tensor,
                        t: torch.Tensor, tlen: torch.Tensor,
                        match: int = 1, mismatch: int = -2, go: int = 3,
                        ge: int = 1, mode: str = "global") -> torch.Tensor:
    """Affine-gap score per pair.  q (B, Lq) uint8, t (B, Lt) uint8 codes
    (255 padding, codes >= 4 always mismatch), qlen/tlen (B,) int32 with
    0 <= qlen <= Lq and 0 <= tlen <= Lt.  Returns (B,) int32."""
    if mode not in ("global", "fit"):
        raise ValueError(f"mode must be 'global' or 'fit', got {mode!r}")
    _check(q, qlen, t, tlen)
    if q.device.type == "cpu":
        return affine_global_score_batch(q, qlen, t, tlen, match, mismatch,
                                         go, ge, mode)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Lq = q.shape
    Lt = t.shape[1]
    if 16 * (Lq + 1) > 227 * 1024:
        raise ValueError(f"query width {Lq} exceeds the kernel's shared "
                         "memory carry")
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return out
    threads = min(MAX_THREADS, -(-(Lt + 1) // 32) * 32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                    tlen.data_ptr(), out.data_ptr(), B, Lq, Lt, match,
                    mismatch, go, ge, int(mode == "fit"), threads, stream)
    if rc != 0:
        raise RuntimeError(f"nw_align kernel launch failed: CUDA error {rc}")
    COUNT.launches += 1
    COUNT.pairs += B
    return out
