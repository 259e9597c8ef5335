"""Plain PyTorch affine-gap DP (port of
turingassembler_tpu/ops/align.py:affine_global_score_batch).

The plain version of the CUDA kernel in ops/nw_align.py: the wrapper
there runs it for tensors on the CPU, and chip_smoke.py holds the kernel
against it on the card.  Do not call it directly; go through ops/dp.py.

One pair per batch row, a Python loop over query rows, full-width
tensor ops over (batch, target column).  The in-row horizontal-gap chain
is closed with a running max: because a second gap-open inside a gap is
dominated by extending the first,
  F[j] = max_{t<j}(b[t] - go - ge*(j-t)) = cummax(b + ge*j)[j-1] - go - ge*j.
Instead of keeping every row, each pair's score is captured from the
row i == qlen as the loop passes it.
"""

from __future__ import annotations

import torch

NEG = -(1 << 20)


def affine_global_score_batch(q: torch.Tensor, qlen: torch.Tensor,
                              t: torch.Tensor, tlen: torch.Tensor,
                              match: int = 1, mismatch: int = -2,
                              gap_open: int = 3, gap_ext: int = 1,
                              mode: str = "global") -> torch.Tensor:
    """Gotoh affine-gap score per pair (a gap of length L costs
    gap_open + gap_ext*L; BWA's ksw_global2 scoring is (1, -2, 3, 1)).

    q (B, Lq) uint8 and t (B, Lt) uint8 codes, 255-padded; qlen/tlen (B,)
    int32.  Codes >= 4 always mismatch.  mode "global" scores end to end
    (H at (qlen, tlen)); mode "fit" leaves target-end gaps free (max of
    row qlen over columns <= tlen).  Returns (B,) int32.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    go, ge = gap_open, gap_ext
    jj = torch.arange(Lt + 1, dtype=torch.int32, device=dev)
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    if mode == "fit":
        h = torch.zeros((B, Lt + 1), dtype=torch.int32, device=dev)
        keep = jj[None, :] <= tlen[:, None]
    else:
        h = torch.where(jj == 0, 0, -(go + ge * jj)).to(torch.int32)
        h = h.expand(B, Lt + 1).clone()
        keep = jj[None, :] == tlen[:, None]
    neg = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    t_ok = t < 4
    tcodes = t.to(torch.int32)

    def capture(best, h, i):
        at = (qlen == i)[:, None] & keep
        return torch.maximum(best, torch.where(at, h, NEG).amax(dim=1))

    best = capture(torch.full((B,), NEG, dtype=torch.int32, device=dev), h, 0)
    e = torch.full((B, Lt + 1), NEG, dtype=torch.int32, device=dev)
    for i in range(1, Lq + 1):
        qi = q[:, i - 1].to(torch.int32)[:, None]
        sc = torch.where((tcodes == qi) & t_ok & (qi < 4), match, mismatch
                         ).to(torch.int32)
        e = torch.maximum(e - ge, h - go - ge)
        b = torch.cat([torch.full((B, 1), -(go + ge * i), dtype=torch.int32,
                                  device=dev),
                       torch.maximum(e[:, 1:], h[:, :-1] + sc)], dim=1)
        c = torch.cummax(b + ge * jj, dim=1).values
        f = torch.cat([neg, c[:, :-1]], dim=1) - go - ge * jj
        h = torch.maximum(b, f)
        best = capture(best, h, i)
    return best
