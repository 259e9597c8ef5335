"""Affine-gap alignment score, "fit" form, plain.

Gotoh's recurrence with a gap of length L costing go + ge * L: the whole
query aligns, and target bases before and after it cost nothing.

  H[0][j] = 0                      (a free start anywhere in the target)
  H[i][0] = -(go + ge * i)
  E[i][j] = max(E[i-1][j] - ge, H[i-1][j] - go - ge)      query gap run
  F[i][j] = max(F[i][j-1] - ge, H[i][j-1] - go - ge)      target gap run
  H[i][j] = max(H[i-1][j-1] + s(q_i, t_j), E[i][j], F[i][j])
  score   = max over j <= tlen of H[qlen][j]

with s = match where the codes are equal and below 4, mismatch
otherwise.  A row is computed at once over the pairs and the columns:
with go >= 0 a target gap never gains by closing and opening again, so
F[i][j] = max over t < j of B[t] - go - ge * (j - t), B being H before
F, which a running maximum of B[t] + ge * t gives.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)


def fit_scores(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
               tlen: torch.Tensor, match: int, mismatch: int, go: int,
               ge: int) -> torch.Tensor:
    """(P,) int64 scores of q (P, Lq) against t (P, Lt), codes as uint8
    (>= 4 never matches), over their first qlen and tlen bases."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    j = torch.arange(Lt + 1, device=dev)
    qlen, tlen = qlen.long(), tlen.long()
    in_t = j[None, :] <= tlen[:, None]
    h = torch.zeros((P, Lt + 1), dtype=torch.int64, device=dev)
    e = torch.full_like(h, NEG)
    best = torch.where(qlen == 0, 0, NEG)
    tc = t.long()
    for i in range(1, Lq + 1):
        qi = q[:, i - 1].long()[:, None]
        s = torch.where((tc == qi) & (qi < 4), match, mismatch)
        e = torch.maximum(e - ge, h - go - ge)
        b = torch.maximum(h[:, :-1] + s, e[:, 1:])
        b = torch.cat([torch.full((P, 1), -(go + ge * i), device=dev,
                                  dtype=torch.int64), b], 1)
        run = torch.cummax(b + ge * j, 1).values
        f = torch.cat([torch.full((P, 1), NEG, device=dev,
                                  dtype=torch.int64), run[:, :-1]], 1) \
            - go - ge * j
        h = torch.maximum(b, f)
        row = torch.where(in_t, h, NEG).amax(1)
        best = torch.where(qlen == i, row, best)
    return best
