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

`affine_score_strips` is a second plain function that follows the CUDA
kernel's formulation cell by cell; the CPU tests hold it against the
first at exact equality, since the kernel itself runs only on the card.
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


def affine_score_strips(q: torch.Tensor, qlen: torch.Tensor,
                        t: torch.Tensor, tlen: torch.Tensor,
                        match: int = 1, mismatch: int = -2,
                        gap_open: int = 3, gap_ext: int = 1,
                        mode: str = "global", strip: int = 2,
                        lanes: int = 32) -> torch.Tensor:
    """The same score computed as csrc/nw_align.cu computes it (needs
    gap_open >= 0).  Columns 1..tlen are cut into tiles of lanes * strip
    columns, a tile into `lanes` strips of `strip` columns.  A strip
    keeps H of the previous row and E of this row; along a row it takes
    from its left neighbour the last-column H and the outgoing F, and
    closes F sequentially, F[c+1] = max(F[c] - ge, H[c] - go - ge).
    Column 0 is the first strip's left boundary, never a cell.  Between
    tiles the last strip's H and F of every row wait in a carry buffer.
    Each pair stops at its own qlen and tlen, and its score is read from
    the strips' H after the last row.  The kernel's lanes work on
    different rows at once; the order below, row by row and strip by
    strip, meets the same dependencies.  Batched over pairs, Python
    loops over tiles, rows and columns: for tests at small sizes only."""
    B, Lq = q.shape
    Lt = t.shape[1]
    go, ge, goge = gap_open, gap_ext, gap_open + gap_ext
    fit = mode == "fit"
    i32 = dict(dtype=torch.int32, device=q.device)
    nrows = torch.clamp(qlen, max=Lq).to(torch.int32)
    ncols = torch.clamp(tlen, max=Lt).to(torch.int32)
    jj = torch.arange(Lt, **i32)
    qc = torch.where(q < 4, q, 0xFF).to(torch.int32)
    # a strip never loads a base past tlen
    tcodes = torch.where((t < 4) & (jj < ncols[:, None]), t, 0xFE
                         ).to(torch.int32)
    width = lanes * strip

    def const(v):
        return torch.full((B,), v, **i32)

    def row0(c):
        return const(0 if fit or c == 0 else -(go + ge * c))

    # column 0 of the last row
    best = torch.where(nrows > 0, -(go + ge * nrows), 0).to(torch.int32)
    if not fit:
        best = torch.where(ncols <= 0, best, NEG)
    carry_h = torch.zeros((B, Lq + 1), **i32)
    carry_f = torch.zeros((B, Lq + 1), **i32)
    for tile in range(-(-Lt // width)):
        first = 1 + tile * width
        cols = range(first, min(first + width, Lt + 1))
        more = ncols > first + width - 1        # a tile follows
        h = {c: row0(c) for c in cols}          # H[i-1][c]
        e = {c: h[c] - goge for c in cols}      # E[i][c]
        hdiag = {c: row0(c - 1) for c in cols[::strip]}   # H[i-1][c0-1]
        for i in range(1, Lq + 1):
            qi = qc[:, i - 1]
            for c in cols:
                if (c - first) % strip == 0:    # a strip's left boundary
                    if c == 1:
                        hl = const(-(go + ge * i))
                        f = hl - goge
                    elif c == first:
                        hl, f = carry_h[:, i].clone(), carry_f[:, i].clone()
                    else:                       # f runs on from the left
                        hl = h[c - 1]
                    hd, hdiag[c] = hdiag[c], hl
                    # a strip works while its first column and the row
                    # are the pair's
                    on = (c <= ncols) & (i <= nrows)
                sub = torch.where(tcodes[:, c - 1] == qi, const(match),
                                  const(mismatch))
                b = torch.maximum(hd + sub, e[c])
                hn = torch.maximum(b, f)
                og = hn - goge
                e[c] = torch.where(on, torch.maximum(e[c] - ge, og), e[c])
                f = torch.maximum(f - ge, og)
                hd = h[c]
                h[c] = torch.where(on, hn, h[c])
            keep = more & (i <= nrows)
            carry_h[:, i] = torch.where(keep, h[cols[-1]], carry_h[:, i])
            carry_f[:, i] = torch.where(keep, f, carry_f[:, i])
        for c in cols:
            at = (c <= ncols) if fit else (c == ncols)
            best = torch.where(at, torch.maximum(best, h[c]), best)
    return best
