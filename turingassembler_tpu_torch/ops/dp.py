"""The one alignment scorer of the port (port of turingassembler_tpu/ops/dp.py).

One affine-gap recurrence (a gap of length L costs go + ge*L) with
two lowerings of the same integer math, chosen by the device of the
tensors: the CUDA kernel ops/nw_align.py on the card, its plain PyTorch
version ops/align.py on the CPU.  Both are full width: the score is
exact for any divergence between query and target, there is no band.

Call sites: the mapper's remainder DP
(mapper/minimizers.py:_dp_verify_rest), with BWA scoring in "fit" mode,
through `affine_scores_tensors` on windows it cut on the device; and the
align-bubble check (resolve/basic.py:nw_align_scores_batch), with bubble
scoring in "global" mode, through `affine_scores` on host arrays padded
to the batch's longest branch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .nw_align import banded_affine_score

# (match, mismatch, gap_open, gap_extend)
SCORING_BUBBLE: Tuple[int, int, int, int] = (1, -1, 0, 3)
SCORING_BWA: Tuple[int, int, int, int] = (1, -2, 3, 1)

MIN_MAP_SCORE = 50  # reference read_mapper gate: score < 50 -> unmapped


def affine_scores_tensors(q: torch.Tensor, qlen: torch.Tensor,
                          t: torch.Tensor, tlen: torch.Tensor,
                          scoring: Tuple[int, int, int, int],
                          mode: str = "global") -> torch.Tensor:
    """Alignment score for each padded pair, for a caller that holds
    tensors: everything stays on the device of `q`, and the (B,) int32
    scores come back as a tensor there.

    q (B, Lq) and t (B, Lt) codes with 255 padding, qlen/tlen (B,)
    effective lengths, any integer types.  mode "global" is end to end
    on both sequences; "fit" leaves target-end gaps free (the query must
    align fully, the window slack costs nothing)."""
    match, mismatch, go, ge = scoring
    return banded_affine_score(
        q.to(torch.uint8).contiguous(), qlen.to(torch.int32).contiguous(),
        t.to(torch.uint8).contiguous(), tlen.to(torch.int32).contiguous(),
        match=match, mismatch=mismatch, go=go, ge=ge, mode=mode)


def affine_scores(q, qlen, t, tlen, scoring: Tuple[int, int, int, int],
                  mode: str = "global",
                  device: str | torch.device = "cuda") -> np.ndarray:
    """affine_scores_tensors for host arrays: copies them to `device`
    and the (B,) int32 scores back."""
    dev = resolve_device(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt)).to(dev)

    return affine_scores_tensors(put(q, np.uint8), put(qlen, np.int32),
                                 put(t, np.uint8), put(tlen, np.int32),
                                 scoring, mode).cpu().numpy()
