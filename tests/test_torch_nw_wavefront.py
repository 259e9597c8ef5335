"""The CUDA NW kernel's schedule, checked where the kernel cannot run.

csrc/nw_align.cu computes the affine-gap score by strips of S columns a
lane, the horizontal-gap chain F closed sequentially (Gotoh form), and
column tiles of 32 * S columns with the boundary H and F carried per
row.  ops/align.py:affine_score_strips follows that formulation cell by
cell in PyTorch; here it is held against the plain DP
(affine_global_score_batch), the JAX package's scan lowering and its
Pallas kernel in interpret mode.  Also the wrapper's launch plan.

Tolerance: exact equality (integer scores).
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu.ops.align import affine_global_score_batch as jscan
from turingassembler_tpu.ops.pallas_align import banded_affine_score as jpallas
from turingassembler_tpu_torch.ops import nw_align
from turingassembler_tpu_torch.ops.align import (affine_global_score_batch,
                                                 affine_score_strips)

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

SCORINGS = {"bwa": (1, -2, 3, 1), "bubble": (1, -1, 0, 3)}   # bubble: go = 0


def _pairs(B, Lq, Lt, seed):
    """Random codes with code-4 bases, 255 padding past each length;
    qlen = 0, tlen = 0 and full-width rows; half the pairs are a target
    slice with an edit, so scores span the whole range."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(0, Lt + 1, B).astype(np.int32)
    qlen[0], tlen[1] = 0, 0
    qlen[2], tlen[2] = Lq, Lt
    qlen[3], tlen[3] = 0, 0
    half = np.arange(0, B, 2)
    off = rng.integers(0, 6, len(half))
    src = np.minimum(off[:, None] + np.arange(Lq)[None, :], Lt - 1)
    q[half] = np.take_along_axis(t[half], src, axis=1)
    q[half, rng.integers(0, Lq, len(half))] = rng.integers(0, 4, len(half))
    q[np.arange(Lq)[None, :] >= qlen[:, None]] = 255
    t[np.arange(Lt)[None, :] >= tlen[:, None]] = 255
    return q, qlen, t, tlen


def _strips(arrs, sc, mode, strip, lanes=32):
    return affine_score_strips(*(torch.as_tensor(a) for a in arrs), *sc,
                               mode=mode, strip=strip, lanes=lanes).numpy()


def _plain(arrs, sc, mode):
    return affine_global_score_batch(*(torch.as_tensor(a) for a in arrs),
                                     *sc, mode=mode).numpy()


# (strip, lanes, Lt): a tile holds lanes * strip columns after column 0.
# One column short of a tile, the full tile, one column into the next;
# at the kernel's 32 lanes for two strip widths, and at fewer lanes so
# that three and more tiles stay cheap.
SHAPES = [(2, 32, 63), (2, 32, 64), (2, 32, 65), (4, 32, 128), (4, 32, 129),
          (1, 4, 4), (1, 4, 5), (3, 4, 37), (6, 2, 29), (8, 2, 16),
          (16, 1, 33)]


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "fit"])
@pytest.mark.parametrize("strip,lanes,Lt", SHAPES)
def test_strips_match_plain(strip, lanes, Lt, mode, scoring):
    arrs = _pairs(24, 14, Lt, seed=strip * 1000 + Lt)
    sc = SCORINGS[scoring]
    got = _strips(arrs, sc, mode, strip, lanes)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _plain(arrs, sc, mode))


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "fit"])
def test_strips_match_jax_scan_and_pallas_interpret(mode, scoring):
    """Two tiles of 3 strips of 4 columns against the JAX package's scan
    lowering and its Pallas kernel in interpret mode."""
    q, qlen, t, tlen = arrs = _pairs(16, 20, 21, seed=7)
    m, mm, go, ge = sc = SCORINGS[scoring]
    got = _strips(arrs, sc, mode, strip=4, lanes=3)
    np.testing.assert_array_equal(got, np.asarray(jscan(
        q, qlen, t, tlen, match=m, mismatch=mm, gap_open=go, gap_ext=ge,
        mode=mode)))
    np.testing.assert_array_equal(got, np.asarray(jpallas(
        q, qlen, t, tlen, match=m, mismatch=mm, go=go, ge=ge, mode=mode,
        interpret=True)))


def test_strips_all_padding_and_unrelated():
    """Every pair empty on one side or both; and unrelated full-width
    pairs, whose score is all gaps and mismatches."""
    B, Lq, Lt = 6, 9, 11
    q = np.full((B, Lq), 255, np.uint8)
    t = np.full((B, Lt), 255, np.uint8)
    qlen = np.array([0, 0, 9, 9, 5, 0], np.int32)
    tlen = np.array([0, 11, 0, 11, 7, 3], np.int32)
    q[2:5] = 0
    t[3:5] = 1
    q[np.arange(Lq)[None, :] >= qlen[:, None]] = 255
    t[np.arange(Lt)[None, :] >= tlen[:, None]] = 255
    for sc in SCORINGS.values():
        for mode in ("global", "fit"):
            np.testing.assert_array_equal(
                _strips((q, qlen, t, tlen), sc, mode, strip=2, lanes=2),
                _plain((q, qlen, t, tlen), sc, mode))


@pytest.mark.parametrize("B,Lq,Lt,want", [
    (65_536, 152, 184, (6, 8)),       # the map's remainder DP: one tile
    (4_096, 256, 256, (8, 8)),        # bubble check, many pairs
    (32, 1_024, 1_024, (16, 1)),      # bubble check, few wide pairs
    (300, 37, 1_500, (16, 1)),
    (1_000, 40, 33, (2, 3)),
    (2_112, 1_000, 600, (12, 8)),     # 72 KB of tile carries a block
    (64, 40, 193, (8, 1)),            # one column past strip 6's tile
])
def test_launch_plan(B, Lq, Lt, want):
    strip, warps, shared = nw_align.launch_plan(B, Lq, Lt)
    assert (strip, warps) == want
    tiled = Lt > 32 * strip
    assert shared == warps * ((8 * (Lq + 1) if tiled else 0)
                              + -(-Lq // 8) * 8)
    assert shared <= nw_align.MAX_SHARED


def test_launch_plan_limits():
    # a long query with tiles leaves room for fewer pairs a block
    strip, warps, shared = nw_align.launch_plan(65_536, 10_000, 3_600)
    assert warps == nw_align.MAX_SHARED // (8 * 10_001 + 10_000) == 2
    assert nw_align.launch_plan(8, 3_500, 3_600, strip=2)[0] == 2
    with pytest.raises(ValueError):
        nw_align.launch_plan(8, 30_000, 3_600)
    with pytest.raises(ValueError):
        nw_align.launch_plan(8, 100, 100, strip=5)


def test_wrapper_rejects_negative_gap_open():
    q = torch.zeros((4, 10), dtype=torch.uint8)
    ln = torch.full((4,), 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        nw_align.banded_affine_score(q, ln, q, ln, go=-1)
