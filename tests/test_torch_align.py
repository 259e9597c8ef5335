"""Port parity: the plain affine-gap DP of turingassembler_tpu_torch
(ops/align.py, the plain version of the CUDA kernel) against the JAX
package's scan lowering and its Pallas kernel in interpret mode; the
kernel wrapper (ops/nw_align.py) and ops/dp.py on CPU tensors.

Tolerance: exact equality (integer scores).
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu.ops import dp as jdp
from turingassembler_tpu.ops.align import affine_global_score_batch as jscan
from turingassembler_tpu.ops.pallas_align import banded_affine_score as jpallas
from turingassembler_tpu_torch.ops import dp as tdp
from turingassembler_tpu_torch.ops import nw_align
from turingassembler_tpu_torch.ops.align import affine_global_score_batch

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

SCORINGS = {"bwa": (1, -2, 3, 1), "bubble": (1, -1, 0, 3)}


def _port(q, qlen, t, tlen, scoring=(1, -2, 3, 1), mode="global"):
    return affine_global_score_batch(
        torch.as_tensor(q), torch.as_tensor(qlen), torch.as_tensor(t),
        torch.as_tensor(tlen), *scoring, mode=mode).numpy()


def _jax(q, qlen, t, tlen, scoring=(1, -2, 3, 1), mode="global"):
    m, mm, go, ge = scoring
    return np.asarray(jscan(q, qlen, t, tlen, match=m, mismatch=mm,
                            gap_open=go, gap_ext=ge, mode=mode))


def _pallas(q, qlen, t, tlen, scoring=(1, -2, 3, 1), mode="global"):
    m, mm, go, ge = scoring
    return np.asarray(jpallas(q, qlen, t, tlen, match=m, mismatch=mm, go=go,
                              ge=ge, mode=mode, interpret=True))


def _random_pairs(B, Lq, Lt, seed, related=True):
    """Random codes (some code-4 bases), 255 padding past each length,
    qlen = 0 and tlen = 0 rows included; half the pairs are a target
    prefix with a few edits, so scores span the whole range."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(0, Lt + 1, B).astype(np.int32)
    qlen[0], tlen[1] = 0, 0
    for i in range(B):
        if related and i % 2 == 0:
            off = int(rng.integers(0, max(tlen[i] - qlen[i], 0) + 1))
            n = int(min(qlen[i], tlen[i] - off))
            q[i, :n] = t[i, off:off + n]
            if n > 4:
                p = rng.integers(0, n, 2)
                q[i, p] = (q[i, p] + 1) % 4
        q[i, qlen[i]:] = 255
        t[i, tlen[i]:] = 255
    return q, qlen, t, tlen


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "fit"])
def test_plain_matches_jax_scan(scoring, mode):
    q, qlen, t, tlen = _random_pairs(64, 40, 70, seed=1)
    sc = SCORINGS[scoring]
    np.testing.assert_array_equal(_port(q, qlen, t, tlen, sc, mode),
                                  _jax(q, qlen, t, tlen, sc, mode))


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "fit"])
def test_plain_matches_pallas_interpret(scoring, mode):
    """Lt > Lq, qlen = 0 rows, code-4 bases."""
    q, qlen, t, tlen = _random_pairs(16, 24, 150, seed=2)
    sc = SCORINGS[scoring]
    np.testing.assert_array_equal(_port(q, qlen, t, tlen, sc, mode),
                                  _pallas(q, qlen, t, tlen, sc, mode))


def _inband_batch(rng, B, Lq, Lt, W):
    """tests/test_pallas_align.py's near-identical pairs."""
    q = np.full((B, Lq), 255, np.uint8)
    t = np.full((B, Lt), 255, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for i in range(B):
        ql = int(rng.integers(10, Lq + 1))
        dmax = W // 2 - 1
        tl = int(np.clip(ql + rng.integers(-dmax, dmax + 1), 1, Lt))
        qlen[i], tlen[i] = ql, tl
        base = rng.integers(0, 4, max(ql, tl)).astype(np.uint8)
        qq = base[:ql].copy()
        tt = base[:tl].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = rng.integers(0, tl)
            tt[p] = (tt[p] + rng.integers(1, 4)) % 4
        q[i, :ql] = qq
        t[i, :tl] = tt
    return q, qlen, t, tlen


@pytest.mark.parametrize("W", [32, 64])
def test_pallas_inband_cases(W):
    q, qlen, t, tlen = _inband_batch(np.random.default_rng(0), 8, 60, 70, W)
    want = _pallas(q, qlen, t, tlen)
    np.testing.assert_array_equal(want, _jax(q, qlen, t, tlen))
    np.testing.assert_array_equal(_port(q, qlen, t, tlen), want)


def test_pallas_identical_case():
    B, L = 4, 40
    q = np.tile(np.random.default_rng(0).integers(0, 4, L).astype(np.uint8),
                (B, 1))
    ql = np.full(B, L, np.int32)
    np.testing.assert_array_equal(_port(q, ql, q, ql), np.full(B, L))
    np.testing.assert_array_equal(_port(q, ql, q, ql), _pallas(q, ql, q, ql))


def test_pallas_fit_case():
    """tests/test_pallas_align.py's fit case: query = a target slice with
    a few substitutions."""
    B, Lq, Lt = 8, 40, 80
    r = np.random.default_rng(3)
    q = np.full((B, Lq), 255, np.uint8)
    t = np.full((B, Lt), 255, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for i in range(B):
        ql = int(r.integers(15, Lq + 1))
        tl = int(r.integers(ql, Lt + 1))
        off = int(r.integers(0, min(tl - ql + 1, 30)))
        qlen[i], tlen[i] = ql, tl
        tt = r.integers(0, 4, tl).astype(np.uint8)
        qq = tt[off:off + ql].copy()
        for _ in range(int(r.integers(0, 3))):
            p = r.integers(0, ql)
            qq[p] = (qq[p] + r.integers(1, 4)) % 4
        q[i, :ql] = qq
        t[i, :tl] = tt
    want = _pallas(q, qlen, t, tlen, mode="fit")
    np.testing.assert_array_equal(want, _jax(q, qlen, t, tlen, mode="fit"))
    np.testing.assert_array_equal(_port(q, qlen, t, tlen, mode="fit"), want)


def test_wrapper_cpu_runs_plain_and_counts_no_launch():
    q, qlen, t, tlen = _random_pairs(32, 30, 50, seed=4)
    before = (nw_align.COUNT.launches, nw_align.COUNT.total("pairs"))
    got = nw_align.banded_affine_score(
        torch.as_tensor(q), torch.as_tensor(qlen), torch.as_tensor(t),
        torch.as_tensor(tlen), mode="fit")
    np.testing.assert_array_equal(got.numpy(),
                                  _jax(q, qlen, t, tlen, mode="fit"))
    assert (nw_align.COUNT.launches, nw_align.COUNT.total("pairs")) == before


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((4, 10), dtype=torch.uint8)
    t = torch.zeros((4, 12), dtype=torch.uint8)
    ql = torch.full((4,), 10, dtype=torch.int32)
    tl = torch.full((4,), 12, dtype=torch.int32)
    with pytest.raises(ValueError):
        nw_align.banded_affine_score(q.long(), ql, t, tl)
    with pytest.raises(ValueError):
        nw_align.banded_affine_score(q, ql[:3], t, tl)
    with pytest.raises(ValueError):
        nw_align.banded_affine_score(q.t(), ql, t, tl)
    with pytest.raises(ValueError):
        nw_align.banded_affine_score(q, ql, t, tl, mode="local")


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_affine_scores_matches_jax_dp(scoring):
    q, qlen, t, tlen = _random_pairs(48, 36, 68, seed=5)
    sc = SCORINGS[scoring]
    for mode in ("global", "fit"):
        want = jdp.affine_scores(q, qlen, t, tlen, sc, backend="scan",
                                 mode=mode)
        got = tdp.affine_scores(q, qlen, t, tlen, sc, mode=mode, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
