"""Port parity: ops/limbs.py and ops/kmers.py of turingassembler_tpu_torch
against the JAX package on the same numpy inputs.

Tolerance: exact equality.  Every output is an integer array (limbs are
compared as values: uint32 in JAX, int64 in [0, 2^32) in the port).
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu.ops import kmers as jk
from turingassembler_tpu.ops import limbs as jl
from turingassembler_tpu_torch.ops import kmers as tk
from turingassembler_tpu_torch.ops import limbs as tl

# small tensors: one intra-op thread each, so test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

KS = [17, 31, 32, 45, 46, 63, 64]


def _eq(jax_arr, torch_arr):
    a = np.asarray(jax_arr).astype(np.int64)
    b = torch_arr.numpy().astype(np.int64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _kmers(k, n=200, seed=0):
    rng = np.random.default_rng(seed + k)
    b = rng.integers(0, 4, (n, k)).astype(np.uint8)
    b[0] = 3                     # all-T
    b[1] = 0                     # all-A
    b[2, k // 2] = 4             # an N packs as 0
    return b


def _reads(k, seed=0):
    """Reads with N bases, 255 padding, and reads shorter than k."""
    rng = np.random.default_rng(seed + 100 + k)
    B, L = 24, 96
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(k - 5, L + 1, B).astype(np.int32)
    lengths[:3] = [L, k, k - 1]
    for i in range(B):
        reads[i, lengths[i]:] = 255
    reads[4, 30] = 4
    reads[5, 0] = 4
    reads[6, :] = 3              # an all-T read
    lengths[6] = L
    return reads, lengths


@pytest.mark.parametrize("k", KS)
def test_pack_unpack_revcomp(k):
    b = _kmers(k)
    jp = jl.pack_bases(b, k)
    tp = tl.pack_bases(torch.as_tensor(b), k)
    _eq(jp, tp)
    _eq(jl.unpack_limbs(jp, k), tl.unpack_limbs(tp, k))
    _eq(jl.revcomp_limbs(jp, k), tl.revcomp_limbs(tp, k))
    jc, jr = jl.canonicalize(jp, k)
    tc, tr = tl.canonicalize(tp, k)
    _eq(jc, tc)
    _eq(jr, tr)
    # revcomp is an involution on packed rows
    _eq(jp, tl.revcomp_limbs(tl.revcomp_limbs(tp, k), k))


@pytest.mark.parametrize("k", KS)
def test_lex_compare(k):
    b = _kmers(k)
    a_ = tl.pack_bases(torch.as_tensor(b), k)
    b_ = tl.pack_bases(torch.as_tensor(b[::-1].copy()), k)
    ja = np.asarray(jl.pack_bases(b, k))
    jb = np.asarray(jl.pack_bases(b[::-1].copy(), k))
    _eq(jl.lex_lt(ja, jb), tl.lex_lt(a_, b_))
    _eq(jl.lex_eq(ja, jb), tl.lex_eq(a_, b_))
    _eq(jl.lex_le(ja, jb), tl.lex_le(a_, b_))


@pytest.mark.parametrize("k", KS)
def test_hash_limbs_bit_exact(k):
    b = _kmers(k, n=500)
    jp = jl.pack_bases(b, k)
    tp = tl.pack_bases(torch.as_tensor(b), k)
    for seed in (0x9E3779B9, 0x27D4EB2F):
        _eq(jl.hash_limbs(jp, seed), tl.hash_limbs(tp, seed))


def test_hash_limbs_extreme_limbs():
    """Limb values at the 32-bit edges, where an unmasked int64 multiply
    or shift would go wrong."""
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                     0xDEADBEEF, 0x12345678], np.uint32)
    rows = np.stack(np.meshgrid(vals, vals, vals), -1).reshape(-1, 3)
    _eq(jl.hash_limbs(rows), tl.hash_limbs(torch.as_tensor(rows.astype(np.int64))))


@pytest.mark.parametrize("k", KS)
def test_extract_canonical_kmers(k):
    reads, lengths = _reads(k)
    jc, jr, jv = jk.extract_canonical_kmers(reads, lengths, k)
    tc, tr, tv = tk.extract_canonical_kmers(torch.as_tensor(reads),
                                            torch.as_tensor(lengths), k)
    _eq(jv, tv)
    v = np.asarray(jv)
    # invalid windows carry don't-care limbs in both
    np.testing.assert_array_equal(np.asarray(jc).astype(np.int64)[v],
                                  tc.numpy()[v])
    np.testing.assert_array_equal(np.asarray(jr)[v], tr.numpy()[v])
    _eq(jk.window_validity(reads, lengths, k),
        tk.window_validity(torch.as_tensor(reads), torch.as_tensor(lengths), k))


@pytest.mark.parametrize("k", [k for k in KS if k < 64])
def test_split_kedge_and_end_bases(k):
    b = _kmers(k + 1)
    jp = jl.pack_bases(b, k + 1)
    tp = tl.pack_bases(torch.as_tensor(b), k + 1)
    jpre, jsuf = jk.split_kedge(jp, k)
    tpre, tsuf = tk.split_kedge(tp, k)
    _eq(jpre, tpre)
    _eq(jsuf, tsuf)
    _eq(jk.kedge_first_base(jp), tk.kedge_first_base(tp))
    _eq(jk.kedge_last_base(jp, k), tk.kedge_last_base(tp, k))


def test_lex_order_matches_numpy_lexsort():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, (3000, 3)).astype(np.int64) * 0x55555555
    perm = tl.plain_lex_order(torch.as_tensor(rows)).numpy()
    want = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
    np.testing.assert_array_equal(rows[perm], rows[want])
    np.testing.assert_array_equal(perm, want)   # both stable
