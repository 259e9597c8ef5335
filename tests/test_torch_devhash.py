"""The port's hash counter (ops/devhash.py) and the engines of
kmer/count.py against the JAX package's.

The cases of tests/test_devhash.py run through both packages on the same
numpy-seeded keys: the oracle, overflow (both raise), and same-round
claim collisions at 0.4 load, on the one-record-a-slot table.  The
port's hashes() against the JAX _hashes, and insert_reads against the
JAX fused batch insert (_count_batch_fused, fed through its read pack).
On the CPU the port runs the plain version (probe rounds);
csrc/devhash.cu is held against it on the card by chip_smoke.py, phase
14, and its reads entry's window formulation against
extract_canonical_kmers here, in a numpy model.  Then every `engine=` of
the port against the same JAX engine on one read set ("auto" is megasort
in the port and "np" in the JAX package on its CPU backend: the same
arrays), and the hash engine against the JAX np engine and the port's
megasort.  Tolerance: exact equality of the finalized (keys, counts),
dtypes too, and of every hash word.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turingassembler_tpu import testing as jt
from turingassembler_tpu.kmer.count import _count_batch_fused, host_pack_reads
from turingassembler_tpu.kmer.count import count_kedges_from_reads as j_count
from turingassembler_tpu.ops.devhash import DeviceHashCounter as JCounter
from turingassembler_tpu.ops.devhash import _hashes as j_hashes
from turingassembler_tpu_torch.kmer.count import \
    count_kedges_from_reads as t_count
from turingassembler_tpu_torch.ops import devhash
from turingassembler_tpu_torch.ops import kmers as km
from turingassembler_tpu_torch.ops.devhash import DeviceHashCounter as TCounter

torch.set_num_threads(1)


def both(capacity_log2, nl):
    return JCounter(capacity_log2, nl), TCounter(capacity_log2, nl,
                                                 device="cpu")


def finalize_same(jc, tc, **kw):
    jk, jn = jc.finalize(**kw)
    tk, tn = tc.finalize(**kw)
    assert tk.dtype == jk.dtype == np.uint32 and tn.dtype == jn.dtype
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tn, jn)
    return tk, tn


@pytest.mark.parametrize("nl", [3, 6])    # a 32- and a 64-byte record
def test_hash_counter_oracle(nl):
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 2**32, (300, nl), dtype=np.uint32)
    jc, tc = both(12, nl)       # 4096 slots
    want = {}
    for _ in range(5):
        kmers = pool[rng.integers(0, 300, 2000)]
        valid = rng.random(2000) < 0.9
        jc.insert(kmers, valid)
        tc.insert(kmers, valid)
        for i in np.flatnonzero(valid):
            want[tuple(kmers[i])] = want.get(tuple(kmers[i]), 0) + 1
    keys, counts = finalize_same(jc, tc)
    assert {tuple(k): int(c) for k, c in zip(keys, counts)} == want
    # unsorted: the same set in slot order
    uk, uc = tc.finalize(sort=False)
    assert {tuple(k): int(c) for k, c in zip(uk, uc)} == want


def test_hash_counter_overflow():
    rng = np.random.default_rng(1)
    nl = 2
    jc, tc = both(6, nl)        # 64 slots
    kmers = rng.integers(0, 2**32, (1000, nl), dtype=np.uint32)
    jc.insert(kmers, np.ones(1000, bool))
    tc.insert(kmers, np.ones(1000, bool))
    for c in (jc, tc):
        with pytest.raises(RuntimeError, match="overflow"):
            c.finalize()
    assert tc.overflow() > 0


def test_hash_counter_compaction_overflow():
    rng = np.random.default_rng(2)
    jc, tc = both(12, 2)
    kmers = rng.integers(0, 2**32, (1500, 2), dtype=np.uint32)
    jc.insert(kmers, np.ones(1500, bool))
    tc.insert(kmers, np.ones(1500, bool))
    for c in (jc, tc):
        with pytest.raises(RuntimeError, match="compaction overflow"):
            c.finalize(out_cap_log2=10)
    finalize_same(jc, tc, out_cap_log2=11)


def test_hash_counter_same_round_collisions():
    """Hundreds of distinct keys claim slots in the same probe round at
    0.4 load: the lowest lane wins a slot, the others probe on."""
    nl = 2
    pool = np.random.default_rng(7).integers(0, 2**32, (400, nl),
                                             dtype=np.uint32)
    jc, tc = both(10, nl)
    for _ in range(3):
        jc.insert(pool, np.ones(len(pool), bool))
        tc.insert(pool, np.ones(len(pool), bool))
    keys, counts = finalize_same(jc, tc)
    assert len(keys) == 400 and (counts == 3).all()


def test_fingerprints_avoid_empty_and_busy():
    kmers = torch.randint(0, 2**32, (4096, 3), generator=torch.Generator()
                          .manual_seed(0))
    slot, stride, got, _ = devhash.hashes(kmers, 1023)
    assert (got < devhash.BUSY).all() and (stride % 2 == 1).all()
    assert (slot <= 1023).all()
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1])
    assert devhash.to_i32(x).tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert torch.equal(devhash.to_u32(devhash.to_i32(x)), x)


@pytest.mark.parametrize("nl", [1, 3, 8])
def test_hashes_match_jax(nl):
    """hashes() == the JAX _hashes: slot, stride and fpB on every row, fpA
    wherever the JAX fpA is off 0xFFFFFFFE (the port moves BUSY too)."""
    rng = np.random.default_rng(10 + nl)
    keys = rng.integers(0, 2**32, (5000, nl), dtype=np.uint32)
    keys[0], keys[1], keys[2] = 0, 2**32 - 1, 2**31      # edge limbs
    mask = (1 << 20) - 1
    want = [np.asarray(x).astype(np.int64)
            for x in j_hashes(jnp.asarray(keys), jnp.uint32(mask))]
    got = [x.numpy() for x in devhash.hashes(
        torch.from_numpy(keys.astype(np.int64)), mask)]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    keep = want[2] < devhash.BUSY
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got[2][keep], want[2][keep])


def read_batches(rng, n_batches, B, L):
    """(bases, lengths) batches of reads from both strands of a 600 bp
    genome (k-mers repeat), with N codes (4), odd lengths, 255 padding
    past the length in half the rows and valid codes in the other half,
    and zero-length padding rows."""
    genome = rng.integers(0, 4, 600 + L).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        bases = genome[rng.integers(0, 600, B)[:, None] + np.arange(L)]
        flip = rng.random(B) < 0.5
        bases[flip] = 3 - bases[flip, ::-1]
        bases[rng.random((B, L)) < 0.004] = 4
        lengths = (rng.integers(0, L // 2, B) * 2 + 1).astype(np.int32)
        lengths[:4] = L if L % 2 else L - 1
        lengths[-3:] = 0
        for b in range(0, B, 2):
            bases[b, lengths[b]:] = 255
        out.append((bases, lengths))
    return out


@pytest.mark.parametrize("k1", [32, 46, 64])
def test_insert_reads_matches_jax_fused(k1):
    """insert_reads on the CPU (extract_canonical_kmers, then the plain
    insert) == the JAX hash engine's fused batch insert, batch after
    batch, fed through its 2-bit read pack."""
    rng = np.random.default_rng(k1)
    nl = (k1 + 15) // 16
    jc, tc = both(16, nl)
    launches = devhash.COUNT.launches
    for bases, lengths in read_batches(rng, 2, 48, 101):
        packed, nmask = host_pack_reads(bases)
        jc.keys, jc.counts, ovf = _count_batch_fused(
            jc.keys, jc.counts, jnp.asarray(packed), jnp.asarray(nmask),
            jnp.asarray(lengths), bases.shape[1], k1)
        jc._ovf = jc._ovf + ovf
        tc.insert_reads(bases, lengths, k1)
    keys, counts = finalize_same(jc, tc)
    assert counts.sum() > 500 and (counts > 1).any()
    assert devhash.COUNT.launches == launches      # no kernel on the CPU
    with pytest.raises(ValueError, match="limbs"):
        tc.insert_reads(bases, lengths, k1 + 16)


def _brev(x):
    """__brev on uint32 numpy arrays."""
    for sh, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                  (8, 0x00FF00FF)):
        x = ((x >> np.uint32(sh)) & np.uint32(m)) \
            | ((x & np.uint32(m)) << np.uint32(sh))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def reads_entry_model(bases, lengths, k1):
    """csrc/devhash.cu:count_reads_kernel's windows in numpy: the packed
    words of positions -16 .. L-1, the forward limbs at p + 16 l, the
    reverse-complement limbs as rev2(~word) at p + k1 - 16 - 16 l, the
    last limb masked, lex_lt; validity from the invalid-base mask words
    through a funnel shift.  Returns (canon (B, P, nl), valid (B, P))."""
    B, L = bases.shape
    nl, P = (k1 + 15) // 16, L - k1 + 1
    c = np.zeros((B, L + 32), np.uint32)
    c[:, 16:16 + L] = np.where(bases < 4, bases, 0)
    packed = np.zeros((B, L + 16), np.uint32)       # index q + 16
    for j in range(16):
        packed |= c[:, j:j + L + 16] << np.uint32(30 - 2 * j)
    MW = L // 32 + 2
    bits = np.zeros((B, MW * 32), np.uint64)
    bits[:, :L] = bases >= 4
    bad = (bits.reshape(B, MW, 32) << np.arange(32, dtype=np.uint64)).sum(2)
    p = np.arange(P)
    ok = p[None, :] + k1 <= lengths[:, None]
    for off in range(0, k1, 32):
        q = p + off
        pair = bad[:, q >> 5] | (bad[:, (q >> 5) + 1] << np.uint64(32))
        got = (pair >> (q & 31).astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        nb = min(32, k1 - off)
        ok &= (got & np.uint64((1 << nb) - 1)) == 0
    used = 2 * k1 - 32 * (nl - 1)
    last = np.uint32((0xFFFFFFFF << (32 - used)) & 0xFFFFFFFF)
    fw = np.stack([packed[:, 16 + p + 16 * l] for l in range(nl)], -1)
    rc = np.stack([_brev(~packed[:, 16 + p + k1 - 16 - 16 * l])
                   for l in range(nl)], -1)
    rc = ((rc >> np.uint32(1)) & np.uint32(0x55555555)) \
        | ((rc & np.uint32(0x55555555)) << np.uint32(1))
    fw[..., -1] &= last
    rc[..., -1] &= last
    lt = np.zeros((B, P), bool)
    eq = np.ones((B, P), bool)
    for l in range(nl):
        lt |= eq & (rc[..., l] < fw[..., l])
        eq &= rc[..., l] == fw[..., l]
    return np.where(lt[..., None], rc, fw), ok


@pytest.mark.parametrize("k1", [1, 16, 17, 32, 33, 46, 64, 100, 128])
def test_reads_entry_formulation(k1):
    """The reads entry's window arithmetic == extract_canonical_kmers on
    every valid window, and its validity on every window."""
    rng = np.random.default_rng(100 + k1)
    bases, lengths = read_batches(rng, 1, 16, 261)[0]
    canon, _, valid = km.extract_canonical_kmers(
        torch.from_numpy(bases), torch.from_numpy(lengths), k1)
    got, ok = reads_entry_model(bases, lengths, k1)
    np.testing.assert_array_equal(ok, valid.numpy())
    assert ok.sum() > 100
    np.testing.assert_array_equal(got[ok].astype(np.int64),
                                  canon.numpy()[ok])


@pytest.mark.parametrize("nl", [1, 3, 5, 6, 8])
def test_table_is_one_record_a_slot(nl):
    """fp, payload and counts are views of one (C, W) int32 tensor, 32-byte
    aligned, W = 8 words (one 32-byte sector) up to nl = 5, 16 after."""
    t = TCounter(10, nl, device="cpu")
    W = 8 if nl <= 5 else 16
    assert t.table.shape == (1024, W) and t.table.dtype == torch.int32
    assert t.table.is_contiguous() and t.table.data_ptr() % 32 == 0
    base = t.table.data_ptr()
    assert t.fp.data_ptr() == base and t.fp.shape == (2, 1024)
    assert t.payload.data_ptr() == base + 8 and t.payload.shape == (nl, 1024)
    assert t.counts.data_ptr() == base + 4 * (2 + nl)
    assert t.fp.stride() == t.payload.stride() == (1, W)
    assert (t.table[:, :2 + nl] == -1).all() and (t.counts == 0).all()
    keys = np.random.default_rng(nl).integers(0, 2**32, (50, nl),
                                              dtype=np.uint32)
    t.insert(np.concatenate([keys, keys[:10]]), np.ones(60, bool))
    assert int(t.table[:, 2 + nl].sum()) == 60 == int(t.counts.sum())
    rows = t.table[t.counts > 0]
    assert (rows[:, 0] != -1).all() and (rows[:, 2 + nl] >= 1).all()
    assert devhash.record_words(nl) == W


def test_kernel_wrapper_refuses_bad_tensors():
    """The kernel's wrappers check types before any launch (they never
    fall back to the plain version): the rows entry takes int64 limbs,
    the reads entry uint8 codes and k1 <= 128, the check entry int64."""
    t = TCounter(6, 2, device="cpu")
    words = torch.zeros((3, 2), dtype=torch.int32)
    ones = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="kmers"):
        devhash.insert_kernel(t.table, 2, words, ones, t.ovf)
    with pytest.raises(ValueError, match="table"):
        devhash.insert_kernel(t.table[:, :6], 2, words.long(), ones, t.ovf)
    lengths = torch.full((3,), 40, dtype=torch.int32)
    with pytest.raises(ValueError, match="bases"):
        devhash.count_reads_kernel(t.table, 2, torch.zeros((3, 40)), lengths,
                                   31, t.ovf)
    codes = torch.zeros((3, 200), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k1"):
        devhash.count_reads_kernel(TCounter(6, 9, device="cpu").table, 9,
                                   codes, lengths, 129, t.ovf)
    with pytest.raises(ValueError, match="k1"):
        devhash.count_reads_kernel(t.table, 2, codes, lengths, 33, t.ovf)
    with pytest.raises(ValueError, match="kmers"):
        devhash.kernel_hashes(words, 64)


def test_counter_on_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TCounter(10, 2)


@pytest.fixture(scope="module")
def reads():
    genome = jt.random_genome(3000, seed=5)
    return jt.sim_reads(genome, coverage=20.0, read_len=100, seed=8)


def test_hash_engine_matches_np_engine(reads, monkeypatch):
    monkeypatch.setenv("TA_HASH_CAP_LOG2", "18")
    r, ln = reads
    ke1, c1 = j_count(r, ln, 31, engine="np")
    ke2, c2 = t_count(r, ln, 31, engine="hash", device="cpu")
    ke3, c3 = t_count(r, ln, 31, engine="megasort", device="cpu")
    for a, b in ((ke1, ke2), (c1, c2), (ke1, ke3), (c1, c3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["hash", "device", "np", "megasort",
                                    "auto"])
def test_engine_matches_jax(reads, engine, monkeypatch):
    monkeypatch.setenv("TA_HASH_CAP_LOG2", "18")
    r, ln = reads
    # several batches with a short tail, and a min_count filter
    want = j_count(r, ln, 31, batch_size=256, min_count=2, engine=engine)
    got = t_count(r, ln, 31, batch_size=256, min_count=2, engine=engine,
                  device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 1000


def test_unknown_engine_raises(reads):
    with pytest.raises(ValueError, match="engine"):
        t_count(*reads, 31, engine="kmc", device="cpu")
