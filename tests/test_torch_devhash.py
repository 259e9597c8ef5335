"""The port's hash counter (ops/devhash.py) and the engines of
kmer/count.py against the JAX package's.

The cases of tests/test_devhash.py run through both packages on the same
numpy-seeded keys: the oracle, overflow (both raise), and same-round
claim collisions at 0.4 load.  On the CPU the port runs the plain
version (probe rounds); csrc/devhash.cu is held against it on the card
by chip_smoke.py, phase 14.  Then every `engine=` of the port against
the same JAX engine on one read set ("auto" is megasort in the port and
"np" in the JAX package on its CPU backend: the same arrays), and the
hash engine against the JAX np engine and the port's megasort.
Tolerance: exact equality of the finalized (keys, counts), dtypes too.
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.kmer.count import count_kedges_from_reads as j_count
from turingassembler_tpu.ops.devhash import DeviceHashCounter as JCounter
from turingassembler_tpu_torch.kmer.count import \
    count_kedges_from_reads as t_count
from turingassembler_tpu_torch.ops import devhash
from turingassembler_tpu_torch.ops.devhash import DeviceHashCounter as TCounter


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


def test_hash_counter_oracle():
    rng = np.random.default_rng(0)
    nl = 3
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


def test_kernel_wrapper_refuses_bad_tensors():
    """The kernel's wrapper checks types before any launch (it never
    falls back to the plain version)."""
    t = TCounter(6, 2, device="cpu")
    words = torch.zeros((3, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="words"):
        devhash.insert_kernel(t.fp, t.payload, t.counts, words,
                              torch.ones(3, dtype=torch.bool),
                              torch.zeros((4, 3), dtype=torch.int32), t.ovf)


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
