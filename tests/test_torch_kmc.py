"""The port's KMC database interop (io/kmc.py, a copy of the JAX module)
against the JAX package's.

For the legacy (kmer_type 0) and the KMC2 (0x200) layouts: the port
writes and JAX reads, JAX writes and the port reads, and both writers'
files are byte-identical; load_kedges_from_kmc gives the JAX arrays and,
on a database written from the port's own count, that count.  Inputs are
numpy-seeded.  Tolerance: exact, byte for byte.
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.io import kmc as jkmc
from turingassembler_tpu_torch.io import kmc as tkmc
from turingassembler_tpu_torch.kmer.count import count_kedges_from_reads
from turingassembler_tpu_torch.ops import limbs as lb

torch.set_num_threads(1)


def sorted_kmers(n, k, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (2 * n, k)).astype(np.uint8)
    v = np.ascontiguousarray(codes).view([("", np.uint8)] * k).ravel()
    order = np.argsort(v, kind="stable")
    codes, v = codes[order], v[order]
    keep = np.ones(len(v), bool)
    keep[1:] = v[1:] != v[:-1]
    codes = codes[keep][:n]
    return codes, rng.integers(1, 1000, len(codes)).astype(np.int64)


def files(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".kmc_pre", ".kmc_suf")]


@pytest.mark.parametrize("variant", [0, 0x200])
@pytest.mark.parametrize("k,n,p", [(46, 3000, None), (30, 800, 6),
                                   (21, 500, None)])
def test_kmc_both_ways(tmp_path, variant, k, n, p):
    codes, counts = sorted_kmers(n, k, seed=k)
    pt, pj = str(tmp_path / "port"), str(tmp_path / "jax")
    tkmc.write_kmc_database(codes, counts, pt, lut_prefix_length=p,
                            variant=variant)
    jkmc.write_kmc_database(codes, counts, pj, lut_prefix_length=p,
                            variant=variant)
    assert files(pt) == files(pj)
    for reader, path in ((jkmc.read_kmc_database, pt),
                         (tkmc.read_kmc_database, pj)):
        c, n_, info = reader(path)
        np.testing.assert_array_equal(c, codes)
        np.testing.assert_array_equal(n_, counts)
        assert info["kmer_length"] == k and info["total_kmers"] == len(codes)
    want = jkmc.load_kedges_from_kmc(pj)
    got = tkmc.load_kedges_from_kmc(pt)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] == k - 1


def test_kmc_unsorted_input_and_bad_prefix(tmp_path):
    codes, counts = sorted_kmers(400, 22, seed=3)
    perm = np.random.default_rng(4).permutation(len(codes))
    pt, pj = str(tmp_path / "port"), str(tmp_path / "jax")
    tkmc.write_kmc_database(codes[perm], counts[perm], pt)
    jkmc.write_kmc_database(codes[perm], counts[perm], pj)
    assert files(pt) == files(pj)
    np.testing.assert_array_equal(tkmc.read_kmc_database(pt)[0], codes)
    for mod in (tkmc, jkmc):
        with pytest.raises(ValueError, match="divisible"):
            mod.write_kmc_database(codes, counts, pt, lut_prefix_length=5)


def test_kmc_round_trip_of_the_port_count(tmp_path):
    genome = jt.random_genome(4000, seed=9)
    reads, lengths = jt.sim_reads(genome, coverage=15.0, read_len=100, seed=10)
    k = 45
    kedges, counts = count_kedges_from_reads(reads, lengths, k, device="cpu")
    path = str(tmp_path / "KMC_46_count")
    tkmc.write_kmc_database(lb.np_unpack_limbs(kedges, k + 1), counts, path)
    ke, c, k_back = tkmc.load_kedges_from_kmc(path)
    assert k_back == k
    np.testing.assert_array_equal(ke, kedges)
    np.testing.assert_array_equal(c, counts)
