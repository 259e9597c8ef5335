"""The out-of-core branch of the port's k-mer count (device table ->
host runs -> disk runs -> external merge) against the in-memory count
and against the JAX package, and the numpy run merges against the JAX
package's.

Inputs from numpy seeds, the same batches into both packages,
device="cpu" on the port's side.  Tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from turingassembler_tpu.kmer import megasort as jms
from turingassembler_tpu.ops import sortops as jso
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.kmer import megasort as tms
from turingassembler_tpu_torch.ops import sortops as tso

torch.set_num_threads(1)

K = 31


def read_batches(seed, n_batch=512):
    genome = tt.random_genome(20_000, seed=seed)
    reads, lengths = tt.sim_reads(genome, coverage=8, read_len=100,
                                  seed=seed + 1, error_rate=0.005)
    return [(reads[i:i + n_batch], lengths[i:i + n_batch])
            for i in range(0, len(reads), n_batch)]


@pytest.fixture(scope="module")
def batches():
    return read_batches(9)


@pytest.fixture(scope="module")
def in_memory(batches):
    """The port's in-memory table at min count 1 and 2, as host arrays."""
    return {mc: tms.count_kedges_megasort(iter(batches), K, min_count=mc,
                                          max_lanes=1 << 15, device="cpu")
            for mc in (1, 2)}


def test_in_memory_equals_jax(batches, in_memory):
    want_k, want_c = jms.count_kedges_megasort(iter(batches), K, min_count=2,
                                               max_lanes=1 << 15,
                                               out_cap_log2=17)
    np.testing.assert_array_equal(in_memory[2][0], want_k)
    np.testing.assert_array_equal(in_memory[2][1], want_c)
    assert in_memory[2][0].dtype == want_k.dtype == np.uint32
    assert in_memory[2][1].dtype == want_c.dtype == np.int64


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("device_lanes", [4096, 20_000])
def test_host_runs_equal_in_memory(batches, in_memory, device_lanes,
                                   min_count, tmp_path):
    """A device budget and no host budget: runs stay in RAM."""
    spill = tmp_path / "spill"
    got_k, got_c = tms.count_kedges_megasort(
        iter(batches), K, min_count=min_count, max_lanes=1 << 15,
        device_lanes=device_lanes, spill_dir=str(spill), device="cpu")
    np.testing.assert_array_equal(got_k, in_memory[min_count][0])
    np.testing.assert_array_equal(got_c, in_memory[min_count][1])
    assert got_k.dtype == np.uint32 and got_c.dtype == np.int64
    assert not spill.exists()


@pytest.mark.parametrize("min_count", [1, 2])
def test_disk_runs_equal_in_memory(batches, in_memory, min_count, tmp_path):
    """Tiny device and host budgets: at least two runs on disk, merged by
    the external k-way merge into disk memmaps; row for row the
    in-memory table."""
    spill = tmp_path / "spill"
    got_k, got_c = tms.count_kedges_megasort(
        iter(batches), K, min_count=min_count, max_lanes=1 << 15,
        device_lanes=4096, host_mb=0.05, spill_dir=str(spill), device="cpu")
    runs = [f for f in os.listdir(spill) if f.startswith("count_run")
            and f.endswith("_keys.npy")]
    assert len(runs) >= 2
    assert isinstance(got_k, np.memmap)
    np.testing.assert_array_equal(np.asarray(got_k), in_memory[min_count][0])
    np.testing.assert_array_equal(np.asarray(got_c), in_memory[min_count][1])


def test_disk_runs_equal_jax_spill(batches, in_memory, tmp_path, monkeypatch):
    """The JAX package under the same budgets (it reads them from the
    environment) gives the same table."""
    monkeypatch.setenv("TA_SORT_DEVICE_LANES", "4096")
    monkeypatch.setenv("TA_SORT_HOST_MB", "0.05")
    monkeypatch.setenv("TA_SPILL_DIR", str(tmp_path / "jspill"))
    want_k, want_c = jms.count_kedges_megasort(
        iter(batches), K, min_count=2, max_lanes=1 << 15, out_cap_log2=17)
    assert os.listdir(tmp_path / "jspill")
    np.testing.assert_array_equal(np.asarray(want_k), in_memory[2][0])
    np.testing.assert_array_equal(np.asarray(want_c), in_memory[2][1])


def test_device_form_returns_host_pair_only_when_spilled(batches, in_memory):
    res = tms.count_kedges_megasort_device(
        iter(batches), K, min_count=2, max_lanes=1 << 15, device="cpu")
    assert len(res) == 3 and isinstance(res[0], torch.Tensor)
    assert res[2] == len(in_memory[2][0])
    res = tms.count_kedges_megasort_device(
        iter(batches), K, min_count=2, max_lanes=1 << 15,
        device_lanes=4096, device="cpu")
    assert len(res) == 2 and isinstance(res[0], np.ndarray)
    np.testing.assert_array_equal(res[0], in_memory[2][0])


def test_budget_never_reached_stays_on_device(batches, in_memory):
    res = tms.count_kedges_megasort_device(
        iter(batches), K, max_lanes=1 << 15, device_lanes=1 << 30,
        host_mb=0.001, device="cpu")
    assert len(res) == 3
    np.testing.assert_array_equal(res[0].numpy().astype(np.uint32),
                                  in_memory[1][0])


def test_accumulator_window_bounded_by_device_budget():
    acc = tms._Accumulator(2, 1 << 28, torch.device("cpu"), device_lanes=1000)
    assert acc.flush_lanes == 1000
    acc = tms._Accumulator(2, 1 << 28, torch.device("cpu"))
    assert acc.flush_lanes == 1 << 28


def random_runs(seed, n_runs=5, nl=2, hi=50):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n_runs):
        n = int(rng.integers(50, 400))
        keys = np.unique(rng.integers(0, hi, (n, nl)).astype(np.uint32),
                         axis=0)
        runs.append((keys, rng.integers(1, 9, len(keys)).astype(np.int64)))
    return runs


@pytest.mark.parametrize("seed", [11, 12])
def test_np_merge_count_runs(seed):
    runs = random_runs(seed)
    want = jso.np_merge_count_runs(runs)
    got = tso.np_merge_count_runs(runs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for fn in (jso.np_merge_count_runs, tso.np_merge_count_runs):
        k0, c0 = fn([])
        assert k0.shape == (0, 0) and c0.shape == (0,)


@pytest.mark.parametrize("to_disk", [False, True])
@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("chunk_rows", [7, 64, 1 << 22])
def test_np_external_merge_runs(chunk_rows, min_count, to_disk, tmp_path):
    """Slice boundaries forced tiny so many pivot cuts happen; RAM and
    memmap outputs."""
    runs = random_runs(13, nl=3, hi=12)
    kw = dict(chunk_rows=chunk_rows, min_count=min_count)
    want = jso.np_external_merge_runs(
        runs, out_dir=str(tmp_path / "j") if to_disk else None, **kw)
    got = tso.np_external_merge_runs(
        runs, out_dir=str(tmp_path / "t") if to_disk else None, **kw)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    oracle_k, oracle_c = tso.np_merge_count_runs(runs)
    keep = oracle_c >= min_count
    np.testing.assert_array_equal(np.asarray(got[0]), oracle_k[keep])
    np.testing.assert_array_equal(np.asarray(got[1]), oracle_c[keep])
    if to_disk:
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))


def test_np_external_merge_runs_degenerate():
    empty = (np.zeros((0, 2), np.uint32), np.zeros(0, np.int64))
    for fn in (jso.np_external_merge_runs, tso.np_external_merge_runs):
        k0, c0 = fn([empty])
        assert len(k0) == 0 and len(c0) == 0
    one = random_runs(14, n_runs=1)
    want = jso.np_external_merge_runs(one + [empty])
    got = tso.np_external_merge_runs(one + [empty])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
