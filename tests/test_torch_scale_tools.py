"""The count's batch coalescing and the port's scale tools
(turingassembler_tpu_torch/tools/) against the JAX package.

(a) kmer.megasort._coalesce_batches == the JAX function on seeded
ragged streams; (b) the count through it == the JAX count with
records of 1,000 reads in both packages, in memory and spilled; (c) the
E. coli twin's genome and FASTQ bytes == the JAX tool's; (d) the twin's
main on the CPU at 60 kbp (report keys, exit code = gates); (e) the spill
twin at 20,000 pairs: archive checks, a count that really spilled, equal
tables; and the JAX spill tool's count budget, which spills nothing.

Inputs from numpy seeds; exact equality throughout.
"""

import importlib.util
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from turingassembler_tpu.kmer import megasort as jms
from turingassembler_tpu_torch import logging_utils
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.kmer import megasort as tms
from turingassembler_tpu_torch.tools import ecoli_scale, spill_scale

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ragged(seed, sizes, widths):
    """Host batches of the given row counts and widths: codes 0-3 and
    some 255, lengths 0..width."""
    rng = np.random.default_rng(seed)
    out = []
    for n, w in zip(sizes, widths):
        b = rng.integers(0, 4, (n, w)).astype(np.uint8)
        b[rng.random((n, w)) < 0.01] = 255
        out.append((b, rng.integers(0, w + 1, n).astype(np.int32)))
    return out


STREAMS = {
    "mixed_widths": ([300, 500, 200, 700, 90], [96, 152, 120, 152, 64]),
    "exact_multiple": ([250, 250, 500], [100, 100, 100]),
    "tail": ([400, 400, 333], [128, 136, 128]),
    "batch_over_target": ([2_345, 10], [152, 80]),
    "empty": ([], []),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_coalesce_batches_equals_jax(name):
    """Every record equals the JAX one; the tail record is the JAX tail
    without its pad rows (255 bases, length 0)."""
    batches = ragged(len(name), *STREAMS[name])
    want = list(jms._coalesce_batches(iter(batches), 500))
    got = list(tms._coalesce_batches(iter(batches), 500))
    n_reads = sum(STREAMS[name][0])
    assert len(got) == len(want) == -(-n_reads // 500)
    assert sum(len(gb) for gb, _ in got) == n_reads
    for (gb, gl), (wb, wl) in zip(got, want):
        n = len(gb)
        assert n == len(gl) and len(wb) == 500
        np.testing.assert_array_equal(gb, wb[:n])
        np.testing.assert_array_equal(gl, wl[:n])
        assert (wb[n:] == 255).all() and (wl[n:] == 0).all()
        assert gb.dtype == wb.dtype == np.uint8
        assert gl.dtype == wl.dtype == np.int32
    assert all(len(gb) == 500 for gb, _ in got[:-1])


def count_batches(seed=5):
    """Reads of a 30 kbp genome with errors, in ragged batches of two
    widths."""
    genome = tt.random_genome(30_000, seed=seed)
    reads, lengths = tt.sim_reads(genome, coverage=12, read_len=100,
                                  seed=seed + 1, error_rate=0.005)
    out, lo, rng = [], 0, np.random.default_rng(seed)
    while lo < len(reads):
        n = int(rng.integers(200, 700))
        b, ln = reads[lo:lo + n], lengths[lo:lo + n]
        if len(out) % 2:                 # a wider batch, padded with 255
            b = np.concatenate([b, np.full((len(b), 24), 255, np.uint8)], 1)
        out.append((b, ln))
        lo += n
    return out


@pytest.mark.parametrize("spilled", [False, True])
def test_count_through_records_equals_jax(spilled, tmp_path, monkeypatch):
    monkeypatch.setenv("TA_COUNT_CHUNK", "1000")      # the JAX count's
    monkeypatch.setattr(tms, "COUNT_CHUNK", 1000)
    batches = count_batches()
    kw = {}
    if spilled:
        kw = dict(device_lanes=20_000, host_mb=0.5,
                  spill_dir=str(tmp_path / "port"))
        monkeypatch.setenv("TA_SORT_DEVICE_LANES", "20000")
        monkeypatch.setenv("TA_SORT_HOST_MB", "0.5")
        monkeypatch.setenv("TA_SPILL_DIR", str(tmp_path / "jax"))
    want_k, want_c = jms.count_kedges_megasort(iter(batches), 31,
                                               min_count=2, out_cap_log2=17)
    stats = {}
    got_k, got_c = tms.count_kedges_megasort(iter(batches), 31, min_count=2,
                                             device="cpu", stats=stats,
                                             **kw)
    np.testing.assert_array_equal(np.asarray(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))
    assert stats["records"] == -(-sum(len(b) for b, _ in batches) // 1000)
    if spilled:
        assert stats["host_runs"] >= 1 and stats["disk_runs"] >= 1
        assert os.listdir(tmp_path / "jax")
    else:
        assert stats["host_runs"] == stats["disk_runs"] == 0


def test_count_chunk_is_the_jax_default(monkeypatch):
    """With TA_COUNT_CHUNK unset the JAX count joins its batches into
    records of COUNT_CHUNK reads, and count_reads_device cuts its reads
    into chunks of as many."""
    monkeypatch.delenv("TA_COUNT_CHUNK", raising=False)
    targets = []
    real = jms._coalesce_batches

    def spy(batches, target_reads):
        targets.append(target_reads)
        return real(batches, target_reads)

    monkeypatch.setattr(jms, "_coalesce_batches", spy)
    jms.count_kedges_megasort(iter(ragged(1, [40], [64])), 21,
                              out_cap_log2=12)
    assert targets == [tms.COUNT_CHUNK]
    default = inspect.signature(tms.count_reads_device).parameters[
        "chunk_reads"].default
    assert default == tms.COUNT_CHUNK


@pytest.mark.parametrize("harsh", [False, True])
def test_ecoli_library_bytes_equal_jax(harsh, tmp_path, monkeypatch):
    jtool = jax_tool("ecoli_scale")
    for mod in (jtool, ecoli_scale):
        monkeypatch.setattr(mod, "N_MOLECULES", 50)
    genome = ecoli_scale.build_genome(11)
    np.testing.assert_array_equal(genome, jtool.build_genome(11))
    rates = (0.005, 0.10, 0.03) if harsh else (0.002, 0.0, 0.0)
    want, n_want = jtool.write_library(str(tmp_path / "jax"), genome,
                                       *rates, 12)
    got, n_got = ecoli_scale.write_library(str(tmp_path / "port"), genome,
                                           *rates, 12)
    assert n_got == n_want == 50 * ecoli_scale.READS_PER_MOL
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), os.path.basename(g)


def test_fastq_block_equals_fstrings():
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for first, n in ((0, 0), (0, 1), (7, 25), (99_990, 40)):
        seqs = acgt[rng.integers(0, 4, (n, 11))]
        want = "".join(f"@r{first + j}\n{seqs[j].tobytes().decode()}\n+\n"
                       f"{'I' * 11}\n" for j in range(n)).encode()
        assert tt.fastq_block(first, seqs) == want


ADDED_KEYS = {"device_name", "nw", "peak_device_memory_gib", "peak_rss_gib"}


def test_ecoli_main_on_cpu(tmp_path, monkeypatch):
    """At 60 kbp (a plain random genome, 462 molecules: 37x) the twin's
    report has the JAX report's keys (ECOLI_r05.json, written by the JAX
    tool) plus the port's, and its exit code is the gates' verdict."""
    monkeypatch.setattr(ecoli_scale, "GENOME_SIZE", 60_000)
    monkeypatch.setattr(ecoli_scale, "build_genome",
                        lambda seed=11: tt.random_genome(60_000, seed=seed))
    monkeypatch.setattr(ecoli_scale, "N_MOLECULES", 462)
    report = tmp_path / "report.json"
    # a stage an earlier run left open stays out of the report
    logging_utils.set_log_stage("build_4_5")
    rc = ecoli_scale.main(["--cpu", "--out", str(tmp_path / "run"),
                           "--report", str(report)])
    with open(report) as fp:
        got = json.load(fp)
    with open(os.path.join(ROOT, "ECOLI_r05.json")) as fp:
        jax_report = json.load(fp)
    assert set(got) == set(jax_report) | ADDED_KEYS
    for part in ("dataset", "result", "reference_published"):
        assert set(got[part]) == set(jax_report[part])
    assert got["backend"] == got["device_name"] == "cpu"
    assert got["peak_device_memory_gib"] is None
    assert got["nw"] == {"launches": 0, "pairs": 0}
    assert got["peak_rss_gib"] > 0
    assert got["dataset"]["n_pairs"] == 462 * ecoli_scale.READS_PER_MOL
    assert {"build_0", "build_bridge", "readpair_extend"} <= set(
        got["walls_s"])
    assert "build_4_5" not in got["walls_s"]
    assert got["result"]["n_misassemblies"] == 0
    res = types.SimpleNamespace(**got["result"])
    assert rc == (0 if ecoli_scale.gates_hold(res, False) else 1)
    with open(tmp_path / "run" / "asm" / "scaffold.full.fasta") as fp:
        assert fp.read().startswith(">")


def test_ecoli_gates():
    g = ecoli_scale.GENOME_SIZE
    good = dict(n_misassemblies=0, genome_fraction=0.99, nga50=0.9 * g,
                mismatches_per_100kbp=5.65, indels_per_100kbp=0.47)
    assert ecoli_scale.gates_hold(types.SimpleNamespace(**good), False)
    for key, bad in (("n_misassemblies", 1), ("genome_fraction", 0.9899),
                     ("nga50", 0.9 * g - 1),
                     ("mismatches_per_100kbp", 5.66),
                     ("indels_per_100kbp", 0.48)):
        res = types.SimpleNamespace(**dict(good, **{key: bad}))
        assert not ecoli_scale.gates_hold(res, False), key
    wide = types.SimpleNamespace(**dict(good, mismatches_per_100kbp=11.3,
                                        indels_per_100kbp=0.94))
    assert ecoli_scale.gates_hold(wide, True)
    assert not ecoli_scale.gates_hold(wide, False)


def test_spill_tool_really_spills(tmp_path):
    report = tmp_path / "report.json"
    rc = spill_scale.main([
        "--pairs", "20000", "--count-pairs", "10000", "--sort-budget-mb",
        "1", "--count-budget-mb", "16", "--out", str(tmp_path / "lib"),
        "--report", str(report), "--device", "cpu"])
    assert rc == 0
    assert "TA_SORT_MEM_BYTES" not in os.environ
    with open(report) as fp:
        rep = json.load(fp)
    assert rep["n_pairs"] == 20_000
    assert rep["sort"]["verified_barcodes_structural"] == 512
    assert rep["sort"]["verified_barcodes_content"] == 32
    assert rep["sort"]["runs"] >= 2
    ab = rep["count_ab"]
    assert ab["reads"] == 20_000 and ab["equal"] is True
    assert ab["host_runs"] >= 2 and ab["disk_runs"] >= 1
    assert os.listdir(tmp_path / "lib" / "count_spill")


def test_jax_spill_tool_count_budget_spills_nothing(tmp_path, monkeypatch):
    """The JAX tool's count A/B sets only TA_SORT_HOST_MB (and
    TA_SPILL_DIR): the JAX count then keeps its table on the device and
    writes no run, however small the budget.  The twin's budget (a
    device budget beside the host one) leaves disk runs on the same
    reads."""
    genome = tt.random_genome(50_000, seed=8)
    reads, lengths = tt.sim_reads(genome, coverage=6, read_len=120, seed=9)
    batches = [(reads[i:i + 2048], lengths[i:i + 2048])
               for i in range(0, len(reads), 2048)]
    monkeypatch.setenv("TA_SORT_HOST_MB", "0.001")
    monkeypatch.setenv("TA_SPILL_DIR", str(tmp_path / "jax"))
    want_k, want_c = jms.count_kedges_megasort(iter(batches), 45,
                                               out_cap_log2=17)
    assert not (tmp_path / "jax").exists()
    stats = {}
    got_k, got_c = tms.count_kedges_megasort(
        iter(batches), 45, device_lanes=max(len(want_k) // 5, 1),
        host_mb=0.001, spill_dir=str(tmp_path / "port"), device="cpu",
        stats=stats)
    assert stats["disk_runs"] >= 1
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
    np.testing.assert_array_equal(np.asarray(got_c), want_c)
