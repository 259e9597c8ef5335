"""The port's two top-level entry points against the JAX package's: the
bench twin (turingassembler_tpu_torch/bench.py, twin of bench.py) and the
graft twin (turingassembler_tpu_torch/graft_entry.py, twin of
__graft_entry__.py).

(a) bench.make_workload == bench.py's genome and reads, byte for byte;
(b) the bench chain (count + build, then the verified map from the
count's device tensors) on the CPU == the JAX count_reads_device +
build_graph_on_device + map_reads(graph=g); (c) the bench twin's main on
the CPU at a small size prints one JSON line with bench.py's keys plus
the device and the NW counts, and its stderr the NW launches' shapes;
(d) without a GPU its default device raises and prints nothing; (e) entry("cpu")'s forward == the JAX
entry()'s jitted forward; (f) dryrun_multichip(2, "cpu") prints the JAX
dryrun_multichip(2)'s line (conftest's virtual CPU devices), figure for
figure; (g) on one device the JAX dryrun fails its own first check (a
roomy cap of 256 short of the 264 k-mers one device routes), the
port's passes.

Inputs from numpy seeds; exact equality throughout.
"""

import importlib.util
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.device_build import \
    build_graph_on_device as j_build
from turingassembler_tpu.kmer.megasort import count_reads_device as j_count
from turingassembler_tpu.kmer.megasort import pull_rows
from turingassembler_tpu.mapper import minimizers as jm
from turingassembler_tpu_torch import bench, graft_entry
from turingassembler_tpu_torch.mapper import minimizers as tm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N_READS, K = 20_000, 2_048, 45
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "value_count_build",
              "vs_baseline_count_build", "weather"}
WEATHER_KEYS = {"compile_warmup_s", "count_s", "build_s", "map_s"}
GRAPH_FIELDS = ("edge_source", "edge_target", "edge_rc", "edge_count",
                "seq_off", "seq_data", "node_rc", "adj_off", "adj_list")


def jax_graft():
    """The JAX package's __graft_entry__.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_workload_matches_jax():
    genome, reads, lengths = bench.make_workload(G, N_READS)
    jg = jt.random_genome(G, seed=0)
    jr, jl = jt.sim_reads(jg, coverage=N_READS * 150 / G, read_len=150,
                          seed=1, pad_to=152)
    np.testing.assert_array_equal(genome, jg)
    assert reads.shape == (N_READS, 152) and reads.dtype == np.uint8
    assert lengths.dtype == np.int32
    assert reads.tobytes() == jr[:N_READS].tobytes()
    assert lengths.tobytes() == jl[:N_READS].astype(np.int32).tobytes()


def test_bench_chain_matches_jax():
    genome, reads, lengths = bench.make_workload(G, N_READS)
    stage = bench.Stages("cpu")
    u, c, n, shipped, g = bench.count_and_build(stage, reads, lengths, K)
    idx = stage("index", lambda: tm.EdgeMinimizerIndex.build(g,
                                                             device="cpu"))
    e, s = bench.map_shipped(stage, idx, reads, lengths, g, shipped)
    assert set(stage.seconds) == {"count", "build", "index", "map"}

    ju, jc, jn = j_count(reads, lengths, K, out_cap_log2=17)
    assert n == jn
    np.testing.assert_array_equal(u.numpy(),
                                  pull_rows(ju, jn).astype(np.int64))
    np.testing.assert_array_equal(c.numpy(), pull_rows(jc, jn))
    gj = j_build(ju, jc, jn, K)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(gj, f),
                                      err_msg=f)
    je, _, js = jm.map_reads(jm.EdgeMinimizerIndex.build(gj), reads,
                             lengths, graph=gj)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(s, js)
    assert bench.check_outputs(genome, g, e, s)[1] >= 0.99


def test_bench_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("TA_BENCH_GENOME", "20000")
    monkeypatch.setenv("TA_BENCH_BATCH", "256")
    monkeypatch.setenv("TA_BENCH_NBATCHES", "4")
    assert bench.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    out = cap.out.splitlines()
    # every NW launch of the map passes: none, the CPU scores the pairs
    # through the plain version
    assert [ln for ln in cap.err.splitlines()
            if ln.startswith("nw shapes: ")] == ["nw shapes: []"]
    assert len(out) == 1
    line = json.loads(out[-1])
    assert set(line) == BENCH_KEYS | {"device", "nw_launches", "nw_pairs"}
    assert set(line["weather"]) == WEATHER_KEYS
    assert line["metric"] == (
        "reads/s (k45 count + level-0 DBG build + DP-verified read->edge "
        "map, 150bp reads, CPU)")
    assert line["device"] == "cpu" and line["unit"] == "reads/s"
    assert (line["nw_launches"], line["nw_pairs"]) == (0, 0)
    w = line["weather"]
    assert 1 <= len(w["count_s"]) == len(w["build_s"]) <= 5
    assert len(w["map_s"]) == 3
    assert line["value"] > 0 and line["value_count_build"] > line["value"]
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / 38_135.593, abs=1e-3)


def test_bench_main_raises_without_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_entry_matches_jax():
    fwd, (bases, lengths) = graft_entry.entry("cpu")
    u, c, n = fwd(bases, lengths)
    jfwd, jargs = jax_graft().entry()
    ju, jc, jn = jax.block_until_ready(jfwd(*jargs))
    np.testing.assert_array_equal(bases.numpy(), jargs[0])
    np.testing.assert_array_equal(lengths.numpy(), jargs[1])
    n = int(n)
    assert n == int(jn) > 0
    np.testing.assert_array_equal(u[:n].numpy(),
                                  np.asarray(ju)[:n].astype(np.int64))
    np.testing.assert_array_equal(c[:n].numpy(), np.asarray(jc)[:n])


FIGURES = re.compile(
    r"dryrun_multichip\((\d+)\): ok — (\d+) k-mers routed, (\d+) unique "
    r"\(sort engine\) / (\d+) unique \(hash engine\); overflow-regrow "
    r"exercised \((\d+) doublings.*sharded map: (\d+)/(\d+) voted, (\d+) "
    r"DP-verified.*skew stage: (\d+) k-mers \((\d+) unique, top-128 keys "
    r"carry (\d+)% of mass\)")
NAMES = ("routed", "unique_sort", "unique_hash", "regrow", "voted",
         "reads_mapped", "verified", "skew_routed", "skew_unique", "hot_pct")


def test_dryrun_multichip_matches_jax(capsys):
    jax_graft().dryrun_multichip(2)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = graft_entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == jax_line
    m = FIGURES.fullmatch(jax_line.split(", sharded == host oracle")[0])
    assert m and int(m.group(1)) == 2
    assert got == dict(zip(NAMES, map(int, m.groups()[1:])))
    assert got["regrow"] >= 1 and got["verified"] > 0


def test_dryrun_one_device():
    """The JAX function fails its first check on one device; the port's
    roomy cap holds all 264 k-mers and every stage passes."""
    with pytest.raises(AssertionError):
        jax_graft().dryrun_multichip(1)
    got = graft_entry.dryrun_multichip(1, device="cpu")
    assert got["routed"] == got["unique_sort"] == got["unique_hash"] == 264
    assert got["regrow"] >= 1 and got["voted"] == got["reads_mapped"] == 4
    assert got["skew_routed"] == 1024 * (152 - 31) and got["hot_pct"] >= 20
