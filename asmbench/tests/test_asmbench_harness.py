"""Whole runs of the harness on the CPU at a test size (the card's look
skipped), the result line's keys, what the runs load, and the control
and the planted faults coming out as not correct."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import asmbench_helpers as h
from asmbench import control, harness, spec

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(cell, traced=False, seconds=0.5):
    return harness.run(cell, h.SEED, seconds, traced, device="cpu",
                       bench=h.bench(), roots=h.ROOTS)


@pytest.mark.parametrize("cell", ["tiny.level0", "tiny.aux_map"])
def test_result_line_has_the_required_keys(cell):
    r = run(cell)
    assert list(r) == LINE_KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"reads_per_s", "job_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_drift_gives_each_part_its_median_and_the_spread():
    walls = [0.125] * 8 + [0.25] * 4          # back to back, 2 s in all
    starts = [sum(walls[:i]) for i in range(len(walls))]
    line = harness.drift(starts, walls, parts=4)
    assert "(ms): 125.0 125.0 250.0 250.0;" in line
    assert line.endswith("quartile spread 100.00% of the median")
    assert " - " in harness.drift([0.0, 1.9], [0.1, 0.1])


def test_traced_line_carries_the_per_layer_metrics():
    r = run("tiny.level0", traced=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert {"count_ms", "build_ms"} <= set(r["metrics"])
    assert "reads_per_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["correct"] is True


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.HERE / 'tests')!r}]
import asmbench_helpers as h
from asmbench import harness
r = harness.run("tiny.aux_map", h.SEED, 0.2, False, device="cpu",
                bench=h.bench(), roots=h.ROOTS)
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "turingassembler_tpu"}}),
      harness.forbidden_modules(), r["correct"])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "[] [] True"


def imports_of(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "turingassembler_tpu"}
    for p in spec.HERE.rglob("*.py"):
        for name in imports_of(p):
            assert name.split(".")[0] not in bad, (p, name)


def test_the_reference_imports_nothing_of_the_program():
    for p in (spec.HERE / "reference").rglob("*.py"):
        for name in imports_of(p):
            assert name.split(".")[0] in {
                "__future__", "collections", "dataclasses", "math",
                "numpy", "torch"}, (p, name)


def test_run_gives_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = subprocess.run(
        [sys.executable, "asmbench/run.py", "--workload", "ecoli.level0",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


# the level-0 control merges (k+1)-mers whose 32-bit fingerprints meet:
# a library needs some 10^5 of them before two are sure to, hence the
# larger configuration there
@pytest.mark.parametrize("cell,control_cell", [
    ("tiny.level0", "small.level0"), ("tiny.aux_map", "tiny.aux_map")])
def test_control_fails_and_the_program_passes(cell, control_cell):
    r = control.reading(control_cell, h.SEED + 1, device="cpu",
                        bench=h.bench(), roots=h.ROOTS)
    assert any(r["numbers"][n] > r["limits"][n] for n in r["limits"]), r
    r = harness.run(cell, h.SEED + 1, 0.3, False, device="cpu",
                    bench=h.bench(), roots=h.ROOTS)
    assert r["correct"] is True, r["checks"]


def _half_of_the_batches(orig):
    def count(batches, *a, **kw):
        return orig([b for i, b in enumerate(batches) if i % 2 == 0],
                    *a, **kw)
    return count


def _one_count_altered(orig):
    def count(*a, **kw):
        u, c, n = orig(*a, **kw)
        c = c.clone()
        c[n // 2] += 1
        return u, c, n
    return count


def _first_answer_kept(orig):
    first = []

    def call(*a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0]
    return call


def _half_of_the_reads(orig):
    def map_reads(index, bases, lengths, *a, **kw):
        e, hits, s = orig(index, bases, lengths, *a, **kw)
        e, s = e.copy(), s.copy()
        e[len(e) // 2:], s[len(s) // 2:] = -1, -1
        return e, hits, s
    return map_reads


def _one_read_altered(orig):
    def map_reads(*a, **kw):
        e, hits, s = orig(*a, **kw)
        e = e.copy()
        i = int((e >= 0).argmax())
        e[i] = e[i] + 1 if e[i] > 0 else 1
        return e, hits, s
    return map_reads


FAULTS = [
    ("tiny.level0", "kmer.megasort", "count_kedges_megasort_device",
     _half_of_the_batches),
    ("tiny.level0", "kmer.megasort", "count_kedges_megasort_device",
     _one_count_altered),
    ("tiny.level0", "kmer.megasort", "count_kedges_megasort_device",
     _first_answer_kept),
    ("tiny.level0", "graph.device_build", "build_graph_on_device",
     _first_answer_kept),
    ("tiny.aux_map", "mapper.minimizers", "map_reads", _half_of_the_reads),
    ("tiny.aux_map", "mapper.minimizers", "map_reads", _one_read_altered),
    ("tiny.aux_map", "mapper.minimizers", "map_reads", _first_answer_kept),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, module,
                                                  name, fault):
    import importlib
    mod = importlib.import_module("turingassembler_tpu_torch." + module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = run(cell)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "asmbench/run.py", "--workload", "ecoli.level0",
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
