"""A bench with the test-only cells over asmbench/tests/data."""

from __future__ import annotations

import copy

from asmbench import spec

DATA = spec.HERE / "tests" / "data"
ROOTS = (DATA, spec.HERE)
SEED = 2 ** 31 + 11


def bench() -> dict:
    b = copy.deepcopy(spec.benchmark())
    b["workloads"] += [
        {"name": "tiny.level0", "config": "tiny", "traffic": "level0",
         "chips": 1, "why": "test"},
        {"name": "tiny.aux_map", "config": "tiny", "traffic": "aux_map",
         "chips": 1, "why": "test"},
        {"name": "small.level0", "config": "small", "traffic": "level0",
         "chips": 1, "why": "test"}]
    for m in b["per_layer"]:
        m.pop("workloads", None)
    return b
