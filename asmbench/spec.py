"""Finding a cell's pieces by name.

BENCHMARK.json, at the root of the checkout, names each cell's
configuration and traffic mix and each metric.  Every piece is a file of
its own, found by its name and nothing else, so a new configuration, mix,
entry or per-layer metric is a new file and a new entry in
BENCHMARK.json, never an edit of a file that is there:

  configs/<config>.json     a configuration (sizes, genome, reads)
  traffic/<traffic>.json    a traffic mix, naming its entry
  entries/<entry>.py        what one job of a mix runs
  metrics/<metric>.py       the reader of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _find(kind: str, name: str, suffix: str, roots) -> Path:
    for root in roots:
        p = Path(root) / kind / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                            f"{', '.join(str(r) for r in roots)}")


def load_json(kind: str, name: str, roots=(HERE,)) -> dict:
    """configs/<name>.json or traffic/<name>.json from the first root
    that holds it."""
    with open(_find(kind, name, ".json", roots)) as f:
        return json.load(f)


def load_module(kind: str, name: str, roots=(HERE,)):
    """entries/<name>.py or metrics/<name>.py as a module of its own."""
    path = _find(kind, name, ".py", roots)
    spec = importlib.util.spec_from_file_location(
        f"asmbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: dict, roots=(HERE,)):
    """(cell, configuration, traffic mix, entry module) of a cell."""
    c = cell(name, bench)
    mix = load_json("traffic", c["traffic"], roots)
    return (c, load_json("configs", c["config"], roots), mix,
            load_module("entries", mix["entry"], roots))


def per_layer_metrics(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those whose `workloads`
    names it, or that have no `workloads` key and move an end-to-end
    metric the cell reports (a metric a later benchmark adds without
    the key, which every such cell has to report)."""
    moved = {m["name"] for m in end_to_end_metrics(bench)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def end_to_end_metrics(bench: dict) -> list:
    """Every end-to-end metric: each cell reports them all."""
    return list(bench["end_to_end"])
