"""Carry state from the JAX package into the port, as numpy arrays.

Each function takes the JAX package's objects by their attributes (it
imports nothing of that package) and returns the port's form, so each
stage of the port can be run on exactly the input the JAX package's
previous stage produced.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .graph.structs import AsmGraph
from .mapper.minimizers import EdgeMinimizerIndex

_GRAPH_ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source",
                 "edge_target", "edge_rc", "edge_count", "seq_off",
                 "seq_data")


def kmer_table(uniq, counts, n: int, device: str | torch.device = "cuda"):
    """(uniq (cap, nl) uint32, counts (cap,), n) of the JAX count ->
    the port's (uniq (n, nl) int64, counts (n,) int32, n) on `device`."""
    dev = resolve_device(device)
    u = np.asarray(uniq)[:n].astype(np.int64)
    c = np.asarray(counts)[:n].astype(np.int32)
    return torch.as_tensor(u).to(dev), torch.as_tensor(c).to(dev), int(n)


def graph(g) -> AsmGraph:
    """An AsmGraph of the JAX package -> the port's AsmGraph, field by
    field (arrays copied)."""
    out = AsmGraph(ksize=int(g.ksize))
    for f in _GRAPH_ARRAYS:
        setattr(out, f, np.array(getattr(g, f), copy=True))
    out.holes = {int(e): (np.array(p), np.array(l))
                 for e, (p, l) in g.holes.items()}
    return out


def minimizer_index(idx) -> EdgeMinimizerIndex:
    """An EdgeMinimizerIndex of the JAX package -> the port's."""
    return EdgeMinimizerIndex(
        keys=np.array(idx.keys, np.uint32), edge=np.array(idx.edge, np.int32),
        pos=np.array(idx.pos, np.int32), count=np.array(idx.count, np.int32),
        k=int(idx.k), w=int(idx.w))
