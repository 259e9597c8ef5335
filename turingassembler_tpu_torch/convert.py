"""Carry state from the JAX package into the port, as numpy arrays.

Each function takes the JAX package's objects by their attributes (it
imports nothing of that package) and returns the port's form, so each
stage of the port can be run on exactly the input the JAX package's
previous stage produced.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .barcode.sort_read import ReadPath
from .config import Config
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


def config(cfg) -> Config:
    """A Config of the JAX package -> the port's Config, field by field
    down the nested dataclasses; a field only one side has (the device
    parameters differ) keeps the port's default."""
    def take(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            if not hasattr(src, f.name):
                continue
            v = getattr(src, f.name)
            kw[f.name] = take(f.default_factory, v) \
                if dataclasses.is_dataclass(v) else v
        return cls(**kw)
    return take(Config, cfg)


def graph(g) -> AsmGraph:
    """An AsmGraph of the JAX package -> the port's AsmGraph, field by
    field (arrays copied), at any level: tombstoned edges (source -1)
    and N-gap holes carry over as they are, and so does barcode aux info
    (barcodes, barcodes_scaf, barcodes_cov, candidates, aux_flag)."""
    out = AsmGraph(ksize=int(g.ksize))
    for f in _GRAPH_ARRAYS:
        setattr(out, f, np.array(getattr(g, f), copy=True))
    out.holes = {int(e): (np.array(p), np.array(l))
                 for e, (p, l) in g.holes.items()}
    # barcode aux info: dicts copied with their insertion orders, which
    # the .bin writer and the candidate lists follow
    if g.barcodes is not None:
        out.barcodes = [[dict(d) for d in lv] for lv in g.barcodes]
    if g.barcodes_scaf is not None:
        out.barcodes_scaf = [dict(d) for d in g.barcodes_scaf]
    if g.barcodes_cov is not None:
        out.barcodes_cov = [dict(d) for d in g.barcodes_cov]
    out.candidates = dict(g.candidates)
    out.aux_flag = int(g.aux_flag)
    return out


def read_path(rp) -> ReadPath:
    """A ReadPath of the JAX package -> the port's."""
    return ReadPath(str(rp.R1_path), str(rp.R2_path), str(rp.idx_path))


def minimizer_index(idx) -> EdgeMinimizerIndex:
    """An EdgeMinimizerIndex of the JAX package -> the port's."""
    return EdgeMinimizerIndex(
        keys=np.array(idx.keys, np.uint32), edge=np.array(idx.edge, np.int32),
        pos=np.array(idx.pos, np.int32), count=np.array(idx.count, np.int32),
        k=int(idx.k), w=int(idx.w))
