"""Read->edge mapping over the shards of a mesh (port of
turingassembler_tpu/parallel/sharded_map.py).

The aux-info and read-pair stages map the whole library (upstream fans
them out over a thread pool sharing one BWA index,
src/barcode_builder.c:408-436).  Here the reads are split over the
shards (data parallel) and each shard runs the single-device map_reads
on its rows on its device, with the minimizer index and the
nibble-packed contig pool copied to that device.  No collective is
needed, since every read's map is its own, so the results equal
map_reads on the same rows bit for bit.  The JAX package's per-shard
step functions (`sharded_map_step[_verified]`) are that per-shard
map_reads call here.  Shards on different GPUs run in one thread a GPU.

A process maps the rows it is given on its own shards: in a
multi-process mesh each rank maps its rows.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from ..mapper.minimizers import EdgeMinimizerIndex, map_reads
from .mesh import Mesh


def map_reads_sharded(index: EdgeMinimizerIndex, bases: np.ndarray,
                      lengths: np.ndarray, mesh: Mesh,
                      batch_size: int = 8192, graph=None, min_score=None,
                      with_hits: bool = True):
    """Mesh-parallel map_reads over this process's shards: shard s maps
    the s-th of `mesh.n_local` contiguous row blocks on its device, in
    batches of batch_size / n_local rows.  With a graph every voted hit
    is verified (the gapless bound, the DP for the rest on the shard's
    device).  min_score is a scalar or one floor a row.

    Returns (edge (N,) int32 [-1 unmapped], n_hits (N,) int32,
    est_start (N,) int32 clamped >= 0 on mapped lanes)."""
    L, N = mesh.n_local, len(bases)
    per = max(-(-batch_size // L), 1)
    bounds = [N * s // L for s in range(L + 1)]
    floors = None if min_score is None or np.ndim(min_score) == 0 \
        else np.asarray(min_score)

    def run(s):
        lo, hi = bounds[s], bounds[s + 1]
        floor = min_score if floors is None else floors[lo:hi]
        return map_reads(index, bases[lo:hi], lengths[lo:hi],
                         batch_size=per, graph=graph, min_score=floor,
                         with_hits=with_hits, device=mesh.devices[s])

    def run_on(dev, shards):
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
        with ctx:
            return [(s, run(s)) for s in shards]

    by_dev: dict = {}
    for s, d in enumerate(mesh.devices):
        by_dev.setdefault(d, []).append(s)
    if len(by_dev) == 1:
        done = [run_on(d, ss) for d, ss in by_dev.items()]
    else:
        with ThreadPoolExecutor(len(by_dev)) as ex:
            done = list(ex.map(run_on, by_dev, by_dev.values()))
    outs = dict(pair for part in done for pair in part)
    return tuple(np.concatenate([outs[s][j] for s in range(L)])
                 .astype(np.int32) for j in range(3))
