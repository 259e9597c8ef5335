"""Hash-partitioned k-mer counting over the shards of a mesh (port of
turingassembler_tpu/parallel/sharded_count.py).

Each shard extracts the canonical (k+1)-mers of its rows of the read
batch, routes every k-mer to the shard that owns its hash (hash_limbs
mod the number of shards) with one all-to-all, and counts what it
received with a local sort and run-length count.  A k-mer's count lives
on one shard only, so the shard tables are disjoint and merge by
concatenation.

Routing sorts the k-mers by destination into a send buffer of a fixed
capacity per destination; k-mers past it are dropped and counted over
all shards, and the host wrapper raises when any was (the caller grows
the capacity).

The JAX package's hash-table variant (ShardedHashCounter and its
_route_and_insert) needs ops/devhash.py, which is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kmer.megasort import _sort_count
from ..ops import kmers as km
from ..ops import limbs as lb
from ..ops.sortops import np_merge_count_runs
from .distributed import global_read_batch
from .mesh import Mesh


def _route(bases: torch.Tensor, lengths: torch.Tensor, *, k1: int,
           n_shards: int, cap_per_dest: int):
    """One shard's routing: its k-mers into the (n_shards, cap, nl) send
    buffer by destination.  Returns (send, send_valid (n_shards, cap),
    dropped, valid k-mers)."""
    dev = bases.device
    canon, _, valid = km.extract_canonical_kmers(bases, lengths, k1)
    nl = canon.shape[-1]
    flat = canon.reshape(-1, nl)
    vflat = valid.reshape(-1)
    n = flat.shape[0]
    shard = lb.hash_limbs(flat) % n_shards
    shard = torch.where(vflat, shard, n_shards)      # invalids route nowhere
    order = torch.argsort(shard, stable=True)
    shard_s = shard[order]
    flat_s = flat[order]
    start_of = torch.searchsorted(
        shard_s, torch.arange(n_shards + 1, device=dev, dtype=shard_s.dtype))
    pos_in_run = torch.arange(n, device=dev) - start_of[shard_s]
    live = shard_s < n_shards
    in_range = live & (pos_in_run < cap_per_dest)
    slot = (shard_s * cap_per_dest + pos_in_run)[in_range]
    send = torch.zeros((n_shards * cap_per_dest, nl), dtype=flat.dtype,
                       device=dev)
    send_valid = torch.zeros(n_shards * cap_per_dest, dtype=torch.bool,
                             device=dev)
    send[slot] = flat_s[in_range]
    send_valid[slot] = True
    n_dropped = int((live & (pos_in_run >= cap_per_dest)).sum())
    return (send.reshape(n_shards, cap_per_dest, nl),
            send_valid.reshape(n_shards, cap_per_dest), n_dropped,
            int(vflat.sum()))


def _route_and_count(bases: List[torch.Tensor], lengths: List[torch.Tensor],
                     *, mesh: Mesh, k1: int, cap_per_dest: int):
    """Every local shard's routing, the exchange, and each shard's count
    of what it received.  Returns per local shard (uniq (n, nl) int64
    sorted unique, counts (n,) int32), with the dropped and the valid
    k-mers summed over all shards."""
    sends, valids = [], []
    dropped = total = 0
    for b, ln in zip(bases, lengths):
        s, v, d, t = _route(b, ln, k1=k1, n_shards=mesh.size,
                            cap_per_dest=cap_per_dest)
        sends.append(s)
        valids.append(v)
        dropped += d
        total += t
    recv = mesh.all_to_all(sends)
    recv_valid = mesh.all_to_all(valids)
    tables = []
    for r, v in zip(recv, recv_valid):
        rows = r.reshape(-1, r.shape[-1])[v.reshape(-1)]
        tables.append(_sort_count(rows) if rows.shape[0] else
                      (rows, torch.zeros(0, dtype=torch.int32,
                                         device=rows.device)))
    return tables, mesh.psum(dropped), mesh.psum(total)


def sharded_count_step(bases: List[torch.Tensor], lengths: List[torch.Tensor],
                       *, mesh: Mesh, k: int, cap_per_dest: int):
    """One distributed counting step over a sharded batch (a tensor a
    local shard, as global_read_batch places it).  Returns per local
    shard (uniq, counts, n_unique) plus the dropped and the valid
    k-mers over all shards.  The k-mer space stays partitioned."""
    tables, dropped, total = _route_and_count(
        bases, lengths, mesh=mesh, k1=k + 1, cap_per_dest=cap_per_dest)
    return ([t[0] for t in tables], [t[1] for t in tables],
            [int(t[1].shape[0]) for t in tables], dropped, total)


def device_put_sharded_batch(bases: np.ndarray, lengths: np.ndarray,
                             mesh: Mesh):
    """Place a global host batch on the mesh, sharded by read: this
    process's rows of it, split over its shards."""
    n = len(bases) // mesh.world
    lo = mesh.rank * n
    return global_read_batch(bases[lo:lo + n], lengths[lo:lo + n], mesh)


def sharded_count_to_host(bases: np.ndarray, lengths: np.ndarray, mesh: Mesh,
                          k: int, cap_per_dest: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Run one sharded step over a global host batch and merge every
    shard's table on the host: (kedges (n, nl) uint32 sorted unique,
    counts (n,) int64), on every process."""
    D = mesh.size
    B, L = bases.shape
    if B % D:
        raise ValueError(f"a batch of {B} reads does not divide evenly over "
                         f"{D} shards")
    if cap_per_dest is None:
        per_dev_kmers = (B // D) * (L - k)
        cap_per_dest = int(2.2 * per_dev_kmers / D) + 64
    db, dl = device_put_sharded_batch(bases, lengths, mesh)
    uniq, counts, _, dropped, _ = sharded_count_step(
        db, dl, mesh=mesh, k=k, cap_per_dest=cap_per_dest)
    if dropped > 0:
        raise RuntimeError(f"sharded_count: {dropped} k-mers dropped; "
                           f"raise cap_per_dest (current {cap_per_dest})")
    runs = [(u.cpu().numpy().astype(np.uint32),
             c.cpu().numpy().astype(np.int64)) for u, c in zip(uniq, counts)]
    runs = [r for part in mesh.gather(runs) for r in part]
    return np_merge_count_runs(runs)
