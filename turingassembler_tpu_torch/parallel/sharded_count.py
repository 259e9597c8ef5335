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

ShardedHashCounter is the hash-table variant: the same routing (with
its own hash seed, as in the JAX package), then each shard inserts what
it received into its own DeviceHashCounter (ops/devhash.py), one kernel
launch a shard and batch on a card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kmer.megasort import _sort_count
from ..ops import kmers as km
from ..ops import limbs as lb
from ..ops.devhash import DeviceHashCounter
from ..ops.sortops import np_merge_count_runs
from .distributed import global_read_batch
from .mesh import Mesh


def _route(bases: torch.Tensor, lengths: torch.Tensor, *, k1: int,
           n_shards: int, cap_per_dest: int, seed: int = 0x9E3779B9):
    """One shard's routing: its k-mers into the (n_shards, cap, nl) send
    buffer by destination, hash_limbs(k-mer, seed) mod n_shards.  Returns
    (send, send_valid (n_shards, cap), dropped, valid k-mers)."""
    dev = bases.device
    canon, _, valid = km.extract_canonical_kmers(bases, lengths, k1)
    nl = canon.shape[-1]
    flat = canon.reshape(-1, nl)
    vflat = valid.reshape(-1)
    n = flat.shape[0]
    shard = lb.hash_limbs(flat, seed) % n_shards
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


# ---------------------------------------------------------------------------
# hash-engine variant: one open-addressing table a shard
# ---------------------------------------------------------------------------

ROUTE_SEED = 0x51ED270B     # the JAX _route_and_insert's routing hash seed


def _route_and_insert(counters: List[DeviceHashCounter],
                      bases: List[torch.Tensor], lengths: List[torch.Tensor],
                      *, mesh: Mesh, k1: int, cap_per_dest: int) -> int:
    """Every local shard's routing, the exchange, and each shard's insert
    of what it received (padding rows invalid) into its own table.
    Returns the k-mers dropped by the routing over all shards."""
    sends, valids = [], []
    dropped = 0
    for b, ln in zip(bases, lengths):
        s, v, d, _ = _route(b, ln, k1=k1, n_shards=mesh.size,
                            cap_per_dest=cap_per_dest, seed=ROUTE_SEED)
        sends.append(s)
        valids.append(v)
        dropped += d
    for counter, r, v in zip(counters, mesh.all_to_all(sends),
                             mesh.all_to_all(valids)):
        counter.insert(r.reshape(-1, r.shape[-1]), v.reshape(-1))
    return mesh.psum(dropped)


class ShardedHashCounter:
    """Mesh-wide k-mer counter: the k-mer space hash-partitioned over the
    shards of `mesh`, each shard holding its own DeviceHashCounter of
    2^capacity_log2 slots on its device.  A k-mer's count exists on one
    shard only, so the shards' tables merge by concatenation."""

    def __init__(self, mesh: Mesh, k: int, capacity_log2: int,
                 cap_per_dest: int):
        self.mesh = mesh
        self.k = k
        self.cap_per_dest = cap_per_dest
        self.capacity_log2 = capacity_log2
        nl = lb.n_limbs(k + 1)
        self.counters = [DeviceHashCounter(capacity_log2, nl, device=d)
                         for d in mesh.devices]
        self._dropped = 0

    def insert_batch(self, bases: np.ndarray, lengths: np.ndarray) -> None:
        """Route and count one global host batch (its reads divide evenly
        over the shards)."""
        db, dl = device_put_sharded_batch(bases, lengths, self.mesh)
        self._dropped += _route_and_insert(
            self.counters, db, dl, mesh=self.mesh, k1=self.k + 1,
            cap_per_dest=self.cap_per_dest)

    def overflow(self) -> int:
        """Lanes that found no slot plus k-mers dropped by the routing,
        over all shards."""
        return self.mesh.psum(sum(c.overflow() for c in self.counters)) \
            + self._dropped

    def shard_tables(self):
        """Each local shard's sorted live set, host (keys uint32, counts
        int64)."""
        return [c.finalize(out_cap_log2=self.capacity_log2)
                for c in self.counters]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every shard's table merged on the host (disjoint key spaces):
        (kedges (n, nl) uint32 sorted unique, counts (n,) int64), on every
        process.  Raises when any lane overflowed or any k-mer was
        dropped."""
        ovf = self.overflow()
        if ovf > 0:
            raise RuntimeError(f"ShardedHashCounter overflow ({ovf}); grow "
                               "capacity or cap_per_dest")
        runs = [r for part in self.mesh.gather(self.shard_tables())
                for r in part]
        return np_merge_count_runs(runs)
