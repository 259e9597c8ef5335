"""Top-level entry points of the port (twin of the JAX package's
__graft_entry__.py).

entry(device):            a single-device forward step on tensors
                          (canonical (k+1)-mer extraction + sort +
                          run-length count, the assembler's hot path)
                          and its inputs.
dryrun_multichip(n, device): the sharded stack end to end over an
                          n-shard mesh, every stage checked: the sharded
                          sort count, its overflow-regrow, the sharded
                          hash counter, the vote and verified sharded
                          maps, and a skewed count against the host
                          oracle.

A mesh may hold several shards on one device (parallel/mesh.py), so
dryrun_multichip(4, "cuda:0") runs four shards on one card; it needs
`device` to exist, not n GPUs.  The checks raise AssertionError, as the
JAX function's asserts do, and stay under `python -O`.
"""

from __future__ import annotations

import numpy as np
import torch

K_ENTRY = 45
DRYRUN_K = 31
HASH_CAP_LOG2 = 12         # a shard's table in the dryrun's hash stage


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def entry(device="cuda"):
    """Returns (forward, (bases, lengths)): forward(bases, lengths) ->
    (uniq (N, nl) int64, counts (N,) int32, n_unique 0-d) over 256 reads
    of 152 codes (length 150) from default_rng(0), on `device`."""
    from .device import resolve_device
    from .ops import kmers as km
    from .ops import sortops as so

    dev = resolve_device(device)

    def forward(bases, lengths):
        canon, _, valid = km.extract_canonical_kmers(bases, lengths,
                                                     K_ENTRY + 1)
        return so.sort_unique_count(canon.reshape(-1, canon.shape[-1]),
                                    valid.reshape(-1))

    B, L = 256, 152
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = np.full(B, 150, np.int32)
    return forward, (torch.from_numpy(bases).to(dev),
                     torch.from_numpy(lengths).to(dev))


def dryrun_batch(n_shards: int):
    """The dryrun's generator, drawn on by its later stages, and its first
    batch: (rng, bases (8 n, 64) uint8 random codes, lengths (8 n,))."""
    rng = np.random.default_rng(1)
    B, L = 8 * n_shards, 64
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    return rng, bases, np.full(B, L, np.int32)


def hash_cap_per_dest(n_shards: int, bases: np.ndarray) -> int:
    """The hash stage's routing cap: a shard's k-mers, at least 256."""
    B, L = bases.shape
    return max(256, B * (L - DRYRUN_K) // n_shards)


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """Every stage of the JAX dryrun_multichip on make_mesh(n_shards,
    devices=device); prints its summary line and returns its figures."""
    from .device import resolve_device
    from .graph.from_contigs import graph_from_contigs
    from .kmer.count import count_kedges_from_reads
    from .mapper.minimizers import EdgeMinimizerIndex, map_reads
    from .parallel.mesh import make_mesh
    from .parallel.sharded_count import (ShardedHashCounter,
                                         device_put_sharded_batch,
                                         sharded_count_step,
                                         sharded_count_to_host)
    from .parallel.sharded_map import map_reads_sharded

    dev = resolve_device(device)
    if dev.type == "cuda":
        _check((dev.index or 0) < torch.cuda.device_count(),
               f"no device {dev}: {torch.cuda.device_count()} visible")
    mesh = make_mesh(n_shards, devices=dev)
    k = DRYRUN_K
    rng, bases, lengths = dryrun_batch(n_shards)
    B, L = bases.shape
    db, dl = device_put_sharded_batch(bases, lengths, mesh)
    # the roomy cap holds a shard's every k-mer bound for one destination
    # (the JAX function's 256 is short of 264 on one device)
    per_shard_kmers = (B // n_shards) * (L - k)
    uniq, counts, n_unique, dropped, total = sharded_count_step(
        db, dl, mesh=mesh, k=k, cap_per_dest=per_shard_kmers)
    _check(dropped == 0, f"{dropped} k-mers dropped at a roomy cap")
    _check(total == B * (L - k), f"{total} k-mers routed, not {B * (L - k)}")
    _check(sum(n_unique) > 0, "no unique k-mer")

    # overflow-regrow: a cap that must overflow, doubled until nothing is
    # dropped; each shard's table must then equal the roomy run's
    cap = max(1, per_shard_kmers // (4 * n_shards))   # deliberately short
    u2, c2, nu2, d2, _ = sharded_count_step(db, dl, mesh=mesh, k=k,
                                            cap_per_dest=cap)
    n_regrow = 0
    while d2 > 0:
        cap *= 2
        n_regrow += 1
        _check(n_regrow < 16, "overflow-regrow failed to converge")
        u2, c2, nu2, d2, _ = sharded_count_step(db, dl, mesh=mesh, k=k,
                                                cap_per_dest=cap)
    _check(n_regrow >= 1,
           "overflow stress never overflowed; shrink the starting cap")
    _check(nu2 == n_unique, "shard sizes differ after recovery")
    for s in range(mesh.n_local):
        _check(torch.equal(uniq[s], u2[s]) and torch.equal(counts[s], c2[s]),
               f"shard {s}'s table differs after recovery")

    # the hash-table engine: one table a shard
    ctr = ShardedHashCounter(mesh, k, capacity_log2=HASH_CAP_LOG2,
                             cap_per_dest=hash_cap_per_dest(n_shards, bases))
    ctr.insert_batch(bases, lengths)
    ks, cs = ctr.finalize()
    _check(int(cs.sum()) == B * (L - k), "hash engine lost k-mers")

    # the sharded map, vote and verified, against the single-device map
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    contigs = [ACGT[genome[:1200]].tobytes().decode(),
               ACGT[genome[1200:]].tobytes().decode()]
    g = graph_from_contigs(contigs, 45)
    idx = EdgeMinimizerIndex.build(g, device=dev)
    starts = rng.integers(0, len(genome) - 100, 4 * n_shards)
    rbases = np.stack([genome[s:s + 100] for s in starts]).astype(np.uint8)
    rlens = np.full(len(rbases), 100, np.int32)
    e1, _, s1 = map_reads(idx, rbases, rlens, batch_size=len(rbases),
                          device=dev)
    eD, _, sD = map_reads_sharded(idx, rbases, rlens, mesh,
                                  batch_size=len(rbases))
    _check((e1 == eD).all() and (s1 == sD).all(),
           "sharded vote map != single device")
    n_mapped = int((eD >= 0).sum())
    e1v, _, s1v = map_reads(idx, rbases, rlens, batch_size=len(rbases),
                            graph=g, device=dev)
    eDv, _, sDv = map_reads_sharded(idx, rbases, rlens, mesh,
                                    batch_size=len(rbases), graph=g)
    _check((e1v == eDv).all() and (s1v == sDv).all(),
           "sharded verified map != single device")
    n_ver = int((eDv >= 0).sum())
    _check(n_ver > 0, "no read verified")

    # skew: 30% of the reads from one 152 bp locus, so a few k-mers carry
    # 30% of the mass and their destinations run hot; the sharded count
    # must equal the host oracle
    B2, L2, k2 = 1024 * n_shards, 152, 31
    genome2 = rng.integers(0, 4, 50_000).astype(np.uint8)
    starts2 = rng.integers(0, 50_000 - L2, B2)
    starts2[:int(0.3 * B2)] = 1000
    bases2 = genome2[starts2[:, None] + np.arange(L2)[None, :]] \
        .astype(np.uint8)
    lengths2 = np.full(B2, L2, np.int32)
    n_routed = B2 * (L2 - k2)
    # worst case: every k-mer of one shard routed to one destination
    cap2 = (B2 // n_shards) * (L2 - k2)
    kedges_s, counts_s = sharded_count_to_host(bases2, lengths2, mesh, k2,
                                               cap_per_dest=cap2)
    kedges_o, counts_o = count_kedges_from_reads(
        bases2, lengths2, k2, engine="np", batch_size=1 << 20, device=dev)
    _check(np.array_equal(kedges_s, kedges_o)
           and np.array_equal(counts_s, counts_o),
           "skewed sharded count != host oracle")
    hot_mass = int(np.sort(counts_o)[-128:].sum())
    _check(hot_mass >= 0.2 * int(counts_o.sum()),
           "skew workload lost its imbalance")

    figures = dict(
        routed=int(total), unique_sort=int(sum(n_unique)),
        unique_hash=len(ks), regrow=n_regrow, voted=n_mapped,
        reads_mapped=len(rbases), verified=n_ver, skew_routed=n_routed,
        skew_unique=len(kedges_s),
        hot_pct=100 * hot_mass // int(counts_o.sum()))
    print(f"dryrun_multichip({n_shards}): ok — "
          f"{figures['routed']} k-mers routed, {figures['unique_sort']} "
          f"unique (sort engine) / {figures['unique_hash']} unique (hash "
          f"engine); overflow-regrow exercised ({n_regrow} doublings, "
          f"bit-equal after recovery); "
          f"sharded map: {n_mapped}/{len(rbases)} voted, {n_ver} "
          f"DP-verified on-mesh, bit-equal to single device; "
          f"skew stage: {n_routed} k-mers ({len(kedges_s)} unique, "
          f"top-128 keys carry {figures['hot_pct']}% of "
          f"mass), sharded == host oracle", flush=True)
    return figures
