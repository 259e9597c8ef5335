"""Level-0 de Bruijn graph construction on the device (port of
turingassembler_tpu/graph/device_build.py).

Input is the sorted unique k-edge table of kmer/megasort.py: (k+1)-mer
limb rows (n, nl) int64 and counts (n,) int32.  Directed k-edge lanes
are [0, n) in canonical orientation and [n, 2n) reverse-complemented;
the JAX package pads the table to a power-of-two capacity, and every
ordering here (node ids, unitig ids, cycle breaks) is by lane index in
the same relative order, so the graph arrays come out identical.

  _front         node fingerprints (front_keys), their sort
                 (kmer_sort.lex_order), node ids, adjacency, successor and
                 predecessor pointers (link_nodes)
  _rank_chains   pointer doubling to (head, distance), the cycle lanes and
                 heads counted on the device (rank_chains)
  _break_cycles  circular unitigs break at their rc-mirror-consistent
                 minimum adjacency (tensor code), then rank again
  _assemble      unitig arrays and the base pool (assemble_unitigs)

The entries are ops/unitig_build.py's: the kernels of
csrc/unitig_build.cu on a card, their plain tensor versions on the CPU.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..ops import kmer_sort as ks
from ..ops import unitig_build as ub
from .structs import AsmGraph

log = logging.getLogger("turingassembler")


def _break_cycles(prev_ptr: torch.Tensor, head_of: torch.Tensor, info):
    """Pure cycles (circular unitigs).  The fw and rc copies of a circular
    unitig are two cycles that must break at mirrored adjacencies: each
    adjacency (prev(d) -> d) is keyed by min(enc(prev, d), enc(rc(d),
    rc(prev))), invariant under the rc mirror, and each cycle breaks at
    its minimum key (min-doubling).  The chains are then ranked again
    (rank_chains, its scalars into info)."""
    D = prev_ptr.shape[0]
    n = D // 2
    d_idx = torch.arange(D, dtype=torch.int32, device=prev_ptr.device)
    on_cyc = prev_ptr[head_of] >= 0
    rcd = torch.where(d_idx < n, d_idx + n, d_idx - n)
    p = torch.where(on_cyc, prev_ptr, d_idx)
    e2a, e2b = rcd, rcd[p]
    use1 = (p < e2a) | ((p == e2a) & (d_idx <= e2b))
    ka = torch.where(use1, p, e2a)
    kb = torch.where(use1, d_idx, e2b)
    va = torch.where(on_cyc, ka, D)
    vb = torch.where(on_cyc, kb, D)
    nxt = p
    for _ in range(ub.rounds(D)):
        ga, gb = va[nxt], vb[nxt]
        lt = (ga < va) | ((ga == va) & (gb < vb))
        va = torch.where(lt, ga, va)
        vb = torch.where(lt, gb, vb)
        nxt = nxt[nxt]
    new_head = on_cyc & (ka == va) & (kb == vb)
    prev_ptr = torch.where(new_head, -1, prev_ptr)
    head_of, dist = _rank_chains(prev_ptr, info)
    return prev_ptr, head_of, dist


def _front(uniq: torch.Tensor, k: int):
    """k-edges -> (src_key, tgt_key, lastbase, prev_ptr, info): the
    directed lanes' node keys, last bases and chain predecessors."""
    fp, flags, info = ub.front_keys(uniq, k)
    order = ks.lex_order(fp)
    return (*ub.link_nodes(fp, order, flags), info)


def _rank_chains(prev_ptr: torch.Tensor, info, walks=None):
    """(head_of, dist); info gets the cycle lanes and the heads, walks
    (when given) the kernel's walk figures."""
    head_of, dist, _ = ub.rank_chains(prev_ptr, info, walks)
    return head_of, dist


def _assemble(uniq, counts, src_key, tgt_key, lastbase, head_of, dist,
              k: int, n_e: int):
    """Chains -> (ints, seq) on the host: ops/unitig_build.py:Unitigs'
    int64 arrays and base pool."""
    return ub.assemble_unitigs(uniq, counts, src_key, tgt_key, lastbase,
                               head_of, dist, k, n_e).to_host()


def build_graph_on_device(uniq: torch.Tensor, counts: torch.Tensor, n: int,
                          k: int, *,
                          device: str | torch.device = "cuda") -> AsmGraph:
    """Sorted unique k-edge table -> host AsmGraph.

    uniq: (>= n, nl) int64 limb rows, rows [0, n) sorted unique;
    counts: (>= n,) int32.  Host syncs: lex_order's own, one stacked pull
    of (cycle lanes, unitigs, limb flag) after the ranking (a second after
    a cycle break), and the two output pulls.  The `build` span (tracing.py)
    counts them, with its unitigs and cycle_breaks; its children
    build.front, build.rank (lanes; on a card also rank_chains'
    walk_bits, the offset bits of a lane's word, and promoted, the
    rulers its long walks promoted), build.cycles, build.assemble (the
    pulls' bytes) and build.host (the host graph) divide its time."""
    dev = resolve_device(device)
    if n == 0:
        return AsmGraph(ksize=k)
    with tracing.span("build"):
        uniq = uniq[:n].to(dev)
        counts = counts[:n].to(dev).int()
        with tracing.span("build.front"):
            src_key, tgt_key, lastbase, prev_ptr, info = _front(uniq, k)
        with tracing.span("build.rank", lanes=2 * n):
            # while tracing on a card, the kernel's walk figures ride
            # the scalars' one pull
            walks = torch.zeros(4, dtype=torch.int32, device=dev) \
                if dev.type == "cuda" and tracing.enabled() else None
            head_of, dist = _rank_chains(prev_ptr, info, walks)
            tracing.host_sync()
            n_cyc, n_e, bad, *walked = (
                info if walks is None else torch.cat([info, walks])).tolist()
            if walked:
                tracing.add(walk_bits=walked[3], promoted=walked[2])
        if bad:
            raise ValueError("device_build: a k-edge limb lies outside "
                             "[0, 2^32)")
        tracing.add(cycle_breaks=int(n_cyc > 0))
        if n_cyc:
            with tracing.span("build.cycles"):
                prev_ptr, head_of, dist = _break_cycles(prev_ptr, head_of,
                                                        info)
                tracing.host_sync()
                n_cyc, n_e, _ = info.tolist()
        with tracing.span("build.assemble"):
            ints, seq = _assemble(uniq, counts, src_key, tgt_key, lastbase,
                                  head_of, dist, k, n_e)
            tracing.add(bytes=ints.nbytes + seq.nbytes)
        tracing.add(unitigs=n_e)
        log.debug("level-0 build: %d unitigs", n_e)

        with tracing.span("build.host"):
            g = AsmGraph(ksize=k)
            g.node_rc = np.arange(int(ints[-1]), dtype=np.int64) ^ 1
            (g.seq_off, g.edge_count, g.edge_rc, g.edge_source,
             g.edge_target) = (a.copy() for a in np.split(
                 ints[:-1], [n_e + 1, 2 * n_e + 1, 3 * n_e + 1, 4 * n_e + 1]))
            g.seq_data = seq
            g.rebuild_adjacency()
    return g
