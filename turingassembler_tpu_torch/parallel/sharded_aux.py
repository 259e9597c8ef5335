"""Barcode aux info over shards and processes (port of
turingassembler_tpu/parallel/sharded_aux.py).

The aux-info stage is a full-library map and two reductions: barcode
attachment, a key-sum over (store, edge, barcode) triples, and the
read-pair candidates, a key-sum over directed (e1, e2) pairs.  Both are
associative, so a process reduces its own read pairs to host tables
(mapped on its shards when given a mesh) and the tables merge by key on
rank 0 (barcode/builder.merge_attach_tables and a dict key-sum), where
apply_aux_tables folds them into the graph.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _map_shard_verified(index, graph, bases_local, lens_local, mesh):
    """The verified map of this process's read rows over its shards of
    `mesh`: (edges, starts) as map_reads gives them with the default
    score floor."""
    from .sharded_map import map_reads_sharded
    e, _, p = map_reads_sharded(index, bases_local, lens_local, mesh,
                                batch_size=max(len(bases_local), 1),
                                graph=graph, with_hits=False)
    return e, p


def aux_tables_local(g, index, b1, l1, b2, l2, bcs, mesh=None, *,
                     device="cuda"
                     ) -> Tuple[tuple, Dict[Tuple[int, int], int]]:
    """This process's aux-info contribution for its read pairs:
    (attach_table, candidate read-pair counts).  With a mesh of more
    than one shard the map runs over this process's shards; otherwise
    on `device`.

    Mirrors construct_aux_info's per-batch body (both strand records
    attach, all 2x2 candidate combos under the fragment gate), so merged
    tables equal the single-process dicts."""
    from ..barcode.builder import (_candidate_pair_keys, _mirror_hits,
                                   attach_table, merge_attach_tables)
    from ..mapper.minimizers import map_reads

    lens = g.edge_len()
    if mesh is not None and mesh.size > 1:
        e1, p1 = _map_shard_verified(index, g, b1, l1, mesh)
        e2, p2 = _map_shard_verified(index, g, b2, l2, mesh)
    else:
        e1, _, p1 = map_reads(index, b1, l1, graph=g, with_hits=False,
                              device=device)
        e2, _, p2 = map_reads(index, b2, l2, graph=g, with_hits=False,
                              device=device)
    e1m, p1m = _mirror_hits(g, lens, e1, p1, l1)
    e2m, p2m = _mirror_hits(g, lens, e2, p2, l2)
    tables = [attach_table(lens, e, p, bcs)
              for e, p in ((e1, p1), (e1m, p1m), (e2, p2), (e2m, p2m))]
    table = merge_attach_tables(tables)
    cands: Dict[Tuple[int, int], int] = {}
    for k_, c_ in _candidate_pair_keys(
            g, (e1, p1, e1m, p1m), (e2, p2, e2m, p2m)):
        key = (int(k_ >> 32), int(k_ & 0xFFFFFFFF))
        cands[key] = cands.get(key, 0) + int(c_)
    return table, cands


def apply_aux_tables(g, table, cands: Dict[Tuple[int, int], int]) -> None:
    """Fold merged tables into the graph's aux structures."""
    from ..barcode.builder import apply_attach_table, init_barcode_structs
    init_barcode_structs(g)
    if len(table[0]):
        apply_attach_table(g, table)
    for key, c in cands.items():
        nr, np_ = g.candidates.get(key, (0, 0))
        g.candidates[key] = (nr, np_ + int(c))
