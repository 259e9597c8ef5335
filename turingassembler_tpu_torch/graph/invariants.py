"""Structural invariant checker — the rebuild of `test_asm_graph`.

The reference runs a 10+ point structural audit after every build/resolve
stage and aborts on violation (src/assembly_graph.c:987-1171, invoked at
e.g. src/process.c:52,64,131).  We keep that discipline: `check_graph`
raises AssertionError with a precise message; pipeline stages call it in
debug/test mode, and the pytest suite uses it as the universal property
test.

Checks mirrored from the reference:
  1. adjacency <-> edge_source consistency (each adj edge starts at its node)
  2. edge source/target/rc ids in range
  3. rc involution on edges and nodes (rc(rc(x)) == x)
  4. edge and its rc have identical length and count
  5. seq(rc(e)) == revcomp(seq(e)); holes mirror symmetrically
  6. source(rc(e)) == node_rc[target(e)]
  7. sibling out-edges of a node share the node's k-prefix
  8. every live edge appears exactly once in the adjacency lists
"""

from __future__ import annotations

import numpy as np

from .structs import AsmGraph


def check_graph(g: AsmGraph, check_seq: bool = True) -> None:
    n_v, n_e = g.n_v, g.n_e
    alive = g.alive_mask()
    live = np.flatnonzero(alive)

    # ids in range
    assert g.edge_source[alive].min(initial=0) >= 0
    if live.size:
        assert g.edge_source[alive].max() < n_v, "edge source out of range"
        assert g.edge_target[alive].min() >= 0 and g.edge_target[alive].max() < n_v
        rc = g.edge_rc[alive]
        assert rc.min() >= 0 and rc.max() < n_e, "edge rc out of range"
        # rc involution + liveness
        assert np.all(g.edge_rc[rc] == live), "edge rc not an involution"
        assert np.all(alive[rc]), "rc of live edge is dead"
        # length/count symmetry
        lens = g.edge_len()
        assert np.all(lens[live] == lens[rc]), "rc length mismatch"
        assert np.all(g.edge_count[live] == g.edge_count[rc]), "rc count mismatch"
        # source(rc) == node_rc[target]
        assert np.all(g.edge_source[rc] == g.node_rc[g.edge_target[live]]), \
            "source(rc(e)) != rc(target(e))"
        assert np.all(g.edge_target[rc] == g.node_rc[g.edge_source[live]]), \
            "target(rc(e)) != rc(source(e))"

    # node rc involution
    if n_v:
        assert np.all(g.node_rc[g.node_rc] == np.arange(n_v)), "node rc not involution"

    # adjacency consistency
    assert len(g.adj_off) == n_v + 1
    deg = g.node_deg()
    assert g.adj_off[-1] == len(g.adj_list)
    if len(g.adj_list):
        counts = np.zeros(n_e, np.int64)
        np.add.at(counts, g.adj_list, 1)
        assert np.all(counts[g.adj_list] == 1), "edge repeated in adjacency"
        owners = np.repeat(np.arange(n_v), deg)
        assert np.all(g.edge_source[g.adj_list] == owners), \
            "adjacency edge does not start at its node"
    assert np.array_equal(np.sort(g.adj_list), live), \
        "adjacency lists != set of live edges"

    if check_seq and live.size:
        k = g.ksize
        lens = g.edge_len()
        assert np.all(lens[live] > k), "edge shorter than k"
        # rc sequence equality + k-prefix sharing
        for e in live:
            r = int(g.edge_rc[e])
            if r < e:
                continue  # checked from the partner
            s = g.get_seq(e)
            sr = g.get_seq(r)
            np.testing.assert_array_equal(sr, (3 - s)[::-1],
                                          err_msg=f"rc seq mismatch e={e} rc={r}")
            # holes mirror: hole after position p in e <-> hole after
            # len-2-p ... only check count+lengths reversed
            he = g.holes.get(int(e))
            hr = g.holes.get(r)
            if he is not None or hr is not None:
                assert he is not None and hr is not None, f"hole asymmetry e={e}"
                np.testing.assert_array_equal(he[1][::-1], hr[1],
                                              err_msg=f"hole length mismatch e={e}")
        # sibling edges of a node share the first k bases
        for u in range(n_v):
            es = g.node_adj(u)
            if len(es) <= 1:
                continue
            first = g.get_seq(int(es[0]))[:k]
            for e in es[1:]:
                np.testing.assert_array_equal(
                    g.get_seq(int(e))[:k], first,
                    err_msg=f"siblings of node {u} disagree on k-prefix")
