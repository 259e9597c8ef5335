"""The port's FASTG loader (io/fastg.py) and unfiltered FASTA writer
(io/fasta.py:write_fasta_all) against the JAX package's.

Inputs: the adjacency case of tests/test_fastg.py, and FASTG files of
random contigs (numpy seeds) with no adjacency, as
tests/test_cli_variants.py writes them for build_barcode_fastg.
Tolerance: exact — parsed records, graph arrays, file bytes.
"""

import numpy as np
import pytest

from turingassembler_tpu.io import fasta as jfasta
from turingassembler_tpu.io import fastg as jfastg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.graph.invariants import check_graph
from turingassembler_tpu_torch.io import fasta as tfasta
from turingassembler_tpu_torch.io import fastg as tfastg

ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
          "edge_rc", "edge_count", "seq_off", "seq_data")
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def rc(s):
    return "".join(COMP[c] for c in reversed(s))


def adjacency_fastg(path):
    """A -> B and A -> C': a branch, k=3 overlaps (tests/test_fastg.py)."""
    A, B, C = "ACGTACG", "ACGGGTT", "AACCCGT"
    path.write_text(
        f">EDGE_1_length_7_cov_10:EDGE_2_length_7_cov_5,"
        f"EDGE_3_length_7_cov_5';\n{A}\n"
        f">EDGE_1_length_7_cov_10';\n{rc(A)}\n"
        f">EDGE_2_length_7_cov_5;\n{B}\n"
        f">EDGE_2_length_7_cov_5';\n{rc(B)}\n"
        f">EDGE_3_length_7_cov_5:EDGE_1_length_7_cov_10';\n{C}\n"
        f">EDGE_3_length_7_cov_5';\n{rc(C)}\n")
    return 3


def contigs_fastg(path, seed):
    """Random contigs, each with its rc record, no successor lists;
    sequences split over lines, coverages with decimals, ids not in
    order."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lines = []
    for i in rng.permutation(np.arange(1, 13)):
        s = acgt[tt.random_genome(int(rng.integers(60, 400)),
                                  seed=int(i) + seed)].tobytes().decode()
        cov = round(float(rng.uniform(1, 60)), 2)
        lines.append(f">EDGE_{i}_length_{len(s)}_cov_{cov};\n{s[:70]}\n"
                     f"{s[70:]}\n")
        lines.append(f">EDGE_{i}_length_{len(s)}_cov_{cov}';\n{rc(s)}\n")
    path.write_text("".join(lines))
    return 31


CASES = {"adjacency": adjacency_fastg,
         "contigs_a": lambda p: contigs_fastg(p, 5),
         "contigs_b": lambda p: contigs_fastg(p, 6)}


@pytest.mark.parametrize("name", list(CASES))
def test_parse_fastg(name, tmp_path):
    p = tmp_path / "g.fastg"
    CASES[name](p)
    got = list(tfastg.parse_fastg(str(p)))
    assert got == list(jfastg.parse_fastg(str(p)))
    assert len(got) >= 6


@pytest.mark.parametrize("name", list(CASES))
def test_load_fastg(name, tmp_path):
    p = tmp_path / "g.fastg"
    k = CASES[name](p)
    want = convert.graph(jfastg.load_fastg(str(p), k))
    got = tfastg.load_fastg(str(p), k)
    check_graph(got, check_seq=False)
    assert got.ksize == want.ksize
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    if name == "adjacency":         # A's target node: B and C' leave it
        assert len(got.node_adj(int(got.edge_target[0]))) == 2


def test_bad_header_raises(tmp_path):
    p = tmp_path / "bad.fastg"
    p.write_text(">NODE_1_length_7;\nACGTACG\n")
    for mod in (tfastg, jfastg):
        with pytest.raises(ValueError, match="bad fastg header"):
            list(mod.parse_fastg(str(p)))


@pytest.mark.parametrize("min_len", [0, 200])
def test_write_fasta_all(min_len, tmp_path):
    """Every live edge, both strands, holes expanded to N, a tombstoned
    pair skipped, and the length floor."""
    p = tmp_path / "g.fastg"
    k = contigs_fastg(p, 7)
    jg = jfastg.load_fastg(str(p), k)
    e = int(np.argmax(jg.edge_len()))
    n = int(jg.edge_len(e))
    jg.holes[e] = (np.array([40, 90], np.int64), np.array([5, 100], np.int64))
    jg.holes[int(jg.edge_rc[e])] = (np.array([n - 92, n - 42], np.int64),
                                    np.array([100, 5], np.int64))
    dead = (e + 2) % jg.n_e
    jg.edge_source[[dead, int(jg.edge_rc[dead])]] = -1
    tg = convert.graph(jg)
    jfasta.write_fasta_all(jg, str(tmp_path / "j.fasta"), min_len)
    tfasta.write_fasta_all(tg, str(tmp_path / "t.fasta"), min_len)
    want = (tmp_path / "j.fasta").read_bytes()
    assert (tmp_path / "t.fasta").read_bytes() == want
    assert want.count(b"N") == 2 * 105 * (n >= min_len)
    n_rec = want.count(b">")
    assert n_rec == int((tg.alive_mask() & (tg.edge_len() >= min_len)).sum())
