"""The plain reference on cases worked out by hand or by brute force."""

import itertools
import random

import numpy as np
import pytest
import torch

from asmbench.reference import dp, kmers, mapper, unitigs

ACGT = "ACGT"


def codes(s):
    return np.array(["ACGTN".index(c) for c in s], np.uint8)


def rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def rand_seq(n, seed):
    r = random.Random(seed)
    return "".join(r.choice(ACGT) for _ in range(n))


def as_strings(rows, k1):
    return ["".join(ACGT[c] for c in row)
            for row in kmers.decode(rows, k1).tolist()]


def pad(reads, width):
    out = np.full((len(reads), width), 255, np.uint8)
    for i, s in enumerate(reads):
        out[i, :len(s)] = codes(s)
    return out, np.array([len(s) for s in reads], np.int32)


@pytest.mark.parametrize("k1", [46, 64])
def test_three_reads_count(k1):
    """Read 2 is read 1's reverse complement, read 3 read 1's first
    k1 + 1 bases with a base that is no base in its middle: every window
    of read 1 counts twice, its first two windows once more, and the
    windows over the bad base not at all."""
    s = rand_seq(k1 + 4, k1)
    bad = s[:k1 + 1] + "N" + s[:k1 + 1]
    bases, lens = pad([s, rc(s), bad], 2 * k1 + 4)
    rows, cnt = kmers.count([(bases, lens)], k1, 1, "cpu")
    want = {}
    for w in [s[i:i + k1] for i in range(5)]:
        c = min(w, rc(w))
        want[c] = want.get(c, 0) + 2
    for w in (s[:k1], s[1:k1 + 1]):
        want[min(w, rc(w))] += 2          # twice: both halves of `bad`
    got = dict(zip(as_strings(rows, k1), cnt.tolist()))
    assert got == want
    # the cutoff keeps what counts at least 3 times
    rows3, cnt3 = kmers.count([(bases, lens)], k1, 3, "cpu")
    assert dict(zip(as_strings(rows3, k1), cnt3.tolist())) == \
        {c: n for c, n in want.items() if n >= 3}


def test_rows_sort_by_their_bases():
    seqs = sorted(rand_seq(64, i) for i in range(40))
    rows = kmers.encode(torch.as_tensor(np.stack([codes(s) for s in seqs])))
    u, n, inv = kmers.unique_rows(rows.flip(0))
    assert as_strings(u, 64) == seqs
    assert n.tolist() == [1] * 40 and inv.tolist() == list(range(39, -1, -1))


def test_unitigs_of_a_genome_with_one_repeat():
    """X R Y R Z with R repeated exactly: X+R[:k] runs into R, R into
    both R[-k:]+Y+R[:k] and R[-k:]+Z, the middle one back into R."""
    k = 45
    X, R, Y, Z = (rand_seq(n, s) for n, s in
                  ((200, 1), (120, 2), (150, 3), (180, 4)))
    # the bases on either side of R differ, so the branches sit at its ends
    X, Y, Z = X + "A", "C" + Y + "G", "T" + Z
    genome = X + R + Y + R + Z
    edges = [genome[i:i + k + 1] for i in range(len(genome) - k)]
    canon = sorted({min(e, rc(e)) for e in edges})
    rows = kmers.encode(torch.as_tensor(np.stack([codes(e) for e in canon])))
    g = unitigs.build(rows, torch.ones(len(canon), dtype=torch.int64), k)
    A, B = X + R[:k], R
    C, D = R[-k:] + Y + R[:k], R[-k:] + Z
    want = {A, B, C, D, rc(A), rc(B), rc(C), rc(D)}
    seqs = ["".join(ACGT[c] for c in g.seq(u)) for u in range(g.n)]
    assert sorted(seqs) == sorted(want)
    by = {s: u for u, s in enumerate(seqs)}
    assert [g.count[by[s]] for s in (A, B, C, D)] == \
        [len(s) - k for s in (A, B, C, D)]
    links = {(seqs[a], seqs[b]) for a in range(g.n) for b in range(g.n)
             if g.end[a] == g.start[b]}
    fw = {(A, B), (B, C), (C, B), (B, D)}
    assert links == fw | {(rc(b), rc(a)) for a, b in fw}
    assert not g.circular.any()


def test_a_circular_unitig_is_known_by_its_rotation():
    k = 45
    ring = rand_seq(100, 7)
    looped = ring + ring[:k]
    edges = {looped[i:i + k + 1] for i in range(len(ring))}
    canon = sorted({min(e, rc(e)) for e in edges})
    rows = kmers.encode(torch.as_tensor(np.stack([codes(e) for e in canon])))
    g = unitigs.build(rows, torch.ones(len(canon), dtype=torch.int64), k)
    assert g.n == 2 and g.circular.all()
    keys = set(unitigs.keys(g))
    for s in (ring, rc(ring)):
        rot = min(s[i:] + s[:i] for i in range(len(s)))
        assert b"\x05" + bytes(codes(rot)) in keys


@pytest.mark.parametrize("seed", range(20))
def test_min_rotation_matches_brute_force(seed):
    r = random.Random(seed)
    s = bytes(r.choice(b"ab") for _ in range(r.randint(1, 30)))
    assert unitigs.min_rotation(s) == min(s[i:] + s[:i] for i in range(len(s)))


def gotoh_fit(q, t, ma=1, mi=-2, go=3, ge=1):
    """Scalar Gotoh, "fit": the whole of q against any part of t."""
    neg = -10 ** 9
    n, m = len(q), len(t)
    H = [[0] * (m + 1) for _ in range(n + 1)]
    E = [[neg] * (m + 1) for _ in range(n + 1)]
    F = [[neg] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        H[i][0] = -(go + ge * i)
        for j in range(1, m + 1):
            E[i][j] = max(E[i - 1][j] - ge, H[i - 1][j] - go - ge)
            F[i][j] = max(F[i][j - 1] - ge, H[i][j - 1] - go - ge)
            s = ma if q[i - 1] == t[j - 1] and q[i - 1] < 4 else mi
            H[i][j] = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
    return max(H[n][j] for j in range(m + 1))


def test_fit_scores_match_a_scalar_gotoh():
    r = np.random.default_rng(0)
    P, Lq, Lt = 40, 12, 18
    q = r.integers(0, 4, (P, Lq)).astype(np.uint8)
    t = r.integers(0, 4, (P, Lt)).astype(np.uint8)
    t[::2, 2:2 + Lq] = q[::2]                  # half of them a near match
    t[::4, 5] = (t[::4, 5] + 1) % 4
    ql = r.integers(0, Lq + 1, P)
    tl = r.integers(0, Lt + 1, P)
    got = dp.fit_scores(torch.as_tensor(q), torch.as_tensor(ql),
                        torch.as_tensor(t), torch.as_tensor(tl),
                        1, -2, 3, 1).tolist()
    want = [gotoh_fit(q[i, :ql[i]].tolist(), t[i, :tl[i]].tolist())
            for i in range(P)]
    assert got == want


def test_minimizers_are_each_windows_leftmost_least():
    r = np.random.default_rng(1)
    L = 90
    c = torch.as_tensor(r.integers(0, 4, (3, L)).astype(np.uint8))
    lens = torch.tensor([90, 60, 33])
    _, marks = mapper._marks_of(c, lens)
    for b in range(3):
        n = int(lens[b]) - mapper.K + 1
        v = mapper.kmer_values(c[b:b + 1, :int(lens[b])])[0]
        h = mapper.hash17(v).tolist()
        want = set()
        for i in range(n - mapper.W + 1):
            w = h[i:i + mapper.W]
            want.add(i + w.index(min(w)))
        assert set(torch.nonzero(marks[b]).flatten().tolist()) == want


def test_hash_words_put_the_last_base_in_the_top_bits():
    # the 17-mer of all A then one T: words (0, 3 << 30)
    v = torch.tensor([3])
    one = mapper.hash17(v)
    assert 0 <= int(one) < 2 ** 32
    assert int(mapper.hash17(torch.tensor([3 << 2]))) != int(one)


def test_vote_and_verify_on_a_read_with_an_indel():
    """A read cut from a unitig maps to it at its start; with one base
    deleted the gapless bound fails and the DP accepts it; a read of
    another sequence stays unmapped."""
    k = 45
    seq = rand_seq(600, 9)
    canon = sorted({min(e, rc(e)) for e in
                    (seq[i:i + k + 1] for i in range(len(seq) - k))})
    rows = kmers.encode(torch.as_tensor(np.stack([codes(e) for e in canon])))
    g = unitigs.build(rows, torch.ones(len(canon), dtype=torch.int64), k)
    ix = mapper.build_index(g, "cpu")
    u = [i for i in range(g.n)
         if "".join(ACGT[c] for c in g.seq(i)) == seq][0]
    read = seq[100:250]
    dele = read[:70] + read[71:]
    bases, lens = pad([read, dele, rand_seq(150, 10)], 152)
    e, s = mapper.map_reads(ix, bases, lens, "cpu")
    assert e.tolist() == [u, u, -1] and s.tolist()[:2] == [100, 100]
    e2, _ = mapper.map_reads(ix, bases, lens, "cpu", with_dp=False)
    assert e2.tolist() == [u, -1, -1]


def test_every_combination_of_reads_and_windows_is_covered():
    # windows that run past a read's length or over a padding code are
    # not counted, whatever the width of the matrix
    for L, W in itertools.product((46, 50), (46, 60)):
        if W < L:
            continue
        b, ln = pad([rand_seq(L, L + W)], W)
        assert len(kmers.window_rows(torch.as_tensor(b),
                                     torch.as_tensor(ln), 46)) == L - 45
