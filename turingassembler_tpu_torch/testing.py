"""Synthetic genomes and reads.

random_genome, revcomp and sim_reads are copies of
turingassembler_tpu/testing.py: the same seeds give the same arrays, so
a run of the port and a run of the JAX package start from identical
data.  mutate_identity and genome_with_repeat_family are copies too.
sim_indel_reads makes reads that need the alignment DP;
second_haplotype plants the variant clusters whose bubbles reach the
align-bubble check, diploid_reads samples both haplotypes;
kmer_hashes and graphs_isomorphic serve the checks of a run."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_genome(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq)[::-1]


def sim_reads(
    genome: np.ndarray,
    coverage: float = 30.0,
    read_len: int = 100,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = False,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform single-end reads from both strands, optional substitution
    errors.  Returns (reads (N, L) uint8 codes padded with 255, lengths
    (N,) int32)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_reads = int(np.ceil(coverage * G / read_len))
    L = pad_to or read_len
    if circular:
        starts = rng.integers(0, G, size=n_reads)
        idx = (starts[:, None] + np.arange(read_len)[None, :]) % G
    else:
        starts = rng.integers(0, max(G - read_len, 1) + 1, size=n_reads)
        idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    if error_rate > 0:
        errs = rng.random(reads.shape) < error_rate
        reads = np.where(errs, (reads + rng.integers(1, 4, size=reads.shape)) % 4,
                         reads).astype(np.uint8)
    out = np.full((n_reads, L), 255, np.uint8)
    out[:, :read_len] = reads
    return out, np.full(n_reads, read_len, np.int32)


def sim_indel_reads(genome: np.ndarray, n: int, read_len: int = 150,
                    seed: int = 0, pad_to: Optional[int] = None,
                    lo: int = 50, hi: int = 100
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """n reads from both strands, each carrying one single-base indel at
    a read position in [lo, hi): half insertions of a random base, half
    deletions.  Vectorised; returns (reads (n, L) uint8 255-padded,
    lengths (n,) int32)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len, size=n)
    p = rng.integers(lo, hi, size=n)[:, None]
    ins = (rng.random(n) < 0.5)[:, None]
    j = np.arange(read_len)[None, :]
    # deletion skips genome base p; insertion puts a random base at p
    src = np.where(ins, j - (j > p), j + (j >= p))
    reads = genome[starts[:, None] + src]
    reads = np.where(ins & (j == p), rng.integers(0, 4, size=(n, 1)),
                     reads).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    out = np.full((n, pad_to or read_len), 255, np.uint8)
    out[:, :read_len] = reads
    return out, np.full(n, read_len, np.int32)


def mutate_identity(seq: np.ndarray, identity: float, seed: int = 0) -> np.ndarray:
    """Substitute bases so the copy is ~identity similar to seq."""
    rng = np.random.default_rng(seed)
    out = seq.copy()
    m = rng.random(len(seq)) > identity
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out.astype(np.uint8)


def genome_with_repeat_family(
    n_segments: int = 4,
    segment_len: int = 8000,
    repeat_len: int = 2000,
    identity: float = 0.95,
    seed: int = 0,
) -> np.ndarray:
    """Unique segments interleaved with near-identical repeat-family
    copies (the hard case for real assemblers: 90-98%-identity repeats
    collapse or misjoin if resolution is weak)."""
    base_rep = random_genome(repeat_len, seed=seed + 1000)
    parts = []
    for i in range(n_segments):
        parts.append(random_genome(segment_len, seed=seed + i))
        if i < n_segments - 1:
            parts.append(mutate_identity(base_rep, identity, seed=seed + 2000 + i))
    return np.concatenate(parts)


def second_haplotype(hap_a: np.ndarray, seed: int = 0,
                     cell: int = 2000) -> Tuple[np.ndarray, int]:
    """A second haplotype: hap_a with one variant cluster in every
    `cell` bases, clusters at least 200 bp apart.  A cluster is a pair of
    SNPs 15-40 bp apart, a deletion of 10-60 bp or an insertion of 10-60
    random bases, a third each.  In a de Bruijn graph of both haplotypes
    at k = 45 each cluster is a bubble whose longer branch is ~100-150 bp:
    past the 100 bp that the simple-bubble pass takes without alignment,
    so the align-bubble check scores it.  Returns (hap_b, n_clusters)."""
    rng = np.random.default_rng(seed)
    n = len(hap_a) // cell
    at = np.arange(n) * cell + rng.integers(100, cell - 200, n)
    kind = rng.integers(0, 3, n)
    size = rng.integers(10, 61, n)
    gap = rng.integers(15, 41, n)
    parts, pos = [], 0
    for p, kd, sz, gp in zip(at.tolist(), kind.tolist(), size.tolist(),
                             gap.tolist()):
        parts.append(hap_a[pos:p])
        if kd == 0:
            seg = hap_a[p:p + gp + 1].copy()
            seg[[0, gp]] = (seg[[0, gp]] + rng.integers(1, 4, 2)) % 4
            parts.append(seg.astype(np.uint8))
            pos = p + gp + 1
        elif kd == 1:
            pos = p + sz
        else:
            parts.append(rng.integers(0, 4, sz).astype(np.uint8))
            pos = p
    parts.append(hap_a[pos:])
    return np.concatenate(parts), n


def kmer_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    """A 64-bit hash of every k-mer of a code sequence (codes 0-3), in
    order: the last 32 bases as a base-4 number, xor a multiple of the
    bases before them.  Equal k-mers hash equal; for k <= 32 the hash is
    injective."""
    if len(seq) < k:
        return np.zeros(0, np.uint64)
    s = seq.astype(np.uint64)
    n = len(seq) - k + 1
    h = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    for j in range(k):
        if j < k - 32:
            hi = (hi << np.uint64(2)) | s[j:j + n]
        else:
            h = (h << np.uint64(2)) | s[j:j + n]
    return h ^ (hi * np.uint64(0x9E3779B97F4A7C15))


def diploid_reads(genome_len: int, seed: int, coverage: float = 20.0,
                  read_len: int = 150, error_rate: float = 0.005,
                  n_repeats: int = 7, repeat_len: int = 2000):
    """The levels workload: a genome of `genome_len` bases with a planted
    repeat family (n_repeats copies of repeat_len bases at 95% identity)
    as haplotype A, second_haplotype of it as B, and reads of both at
    `coverage` each with substitution errors.  Returns (hap_a, hap_b,
    n_clusters, reads (N, read_len) uint8, lengths (N,) int32); the reads
    of A come first."""
    seg = (genome_len - n_repeats * repeat_len) // (n_repeats + 1)
    hap_a = genome_with_repeat_family(n_repeats + 1, seg, repeat_len, 0.95,
                                      seed=seed)
    hap_b, n_clusters = second_haplotype(hap_a, seed=seed + 1)
    ra, la = sim_reads(hap_a, coverage, read_len, seed=seed + 2,
                       error_rate=error_rate)
    rb, lb = sim_reads(hap_b, coverage, read_len, seed=seed + 3,
                       error_rate=error_rate)
    return (hap_a, hap_b, n_clusters, np.concatenate([ra, rb]),
            np.concatenate([la, lb]))


def graphs_isomorphic(ga, gb) -> None:
    """Raise AssertionError unless two graphs built from one k-mer table
    are the same up to node numbering: equal edge arrays (edge ids match
    by construction) and a consistent, rc-respecting bijection of the
    nodes."""
    assert ga.n_e == gb.n_e and ga.n_v == gb.n_v
    for f in ("edge_rc", "edge_count", "seq_off", "seq_data"):
        assert np.array_equal(getattr(ga, f), getattr(gb, f)), f
    a = np.concatenate([ga.edge_source, ga.edge_target])
    b = np.concatenate([gb.edge_source, gb.edge_target])
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    assert len(np.unique(pairs[:, 0])) == len(pairs), "node map conflict"
    assert len(np.unique(pairs[:, 1])) == len(pairs), "node map not 1:1"
    phi = np.full(ga.n_v, -1, np.int64)
    phi[pairs[:, 0]] = pairs[:, 1]
    rc_a = ga.node_rc[pairs[:, 0]]
    known = phi[rc_a] >= 0
    assert np.array_equal(phi[rc_a][known],
                          gb.node_rc[pairs[:, 1]][known]), "rc structure"
