"""Synthetic genomes and reads.

random_genome, revcomp and sim_reads are copies of
turingassembler_tpu/testing.py: the same seeds give the same arrays, so
a run of the port and a run of the JAX package start from identical
data.  mutate_identity and genome_with_repeat_family are copies too.
sim_indel_reads makes reads that need the alignment DP;
second_haplotype plants the variant clusters whose bubbles reach the
align-bubble check, diploid_reads samples both haplotypes;
kmer_hashes and graphs_isomorphic serve the checks of a run.
sim_barcoded_pairs, sim_barcoded_pairs_fast and apply_indel_errors are
copies as well; plant_single_indels is their vectorised single-indel
form, genome_with_exact_repeats the genome whose contigs only barcodes
can order, sim_molecule_pairs samples barcoded molecules evenly up to
a linear genome's ends, and linked_read_library writes a linked-read
library of such a genome as FASTQ files.  two_path_local_graph and
read_pairs_of make a local graph with two candidate paths between its
flanks and the read pairs of one of them, for the bridge's path
scoring."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import os

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


def sim_barcoded_pairs(
    genome: np.ndarray,
    molecule_len: int = 20000,
    n_molecules: int = 300,
    reads_per_molecule: int = 60,
    read_len: int = 100,
    insert: int = 300,
    seed: int = 0,
    error_rate: float = 0.0,
):
    """Linked-read simulation: long molecules carry a barcode; paired-end
    reads sample each molecule (mimics TELL-Seq read clouds).

    Returns (r1, r2, lengths1, lengths2, barcodes (N,) int64) where read
    pairs are FR-oriented like real libraries.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    r1s, r2s, bcs = [], [], []
    for mol in range(n_molecules):
        mstart = int(rng.integers(0, max(G - molecule_len, 1) + 1))
        mlen = min(molecule_len, G - mstart)
        if mlen < insert + 1:
            continue
        starts = rng.integers(mstart, mstart + mlen - insert + 1, size=reads_per_molecule)
        for s in starts:
            frag = genome[s : s + insert]
            fwd = frag[:read_len]
            rev = revcomp(frag)[:read_len]
            if rng.random() < 0.5:
                r1s.append(fwd); r2s.append(rev)
            else:
                r1s.append(rev); r2s.append(fwd)
            bcs.append(mol)
    r1 = np.stack(r1s).astype(np.uint8)
    r2 = np.stack(r2s).astype(np.uint8)
    if error_rate > 0:
        for arr in (r1, r2):
            errs = rng.random(arr.shape) < error_rate
            arr[errs] = (arr[errs] + rng.integers(1, 4, errs.sum())) % 4
    lengths = np.full(len(r1), read_len, np.int32)
    return r1, r2, lengths, lengths.copy(), np.asarray(bcs, np.int64)


def sim_barcoded_pairs_fast(
    genome: np.ndarray,
    molecule_len: int = 20000,
    n_molecules: int = 300,
    reads_per_molecule: int = 60,
    read_len: int = 100,
    insert: int = 300,
    seed: int = 0,
    error_rate: float = 0.0,
    collision_rate: float = 0.0,
    chimera_rate: float = 0.0,
):
    """Vectorized linked-read simulator (same distributional semantics
    as sim_barcoded_pairs, no per-read python loop) with two harsher
    real-read-cloud features:

      collision_rate  fraction of molecules whose barcode is REUSED
                      from another random molecule (real TELL-Seq/10X
                      libraries put several molecules on one barcode);
      chimera_rate    fraction of molecules whose second half of reads
                      comes from a DIFFERENT random locus under the
                      same barcode (chimeric molecule / GEM artifact).

    Returns (r1, r2, lengths1, lengths2, barcodes)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    mstart = rng.integers(0, max(G - molecule_len, 1) + 1, n_molecules)
    mlen = np.minimum(molecule_len, G - mstart)
    ok = mlen >= insert + 1
    mstart, mlen = mstart[ok], mlen[ok]
    mol_ids = np.flatnonzero(ok)
    M = len(mstart)
    R = reads_per_molecule

    bc_of_mol = mol_ids.copy()
    if collision_rate > 0 and M > 1:
        hit = rng.random(M) < collision_rate
        bc_of_mol[hit] = bc_of_mol[rng.integers(0, M, int(hit.sum()))]

    span = (mlen - insert + 1).astype(np.int64)
    starts = mstart[:, None] + (rng.random((M, R)) * span[:, None]).astype(np.int64)
    if chimera_rate > 0 and M > 1:
        chim = rng.random(M) < chimera_rate
        n_c = int(chim.sum())
        if n_c:
            alt = rng.integers(0, max(G - molecule_len, 1) + 1, n_c)
            alt_len = np.minimum(molecule_len, G - alt)
            keep = alt_len >= insert + 1
            alt_span = (alt_len - insert + 1).astype(np.int64)
            half = R // 2
            alt_starts = alt[:, None] + (
                rng.random((n_c, R - half)) * alt_span[:, None]).astype(np.int64)
            rows = np.flatnonzero(chim)[keep]
            starts[rows, half:] = alt_starts[keep]
    starts = starts.ravel()
    bcs = np.repeat(bc_of_mol, R)
    N = len(starts)

    frag = genome[starts[:, None] + np.arange(insert)[None, :]]
    fwd = np.ascontiguousarray(frag[:, :read_len])
    rev = np.ascontiguousarray((3 - frag)[:, ::-1][:, :read_len])
    swap = rng.random(N) < 0.5
    r1 = np.where(swap[:, None], rev, fwd).astype(np.uint8)
    r2 = np.where(swap[:, None], fwd, rev).astype(np.uint8)
    if error_rate > 0:
        for arr in (r1, r2):
            errs = rng.random(arr.shape) < error_rate
            arr[errs] = (arr[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    lengths = np.full(N, read_len, np.int32)
    return r1, r2, lengths, lengths.copy(), bcs.astype(np.int64)


def apply_indel_errors(
    reads: np.ndarray, lengths: np.ndarray,
    sub_rate: float = 0.008, indel_rate: float = 0.002, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Realistic error model: substitutions + insertions/deletions.
    Returns new (reads, lengths) with per-read variable lengths (padded
    with 255 to the original width)."""
    rng = np.random.default_rng(seed)
    N, L = reads.shape
    out = np.full((N, L), 255, np.uint8)
    out_len = np.zeros(N, np.int32)
    for i in range(N):
        seq = list(reads[i, : lengths[i]])
        # substitutions
        j = 0
        res = []
        while j < len(seq):
            r = rng.random()
            if r < indel_rate / 2:        # deletion
                j += 1
                continue
            if r < indel_rate:            # insertion
                res.append(int(rng.integers(0, 4)))
                # current base still emitted below
            b = seq[j]
            if rng.random() < sub_rate:
                b = (b + int(rng.integers(1, 4))) % 4
            res.append(b)
            j += 1
        res = res[:L]
        out[i, : len(res)] = res
        out_len[i] = len(res)
    return out, out_len


def plant_single_indels(reads: np.ndarray, frac: float, seed: int = 0,
                        lo: int = 40, hi: int = 110
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One single-base indel in a fraction `frac` of full-width reads, at
    a read position in [lo, hi): an inserted random base pushes the last
    base out (length stays), a deleted base leaves the read one shorter
    (255 in its last column).  Vectorised.  Returns (reads, lengths)."""
    rng = np.random.default_rng(seed)
    N, L = reads.shape
    hit = rng.random(N) < frac
    p = rng.integers(lo, min(hi, L - 1), size=N)[:, None]
    ins = (rng.random(N) < 0.5)[:, None]
    j = np.arange(L)[None, :]
    src = np.minimum(np.where(ins, j - (j > p), j + (j >= p)), L - 1)
    alt = np.take_along_axis(reads, src, axis=1)
    alt = np.where(ins & (j == p), rng.integers(0, 4, size=(N, 1)), alt)
    alt = np.where(~ins & (j == L - 1), 255, alt).astype(np.uint8)
    out = np.where(hit[:, None], alt, reads).astype(np.uint8)
    lengths = np.where(hit & ~ins[:, 0], L - 1, L).astype(np.int32)
    return out, lengths


def genome_with_exact_repeats(genome_len: int, n_segments: int = 12,
                              repeat_len: int = 3000, seed: int = 0):
    """`n_segments` unique segments separated by identical copies of one
    repeat of `repeat_len` bases.  No graph pass can join two segments
    across a copy (every copy is the same sequence, longer than a read
    pair's insert), so the assembled graph keeps one contig a segment
    and only shared barcodes order them.  Returns (genome, segment
    starts (n_segments,), segment length)."""
    seg = (genome_len - (n_segments - 1) * repeat_len) // n_segments
    rep = random_genome(repeat_len, seed=seed + 1000)
    parts, starts, pos = [], [], 0
    for i in range(n_segments):
        starts.append(pos)
        parts.append(random_genome(seg, seed=seed + i))
        pos += seg
        if i < n_segments - 1:
            parts.append(rep)
            pos += repeat_len
    return np.concatenate(parts), np.asarray(starts, np.int64), seg


def sim_molecule_pairs(genome: np.ndarray, molecule_len: int,
                       n_molecules: int, pairs_per_molecule: int,
                       read_len: int, insert: int, seed: int,
                       error_rate: float = 0.0):
    """FR read pairs of barcoded molecules that cover a linear genome
    evenly up to its ends: a molecule is a window of `molecule_len`
    bases that may hang over either end and is cut there, as a fragment
    of a chromosome is, and gives pairs in proportion to what is left of
    it (sim_barcoded_pairs_fast keeps every molecule inside the genome,
    which leaves the outer `molecule_len` bases with fewer and fewer
    molecules).  Vectorised.  Returns (r1, r2 (N, read_len) uint8,
    barcodes (N,) int64, ascending, one number a molecule)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    mstart = rng.integers(insert - molecule_len, G - insert + 1, n_molecules)
    lo = np.maximum(mstart, 0)
    hi = np.minimum(mstart + molecule_len, G)
    n = np.maximum(np.rint(pairs_per_molecule * (hi - lo)
                           / molecule_len).astype(np.int64), 1)
    mol = np.repeat(np.arange(n_molecules), n)
    span = (hi - lo - insert + 1)[mol]
    starts = lo[mol] + (rng.random(len(mol)) * span).astype(np.int64)
    frag = genome[starts[:, None] + np.arange(insert)[None, :]]
    fwd = frag[:, :read_len]
    rev = (3 - frag)[:, ::-1][:, :read_len]
    swap = rng.random(len(mol)) < 0.5
    r1 = np.where(swap[:, None], rev, fwd).astype(np.uint8)
    r2 = np.where(swap[:, None], fwd, rev).astype(np.uint8)
    if error_rate > 0:
        for arr in (r1, r2):
            errs = rng.random(arr.shape) < error_rate
            arr[errs] = (arr[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    return r1, r2, mol.astype(np.int64)


def _encode_barcodes(bcs: np.ndarray, length: int) -> np.ndarray:
    """(N,) barcode numbers -> (N, length) ASCII of their base-5 digits,
    most significant first (the inverse of io.fastq.decode_barcode_seq)."""
    digits = np.zeros((len(bcs), length), np.int64)
    v = bcs.astype(np.int64).copy()
    for j in range(length - 1, -1, -1):
        digits[:, j] = v % 5
        v //= 5
    return np.frombuffer(b"ACGTN", np.uint8)[digits]


def linked_read_library(genome_len: int, seed: int, out_dir: str, *,
                        n_segments: int = 12, repeat_len: int = 3000,
                        coverage: float = 40.0, read_len: int = 150,
                        insert: int = 300, molecule_len: int = 30000,
                        pairs_per_molecule: int = 20,
                        error_rate: float = 0.005, indel_frac: float = 0.02,
                        lib: str = "ust", barcode_len: int = 18
                        ) -> Tuple[np.ndarray, Dict[str, str]]:
    """Write a linked-read library of a genome_with_exact_repeats genome
    into `out_dir` and return (genome, files).

    Molecules of `molecule_len` bases carry one barcode each and give
    `pairs_per_molecule` FR read pairs of `read_len` bases at `insert`
    (sim_molecule_pairs: fewer where the genome's end cuts them); their
    number follows from `coverage`.  Reads carry substitutions at
    `error_rate` and a fraction `indel_frac` one single-base indel.
    `lib` picks the layout: "ust" writes R1.fq, R2.fq and the index read
    I1.fq (`barcode_len` bases); "bioturing" puts `BX:Z:<barcode>` into
    the R1 and R2 comments; "10x" puts a 16-base barcode and 7 UMI bases
    in front of R1.  files maps "R1", "R2" (and "I1") to paths."""
    rng = np.random.default_rng(seed + 7)
    genome, _, _ = genome_with_exact_repeats(genome_len, n_segments,
                                             repeat_len, seed)
    n_pairs = coverage * len(genome) / (2 * read_len)
    r1, r2, bcs = sim_molecule_pairs(
        genome, min(molecule_len, len(genome)),
        max(int(round(n_pairs / pairs_per_molecule)), 1),
        pairs_per_molecule, read_len, insert, seed + 1, error_rate)
    r1, l1 = plant_single_indels(r1, indel_frac, seed=seed + 2)
    r2, l2 = plant_single_indels(r2, indel_frac, seed=seed + 3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if lib == "10x":
        barcode_len = 16
    bseq = _encode_barcodes(bcs + 1, barcode_len)
    os.makedirs(out_dir, exist_ok=True)
    files = {n: os.path.join(out_dir, n + ".fq") for n in
             (("R1", "R2", "I1") if lib == "ust" else ("R1", "R2"))}
    s1, s2 = acgt[np.minimum(r1, 3)], acgt[np.minimum(r2, 3)]
    umi = acgt[rng.integers(0, 4, (len(r1), 7))] if lib == "10x" else None
    qual = b"I" * (read_len + 23)
    with open(files["R1"], "wb") as o1, open(files["R2"], "wb") as o2:
        for i in range(len(r1)):
            a, b = s1[i, :l1[i]].tobytes(), s2[i, :l2[i]].tobytes()
            tag = b""
            if lib == "bioturing":
                tag = b" BX:Z:" + bseq[i].tobytes()
            elif lib == "10x":
                a = bseq[i].tobytes() + umi[i].tobytes() + a
            o1.write(b"@r%d%s\n%s\n+\n%s\n" % (i, tag, a, qual[:len(a)]))
            o2.write(b"@r%d%s\n%s\n+\n%s\n" % (i, tag, b, qual[:len(b)]))
    if lib == "ust":
        with open(files["I1"], "wb") as oi:
            for i in range(len(r1)):
                oi.write(b"@r%d\n%s\n+\n%s\n"
                         % (i, bseq[i].tobytes(), qual[:barcode_len]))
    return genome, files


def two_path_local_graph(seed: int, flank: int = 600, branch: int = 1200,
                         indel: int = 40, snp_every: int = 20, k: int = 31):
    """A local graph at k over the (k+1)-mers of two sequences, L + X + R
    and L + Y + R, two alleles of one locus: Y is X with a substitution
    every `snp_every` bases and less `indel` bases at its middle (random
    flanks L, R of `flank` bases and X of `branch`), and the paths
    between its flank edges.  Returns (graph, paths, (lc_e1, lc_e2),
    (seq_x, seq_y)); each path is a list of edge ids from lc_e1 (the edge
    that starts with L) to lc_e2 (the edge that ends with R)."""
    from .graph.build import build_graph_from_kedges
    from .localasm import local as L
    rng = np.random.default_rng(seed)
    left, x, right = (rng.integers(0, 4, n).astype(np.uint8)
                      for n in (flank, branch, flank))
    cut = (branch - indel) // 2
    y = x.copy()
    y[snp_every // 2::snp_every] = (y[snp_every // 2::snp_every] + 1) % 4
    y = np.concatenate([y[:cut], y[cut + indel:]])
    seq_x = np.concatenate([left, x, right])
    seq_y = np.concatenate([left, y, right])
    kedges = np.unique(np.vstack([L._seq_canon_kedges(s, k + 1)
                                  for s in (seq_x, seq_y)]), axis=0)
    g = build_graph_from_kedges(kedges, np.full(len(kedges), 20, np.int64),
                                k)
    head, tail = seq_x[:k + 1].tobytes(), seq_x[-(k + 1):].tobytes()
    lc_e1 = next(e for e in range(g.n_e) if g.get_seq(e)[:k + 1].tobytes()
                 == head)
    lc_e2 = next(e for e in range(g.n_e) if g.get_seq(e)[-(k + 1):].tobytes()
                 == tail)
    both = np.zeros((2, len(seq_x)), np.uint8)
    both[0], both[1, :len(seq_y)] = seq_x, seq_y
    kset = L.read_kmer_set(both, np.array([len(seq_x), len(seq_y)],
                                          np.int32), k + 6)
    paths = L.get_all_paths_kmer_check(g, L.EdgeMap(-1, lc_e1),
                                       L.EdgeMap(-1, lc_e2), k + 6, kset)
    return g, paths, (lc_e1, lc_e2), (seq_x, seq_y)


def read_pairs_of(seq: np.ndarray, n_pairs: int, seed: int,
                  read_len: int = 150, insert: int = 300,
                  error_rate: float = 0.005, indel_frac: float = 0.02):
    """FR read pairs of one sequence, with substitutions at error_rate
    and one single-base indel in a fraction indel_frac of the reads
    (plant_single_indels).  Returns (bases (2 * n_pairs, read_len) uint8,
    lengths (2 * n_pairs,) int32, n1 = n_pairs): rows [0, n1) are the R1
    mates and row n1 + i is row i's mate, as local_reads_for_pair
    lays them out."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(seq) - insert + 1, n_pairs)
    frag = seq[starts[:, None] + np.arange(insert)[None, :]]
    fwd = frag[:, :read_len]
    rev = (3 - frag)[:, ::-1][:, :read_len]
    swap = rng.random(n_pairs) < 0.5
    reads = np.concatenate([np.where(swap[:, None], rev, fwd),
                            np.where(swap[:, None], fwd, rev)]
                           ).astype(np.uint8)
    errs = rng.random(reads.shape) < error_rate
    reads[errs] = (reads[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    reads, lengths = plant_single_indels(reads, indel_frac, seed=seed + 1)
    return reads, lengths, n_pairs
