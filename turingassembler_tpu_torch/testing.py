"""Synthetic genomes and reads.

random_genome, revcomp, sim_reads and codes_to_str are copies of
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
library of such a genome as FASTQ files; fastq_block formats reads of
one length as FASTQ records at numpy speed.  two_path_local_graph and
read_pairs_of make a local graph with two candidate paths between its
flanks and the read pairs of one of them, for the bridge's path
scoring.  make_212_genome (a copy of tests/test_resolve_big.py's) makes
the two sequences through one short repeat of the 2-1-2 resolvers.
mm_world, mm_reads, mm_bound_queries, mm_segment_rows and mm_map_cases
make the minimizer map kernel's edge cases (ops/mm_map.py);
mm_align_world, mm_align_queries, mm_pool_end_reads and mm_align_cases
its gapless bound's alignment and pool-end cases; kmer_sort_cases the
count's sort cases, over_capacity_rows a repeat-rich count's rows (many
prefixes, each with one row repeated past a sort block), kedge_table and unitig_build_cases the level-0
build's k-edge tables (ops/unitig_build.py), link_collision_cases
made-up fingerprint collisions of its link_nodes."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import os

import numpy as np


def random_genome(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq)[::-1]


def codes_to_str(codes: np.ndarray) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()


def fastq_block(first_id: int, seqs: np.ndarray) -> bytes:
    """FASTQ records `@r<i>`, i from first_id, of the rows of `seqs`
    ((n, L) ASCII bytes, every read L long), each with a quality line of
    L 'I': the bytes of one f"@r{i}\n{seq}\n+\n{'I' * L}\n" a record,
    built a group of equal id widths at a time."""
    n, L = seqs.shape
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    width = np.char.str_len(ids.astype(str))
    out = []
    for w in np.unique(width):
        sel = np.flatnonzero(width == w)
        rec = np.empty((len(sel), w + 2 * L + 7), np.uint8)
        rec[:, 0], rec[:, 1] = ord("@"), ord("r")
        v = ids[sel].copy()
        for j in range(w + 1, 1, -1):
            rec[:, j] = 48 + v % 10
            v //= 10
        rec[:, w + 2] = ord("\n")
        rec[:, w + 3: w + 3 + L] = seqs[sel]
        tail = w + 3 + L
        rec[:, tail: tail + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, tail + 3: tail + 3 + L] = ord("I")
        rec[:, -1] = ord("\n")
        out.append(rec.tobytes())
    return b"".join(out)


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


def make_212_genome(seed=2, rep_len=60, k=21):
    """Two sequences sharing a short middle repeat: A0-R-B0 and A1-R-B1
    creates a 2-in/1-mid/2-out junction at R (rep shorter than
    DISTANCE_KMER + 51 - 2 - 2k so the span check applies)."""
    rng = np.random.default_rng(seed)
    A0 = rng.integers(0, 4, 3000).astype(np.uint8)
    A1 = rng.integers(0, 4, 3000).astype(np.uint8)
    B0 = rng.integers(0, 4, 3000).astype(np.uint8)
    B1 = rng.integers(0, 4, 3000).astype(np.uint8)
    R = rng.integers(0, 4, rep_len).astype(np.uint8)
    h0 = np.concatenate([A0, R, B0])
    h1 = np.concatenate([A1, R, B1])
    return h0, h1


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


def encode_barcodes(bcs: np.ndarray, length: int) -> np.ndarray:
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
    bseq = encode_barcodes(bcs + 1, barcode_len)
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


# ---------------------------------------------------------------------------
# the minimizer map's edge cases (ops/mm_map.py: kernel against plain)
# ---------------------------------------------------------------------------

MM_EDGE_LENS = (5_000, 900, 600, 160)   # forward edges; their rcs follow


def mm_world(seed: int = 0):
    """A pool of random edges and their reverse complements as an AsmGraph
    the minimizer index can be built on (the bridge's candidate-graph
    layout).  Edge 2 carries a 300 bp copy of edge 0, so some minimizers
    occur twice and vote nothing; edge 3 is shorter than a read."""
    from .graph.structs import AsmGraph
    rng = np.random.default_rng(seed)
    fwd = [rng.integers(0, 4, n).astype(np.uint8) for n in MM_EDGE_LENS]
    fwd[2][100:400] = fwd[0][1_000:1_300]
    seqs = [s for f in fwd for s in (f, revcomp(f).copy())]
    g = AsmGraph(ksize=31)
    g.seq_off = np.concatenate(
        [[0], np.cumsum([len(s) for s in seqs])]).astype(np.int64)
    g.seq_data = np.concatenate(seqs).astype(np.uint8)
    g.edge_source = np.zeros(len(seqs), np.int64)
    g.edge_target = np.zeros(len(seqs), np.int64)
    g.edge_rc = np.arange(len(seqs), dtype=np.int64) ^ 1
    g.edge_count = np.ones(len(seqs), np.int64)
    g.node_rc = np.zeros(1, np.int64)
    return g


def mm_reads(g, B: int, L: int, seed: int, k: int = 17, w: int = 17):
    """B reads of width L on the edges of g, eight kinds by row: three of
    plain reads with 1% substitutions, reads with code-4 bases, reads
    shorter than k + w - 1 (lengths 0 to k + w - 1), head and tail
    overhangs (negative starts, reads past the edge end; random bases
    off the edge), and junctions of two edges split anywhere in the
    middle half (ties between two edges, reads under the confidence
    gate).  Returns (bases (B, L) uint8, 255 past each length, lengths
    (B,) int32, thresholds (B,) int64 drawn per read)."""
    rng = np.random.default_rng(seed)
    pool, off, elen = g.seq_data, g.seq_off, g.edge_len()
    kind = np.arange(B) % 8
    n = rng.integers(max((3 * L) // 4, 1), L + 1, B)
    n[kind == 4] = rng.integers(0, k + w, int((kind == 4).sum()))
    e = rng.integers(0, g.n_e, B)
    e2 = (e + 1 + rng.integers(0, g.n_e - 1, B)) % g.n_e
    st = rng.integers(0, np.maximum(elen[e] - n, 0) + 1)
    ovh = rng.integers(1, np.maximum(n // 2, 1) + 1)
    st = np.where(kind == 5, -ovh, st)
    st = np.where(kind == 6, elen[e] - n + ovh, st)
    split = rng.integers(n // 4, 3 * n // 4 + 1)
    st = np.where(kind == 7, elen[e] - split, st)
    j = np.arange(L)[None, :]
    # junction reads leave edge e after `split` bases and go on into e2
    on2 = (kind[:, None] == 7) & (j >= split[:, None])
    ee = np.where(on2, e2[:, None], e[:, None])
    tpos = np.where(on2, j - split[:, None], st[:, None] + j)
    on = (tpos >= 0) & (tpos < elen[ee])
    src = np.clip(off[ee] + tpos, 0, len(pool) - 1)
    reads = np.where(on, pool[src], rng.integers(0, 4, (B, L))
                     ).astype(np.uint8)
    sub = rng.random((B, L)) < 0.01
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ns = kind == 3
    reads[np.flatnonzero(ns)[:, None],
          rng.integers(0, L, (int(ns.sum()), 2))] = 4
    reads[j >= n[:, None]] = 255
    thr = rng.integers(0, L + 1, B).astype(np.int64)
    return reads, n.astype(np.int32), thr


def mm_bound_queries(g, N: int, L: int, seed: int):
    """Queries for the gapless bound alone: edges (-1 for unmapped lanes),
    signed starts from a full query left of the edge to past its end,
    lengths 0 to L, codes copied from the edge where the query lies on it
    in three rows of four (with substitutions and code-4 bases), random
    elsewhere.  Returns (edges (N,) int64, starts (N,) int64, bases (N,
    L) uint8, lengths (N,) int32)."""
    rng = np.random.default_rng(seed)
    elen = g.edge_len()
    edges = rng.integers(-1, g.n_e, N).astype(np.int64)
    starts = rng.integers(-L + 1, int(elen.max()) + 10, N).astype(np.int64)
    lengths = rng.integers(0, L + 1, N).astype(np.int32)
    e = np.maximum(edges, 0)
    tpos = starts[:, None] + np.arange(L)[None, :]
    on = (tpos >= 0) & (tpos < elen[e][:, None]) & (np.arange(N) % 4 != 3
                                                    )[:, None]
    src = np.clip(g.seq_off[e][:, None] + tpos, 0, len(g.seq_data) - 1)
    bases = np.where(on, g.seq_data[src], rng.integers(0, 4, (N, L))
                     ).astype(np.uint8)
    sub = rng.random((N, L)) < 0.02
    bases[sub] = rng.integers(0, 5, int(sub.sum()))
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 255
    return edges, starts, bases, lengths


MM_ALIGN_WIDTHS = (1, 3, 4, 150, 151, 152, 153, 200)


def mm_align_world(seed: int = 0):
    """mm_world with code-4 bases in its pool: every 97th code and the
    pool's last one."""
    g = mm_world(seed)
    g.seq_data = g.seq_data.copy()
    g.seq_data[::97] = 4
    g.seq_data[-1] = 4
    return g


def mm_align_queries(g, L: int, seed: int):
    """Queries of width L for the gapless bound's word loads, at all 16
    start alignments against the pool in each of five places: inside edge
    0, over the heads of edges 0 and 1, over the last edge's tail (the
    on-edge span ends on the pool's last byte), and unmapped.  Lengths L
    or up to 3 less (at least 1); codes copied from the pool under the
    query, with 2% substitutions by codes 0-4 and a code 2 over every
    pool code 4 in every fifth query, random elsewhere, 255 past the
    length.  Returns (edges, starts, bases, lengths) as mm_bound_queries
    does."""
    rng = np.random.default_rng(seed)
    elen, off = g.edge_len(), g.seq_off
    last = g.n_e - 1
    a = np.arange(16)
    inside = 16 * rng.integers(0, (elen[0] - L - 16) // 16, 16) + \
        (a - off[0]) % 16
    edges = np.concatenate([np.zeros(16), np.zeros(16), np.ones(16),
                            np.full(16, last), np.full(16, -1)]
                           ).astype(np.int64)
    starts = np.concatenate([inside, -a, -a, elen[last] - L + a, a]
                            ).astype(np.int64)
    N = len(edges)
    lengths = (L - rng.integers(0, min(4, L), N)).astype(np.int32)
    lengths[::3] = L
    e = np.maximum(edges, 0)
    j = np.arange(L)[None, :]
    tpos = starts[:, None] + j
    on = (tpos >= 0) & (tpos < elen[e][:, None])
    src = np.clip(off[e][:, None] + tpos, 0, len(g.seq_data) - 1)
    bases = np.where(on, g.seq_data[src], rng.integers(0, 4, (N, L))
                     ).astype(np.uint8)
    sub = rng.random((N, L)) < 0.02
    bases[sub] = rng.integers(0, 5, int(sub.sum()))
    # every fifth query holds a code 2 where the pool holds a code 4
    bases[on & (g.seq_data[src] == 4) & (np.arange(N) % 5 == 1)[:, None]] = 2
    bases[j >= lengths[:, None]] = 255
    return edges, starts, bases, lengths


def mm_pool_end_reads(g, seed: int, L: int = 152):
    """Reads of width L copied from the end of g's last edge (the pool's
    last codes, 1% substitutions): ending on its last code or up to 8
    codes before it, or running up to 15 codes past it (random codes
    there); 4 each.  Returns (bases, lengths, thr) as mm_reads does."""
    rng = np.random.default_rng(seed)
    last = g.n_e - 1
    elen = int(g.edge_len()[last])
    st = elen - L + np.repeat(np.arange(-8, 16), 4)
    B = len(st)
    j = np.arange(L)[None, :]
    tpos = st[:, None] + j
    on = (tpos >= 0) & (tpos < elen)
    src = np.clip(g.seq_off[last] + tpos, 0, len(g.seq_data) - 1)
    reads = np.where(on, g.seq_data[src], rng.integers(0, 4, (B, L))
                     ).astype(np.uint8)
    sub = rng.random((B, L)) < 0.01
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    thr = rng.integers(0, L + 1, B).astype(np.int64)
    return reads, np.full(B, L, np.int32), thr


def mm_align_cases(seed: int = 0):
    """The bound's alignment and last-byte cases on mm_align_world:
    (graph, cases) as mm_map_cases gives them, a "bound" case for each
    width of MM_ALIGN_WIDTHS (mm_align_queries) and a "map" case of reads
    at the pool's end (mm_pool_end_reads)."""
    g = mm_align_world(seed)
    cases = {f"aligned queries L={L}": ("bound", mm_align_queries(
        g, L, seed + i)) for i, L in enumerate(MM_ALIGN_WIDTHS)}
    cases["reads at the pool's end"] = ("map", mm_pool_end_reads(g,
                                                                 seed + 99))
    return g, cases


def mm_segment_rows(g, B: int, L: int, seed: int, k: int = 17,
                    w: int = 17):
    """Segment rows as the minimizer index build cuts them (an edge's
    codes from an offset, 255 past its end): B rows of width L with their
    lengths, from edges drawn by length, some with code-4 bases, some
    shorter than k + w - 1.
    Returns (rows (B, L) uint8, lengths (B,) int32)."""
    rng = np.random.default_rng(seed)
    elen = g.edge_len()
    e = rng.choice(g.n_e, B, p=elen / elen.sum())     # by length
    s = rng.integers(0, np.maximum(elen[e] - k, 0) + 1)
    tpos = s[:, None] + np.arange(L)[None, :]
    on = tpos < elen[e][:, None]
    rows = np.where(on, g.seq_data[np.clip(g.seq_off[e][:, None] + tpos, 0,
                                           len(g.seq_data) - 1)], 255
                    ).astype(np.uint8)
    lengths = np.minimum(elen[e] - s, L).astype(np.int32)
    short = np.arange(B) % 4 == 1
    lengths[short] = rng.integers(0, k + w - 1, int(short.sum()))
    bad = rng.random((B, L)) < 0.002
    rows[bad & on] = 4
    rows[np.arange(L)[None, :] >= lengths[:, None]] = 255
    return rows, lengths


def mm_map_cases(seed: int = 0):
    """The minimizer map's edge cases on one mm_world: (graph, cases),
    cases a dict name -> (entry, arrays).  "map" entries hold (bases,
    lengths, thr) for the vote and the verified map: widths 152 (the
    reads), 640 (more than 48 minimizers a read, and a query past the
    bound's window, the wide branch) and 64 (exactly 48 window
    positions).  "bound" entries hold (edges, starts, bases, lengths) at
    widths 152 and 300 (the wide branch).  "rows" entries hold (rows,
    lengths) at the index build's width 4,128, at 200, and at 30, too
    narrow for one window."""
    g = mm_world(seed)
    cases = {
        "reads": ("map", mm_reads(g, 512, 152, seed + 1)),
        "wide reads": ("map", mm_reads(g, 96, 640, seed + 2)),
        "narrowest reads": ("map", mm_reads(g, 64, 64, seed + 3)),
        "queries": ("bound", mm_bound_queries(g, 256, 152, seed + 4)),
        "wide queries": ("bound", mm_bound_queries(g, 128, 300, seed + 5)),
        "segment rows": ("rows", mm_segment_rows(g, 6, 4_128, seed + 6)),
        "short rows": ("rows", mm_segment_rows(g, 16, 200, seed + 7)),
        "narrow rows": ("rows", mm_segment_rows(g, 4, 30, seed + 8)),
    }
    return g, cases


# kmer_sort_cases' "many prefixes over the capacity": prefixes, copies of
# each prefix's one repeated row, distinct rows beside it
OVER_CAPACITY_CASE = (200, 9_000, 20)


def over_capacity_rows(n_prefixes: int, copies: int, singles: int,
                       nl: int = 4, seed: int = 0, device="cpu"):
    """Rows shaped like a repeat-rich library's count (a few k-mers
    thousands of times over): n_prefixes distinct prefixes (the top 16
    bits of limb 0), each holding one row repeated `copies` times beside
    `singles` random rows of the same prefix; every other bit random;
    shuffled.  (n_prefixes * (copies + singles), nl) int64 limbs in
    [0, 2^32), made on `device` from `seed`."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(n):
        return torch.randint(0, 1 << 32, (n, nl), dtype=torch.int64,
                             device=device, generator=gen)

    prefix = torch.randperm(1 << 16, device=device,
                            generator=gen)[:n_prefixes] << 16
    heavy, single = rand(n_prefixes), rand(n_prefixes * singles)
    heavy[:, 0] = (heavy[:, 0] & 0xFFFF) | prefix
    single[:, 0] = (single[:, 0] & 0xFFFF) | prefix.repeat_interleave(singles)
    rows = torch.cat([heavy.repeat_interleave(copies, dim=0), single])
    return rows[torch.randperm(len(rows), device=device, generator=gen)]


def kmer_sort_cases(seed: int = 0):
    """Edge cases of the count's sort (ops/kmer_sort.py): name -> (keys (n,
    nl) int64 limbs in [0, 2^32), weights (n,) int32).  Rows of k1-mers
    have their unused low bits 0; the fingerprint sort's use every bit of
    every limb ("all ones, nl=2").  Cases: all rows
    equal; keys that differ only in the last used bit (k1 = 46, 64); a
    row count that is no multiple of a 4,096-row tile; ties with a
    payload; all-ones rows (a real key, not padding) among their
    neighbours at nl = 2 and nl = 4; one row.  And for sort_count's routes
    on a card (csrc/kmer_sort.cu): 40,000 rows of 300 keys sharing their
    top 16 bits among 20,000 others (one bucket over the block's
    capacity: the LSD route); 200,000 equal rows (no live digit, no
    pass); 300,000 rows of 100,000 canonical 46-mers, whose prefixes skew
    to A (a bucket of A-first rows about 7x one of T-first rows); 40,000
    one-limb rows (a partition at nl = 1); over_capacity_rows(200, 9,000,
    20), 1,804,000 rows at nl = 4 (200 buckets over the block's capacity
    of 8,928: the batched route, many groups at once).  And for
    lex_order's: 60,000
    rows of three values in each limb (0, 2^31 - 1, 2^32 - 2), three
    buckets over a block's capacity (the LSD route with the row index)."""
    rng = np.random.default_rng(seed)
    M32 = 0xFFFFFFFF

    def pool_rows(n, nl, n_keys, k1=None):
        keys = rng.integers(0, 1 << 32, (n_keys, nl), dtype=np.int64)
        if k1 is not None:
            used = 2 * k1 - 32 * (nl - 1)
            keys[:, -1] &= ((1 << used) - 1) << (32 - used)
        return keys[rng.integers(0, n_keys, n)]

    def weights(n):
        return rng.integers(1, 1000, n).astype(np.int32)

    def last_bit(k1, n):
        nl = (k1 + 15) // 16
        low = 32 - (2 * k1 - 32 * (nl - 1))      # the lowest used bit
        base = pool_rows(1, nl, 1, k1)[0]
        keys = np.repeat(base[None], n, axis=0)
        keys[:, -1] &= ~(1 << low)
        keys[rng.random(n) < 0.5, -1] |= 1 << low
        return keys

    def canonical_rows(n, n_keys, k1):
        """n rows drawn from n_keys random k1-mers, each in its canonical
        form: the smaller of its limbs and its reverse complement's."""
        nl = (k1 + 15) // 16
        codes = rng.integers(0, 4, (n_keys, k1), dtype=np.int64)

        def pack(c):
            c = np.pad(c, ((0, 0), (0, 16 * nl - k1))).reshape(-1, nl, 16)
            return (c << (30 - 2 * np.arange(16))).sum(axis=2)

        fw, rc = pack(codes), pack(3 - codes[:, ::-1])
        lt = np.zeros(n_keys, bool)
        eq = np.ones(n_keys, bool)
        for limb in range(nl):
            lt |= eq & (rc[:, limb] < fw[:, limb])
            eq &= rc[:, limb] == fw[:, limb]
        keys = np.where(lt[:, None], rc, fw)
        return keys[rng.integers(0, n_keys, n)]

    def one_prefix_over(n_over, n_tails, n_rest):
        tails = pool_rows(n_tails, 3, n_tails, 46)
        tails[:, 0] = (tails[:, 0] & 0xFFFF) \
            | (int(rng.integers(0, 1 << 16)) << 16)
        keys = np.concatenate([tails[rng.integers(0, n_tails, n_over)],
                               pool_rows(n_rest, 3, n_rest, 46)])
        return keys[rng.permutation(len(keys))]

    ones = pool_rows(9_000, 2, 40)
    ones[rng.random(9_000) < 0.3] = M32
    ones[rng.random(9_000) < 0.1, 1] = M32 - 1
    ones4 = pool_rows(3_000, 4, 30, 64)
    ones4[rng.random(3_000) < 0.4] = M32
    cases = {
        "all equal": np.repeat(pool_rows(1, 3, 1, 46), 5_000, axis=0),
        "last used bit, k1=46": last_bit(46, 6_000),
        "last used bit, k1=64": last_bit(64, 6_000),
        "ragged tile": pool_rows(2 * 4096 + 123, 3, 3_000, 46),
        "ties with a payload": pool_rows(12_345, 2, 700, 31),
        "all ones, nl=2": ones,
        "all ones, nl=4": ones4,
        "one row": pool_rows(1, 3, 1, 46),
        "one prefix over the capacity": one_prefix_over(40_000, 300, 20_000),
        "all equal, large": np.repeat(pool_rows(1, 3, 1, 46), 200_000,
                                      axis=0),
        "canonical-skewed prefixes": canonical_rows(300_000, 100_000, 46),
        "one limb, k1=16": pool_rows(40_000, 1, 10_000, 16),
        "many prefixes over the capacity": over_capacity_rows(
            *OVER_CAPACITY_CASE, seed=seed).numpy(),
    }
    cases = {name: (keys, weights(len(keys))) for name, keys in cases.items()}
    few = np.random.default_rng(seed + 1)
    keys = few.integers(0, 3, (60_000, 3)).astype(np.int64) * 0x7FFFFFFF
    cases["few values, large"] = (keys, few.integers(1, 1000, len(keys))
                                  .astype(np.int32))
    return cases


def kedge_table(reads: np.ndarray, lengths: np.ndarray, k: int):
    """The sorted unique canonical (k+1)-mers of every valid window of the
    reads (no code >= 4, inside the read's length) and how often each
    occurs: (uniq (n, nl) int64 limbs in [0, 2^32), counts (n,) int32), as
    the count gives them with min count 1."""
    k1 = k + 1
    nl = (k1 + 15) // 16
    B, L = reads.shape
    P = max(L - k1 + 1, 0)
    win = reads[:, np.arange(P)[:, None] + np.arange(k1)[None, :]]
    ok = (win < 4).all(axis=2) & \
        (np.arange(P)[None, :] + k1 <= np.asarray(lengths)[:, None])
    codes = win[ok].astype(np.int64)

    def pack(c):
        c = np.pad(c, ((0, 0), (0, 16 * nl - k1))).reshape(-1, nl, 16)
        return (c << (30 - 2 * np.arange(16))).sum(axis=2)

    fw, rc = pack(codes), pack(3 - codes[:, ::-1])
    lt = np.zeros(len(codes), bool)
    eq = np.ones(len(codes), bool)
    for limb in range(nl):
        lt |= eq & (rc[:, limb] < fw[:, limb])
        eq &= rc[:, limb] == fw[:, limb]
    canon = np.where(lt[:, None], rc, fw)
    if not len(canon):
        return np.zeros((0, nl), np.int64), np.zeros(0, np.int32)
    uniq, counts = np.unique(canon, axis=0, return_counts=True)
    return uniq.astype(np.int64), counts.astype(np.int32)


def unitig_build_cases(seed: int = 0):
    """Edge cases of the level-0 build (ops/unitig_build.py): name ->
    (uniq (n, nl) int64, counts (n,) int32, k), kedge_table of seeded
    reads.  A circular genome (pure cycles: the cycle break and the second
    ranking); a palindromic k-edge (odd k, its two lanes on one source
    key) beside a poly-A run longer than k (a k-edge its own successor);
    a palindromic node (even k: orientation 0 either way); exact repeats;
    error-laden branching (many short unitigs, shared nodes); every pair
    of limb counts of the nodes and the k-edges: k = 15 (1, 1), 16 (1,
    2), 31 (2, 2), 32 (2, 3), 45 (3, 3), 48 (3, 4), 63 (4, 4); one k-edge;
    none."""
    rng = np.random.default_rng(seed)

    def genome(n):
        return rng.integers(0, 4, n, dtype=np.uint8)

    def table(g, k, coverage=8, read_len=80, err=0.0, circular=False):
        reads, lengths = sim_reads(g, coverage=coverage, read_len=read_len,
                                   seed=int(rng.integers(1 << 30)),
                                   error_rate=err, circular=circular)
        return (*kedge_table(reads, lengths, k), k)

    def palindrome(m):
        half = genome(m // 2)
        return np.concatenate([half, (3 - half)[::-1]])

    cases = {
        "circular, k=21": table(genome(3_000), 21, coverage=10,
                                circular=True),
        "palindromic k-edge and poly-A, k=21": table(np.concatenate(
            [genome(400), palindrome(22), genome(400), np.zeros(40, np.uint8),
             genome(400)]), 21, coverage=15, read_len=90),
        "palindromic node, k=20": table(np.concatenate(
            [genome(500), palindrome(20), genome(500)]), 20, coverage=12),
    }
    rep = genome(300)
    parts = [genome(600) for _ in range(4)]
    cases["exact repeats, k=21"] = table(np.concatenate(
        [parts[0], rep, parts[1], rep, parts[2], rep, parts[3]]), 21,
        coverage=12)
    cases["error-laden branching, k=31"] = table(genome(4_000), 31,
                                                 read_len=100, err=0.02)
    for k in (15, 16, 32, 45, 48, 63):
        cases[f"k={k}"] = table(genome(2_000), k, read_len=100, err=0.005)
    one = kedge_table(genome(32)[None, :], np.array([32]), 31)
    cases["one k-edge, k=31"] = (one[0][:1], np.array([5], np.int32), 31)
    cases["none, k=31"] = (np.zeros((0, 2), np.int64),
                           np.zeros(0, np.int32), 31)
    return cases


# link_collision_cases' names
LINK_COLLISIONS = ("runs of 9-40 lanes", "nodes merged in pairs",
                   "one run of 5,000 lanes", "every row equal",
                   "k-edges their own successors")


def link_collision_cases(fp: np.ndarray, flags: np.ndarray, seed: int = 0):
    """Made-up inputs of ops/unitig_build.py:link_nodes: name -> a copy of
    the node fingerprints fp (2n, 2) int32 with rows of distinct lanes
    forced equal, collisions the murmur mixes do not make at these sizes.
    "runs of 9-40 lanes": a third of the rows in groups of 9-40 taking
    their first row's value, so (orientation, base) pairs repeat in a run;
    "nodes merged in pairs": a fifth of the distinct values given another
    one's, runs of about 4 lanes; "one run of 5,000 lanes": 5,000 rows
    (all, where fewer) taking the median row's value, a run across
    several of the kernel's 512-position tiles; "every row equal";
    "k-edges their own successors": 20 k-edges i with o_pre == o_suf (in
    the flags (n,) uint8) whose prefix and suffix rows take a value of
    their own, a node with one lane a key whose one successor is itself;
    for half of them one more lane of the same orientation and last base
    as lane n + i joins the node, its rc lane below i, so that i's
    predecessor is the second highest rc lane on the other orientation."""
    rng = np.random.default_rng(seed)
    D = len(fp)
    out = {}
    f = fp.copy()
    perm = rng.permutation(D)
    at = 0
    while at < D // 3:
        grp = perm[at:at + int(rng.integers(9, 41))]
        f[grp] = f[grp[0]]
        at += len(grp)
    out["runs of 9-40 lanes"] = f
    vals, inv = np.unique(fp, axis=0, return_inverse=True)
    pick = rng.permutation(len(vals))[:2 * (len(vals) // 10)]
    to = np.arange(len(vals))
    to[pick[1::2]] = pick[0::2]
    out["nodes merged in pairs"] = vals[to[inv.reshape(-1)]]
    f = fp.copy()
    u = fp.view(np.uint32)
    median = fp[np.lexsort((u[:, 1], u[:, 0]))[D // 2]]
    f[rng.permutation(D)[:5_000]] = median
    out["one run of 5,000 lanes"] = f
    out["every row equal"] = np.repeat(fp[:1], D, axis=0)
    n = D // 2
    f = flags.astype(np.int64)
    lane = np.arange(D)
    src = lane % n
    so = np.where(lane < n, f[src] & 1, 1 - ((f[src] >> 1) & 1))
    lb = np.where(lane < n, (f[src] >> 4) & 3, 3 - ((f[src] >> 2) & 3))
    f_loop = fp.copy()
    fresh = fp.view(np.uint32)[:, 0].max() + 1
    loops = rng.permutation(np.nonzero((f & 1) == ((f >> 1) & 1))[0])
    used = set()
    for t, i in enumerate(loops[:20]):
        if fresh + t > 0xFFFFFFFE:
            break
        val = np.array([fresh + t, 7], np.uint32).view(np.int32)
        f_loop[[i, n + i]] = val
        used.update((i, n + i))
        if t % 2:
            # lane g: so and lb of lane n + i, rc(g) < i, no lane used
            ok = (so == so[n + i]) & (lb == lb[n + i]) & \
                (np.where(lane < n, lane + n, lane - n) < i)
            cand = [g for g in np.nonzero(ok)[0]
                    if g not in used and (g + n) % D not in used]
            if cand:
                f_loop[cand[0]] = val
                used.update((cand[0], (cand[0] + n) % D))
    out["k-edges their own successors"] = f_loop
    return out
