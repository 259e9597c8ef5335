"""Assembly-quality evaluation against a known truth genome (a copy of
turingassembler_tpu/evaluate.py, numpy and Python only; its results are
the JAX package's, field for field, faults included: see ROADMAP.md
queue C on _anchor_index).

The reference's published metrics are QUAST numbers (NGA50, mismatches
per 100 kbp; README.md:13-15).  QUAST isn't available in this
environment, so this module computes the same quantities directly for
synthetic benchmarks where the truth genome is known:

  - contigs are anchored to the truth by unique 63-mers over ONE
    combined index of ALL truth records; each contig window is looked
    up forward then reverse-complement, so anchors carry a strand.  A
    contig chimeric across two records (translocation), across distant
    loci (relocation), or across strands (inversion) shows up as a run
    break and counts as an extensive misassembly — QUAST's three
    extensive classes.  An inverted interior segment has two
    breakpoints and counts twice, as in QUAST.
  - colinear anchor runs become aligned blocks; NGA50 = N50 over
    aligned block lengths relative to the total truth size;
  - per-block mismatch/indel rates come from comparing the aligned span
    (exact hamming for equal-length inter-anchor spans plus the run's
    head/tail up to the contig/record bounds; unequal-length spans
    contribute |length diff| indel bases — their internal substitutions
    are not separable without full DP, a documented undercount QUAST
    shares in spirit for gap columns).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

ANCHOR_K = 63
# A run head/tail whose same-offset hamming divergence exceeds this is
# an unaligned end (QUAST leaves such ends out of the alignment), not a
# mismatch pile-up.
HEAD_TAIL_MAX_DIV = 0.30


@dataclass
class EvalResult:
    nga50: int
    n_blocks: int
    n_misassemblies: int
    genome_fraction: float
    total_aligned: int
    largest_alignment: int
    n_mismatches: int = 0
    n_indel_bases: int = 0
    n_translocations: int = 0
    n_inversions: int = 0
    record_fraction: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def mismatches_per_100kbp(self) -> float:
        return 1e5 * self.n_mismatches / max(self.total_aligned, 1)

    @property
    def indels_per_100kbp(self) -> float:
        return 1e5 * self.n_indel_bases / max(self.total_aligned, 1)

    def __str__(self):
        s = (f"NGA50={self.nga50} blocks={self.n_blocks} "
             f"misassemblies={self.n_misassemblies} "
             f"genome_fraction={self.genome_fraction:.3f} "
             f"mismatches/100kbp={self.mismatches_per_100kbp:.2f} "
             f"indels/100kbp={self.indels_per_100kbp:.2f}")
        if self.n_translocations:
            s += f" translocations={self.n_translocations}"
        if self.n_inversions:
            s += f" inversions={self.n_inversions}"
        return s


GenomeArg = Union[str, Sequence[str], Sequence[Tuple[str, str]]]


def _normalize_records(genome: GenomeArg) -> List[Tuple[str, str]]:
    if isinstance(genome, str):
        return [("genome", genome)]
    out = []
    for i, rec in enumerate(genome):
        if isinstance(rec, str):
            out.append((f"record_{i}", rec))
        else:
            name, seq = rec
            out.append((str(name), seq))
    return out


def _anchor_index(records: List[Tuple[str, str]],
                  k: int = ANCHOR_K) -> Dict[str, Tuple[int, int]]:
    """One combined k-mer -> (record id, position) index over ALL truth
    records; k-mers appearing more than once ANYWHERE — on either
    strand, within or across records — are dropped, so every surviving
    anchor is globally unique and an anchor run that jumps records or
    strands is evidence of a real event, not index ambiguity.  (Forward
    -only dedup would keep both copies of an inverted repeat and anchor
    a correct contig to the wrong strand.)"""
    seen: Dict[str, Tuple[int, int]] = {}
    dup = set()
    for rid, (_, g) in enumerate(records):
        for i in range(len(g) - k + 1):
            w = g[i : i + k]
            if w in seen:
                dup.add(w)
            else:
                seen[w] = (rid, i)
    for w in dup:
        del seen[w]
    # strand-level uniqueness: if rc(w) also occurs anywhere, neither
    # copy can serve as a strand-resolving anchor (k odd -> no
    # palindromic k-mer equals its own rc)
    drop = [w for w in seen if _rc(w) in seen]
    for w in drop:
        if w in seen:
            del seen[w]
    return seen


_RC_TABLE = str.maketrans("ACGTN", "TGCAN")


def _rc(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]


def _hamming(a: str, b: str) -> int:
    """Mismatch count over aligned columns; N columns (scaffold gap
    fill, uncalled bases) are uncalled, not substitutions — QUAST's
    posture."""
    aa = np.frombuffer(a.encode(), np.uint8)
    bb = np.frombuffer(b.encode(), np.uint8)
    n_code = ord("N")
    return int(((aa != bb) & (aa != n_code) & (bb != n_code)).sum())


def evaluate_assembly(contigs: List[str], genome: GenomeArg,
                      k: int = ANCHOR_K, max_gap: int = 1000) -> EvalResult:
    records = _normalize_records(genome)
    idx = _anchor_index(records, k)
    genome_total = sum(len(g) for _, g in records)
    blocks: List[Tuple[int, int, int]] = []   # (rid, ref_start, ref_end)
    n_mis = 0
    n_trans = 0
    n_inv = 0
    n_sub = 0
    n_ind = 0
    for contig in contigs:
        seq = contig
        rcseq = None                           # lazy; only reverse runs need it
        anchors = []                           # (contig pos, rid, ref pos, strand)
        step = max(1, k // 2)
        for i in range(0, len(seq) - k + 1, step):
            w = seq[i : i + k]
            hit = idx.get(w)
            if hit is not None:
                anchors.append((i, hit[0], hit[1], 1))
                continue
            hit = idx.get(_rc(w))
            if hit is not None:
                anchors.append((i, hit[0], hit[1], -1))
        if not anchors:
            continue

        # split into colinear runs: same record, same strand, and a
        # ref-position step consistent with the contig step (mirrored
        # for reverse-strand runs)
        def _follows(a, b):
            (ci, ri, pi, si), (cj, rj, pj, sj) = a, b
            if ri != rj or si != sj:
                return False
            expected = pi + si * (cj - ci)
            return abs(pj - expected) <= max_gap

        runs = [[anchors[0]]]
        for prev_a, cur_a in zip(anchors, anchors[1:]):
            if _follows(runs[-1][-1], cur_a):
                runs[-1].append(cur_a)
            else:
                runs.append([cur_a])

        # QUAST posture: only EXTENSIVE inconsistencies count as
        # misassemblies (relocation threshold 1 kb).  A short run whose
        # flanking runs are mutually colinear is an "allelic island" —
        # e.g. a collapsed repeat copy carrying the other copy's SNPs,
        # which nucmer aligns in place with mismatches (the reference
        # itself reports 5.65 mismatches/100 kbp, README.md:13) — so it
        # is bridged, not counted; short unbridgeable head/tail runs
        # are QUAST's local misassemblies, also not extensive.
        def _colinear(a, b):
            return _follows(a[-1], b[0])

        def _span(r):
            return r[-1][0] - r[0][0] + k

        max_island = max_gap
        kept = [runs[0]]
        i = 1
        while i < len(runs):
            cur = runs[i]
            prev = kept[-1]
            if _colinear(prev, cur):
                kept[-1] = prev + cur
            elif _span(cur) <= max_island and (
                    i + 1 == len(runs)
                    or _colinear(prev, runs[i + 1])):
                pass  # bridged island / local tail
            elif len(kept) == 1 and _span(prev) <= max_island:
                kept[-1] = cur  # local head
            else:
                kept.append(cur)
            i += 1
        if len(kept) > 1:
            n_mis += len(kept) - 1
            for a, b in zip(kept, kept[1:]):
                if a[-1][1] != b[0][1]:
                    n_trans += 1
                elif a[-1][3] != b[0][3]:
                    n_inv += 1
        for run in kept:
            strand = run[0][3]
            if strand == 1:
                s, fwd_run = seq, [(c, r, p) for c, r, p, _ in run]
            else:
                # mirror the run into forward coordinates on rc(seq):
                # anchor (ci, pi, -1) on seq == (len(seq)-k-ci, pi, +1)
                # on rc(seq), in reversed order
                if rcseq is None:
                    rcseq = _rc(seq)
                s = rcseq
                fwd_run = [(len(seq) - k - c, r, p)
                           for c, r, p, _ in reversed(run)]
            (c0, r0, p0), (c1, r1, p1) = fwd_run[0], fwd_run[-1]
            gstr = records[r0][1]
            bs, be = p0, p1 + k
            # inter-anchor substitutions: equal-length spans are exact
            # hamming; unequal spans are |length diff| indel bases
            # (internal substitutions not separable, see module
            # docstring)
            for (ci, _, pi), (cj, _, pj) in zip(fwd_run, fwd_run[1:]):
                if cj - ci == pj - pi:
                    n_sub += _hamming(s[ci:cj], gstr[pi:pj])
                else:
                    n_ind += abs((cj - ci) - (pj - pi))
            # the run's head and tail, clamped to contig/record bounds:
            # substitutions before the first anchor and after the last
            # one are real aligned columns QUAST counts; a divergent
            # end (> HEAD_TAIL_MAX_DIV) is an unaligned end instead and
            # is left out of the block
            h = min(c0, p0)
            if h > 0:
                d = _hamming(s[c0 - h : c0], gstr[p0 - h : p0])
                if d <= HEAD_TAIL_MAX_DIV * h:
                    n_sub += d
                    bs = p0 - h
            t = min(len(s) - (c1 + k), len(gstr) - (p1 + k))
            if t > 0:
                d = _hamming(s[c1 + k : c1 + k + t],
                             gstr[p1 + k : p1 + k + t])
                if d <= HEAD_TAIL_MAX_DIV * t:
                    n_sub += d
                    be = p1 + k + t
            blocks.append((r0, bs, be))
    if not blocks:
        return EvalResult(0, 0, n_mis, 0.0, 0, 0,
                          n_translocations=n_trans, n_inversions=n_inv)

    # merge cover per record for genome fraction
    blocks.sort()
    merged = [list(blocks[0])]
    for r, s, e in blocks[1:]:
        if r == merged[-1][0] and s <= merged[-1][2]:
            merged[-1][2] = max(merged[-1][2], e)
        else:
            merged.append([r, s, e])
    covered = sum(e - s for _, s, e in merged)
    rec_frac = []
    for rid, (name, g) in enumerate(records):
        cov_r = sum(e - s for r, s, e in merged if r == rid)
        rec_frac.append((name, cov_r / max(len(g), 1)))

    # NGA50 over block lengths vs total genome size
    lens = sorted((e - s for _, s, e in blocks), reverse=True)
    half = genome_total / 2
    acc = 0
    nga50 = 0
    for L in lens:
        acc += L
        if acc >= half:
            nga50 = L
            break
    return EvalResult(nga50, len(blocks), n_mis,
                      covered / genome_total, sum(lens), lens[0],
                      n_sub, n_ind, n_trans, n_inv, rec_frac)
