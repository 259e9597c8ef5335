"""Synthetic genomes and read-pair libraries, made on the device from a
seed and copied once into host memory.

A configuration fixes the organism: its `genome_length`, the
`genome_seed` of its random sequence and its `repeats` families.  A library is a
set of FR read pairs drawn from it at the configuration's coverage,
read length and insert, with substitutions and single-base indels; its
seed is the run's.  Every random draw comes from one torch.Generator on
the device, in a fixed order and in chunks of fixed size, so a seed
gives the same library on the same kind of device.  Reads are uint8
codes (0-3 for ACGT) padded with 255 to `pad_to` columns, lengths int32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

CHUNK = 1 << 18      # read pairs drawn at a time


@dataclass
class Library:
    """One library in host memory: R1 and R2 (pairs, pad_to) uint8 codes
    with 255 padding and their (pairs,) int32 lengths."""
    seed: int
    r1: np.ndarray
    l1: np.ndarray
    r2: np.ndarray
    l2: np.ndarray

    @property
    def pairs(self) -> int:
        return len(self.l1)

    @property
    def reads(self) -> int:
        return 2 * len(self.l1)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _codes(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 4, (n,), generator=g, device=device,
                         dtype=torch.uint8)


def _substitute(seq: torch.Tensor, where: torch.Tensor,
                g: torch.Generator) -> torch.Tensor:
    """seq with each base under `where` replaced by one of the other
    three, drawn uniformly."""
    shift = torch.randint(1, 4, seq.shape, generator=g, device=seq.device,
                          dtype=torch.uint8)
    return torch.where(where, (seq + shift) % 4, seq)


def repeat_starts(rep: dict, length: int) -> list:
    """Start of each copy of a repeat family: "spread" copies evenly
    from `first` to `length - last_from_end` (plus `offset`), "tandem"
    copies back to back from `start`."""
    n, size = rep["copies"], rep["length"]
    if rep["layout"] == "spread":
        pos = np.linspace(rep["first"], length - rep["last_from_end"], n)
        return [int(p) + rep.get("offset", 0) for p in pos.astype(np.int64)]
    if rep["layout"] == "tandem":
        return [rep["start"] + i * size for i in range(n)]
    raise ValueError(f"unknown repeat layout {rep['layout']!r}")


def make_genome(config: dict, device) -> torch.Tensor:
    """The configuration's genome as (genome_length,) uint8 codes on
    `device`: a random sequence from genome_seed carrying each repeat family's
    copies, each copy of the family's random unit mutated to the
    family's identity.  Copies may not overlap."""
    device = torch.device(device)
    g = _generator(config["genome_seed"], device)
    n = config["genome_length"]
    seq = _codes(n, g, device)
    taken = []
    for rep in config.get("repeats", []):
        unit = _codes(rep["length"], g, device)
        for s in repeat_starts(rep, n):
            e = s + rep["length"]
            if s < 0 or e > n or any(s < b and a < e for a, b in taken):
                raise ValueError(f"repeat copy [{s}, {e}) overlaps another "
                                 f"or leaves the genome")
            taken.append((s, e))
            diverged = torch.rand(rep["length"], generator=g,
                                  device=device) >= rep["identity"]
            seq[s:e] = _substitute(unit, diverged, g)
    return seq


def n_pairs(genome_length: int, reads: dict) -> int:
    """Pairs that give the configured coverage: ceil(cov * G / (2 * len))."""
    return math.ceil(reads["coverage"] * genome_length
                     / (2 * reads["read_len"]))


def _plant_indels(r: torch.Tensor, reads: dict, g: torch.Generator):
    """One single-base indel in a fraction `indel_frac` of the reads, at
    a read position in [indel_lo, indel_hi): half insert a random base
    and push the last base out, half delete a base and leave the read
    one base shorter.  Returns (reads (n, read_len), lengths (n,))."""
    n, L = r.shape
    dev = r.device
    hit = torch.rand(n, generator=g, device=dev) < reads["indel_frac"]
    p = torch.randint(reads["indel_lo"], reads["indel_hi"], (n, 1),
                      generator=g, device=dev)
    ins = torch.rand(n, 1, generator=g, device=dev) < 0.5
    base = _codes(n, g, dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    src = torch.where(ins, j - (j > p).long(), j + (j >= p).long())
    alt = torch.gather(r, 1, src.clamp(max=L - 1))
    alt = torch.where(ins & (j == p), base, alt)
    alt = torch.where(~ins & (j == L - 1), torch.full_like(alt, 255), alt)
    out = torch.where(hit[:, None], alt, r)
    lengths = torch.where(hit & ~ins[:, 0], L - 1, L).to(torch.int32)
    return out, lengths


def make_library(genome: torch.Tensor, reads: dict, seed: int) -> Library:
    """A library of FR read pairs from `genome` (on its device), drawn
    from `seed`: fragments of `insert` bases at uniform positions, R1
    the fragment's head or its reverse complement's with equal odds and
    R2 the other end, substitutions at `substitution_rate` a base, then
    a single-base indel in `indel_frac` of the reads of each end."""
    dev = genome.device
    g = _generator(seed, dev)
    G = genome.shape[0]
    L, W, ins = reads["read_len"], reads["pad_to"], reads["insert"]
    n = n_pairs(G, reads)
    host = [np.full((n, W), 255, np.uint8), np.zeros(n, np.int32),
            np.full((n, W), 255, np.uint8), np.zeros(n, np.int32)]
    jj = torch.arange(L, device=dev)[None, :]
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        start = torch.randint(0, G - ins + 1, (m, 1), generator=g,
                              device=dev)
        head = genome[start + jj]
        tail = 3 - genome[start + (ins - 1) - jj]      # reverse complement
        swap = torch.rand(m, 1, generator=g, device=dev) < 0.5
        for i, r in enumerate((torch.where(swap, tail, head),
                               torch.where(swap, head, tail))):
            err = torch.rand(r.shape, generator=g, device=dev) \
                < reads["substitution_rate"]
            r, lens = _plant_indels(_substitute(r, err, g), reads, g)
            host[2 * i][lo:lo + m, :L] = r.cpu().numpy()
            host[2 * i + 1][lo:lo + m] = lens.cpu().numpy()
    return Library(seed, *host)


def make_libraries(config: dict, seed: int, count: int, device):
    """The run's libraries, read seeds count*seed + i (2*seed and
    2*seed + 1 for two), from the configuration's genome.  Nothing of
    them stays on the device."""
    genome = make_genome(config, device)
    libs = [make_library(genome, config["reads"], count * seed + i)
            for i in range(count)]
    del genome
    return libs
