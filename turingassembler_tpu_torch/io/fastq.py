"""Host-side FASTQ ingest — the port's data loader (a copy of
turingassembler_tpu/io/fastq.py; the JAX package's C++ loader yields the
same batches and has no twin here yet).

Replaces the reference's producer-thread pipeline (src/fastq_producer.c,
src/get_buffer.c): gzip-chunked FASTQ is parsed with vectorized numpy
newline scans into padded uint8 base-code batches ready for device
transfer.  Base encoding matches nt4_table (src/utils.c:26): A0 C1 G2 T3,
anything else 4 (invalid); pad value 255.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

# ASCII -> code lookup
NT4 = np.full(256, 4, np.uint8)
for i, c in enumerate(b"ACGT"):
    NT4[c] = i
for i, c in enumerate(b"acgt"):
    NT4[c] = i
REV_NT4 = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclass
class ReadBatch:
    bases: np.ndarray          # (B, L) uint8 codes, 255 pad
    lengths: np.ndarray        # (B,) int32
    names: Optional[list] = None
    comments: Optional[list] = None
    quals: Optional[list] = None
    raw_seqs: Optional[list] = None  # bytes per read (for re-emission)


def _parse_chunk(lines: List[bytes], pad_to: int, keep_text: bool):
    """lines: flat FASTQ lines (4 per record)."""
    n = len(lines) // 4
    if any(not lines[4 * i].startswith(b"@") for i in range(n)):
        raise ValueError("malformed FASTQ: a record's header lacks '@'")
    seqs = [lines[4 * i + 1] for i in range(n)]
    lengths = np.array([len(s) for s in seqs], np.int32)
    L = pad_to if pad_to else (int(lengths.max()) if n else 0)
    bases = np.full((n, L), 255, np.uint8)
    for i, s in enumerate(seqs):
        arr = np.frombuffer(s[:L], np.uint8)
        bases[i, : len(arr)] = NT4[arr]
    batch = ReadBatch(bases=bases, lengths=np.minimum(lengths, L))
    if keep_text:
        names, comments = [], []
        for i in range(n):
            hdr = lines[4 * i][1:]
            sp = hdr.find(b" ")
            if sp < 0:
                names.append(hdr); comments.append(b"")
            else:
                names.append(hdr[:sp]); comments.append(hdr[sp + 1 :])
        batch.names = names
        batch.comments = comments
        batch.quals = [lines[4 * i + 3] for i in range(n)]
        batch.raw_seqs = seqs
    return batch


def read_fastq_batches(path: str, batch_size: int = 65536, pad_to: int = 0,
                       keep_text: bool = False) -> Iterator[ReadBatch]:
    """Stream a FASTQ(.gz) file as padded batches."""
    lines: List[bytes] = []
    with _open(path) as fp:
        for line in fp:
            lines.append(line.rstrip(b"\n"))
            if len(lines) == 4 * batch_size:
                yield _parse_chunk(lines, pad_to, keep_text)
                lines = []
    if lines:
        if len(lines) % 4:
            raise ValueError(f"{path}: truncated FASTQ record")
        yield _parse_chunk(lines, pad_to, keep_text)


def write_fastq(path: str, names, seqs_bases, quals=None, comments=None):
    """seqs_bases: list of uint8 code arrays or bytes."""
    with open(path, "wb") as fp:
        for i, nm in enumerate(names):
            s = seqs_bases[i]
            if isinstance(s, np.ndarray):
                s = REV_NT4[np.minimum(s, 4)].tobytes()
            q = quals[i] if quals else b"I" * len(s)
            cm = (b" " + comments[i]) if comments and comments[i] else b""
            fp.write(b"@" + nm + cm + b"\n" + s + b"\n+\n" + q + b"\n")
