"""Host-side FASTQ ingest in Python (a copy of
turingassembler_tpu/io/fastq.py).  The main paths read through the host
C++ reader of io/native_loader.py; read_fastq_batches_headers gives the
same batches from this reader and is its plain version.  The barcode
frequencies and the Python sorter read here, as in the JAX package.

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


def read_fastq_pair_batches(path1: str, path2: str, batch_size: int = 65536,
                            pad_to: int = 0, keep_text: bool = False,
                            path_index: Optional[str] = None):
    """Paired (optionally + index read) FASTQ streaming."""
    g1 = read_fastq_batches(path1, batch_size, pad_to, keep_text)
    g2 = read_fastq_batches(path2, batch_size, pad_to, keep_text)
    gI = read_fastq_batches(path_index, batch_size, 0, True) if path_index else None
    while True:
        b1 = next(g1, None)
        b2 = next(g2, None)
        bI = next(gI, None) if gI else None
        if b1 is None and b2 is None:
            return
        if b1 is None or b2 is None or len(b1.bases) != len(b2.bases):
            raise ValueError("paired FASTQ files have different read counts")
        yield (b1, b2, bI)


def read_fastq_batches_headers(path: str, batch_size: int = 8192,
                               pad_to: int = 256, with_headers: bool = False):
    """Yield (bases, lengths, headers|None) batches, a header being the
    record's name plus " " plus its comment where it has one (the
    batches of the JAX package's read_fastq_batches_native)."""
    for b in read_fastq_batches(path, batch_size, pad_to,
                                keep_text=with_headers):
        hdrs = None
        if with_headers:
            hdrs = [n + (b" " + c if c else b"")
                    for n, c in zip(b.names, b.comments)]
        yield b.bases, b.lengths, hdrs


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


def decode_barcode_seq(seq: bytes) -> int:
    """Base-5 barcode encoding (reference get_barcode_ust_raw,
    src/sort_read.c:25-32): bc = bc*5 + nt4(c)."""
    ret = 0
    for c in seq:
        ret = ret * 5 + int(NT4[c])
    return ret & 0xFFFFFFFFFFFFFFFF


def encode_barcode(bc: int, length: int) -> bytes:
    """Inverse of decode_barcode_seq for fixed-length barcodes."""
    out = bytearray()
    for _ in range(length):
        out.append(b"ACGTN"[bc % 5])
        bc //= 5
    return bytes(reversed(out))
