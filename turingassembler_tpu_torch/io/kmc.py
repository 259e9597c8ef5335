"""KMC k-mer database interop (.kmc_pre / .kmc_suf); a copy of
turingassembler_tpu/io/kmc.py (host numpy).

The reference consumes KMC databases written by the bundled KMC library
(KMC_build_kmer_database, include/kmc_skipping.h:8-11) through its own
reader (src/KMC_reader.c).  This framework counts k-mers natively, but
reads and writes the same on-disk format so databases can be exchanged
with the reference pipeline (and with stock KMC tools using the legacy
header, kmer_type == 0 in KMC_reader.c:77-146).

Layout (legacy variant, all little-endian):

  .kmc_pre   "KMCP"
             uint64 LUT[4^p + 1]   cumulative k-mer start index per
                                   p-base prefix (KMC_worker_multi
                                   iterates LUT[i+1]-LUT[i] records)
             uint64 header[5]      [k_len | mode<<32]
                                   [counter_size | lut_prefix_len<<32]
                                   [min_count | max_count<<32]
                                   [total_kmers]
                                   [flags]  (bit 0 clear = both strands)
             uint32 kmer_type      0 (legacy)
             uint32 header_offset  bytes from LUT end back to header[0]
             "KMCP"

  .kmc_suf   "KMCS"
             records: suffix bytes (big-endian, 4 bases/byte, MSB-first
             within a byte — KMC_worker_multi reverses them into the
             little-endian kmer byte array, KMC_reader.c:241-245) +
             uint32 counter
             "KMCS"

K-mers are sorted by (prefix, suffix) numeric order, which equals
lexicographic base order (A<C<G<T).  The in-memory representation here
is (n, k) uint8 base codes.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ..ops import limbs as lb

_MARKER_PRE = b"KMCP"
_MARKER_SUF = b"KMCS"


def _default_lut_len(k: int) -> int:
    # KMC picks ~log4(n/records-per-bin); the reference's databases use
    # small prefixes; (k - p) must be divisible by 4
    for p in range(min(9, k - 1), 0, -1):
        if (k - p) % 4 == 0:
            return p
    raise ValueError(f"no valid lut prefix length for k={k}")


def write_kmc_database(codes: np.ndarray, counts: np.ndarray, path_prefix: str,
                       lut_prefix_length: int | None = None,
                       min_count: int = 1, max_count: int = 255,
                       variant: int = 0) -> None:
    """codes: (n, k) uint8 base codes sorted lexicographically;
    counts: (n,) ints.  Writes path_prefix + '.kmc_pre'/'.kmc_suf'.

    variant 0 writes the legacy kmer_type-0 layout; variant 0x200 writes
    the KMC2 layout the reference reader's other branch parses
    (KMC_read_prefix, src/KMC_reader.c:50-74: packed kmc_header_t at
    end-header_offset-8, per-prefix LUT + total+1 sentinel, signature
    map).  The .kmc_suf record format is identical in both."""
    n, k = codes.shape if codes.ndim == 2 else (0, int(codes.shape[-1]))
    if lut_prefix_length is None:
        lut_prefix_length = _default_lut_len(k)
    p = lut_prefix_length
    if (k - p) % 4 != 0:
        raise ValueError(f"(k - lut_prefix_length) must be divisible by 4")
    suffix_size = (k - p) // 4

    codes = np.ascontiguousarray(codes, np.uint8)
    counts = np.asarray(counts)
    if n:
        v = codes.view([("", np.uint8)] * k).ravel()
        order = np.argsort(v, kind="stable")  # LUT needs prefix-grouped records
        if not np.array_equal(order, np.arange(n)):
            codes = np.ascontiguousarray(codes[order])
            counts = counts[order]

    # prefix value of each kmer: first p bases, first base most significant
    pw = (4 ** np.arange(p - 1, -1, -1)).astype(np.uint64)
    prefixes = (codes[:, :p].astype(np.uint64) * pw[None, :]).sum(axis=1) \
        if n else np.zeros(0, np.uint64)
    n_pre = 4 ** p
    lut = np.zeros(n_pre + 1, np.uint64)
    np.add.at(lut, prefixes.astype(np.int64) + 1, 1)
    lut = np.cumsum(lut).astype(np.uint64)

    # suffix bytes: remaining bases packed 4/byte MSB-first, stored
    # big-endian (most significant byte first)
    sfx = codes[:, p:].reshape(n, suffix_size, 4).astype(np.uint16)
    sbytes = ((sfx[:, :, 0] << 6) | (sfx[:, :, 1] << 4)
              | (sfx[:, :, 2] << 2) | sfx[:, :, 3]).astype(np.uint8)

    recs = np.zeros((n, suffix_size + 4), np.uint8)
    recs[:, :suffix_size] = sbytes
    recs[:, suffix_size:] = counts.astype("<u4").view(np.uint8).reshape(n, 4)

    if variant == 0x200:
        import struct as _st
        sig_len = 5
        sig_entries = (1 << (2 * sig_len)) + 1
        hdr = _st.pack(
            "<7IQB3s6II",
            k, 0, 4, p, sig_len, min_count, max_count,
            n, 1, b"\x00\x00\x00", 0, 0, 0, 0, 0, 0, 0x200)
        # header_offset: reader seeks header at END-header_offset-8;
        # tail = header(68) + kmer_type(4) + header_offset(4) + marker(4)
        header_offset = 68 + 4
        with open(path_prefix + ".kmc_pre", "wb") as fp:
            fp.write(_MARKER_PRE)
            fp.write(lut.astype("<u8").tobytes())
            fp.write(_st.pack("<Q", n + 1))          # scan sentinel
            fp.write(np.zeros(sig_entries, "<u4").tobytes())
            fp.write(hdr)
            fp.write(_st.pack("<i", 0x200))
            fp.write(_st.pack("<i", header_offset))
            fp.write(_MARKER_PRE)
        with open(path_prefix + ".kmc_suf", "wb") as fp:
            fp.write(_MARKER_SUF)
            fp.write(recs.tobytes())
            fp.write(_MARKER_SUF)
        return

    header = np.array([
        np.uint64(k) | (np.uint64(0) << np.uint64(32)),
        np.uint64(4) | (np.uint64(p) << np.uint64(32)),
        np.uint64(min_count) | (np.uint64(max_count) << np.uint64(32)),
        np.uint64(n),
        np.uint64(0),   # bit 0 clear -> both_strands (canonical)
    ], np.uint64)
    header_offset = 8 * len(header)

    with open(path_prefix + ".kmc_pre", "wb") as fp:
        fp.write(_MARKER_PRE)
        fp.write(lut.astype("<u8").tobytes())
        fp.write(header.astype("<u8").tobytes())
        fp.write(struct.pack("<i", 0))               # kmer_type legacy
        fp.write(struct.pack("<i", header_offset))
        fp.write(_MARKER_PRE)
    with open(path_prefix + ".kmc_suf", "wb") as fp:
        fp.write(_MARKER_SUF)
        fp.write(recs.tobytes())
        fp.write(_MARKER_SUF)


def read_kmc_database(path_prefix: str) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns (codes (n, k) uint8, counts (n,) int64, header dict).
    Mirrors the reference reader (KMC_read_prefix KMC_reader.c:22-146 +
    KMC_worker_multi record walk :204-256), vectorized."""
    with open(path_prefix + ".kmc_pre", "rb") as fp:
        raw = fp.read()
    if raw[:4] != _MARKER_PRE or raw[-4:] != _MARKER_PRE:
        raise ValueError("bad .kmc_pre markers")
    header_offset, = struct.unpack("<i", raw[-8:-4])
    kmer_type, = struct.unpack("<i", raw[-12:-8])
    if kmer_type == 0x200:
        return _read_kmc2(raw, path_prefix, header_offset)
    if kmer_type != 0:
        raise ValueError(f"unknown KMC kmer_type 0x{kmer_type:x}")
    body = np.frombuffer(raw[4:-12], "<u8")
    header_index = len(body) - header_offset // 8
    hdr = body[header_index:]
    k_len = int(hdr[0] & 0xFFFFFFFF)
    mode = int(hdr[0] >> 32)
    counter_size = int(hdr[1] & 0xFFFFFFFF)
    p = int(hdr[1] >> 32)
    min_count = int(hdr[2] & 0xFFFFFFFF)
    max_count = int(hdr[2] >> 32)
    total = int(hdr[3])
    both_strands = (int(hdr[4]) & 0xF) != 1
    lut = body[: 4 ** p + 1].astype(np.int64)

    suffix_size = (k_len - p) // 4
    rec_size = suffix_size + counter_size
    with open(path_prefix + ".kmc_suf", "rb") as fp:
        sraw = fp.read()
    if sraw[:4] != _MARKER_SUF:
        raise ValueError("bad .kmc_suf marker")
    recs = np.frombuffer(sraw[4 : 4 + total * rec_size], np.uint8)
    recs = recs.reshape(total, rec_size)

    # prefix of each record from the LUT runs
    run_len = np.diff(lut)
    prefixes = np.repeat(np.arange(4 ** p, dtype=np.int64), run_len)

    codes = np.empty((total, k_len), np.uint8)
    # prefix bases, first base most significant
    for j in range(p):
        codes[:, j] = (prefixes >> (2 * (p - 1 - j))) & 3
    # suffix bytes big-endian, 4 bases/byte MSB-first
    sb = recs[:, :suffix_size]
    for j in range(suffix_size):
        b = sb[:, j]
        base = p + 4 * j
        codes[:, base] = (b >> 6) & 3
        codes[:, base + 1] = (b >> 4) & 3
        codes[:, base + 2] = (b >> 2) & 3
        codes[:, base + 3] = b & 3
    if counter_size == 4:
        counts = recs[:, suffix_size:].copy().view("<u4").reshape(total)
    else:
        counts = np.zeros(total, np.uint32)
        for j in range(counter_size):
            counts |= recs[:, suffix_size + j].astype(np.uint32) << (8 * j)
    info = dict(kmer_length=k_len, mode=mode, counter_size=counter_size,
                lut_prefix_length=p, min_count=min_count,
                max_count=max_count, total_kmers=total,
                both_strands=both_strands)
    return codes, counts.astype(np.int64), info


def load_kedges_from_kmc(path_prefix: str):
    """Load a KMC (k+1)-mer database as graph-builder input:
    (kedges (n, n_limbs) uint32, counts (n,) int64, k).  Lets the
    pipeline consume databases produced by the reference's KMC stage
    (build_graph_from_scratch, src/kmer_build.c:714-737)."""
    codes, counts, info = read_kmc_database(path_prefix)
    k1 = info["kmer_length"]
    kedges = lb.np_pack_bases(codes, k1)
    return kedges, counts, k1 - 1


def _decode_suffix_records(path_prefix: str, prefixes: np.ndarray,
                           k_len: int, p: int, counter_size: int,
                           total: int):
    """Shared .kmc_suf record decode (identical for both pre-file
    layouts; reference KMC_worker_multi, src/KMC_reader.c:204-256)."""
    suffix_size = (k_len - p) // 4
    rec_size = suffix_size + counter_size
    with open(path_prefix + ".kmc_suf", "rb") as fp:
        sraw = fp.read()
    if sraw[:4] != _MARKER_SUF:
        raise ValueError("bad .kmc_suf marker")
    recs = np.frombuffer(sraw[4 : 4 + total * rec_size], np.uint8)
    recs = recs.reshape(total, rec_size)
    codes = np.empty((total, k_len), np.uint8)
    for j in range(p):
        codes[:, j] = (prefixes >> (2 * (p - 1 - j))) & 3
    sb = recs[:, :suffix_size]
    for j in range(suffix_size):
        b = sb[:, j]
        base = p + 4 * j
        codes[:, base] = (b >> 6) & 3
        codes[:, base + 1] = (b >> 4) & 3
        codes[:, base + 2] = (b >> 2) & 3
        codes[:, base + 3] = b & 3
    if counter_size == 4:
        counts = recs[:, suffix_size:].copy().view("<u4").reshape(total)
    else:
        counts = np.zeros(total, np.uint32)
        for j in range(counter_size):
            counts |= recs[:, suffix_size + j].astype(np.uint32) << (8 * j)
    return codes, counts.astype(np.int64)


def _read_kmc2(raw: bytes, path_prefix: str, header_offset: int):
    """kmer_type 0x200 (KMC2) parse, mirroring the reference branch
    (KMC_read_prefix, src/KMC_reader.c:50-74): packed kmc_header_t at
    end-header_offset-8; LUT area sized from the file minus signature
    map and header; the record walk stops at the total+1 sentinel and
    masks each LUT index with the prefix mask."""
    hstart = len(raw) - header_offset - 8
    hb = raw[hstart : hstart + 68]
    (k_len, mode, counter_size, p, sig_len, min_count,
     max_count) = struct.unpack("<7I", hb[:28])
    total, = struct.unpack("<Q", hb[28:36])
    both_strands = hb[36] != 0
    sig_bytes = (((1 << (2 * sig_len)) + 1)) * 4
    size = len(raw) - 8 - 4                       # C: ftell-4-4 then -=4
    lut_area = size - sig_bytes - header_offset - 8
    n_entries = lut_area // 8                      # e[0..n_lut-1]
    buf = np.frombuffer(raw[4 : 4 + lut_area + 8], "<u8").astype(np.int64)
    # scan stop: first i with buf[i+1] == total + 1 (the sentinel the
    # reference appends / our writer stores right after the LUT)
    stops = np.flatnonzero(buf[1:] == total + 1)
    hi = int(stops[0]) if len(stops) else n_entries - 1
    lut = buf[: hi + 1]
    run_len = np.diff(lut)
    prefix_mask = (1 << (2 * p)) - 1
    prefixes = np.repeat(np.arange(hi, dtype=np.int64) & prefix_mask,
                         run_len)
    codes, counts = _decode_suffix_records(path_prefix, prefixes, k_len, p,
                                           counter_size, total)
    info = dict(kmer_length=k_len, mode=mode, counter_size=counter_size,
                lut_prefix_length=p, min_count=min_count,
                max_count=max_count, total_kmers=total,
                both_strands=both_strands, signature_length=sig_len,
                kmer_type=0x200)
    return codes, counts, info
