"""Barcode-sorted read archive — rebuild of src/sort_read.c (a copy of
turingassembler_tpu/barcode/sort_read.py).  sort_reads runs the port's
host C++ sorter (native/sort_read.cpp, `_sort_reads_native`), which
spills sorted runs to disk past the -sm budget and k-way merges them;
TA_SORT_NATIVE=0 selects the Python loop below, its plain version.  The
files of both equal both of the JAX package's byte for byte.

Produces the reference's durable artifacts byte-compatibly:
  R1.sorted.fq / R2.sorted.fq   reads grouped by barcode, each record
                                re-emitted as '@name BX:Z:<bc> QB:Z:<q>'
                                (ust_add_record, sort_read.c:96-147)
  barcode.idx                   one 40-byte little-endian record per
                                barcode: (barcode u64, off1, off2,
                                len1, len2) — byte spans into the two
                                sorted FASTQs (merge_sorted_large,
                                sort_read.c:567-658)

Barcode extraction per library type (sort_read.c:25-79):
  UST   separate index read, whole sequence base-5 encoded
  BioT  'BX:Z:' tag in the comment
  10X   first 16 bp of R1 (+7 bp UMI skipped; R1 trimmed by 23)

The reference's per-thread radix sort + k-way disk merge becomes, in
the Python loop, a single numpy argsort over (barcode, record) keys.
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import _build
from ..config import (Config, LIB_TYPE_10X, LIB_TYPE_BIOT, LIB_TYPE_SORTED,
                      LIB_TYPE_UST)
from ..io.fastq import NT4, decode_barcode_seq, read_fastq_pair_batches

BX_NONE = 0xFFFFFFFFFFFFFFFF
# records a chunk that the C++ sorter parses of each input file at a time
SORT_CHUNK_RECORDS = 65_536
# the C++ sorter's failure codes (native/sort_read.cpp)
_SORT_ERRORS = {
    -1: (FileNotFoundError, "an input FASTQ file does not open"),
    -2: (OSError, "the sorted archive cannot be written"),
    -3: (OSError, "a spilled run cannot be written or read back"),
    -4: (ValueError, "malformed FASTQ: a record lacks its '@' or is "
         "truncated"),
    -5: (ValueError, "paired FASTQ files have different read counts"),
    -6: (ValueError, "unknown lib type"),
}


@dataclass
class ReadPath:
    R1_path: str
    R2_path: str
    idx_path: str

    @classmethod
    def from_sorted(cls, cfg: Config) -> "ReadPath":
        """For -l sorted inputs: R1/R2 given by -1/-2, idx by -I
        (reference main.c sorted-library handling)."""
        idx = cfg.files_I[0] if cfg.files_I else os.path.join(cfg.out_dir, "barcode.idx")
        return cls(cfg.files_1[0], cfg.files_2[0], idx)


def _decode_bc_bytes(seq: bytes) -> int:
    ret = 0
    for c in seq:
        ret = (ret * 5 + int(NT4[c])) & 0xFFFFFFFFFFFFFFFF
    return ret


def _extract_barcode_biot(comment: bytes) -> Tuple[int, bytes, bytes]:
    i = comment.find(b"BX:Z:")
    if i < 0:
        return BX_NONE, b"", b""
    s = comment[i + 5 :]
    end = 0
    while end < len(s) and s[end : end + 1] not in (b" ", b"\t", b""):
        end += 1
    bseq = s[:end]
    j = comment.find(b"QB:Z:")
    bqual = b""
    if j >= 0:
        q = comment[j + 5 :]
        e2 = 0
        while e2 < len(q) and q[e2 : e2 + 1] not in (b" ", b"\t", b""):
            e2 += 1
        bqual = q[:e2]
    return _decode_bc_bytes(bseq), bseq, bqual


def _sort_reads_native(cfg: Config, out_dir: str) -> ReadPath:
    """The C++ sorter: the same files as the Python loop.  The budget is
    cfg.mmem_gb GiB (-sm; TA_SORT_MEM_BYTES overrides it, as in the JAX
    package): past it the sorter spills sorted runs next to barcode.idx
    and merges them; beside that it holds SORT_CHUNK_RECORDS parsed
    records of each input file.  Raises on any failure."""
    lib_codes = {LIB_TYPE_BIOT: 1, LIB_TYPE_UST: 2, LIB_TYPE_10X: 3}
    if cfg.lib_type not in lib_codes:
        raise ValueError(f"unknown lib type {cfg.lib_type}")
    if len(cfg.files_2) < len(cfg.files_1):
        raise ValueError("every -1 file needs its -2 file")

    def carr(paths):
        a = (ctypes.c_char_p * max(len(paths), 1))()
        for i, p in enumerate(paths):
            a[i] = os.fsencode(p)
        return a

    lib = _build.load_host("sort_read")
    fn = lib.ta_sort_reads_budget
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p)] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    rp = ReadPath(os.path.join(out_dir, "R1.sorted.fq"),
                  os.path.join(out_dir, "R2.sorted.fq"),
                  os.path.join(out_dir, "barcode.idx"))
    budget = int(os.environ.get("TA_SORT_MEM_BYTES",
                                cfg.mmem_gb * (1 << 30)))
    files_1, files_2, files_I = (carr(cfg.files_1), carr(cfg.files_2),
                                 carr(cfg.files_I))
    rc = fn(files_1, files_2, files_I, len(cfg.files_1), len(cfg.files_I),
            lib_codes[cfg.lib_type], os.fsencode(rp.R1_path),
            os.fsencode(rp.R2_path), os.fsencode(rp.idx_path), budget,
            SORT_CHUNK_RECORDS)
    if rc < 0:
        exc, what = _SORT_ERRORS.get(rc, (RuntimeError, f"code {rc}"))
        inputs = list(cfg.files_1) + list(cfg.files_2) + list(cfg.files_I)
        raise exc(f"sort_read: {what} (inputs {inputs})")
    return rp


def sort_reads(cfg: Config, out_dir: Optional[str] = None) -> ReadPath:
    """Sort read pairs by barcode, write the sorted archive + index:
    through the C++ sorter, or with TA_SORT_NATIVE=0 the Python loop."""
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    lib = cfg.lib_type
    if lib == LIB_TYPE_SORTED:
        return ReadPath.from_sorted(cfg)
    if os.environ.get("TA_SORT_NATIVE", "1") != "0":
        return _sort_reads_native(cfg, out_dir)

    recs1: List[bytes] = []
    recs2: List[bytes] = []
    bcs: List[int] = []

    for fi, f1 in enumerate(cfg.files_1):
        f2 = cfg.files_2[fi]
        fI = cfg.files_I[fi] if lib == LIB_TYPE_UST and fi < len(cfg.files_I) else None
        for b1, b2, bI in read_fastq_pair_batches(f1, f2, keep_text=True,
                                                  path_index=fI):
            n = len(b1.raw_seqs)
            for i in range(n):
                name1, name2 = b1.names[i], b2.names[i]
                s1, q1 = b1.raw_seqs[i], b1.quals[i]
                s2, q2 = b2.raw_seqs[i], b2.quals[i]
                if lib == LIB_TYPE_UST:
                    bseq = bI.raw_seqs[i] if bI is not None else b""
                    bqual = bI.quals[i] if bI is not None else b""
                    bc = _decode_bc_bytes(bseq) if bseq else BX_NONE
                elif lib == LIB_TYPE_BIOT:
                    bc, bseq, bqual = _extract_barcode_biot(b1.comments[i])
                elif lib == LIB_TYPE_10X:
                    if len(s1) < 23:
                        bc, bseq, bqual = BX_NONE, b"", b""
                    else:
                        bseq, bqual = s1[:16], q1[:16]
                        bc = _decode_bc_bytes(bseq)
                        s1, q1 = s1[23:], q1[23:]
                else:
                    raise ValueError(f"unknown lib type {lib}")
                tag = b" BX:Z:" + bseq + b" QB:Z:" + bqual if bseq else b""
                recs1.append(b"@" + name1 + tag + b"\n" + s1 + b"\n+\n" + q1 + b"\n")
                recs2.append(b"@" + name2 + tag + b"\n" + s2 + b"\n+\n" + q2 + b"\n")
                bcs.append(bc)

    bcs_arr = np.asarray(bcs, np.uint64)
    order = np.argsort(bcs_arr, kind="stable")

    r1p = os.path.join(out_dir, "R1.sorted.fq")
    r2p = os.path.join(out_dir, "R2.sorted.fq")
    idxp = os.path.join(out_dir, "barcode.idx")
    with open(r1p, "wb") as f1o, open(r2p, "wb") as f2o, open(idxp, "wb") as fio:
        off1 = off2 = 0
        poff1 = poff2 = 0
        prev_bc = None
        for i in order:
            bc = int(bcs_arr[i])
            if prev_bc is not None and bc != prev_bc:
                fio.write(struct.pack("<QQQQQ", prev_bc, poff1, poff2,
                                      off1 - poff1, off2 - poff2))
                poff1, poff2 = off1, off2
            f1o.write(recs1[i]); off1 += len(recs1[i])
            f2o.write(recs2[i]); off2 += len(recs2[i])
            prev_bc = bc
        if prev_bc is not None:
            fio.write(struct.pack("<QQQQQ", prev_bc, poff1, poff2,
                                  off1 - poff1, off2 - poff2))
    return ReadPath(r1p, r2p, idxp)


# ---------------------------------------------------------------------------
# read index (reference construct_read_index, src/barcode_resolve2.c:1490-1511)
# ---------------------------------------------------------------------------

def load_barcode_index(idx_path: str) -> Dict[int, Tuple[int, int, int, int]]:
    """barcode -> (off1, off2, len1, len2)."""
    out = {}
    with open(idx_path, "rb") as fp:
        while True:
            rec = fp.read(40)
            if len(rec) < 40:
                break
            bc, o1, o2, l1, l2 = struct.unpack("<QQQQQ", rec)
            out[bc] = (o1, o2, l1, l2)
    return out


def fetch_reads_by_barcodes(rpath: ReadPath, index, barcodes):
    """Random-access fetch of all read pairs of a barcode set (reference
    filter_read, src/barcode_resolve2.c:1513-1552).  Returns
    (records1 bytes, records2 bytes) FASTQ blobs."""
    blobs1, blobs2 = [], []
    with open(rpath.R1_path, "rb") as f1, open(rpath.R2_path, "rb") as f2:
        for bc in barcodes:
            ent = index.get(int(bc))
            if ent is None:
                continue
            o1, o2, l1, l2 = ent
            f1.seek(o1)
            blobs1.append(f1.read(l1))
            f2.seek(o2)
            blobs2.append(f2.read(l2))
    return b"".join(blobs1), b"".join(blobs2)


def parse_fastq_blob(blob: bytes):
    """FASTQ blob -> (names, seqs bytes, quals, comments)."""
    names, seqs, quals, comments = [], [], [], []
    lines = blob.split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        hdr = lines[i][1:]
        sp = hdr.find(b" ")
        if sp < 0:
            names.append(hdr); comments.append(b"")
        else:
            names.append(hdr[:sp]); comments.append(hdr[sp + 1 :])
        seqs.append(lines[i + 1])
        quals.append(lines[i + 3])
    return names, seqs, quals, comments


def verify_read_archive(rpath: ReadPath, index=None, barcodes=None,
                        max_barcodes: int = 0) -> int:
    """Post-sort archive integrity invariant — reference
    test_same_barcode (src/barcode_resolve2.c:1554-1588) + check_data
    (src/buffer_file_wrapper.c:118-134): every record fetched through a
    barcode's index entry must be a well-formed 4-line FASTQ record
    whose BX tag decodes to ONE barcode per entry, and the record span
    must consume the indexed byte length exactly.

    index defaults to loading rpath.idx_path; barcodes defaults to all
    of them (cap with max_barcodes for sampled checks on big archives).
    Returns the number of barcodes checked; raises ValueError on any
    violation."""
    if index is None:
        index = load_barcode_index(rpath.idx_path)
    if barcodes is None:
        barcodes = sorted(index)
    if max_barcodes and len(barcodes) > max_barcodes:
        step = max(1, len(barcodes) // max_barcodes)
        barcodes = list(barcodes)[::step][:max_barcodes]
    n_checked = 0
    with open(rpath.R1_path, "rb") as f1, open(rpath.R2_path, "rb") as f2:
        for bc in barcodes:
            ent = index.get(int(bc))
            if ent is None:
                raise ValueError(f"barcode {bc} missing from index")
            o1, o2, l1, l2 = ent
            for f, off, ln, side in ((f1, o1, l1, "R1"), (f2, o2, l2, "R2")):
                f.seek(off)
                blob = f.read(ln)
                if len(blob) != ln:
                    raise ValueError(
                        f"{side} span of barcode {bc} truncated "
                        f"({len(blob)} < {ln})")
                names, seqs, quals, comments = parse_fastq_blob(blob)
                if not names or not blob.startswith(b"@") \
                        or not blob.endswith(b"\n"):
                    raise ValueError(
                        f"{side} span of barcode {bc} is not FASTQ-aligned")
                seen = set()
                for nm, sq, ql, cm in zip(names, seqs, quals, comments):
                    if len(sq) != len(ql):
                        raise ValueError(
                            f"{side} record {nm!r} of barcode {bc}: "
                            f"seq/qual length mismatch")
                    if cm.startswith(b"BX:Z:"):
                        sp = cm.find(b" ", 5)
                        seen.add(decode_barcode_seq(
                            cm[5 : sp if sp >= 0 else len(cm)]))
                if len(seen) > 1:
                    raise ValueError(
                        f"{side} span of barcode {bc} mixes barcodes "
                        f"{sorted(seen)[:4]}")
                if seen and next(iter(seen)) != int(bc):
                    raise ValueError(
                        f"{side} span of barcode {bc} holds records of "
                        f"barcode {next(iter(seen))}")
            n_checked += 1
    return n_checked
