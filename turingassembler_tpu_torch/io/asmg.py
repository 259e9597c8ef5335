"""Binary "asmg" graph serialization, byte-compatible with the reference.

On-disk layout (reference save_asm_graph src/assembly_graph.c:1173-1248 /
load_asm_graph :1250-1355, gint_t = int64 per src/attribute.h:38):

  "asmg" | aux_flag u32 | ksize i32 | n_v i64 | n_e i64
  per node:  rc_id i64, deg i64, adj[deg] i64
  per edge:  source i64, target i64; if source != -1:
             rc_id i64, count u64,
             seq_len u32, n_holes u32      <- the reference writes these two
                                              as one 8-byte blob (it xfwrites
                                              sizeof(gint_t) bytes starting at
                                              &seq_len, pulling in the adjacent
                                              n_holes field)
             seq[ceil(seq_len/16)] u32 (binseq packing),
             n_holes u32, p_holes[n] u32, l_holes[n] u32
  if aux_flag & ASM_HAVE_BARCODE: five barcode hashes per live edge
             (size u32, n_item u32, keys[size] u64, cnts[size] u32)

The barcode hash blobs are stored in the reference's open-addressing
layout; we serialize our barcode sets into an equivalent table (power-of-
two size, empty slots key = UINT64_MAX) so reference tooling can read our
files.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from ..graph.structs import AsmGraph
from .binseq import pack_binseq, unpack_binseq

ASM_HAVE_BARCODE = 0x1
BX_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _write_bx_hash(fp: BinaryIO, counter: dict) -> None:
    """Serialize {barcode:int -> count:int} as the reference's
    barcode_hash_t table (src/barcode_hash.c:14-50: power-of-two size,
    linear probe; empty key = (uint64_t)-1)."""
    n = len(counter)
    size = 4
    while size < n * 2:
        size <<= 1
    keys = np.full(size, BX_EMPTY, np.uint64)
    cnts = np.zeros(size, np.uint32)
    mask = size - 1
    for bx, c in counter.items():
        h = (bx * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        i = h & mask
        while keys[i] != BX_EMPTY:
            i = (i + 1) & mask
        keys[i] = bx
        cnts[i] = c
    fp.write(struct.pack("<II", size, n))
    fp.write(keys.tobytes())
    fp.write(cnts.tobytes())


def _read_bx_hash(fp: BinaryIO) -> dict:
    size, n_item = struct.unpack("<II", fp.read(8))
    keys = np.frombuffer(fp.read(8 * size), np.uint64)
    cnts = np.frombuffer(fp.read(4 * size), np.uint32)
    live = keys != BX_EMPTY
    return dict(zip(keys[live].tolist(), cnts[live].tolist()))


def save_graph(g: AsmGraph, path: str) -> None:
    with open(path, "wb") as fp:
        fp.write(b"asmg")
        fp.write(struct.pack("<I", g.aux_flag))
        fp.write(struct.pack("<i", g.ksize))
        fp.write(struct.pack("<qq", g.n_v, g.n_e))
        deg = g.node_deg()
        for u in range(g.n_v):
            fp.write(struct.pack("<qq", int(g.node_rc[u]), int(deg[u])))
            if deg[u]:
                fp.write(g.node_adj(u).astype("<i8").tobytes())
        lens = g.edge_len()
        for e in range(g.n_e):
            fp.write(struct.pack("<qq", int(g.edge_source[e]), int(g.edge_target[e])))
            if g.edge_source[e] == -1:
                continue
            n_holes = len(g.holes[e][0]) if e in g.holes else 0
            fp.write(struct.pack("<qQ", int(g.edge_rc[e]), int(g.edge_count[e])))
            fp.write(struct.pack("<II", int(lens[e]), n_holes))
            fp.write(pack_binseq(g.get_seq(e)).astype("<u4").tobytes())
            fp.write(struct.pack("<I", n_holes))
            if n_holes:
                ph, lh = g.holes[e]
                fp.write(ph.astype("<u4").tobytes())
                fp.write(lh.astype("<u4").tobytes())
        if g.aux_flag & ASM_HAVE_BARCODE:
            for e in range(g.n_e):
                if g.edge_source[e] == -1:
                    continue
                for table in (g.barcodes[e][0], g.barcodes[e][1], g.barcodes[e][2],
                              g.barcodes_scaf[e], g.barcodes_cov[e]):
                    _write_bx_hash(fp, table or {})


def load_graph(path: str) -> AsmGraph:
    with open(path, "rb") as fp:
        sig = fp.read(4)
        if sig != b"asmg":
            raise ValueError(f"{path}: not an assembly graph file")
        (aux_flag,) = struct.unpack("<I", fp.read(4))
        (ksize,) = struct.unpack("<i", fp.read(4))
        n_v, n_e = struct.unpack("<qq", fp.read(16))
        g = AsmGraph(ksize=ksize)
        g.aux_flag = aux_flag
        g.node_rc = np.zeros(n_v, np.int64)
        adj_lists = []
        for u in range(n_v):
            rc, deg = struct.unpack("<qq", fp.read(16))
            g.node_rc[u] = rc
            adj_lists.append(np.frombuffer(fp.read(8 * deg), "<i8") if deg else np.zeros(0, np.int64))
        g.adj_off = np.concatenate([[0], np.cumsum([len(a) for a in adj_lists])]).astype(np.int64)
        g.adj_list = (np.concatenate(adj_lists) if adj_lists else np.zeros(0, np.int64)).astype(np.int64)

        g.edge_source = np.zeros(n_e, np.int64)
        g.edge_target = np.zeros(n_e, np.int64)
        g.edge_rc = np.full(n_e, -1, np.int64)
        g.edge_count = np.zeros(n_e, np.int64)
        seqs = []
        for e in range(n_e):
            src, tgt = struct.unpack("<qq", fp.read(16))
            g.edge_source[e], g.edge_target[e] = src, tgt
            if src == -1:
                seqs.append(np.zeros(0, np.uint8))
                continue
            rc, count = struct.unpack("<qQ", fp.read(16))
            seq_len, _nh_quirk = struct.unpack("<II", fp.read(8))
            g.edge_rc[e], g.edge_count[e] = rc, count
            nw = (seq_len + 15) >> 4
            words = np.frombuffer(fp.read(4 * nw), "<u4")
            seqs.append(unpack_binseq(words, seq_len))
            (n_holes,) = struct.unpack("<I", fp.read(4))
            if n_holes:
                ph = np.frombuffer(fp.read(4 * n_holes), "<u4").astype(np.int64)
                lh = np.frombuffer(fp.read(4 * n_holes), "<u4").astype(np.int64)
                g.holes[e] = (ph, lh)
        lens = np.array([len(s) for s in seqs], np.int64)
        g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        g.seq_data = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)

        if aux_flag & ASM_HAVE_BARCODE:
            g.barcodes = [[{}, {}, {}] for _ in range(n_e)]
            g.barcodes_scaf = [{} for _ in range(n_e)]
            g.barcodes_cov = [{} for _ in range(n_e)]
            for e in range(n_e):
                if g.edge_source[e] == -1:
                    continue
                g.barcodes[e][0] = _read_bx_hash(fp)
                g.barcodes[e][1] = _read_bx_hash(fp)
                g.barcodes[e][2] = _read_bx_hash(fp)
                g.barcodes_scaf[e] = _read_bx_hash(fp)
                g.barcodes_cov[e] = _read_bx_hash(fp)
    return g
