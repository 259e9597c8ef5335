"""Bytes a merge of two counted tables must move (the count's
merge_runs, `count.merge` spans), from its rows: each input row read
once, each output row written once, at roofline/bytes.py's size of a
counted (k1)-mer.  Returns (hbm_bytes, link_bytes, ops), as bytes.py's
functions do; nothing crosses the link."""

from __future__ import annotations

from .bytes import kmer_row_bytes


def merge(rows_in: int, rows_out: int, k1: int):
    return (rows_in + rows_out) * kmer_row_bytes(k1), 0, 0
