"""ctypes binding of the port's host FASTQ reader (native/fastq_reader.cpp,
built at first use by _build.build_host): the port's twin of the JAX
package's io/native_loader.py and its C++ loader.

`read_fastq_batches_native` yields the JAX loader's batches from the
same file: (bases (n, pad_to) uint8 codes A0 C1 G2 T3, 4 for any other
byte, 255 pad; lengths (n,) int32, min(length, pad_to); headers, the
'@'-stripped header lines as bytes, or None).  The plain version is
io/fastq.py:read_fastq_batches_headers.  Unlike the JAX loader, every
header arrives whole: the reader keeps a batch's headers in a buffer of
its own that grows as needed.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import _build

_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    lib = _build.load_host("fastq_reader")
    lib.tafq_open.restype = ctypes.c_void_p
    lib.tafq_open.argtypes = [ctypes.c_char_p]
    lib.tafq_close.restype = None
    lib.tafq_close.argtypes = [ctypes.c_void_p]
    lib.tafq_next_batch.restype = ctypes.c_long
    lib.tafq_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        _I64P]
    lib.tafq_headers.restype = ctypes.c_void_p
    lib.tafq_headers.argtypes = [ctypes.c_void_p]
    return lib


def read_fastq_batches_native(path: str, batch_size: int = 8192,
                              pad_to: int = 256, with_headers: bool = False
                              ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                  Optional[list]]]:
    """Yield (bases, lengths, headers|None) batches of a FASTQ(.gz) file.
    Raises FileNotFoundError if it does not open and ValueError on a
    record without its '@' or a truncated one."""
    if batch_size < 1 or pad_to < 1:
        raise ValueError(f"batch_size {batch_size} and pad_to {pad_to} "
                         "must be positive")
    lib = _lib()
    h = lib.tafq_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            bases = np.empty((batch_size, pad_to), np.uint8)
            lengths = np.empty(batch_size, np.int32)
            off = np.zeros(batch_size + 1, np.int64) if with_headers \
                else None
            n = lib.tafq_next_batch(
                h, batch_size, pad_to,
                bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                None if off is None else off.ctypes.data_as(_I64P))
            if n < 0:
                raise ValueError(f"{path}: malformed FASTQ")
            if n == 0:
                break
            hdrs = None
            if with_headers:
                size = int(off[n])
                raw = ctypes.string_at(lib.tafq_headers(h), size) \
                    if size else b""
                hdrs = [raw[off[i]:off[i + 1]] for i in range(n)]
            yield bases[:n], lengths[:n], hdrs
            if n < batch_size:
                break
    finally:
        lib.tafq_close(h)
