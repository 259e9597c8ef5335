"""Host allocator tuning for page-fault-expensive hosts (a copy of the
JAX package's ops/hostmem.py; cli.main calls it, as the JAX CLI does).

The reference keeps one long-lived arena per data structure (kmhash
tables, read buffers) so page faults are paid once.  Numpy instead
mallocs/frees a fresh buffer per expression; glibc serves every large
block via mmap and returns it on free, so each vector expression
re-faults its pages.  On virtualized hosts where a minor fault is
expensive, that dominates the host-side graph build.

`tune_host_malloc()` flips glibc to heap-only service for large blocks
(M_MMAP_MAX=0) and disables trimming (M_TRIM_THRESHOLD=max), so pages
are faulted once and reused for the life of the process — the same
"allocate once, reuse forever" discipline as the reference's arenas.
It is process-wide and cannot be undone.  chip_smoke.py measures its
effect on the GPU host in fresh processes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys

_done = False

# glibc malloc.h mallopt parameter numbers
_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4


def tune_host_malloc() -> bool:
    """Idempotent; returns True if glibc mallopt was applied."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_MAX, 0)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        _done = bool(ok1 and ok2)
    except OSError:
        return False
    return _done
