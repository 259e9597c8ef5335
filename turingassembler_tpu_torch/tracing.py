"""Spans and their counts inside the port, on the clock torch.profiler
stamps the card's events with.

    with tracing.span("count.ship", bytes=n, pageable=1):
        ...
    tracing.add(rows=r)      # onto the innermost open span of this thread
    tracing.host_sync()      # add(syncs=1), beside a sync the code makes
    for x in tracing.timed(it, "source_ns"):   # next()'s wait, as a count
        ...

Tracing is on while a torch.profiler session records
(torch.autograd.profiler._is_profiler_enabled, read at each call) or
between start() and stop().  Off, span() returns one shared object that
does nothing, and add() and host_sync() return at once: no allocation, no
clock read.  On, each span that closes records

    (id, parent_id, name, thread_id, t0_ns, t1_ns, counts)

in an in-memory list (flat, so a span leaves no tuple for the garbage
collector to count) that records() reads and clear() empties.  parent_id
is the innermost span open in the same thread when the span opened (None
at a root), so maps run from worker threads nest apart.  Stamps are
time.time_ns(), the wall clock of the profiler's device events, so a
device interval can be put down to the span open during it.  A span times
the host alone: it adds no device sync, copy or allocation to what it
wraps; the device side comes from the profiler.

Span names are dotted under their layer's root (`count`, `build`, `map`):
a root's children divide its host time, so every millisecond of a root
has a name.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch.autograd.profiler as _profiler

_records: list = []            # _FIELDS entries a closed span
_FIELDS = 7
_started = False
_ids = itertools.count(1)
_local = threading.local()


def enabled() -> bool:
    """Whether spans record now (a profiler session, or start())."""
    return _started or _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "t0")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.stack.remove(self)
        # flat, no tuple a span: fewer objects for the collector to count
        _records.extend((self.id, self.parent, self.name,
                         threading.get_ident(), self.t0, t1, self.counts))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, **counts):
    """A context manager timing the host between its enter and exit,
    with `counts` to start its counts."""
    # the test of enabled() inline here and below: off costs no more call
    if not (_started or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, counts)


def add(**counts) -> None:
    """Add to the counts of this thread's innermost open span."""
    if not (_started or _profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if stack:
        mine = stack[-1].counts
        for key, n in counts.items():
            mine[key] = mine.get(key, 0) + n


def timed(iterable, key: str):
    """`iterable` itself when tracing is off.  On, an iterator over it
    that adds the ns each of its next() calls waits to `key` on the
    innermost span open then: a wait timed without a span of its own,
    so a loop over many small items appends no record an item."""
    if not (_started or _profiler._is_profiler_enabled):
        return iterable
    return _timed(iter(iterable), key)


def _timed(it, key: str):
    while True:
        t0 = time.time_ns()
        try:
            item = next(it)
        except StopIteration:
            add(**{key: time.time_ns() - t0})
            return
        add(**{key: time.time_ns() - t0})
        yield item


def host_sync(n: int = 1) -> None:
    """Count n host syncs (a pull, an .item(), a nonzero) on the
    innermost open span."""
    if _started or _profiler._is_profiler_enabled:
        add(syncs=n)


def start() -> None:
    global _started
    _started = True


def stop() -> None:
    global _started
    _started = False


def records() -> list:
    """The closed spans recorded so far, in the order they closed."""
    return list(zip(*[iter(_records)] * _FIELDS))


def clear() -> None:
    _records.clear()
