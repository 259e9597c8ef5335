"""Staged logger — rebuild of src/log.c (SURVEY.md LX).

Reference behaviors kept: every line carries source location, the
current pipeline stage label (set_log_stage, log.c:108-121), and peak
RSS; full detail always goes to `assembly.log` while the console shows
>= the chosen level.
"""

from __future__ import annotations

import logging
import os
import resource
import sys
import time
from typing import Optional

_STAGE = {"name": "init", "t0": time.time()}
_STAGE_WALLS: dict = {}
_LOGGER: Optional[logging.Logger] = None


def set_log_stage(name: str) -> None:
    """Switch the pipeline stage label; logs the wall-clock of the stage
    being left (reference per-stage clock, src/time_utils.c used at every
    process.c phase, e.g. process.c:59-65) and accumulates it for
    stage_walls() reports."""
    now = time.time()
    prev = _STAGE["name"]
    if prev != "init":
        # accumulate even on a same-name re-entry (a re-asserted stage
        # must not drop its elapsed interval); only the log line is
        # suppressed for duplicates
        _STAGE_WALLS[prev] = _STAGE_WALLS.get(prev, 0.0) + (now - _STAGE["t0"])
        if prev != name and _LOGGER is not None:
            _LOGGER.info("stage '%s' done in %.1fs", prev, now - _STAGE["t0"])
    _STAGE["name"] = name
    _STAGE["t0"] = now


def add_stage_wall(name: str, seconds: float) -> None:
    """Add seconds to a named part of a stage (pipeline.build_0 records
    its parse, count, build and save times as "build_0.<part>")."""
    _STAGE_WALLS[name] = _STAGE_WALLS.get(name, 0.0) + seconds


def timed_iter(items, name: str):
    """Pass items through, adding the time spent producing them to the
    stage wall `name`; the consumer's own time is not in it."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            add_stage_wall(name, time.perf_counter() - t0)
        yield item


def stage_walls() -> dict:
    """Accumulated seconds per pipeline stage since the last reset."""
    return dict(_STAGE_WALLS)


def reset_stage_walls() -> None:
    _STAGE_WALLS.clear()


class _StageFormatter(logging.Formatter):
    def format(self, record):
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        record.stage = _STAGE["name"]
        record.rss = f"{rss_mb:.0f}MB"
        return super().format(record)


def init_logger(out_dir: str = ".", level: int = logging.INFO) -> logging.Logger:
    global _LOGGER
    logger = logging.getLogger("turingassembler")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    fmt = _StageFormatter(
        "%(asctime)s [%(levelname)s] [%(stage)s] [%(rss)s] "
        "%(filename)s:%(lineno)d %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setLevel(level)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    try:
        os.makedirs(out_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(out_dir, "assembly.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:
        pass
    _LOGGER = logger
    return logger


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        _LOGGER = init_logger()
    return _LOGGER
