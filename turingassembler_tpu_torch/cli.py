"""Command-line interface of the port: the graph-level subcommands of
turingassembler_tpu/cli.py (upstream src/main.c:426-503) with their
options, plus `--device`.

    python -m turingassembler_tpu_torch basic -1 R1.fq -2 R2.fq -k0 45 \\
        -mc 2 -o out --device cuda

Options: `-1/-2/-I` file lists, `-l` library type, `-k0` global k, `-o`
output dir, `-sm` sort memory GB, `-mc` minimum (k+1)-mer count, `-i`
graph .bin (accepted as the JAX package accepts it), `-v` verbosity.
`--device cuda` (the default) raises when no GPU is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from .config import LIB_TYPE_NAMES, Config
from .device import resolve_device
from .logging_utils import init_logger, set_log_stage


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-1", dest="files_1", nargs="+", default=[], help="forward reads")
    p.add_argument("-2", dest="files_2", nargs="+", default=[], help="reverse reads")
    p.add_argument("-I", dest="files_I", nargs="+", default=[], help="index (barcode) reads")
    p.add_argument("-l", dest="lib_type", choices=list(LIB_TYPE_NAMES), default="ust")
    p.add_argument("-k0", dest="k0", type=int, default=45)
    p.add_argument("-o", dest="out_dir", default=".")
    p.add_argument("-i", dest="in_file", default=None, help="input graph .bin")
    p.add_argument("-sm", dest="mmem_gb", type=int, default=32)
    p.add_argument("-mc", dest="min_kmer_count", type=int, default=1,
                   help="drop (k+1)-mers below this count")
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("--device", dest="device", default="cuda",
                   help="cuda (default) or cpu")


def _cfg_from_args(a) -> Config:
    cfg = Config(
        k0=a.k0, out_dir=a.out_dir, mmem_gb=a.mmem_gb,
        lib_type=LIB_TYPE_NAMES[a.lib_type],
        files_1=tuple(a.files_1), files_2=tuple(a.files_2),
        files_I=tuple(a.files_I), in_file=a.in_file)
    return cfg.replace(device=dataclasses.replace(
        cfg.device, min_kmer_count=a.min_kmer_count))


def cmd_basic(cfg: Config, device):
    """Graph-only pipeline: build_0 + build_0_1 + build_1_2."""
    from .pipeline import assembly_basic
    set_log_stage("basic")
    assembly_basic(cfg, device=device)


def cmd_build_0(cfg: Config, device):
    from .pipeline import build_0
    set_log_stage("build_0")
    build_0(cfg, device=device)


def cmd_build_0_1(cfg: Config, device):
    from .pipeline import build_0_1
    set_log_stage("build_0_1")
    build_0_1(cfg, device=device)


def cmd_build_1_2(cfg: Config, device):
    from .pipeline import build_1_2
    set_log_stage("build_1_2")
    build_1_2(cfg)


COMMANDS = {"basic": cmd_basic, "build_0": cmd_build_0,
            "build_0_1": cmd_build_0_1, "build_1_2": cmd_build_1_2}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog="turingassembler_tpu_torch",
        description="read-cloud genome assembler, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        _add_common(sub.add_parser(name))
    a = parser.parse_args(argv)
    cfg = _cfg_from_args(a)
    device = resolve_device(a.device)
    init_logger(cfg.out_dir, logging.DEBUG if a.verbose else logging.INFO)
    try:
        COMMANDS[a.cmd](cfg, device)
    except FileNotFoundError as e:
        print(f"{a.cmd}: file not found: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
