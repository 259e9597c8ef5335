"""The port's CLI against the JAX package's, command by command: the
graph-file passes, the barcode levels 3 -> 4 -> 5, the commands that map
reads or build the minimizer index, and upstream's molecule names.

One linked-read library of about 9 kbp (tests/test_cli_variants.py's
recipe, with one 700 bp repeat twice in the genome so that level 2 keeps
several contigs) goes through the port's `basic`, `sort_read` and
`build_barcode` once.  On those files each command then runs once in the
JAX CLI and once in the port's with `--device cpu`.  Tolerance: every
output file byte for byte, and the printed lines where a command prints
its result.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_pipeline import write_synthetic_library
from turingassembler_tpu import cli as jcli
from turingassembler_tpu.io.fastq import encode_barcode
from turingassembler_tpu_torch import cli as tcli
from turingassembler_tpu_torch.io.fasta import read_fasta

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = "31"
# the four commands whose result is what they print
PRINTING = ("dirty", "mm_index", "barcode_hit", "bin2text")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_variants")
    rng = np.random.default_rng(41)
    A, B, C = (rng.integers(0, 4, 2_600).astype(np.uint8) for _ in range(3))
    R = rng.integers(0, 4, 700).astype(np.uint8)
    genome = np.concatenate([A, R, B, R, C])
    f1, f2, fI, bcs = write_synthetic_library(tmp, genome, n_molecules=60,
                                              seed=5)
    out = str(tmp / "port")
    library = ["-1", f1, "-2", f2, "-I", fI, "-l", "ust"]
    common = ["-k0", K, "-o", out, "--device", "cpu"]
    assert tcli.main(["basic"] + library + common) == 0
    assert tcli.main(["sort_read"] + library + common) == 0
    sorted_args = ["-l", "sorted",
                   "-1", os.path.join(out, "R1.sorted.fq"),
                   "-2", os.path.join(out, "R2.sorted.fq"),
                   "-I", os.path.join(out, "barcode.idx")]
    lvl2 = os.path.join(out, f"graph_k_{K}_level_2.bin")
    assert tcli.main(["build_barcode", "-i", lvl2] + sorted_args
                     + common) == 0
    # an adjacency-free FASTG of the level-2 contigs (each edge and its
    # rc), as tests/test_cli_variants.py writes it
    fastg = str(tmp / "g.fastg")
    with open(fastg, "w") as fp:
        for i, (_, s) in enumerate(read_fasta(lvl2[:-3] + "fasta"), 1):
            rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
            fp.write(f">EDGE_{i}_length_{len(s)}_cov_10;\n{s}\n")
            fp.write(f">EDGE_{i}_length_{len(s)}_cov_10';\n{rc}\n")
    # a frequency file as count_bx writes it: '<barcode>\t<count>'
    seqs = [encode_barcode(int(b) + 1, 16).decode() for b in bcs]
    freq = str(tmp / "freq.txt")
    with open(freq, "w") as fp:
        for s in sorted(set(seqs)):
            fp.write(f"{s}\t{seqs.count(s)}\n")
    return {"tmp": tmp, "lvl2": lvl2, "lvl2_fasta": lvl2[:-3] + "fasta",
            "bc": os.path.join(out, f"graph_k_{K}_added_barcode.bin"),
            "fastg": fastg, "freq": freq, "barcode": seqs[0],
            "sorted": sorted_args}


def arguments(lib, name):
    """The input options of each of the 19 commands."""
    lvl2, bc, srt = lib["lvl2"], lib["bc"], lib["sorted"]
    return {
        "build_2_3": ["-i", lvl2], "dirty": ["-i", lvl2],
        "resolve_dump": ["-i", lvl2], "resolve_bulges": ["-i", lvl2],
        "resolve_complex_bulges": ["-i", lvl2], "resolve_local": ["-i", lvl2],
        "resolve_212_cov": ["-i", lvl2], "mm_index": ["-i", lvl2],
        "build_3_4": ["-i", bc], "build_3_4_nobc": ["-i", bc],
        "build_4_5": ["-i", bc], "resolve_n_m": ["-i", bc],
        "barcode_hit": ["-i", lvl2, "-f", lib["barcode"]] + srt,
        "build_barcode_fasta": ["-f", lib["lvl2_fasta"]] + srt,
        "build_barcode_fastg": ["-f", lib["fastg"]] + srt,
        "debug_get_barcode_graph": ["-i", lvl2] + srt,
        "resolve_molecule": ["-i", lvl2] + srt,
        "debug_split_molecules": ["-i", lvl2, "-f", lib["freq"]] + srt,
    }[name]


NEW = ["build_2_3", "dirty", "resolve_dump", "resolve_bulges",
       "resolve_complex_bulges", "resolve_local", "resolve_212_cov",
       "mm_index", "build_3_4", "build_3_4_nobc", "build_4_5", "resolve_n_m",
       "barcode_hit", "build_barcode_fasta", "build_barcode_fastg",
       "debug_get_barcode_graph", "resolve_molecule", "debug_split_molecules",
       "bin2text"]


def outputs(d):
    """{name: bytes} of what a command left in its directory (the log
    carries times and is left out)."""
    got = {}
    for root, _, files in os.walk(d):
        for f in files:
            if f != "assembly.log":
                p = os.path.join(root, f)
                with open(p, "rb") as fp:
                    got[os.path.relpath(p, d)] = fp.read()
    return got


def test_command_tables_equal():
    assert sorted(tcli.COMMANDS) == sorted(jcli.COMMANDS)
    assert len(tcli.COMMANDS) == 40
    assert sorted(set(tcli.COMMANDS) - set(NEW)) == sorted(
        ["assembly3", "basic", "build_0", "build_0_1", "build_1_2",
         "sort_read", "get_rp_count", "debug_current", "build_coverage",
         "build_barcode", "build_barcode_coverage", "scaffold",
         "build_scaffolding_1_2", "count_bx", "reduce_reads",
         "minimizers_hit", "barcode_graph", "split_molecules",
         "local_assembly", "build_bridge", "evaluate"])


def _options(parser):
    """Each option of a parser: its strings, dest, default, nargs, type,
    choices and action kind."""
    return sorted((tuple(a.option_strings), a.dest, a.default, a.nargs,
                   a.type, tuple(a.choices or ()), type(a).__name__)
                  for a in parser._actions if a.option_strings
                  and a.dest != "help")


def test_command_options_equal():
    """Every JAX subcommand takes the same options in the port, plus
    --device (the JAX main gives every subparser _add_common)."""
    import argparse
    sub = next(a for a in tcli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    assert sorted(sub.choices) == sorted(jcli.COMMANDS)
    for name in jcli.COMMANDS:
        jp = argparse.ArgumentParser()
        jcli._add_common(jp)
        got = [o for o in _options(sub.choices[name])
               if o[0] != ("--device",)]
        assert got == _options(jp), name
        assert ("--device",) in [o[0] for o in _options(sub.choices[name])]
    assert ("--dist-nproc",) in [o[0] for o in got]


@pytest.mark.parametrize("name", NEW)
def test_command_same_files(lib, name, capsys):
    """The command in both CLIs: the same files, byte for byte, and for
    the printing commands the same lines."""
    tmp = lib["tmp"]
    dirs = {w: str(tmp / f"{w}_{name}") for w in ("jax", "port")}
    args = {}
    for w, d in dirs.items():
        if name == "bin2text":      # it writes next to its input
            os.makedirs(d)
            shutil.copy(lib["lvl2"], os.path.join(d, "in.bin"))
            args[w] = ["-i", os.path.join(d, "in.bin")]
        else:
            args[w] = arguments(lib, name)
        args[w] = [name] + args[w] + ["-k0", K, "-o", d]
    capsys.readouterr()
    assert jcli.main(args["jax"]) == 0
    printed_jax = capsys.readouterr().out.replace(dirs["jax"], "<d>")
    assert tcli.main(args["port"] + ["--device", "cpu"]) == 0
    printed_port = capsys.readouterr().out.replace(dirs["port"], "<d>")
    want, got = outputs(dirs["jax"]), outputs(dirs["port"])
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    if name in PRINTING:
        assert printed_port == printed_jax
        assert printed_port.strip()
    else:
        assert want, "the command wrote no file"


def test_levels_do_work(lib, tmp_path):
    """The library is one the barcode levels act on: level 4 has fewer
    live edges than the added_barcode graph it came from."""
    from turingassembler_tpu_torch.io import asmg
    d = str(tmp_path / "l4")
    assert tcli.main(["build_3_4", "-i", lib["bc"], "-k0", K, "-o", d,
                      "--device", "cpu"]) == 0
    g3 = asmg.load_graph(lib["bc"])
    g4 = asmg.load_graph(os.path.join(d, f"graph_k_{K}_level_4.bin"))
    assert g4.alive_mask().sum() < g3.alive_mask().sum()


def test_device_commands_raise_without_gpu(lib, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for name in ("mm_index", "build_barcode_fasta", "build_3_4"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcli.main([name] + arguments(lib, name)
                      + ["-k0", K, "-o", str(tmp_path / name)])


def test_build_3_4_runs_without_jax(lib, tmp_path):
    """`python -m turingassembler_tpu_torch build_3_4 ... --device cpu`
    in a fresh interpreter: the JAX CLI's level-4 files, and neither jax
    nor the JAX package was imported on the way."""
    want, out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main(["build_3_4", "-i", lib["bc"], "-k0", K, "-o",
                      want]) == 0
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['turingassembler_tpu_torch', 'build_3_4', '-i',"
        f" {lib['bc']!r}, '-k0', '{K}', '-o', {out!r}, '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('turingassembler_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'turingassembler_tpu'\n"
        "       or m.startswith('turingassembler_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
    assert outputs(out) == outputs(want)
