"""The port's whole pipeline, `assembly3` (FASTQ files -> levels ->
scaffolds -> per-gap local assembly -> scaffold.full.fasta), against the
JAX package's `assembly3`, both on the CPU, on a repeat genome of about
40 kbp with two gaps (tests/test_assembly3.py's recipe: A-R-B-R-C, R the
same 1,500 bases twice, barcoded pairs from testing.sim_barcoded_pairs).

The JAX run's build_0 is its accelerator branch (count on the device
path, device unitig build), run on the CPU by this file, as in
tests/test_torch_pipeline.py: the JAX build_0 on a CPU backend builds
on the host, which numbers level-0 nodes otherwise.  Everything after it
is JAX assembly3 as it ships.  Tolerance: every file byte for byte,
scaffold.full.fasta and each local graph cache included: the port's
whole run through its CLI with -t 4, in a fresh interpreter that never
imports jax, and the bridge stage alone (the one stage that reads -t)
with -t 4 and -t 1.
"""

import dataclasses
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import pipeline as jpipe
from turingassembler_tpu.graph.device_build import \
    build_graph_on_device as j_build_on_device
from turingassembler_tpu.graph.invariants import check_graph as jcheck
from turingassembler_tpu.kmer.megasort import \
    count_kedges_megasort_device as j_count_device
from turingassembler_tpu_torch import cli as tcli
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode.sort_read import ReadPath
from turingassembler_tpu_torch.evaluate import evaluate_assembly
from turingassembler_tpu_torch.io import asmg
from turingassembler_tpu_torch.io.fasta import read_fasta
from turingassembler_tpu_torch.io.fastq import encode_barcode
from turingassembler_tpu_torch.localasm import bridge as TB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, MC = 31, 2
FINAL = "scaffold.full.fasta"
PATHS = "local_assembly_scaffold_path.txt"
ADDED = f"graph_k_{K}_added_barcode.bin"


def repeat_genome(seg=12_500, seed=11):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, seg).astype(np.uint8)
    r = rng.integers(0, 4, 1_500).astype(np.uint8)
    b = rng.integers(0, 4, seg).astype(np.uint8)
    c = rng.integers(0, 4, seg).astype(np.uint8)
    return np.concatenate([a, r, b, r, c])


def write_library(d, genome):
    r1, r2, _, _, bcs = tt.sim_barcoded_pairs(
        genome, molecule_len=5_000, n_molecules=1_000, reads_per_molecule=18,
        read_len=100, insert=280, seed=1, error_rate=0.002)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    files = [os.path.join(d, n) for n in ("R1.fq", "R2.fq", "I1.fq")]
    with open(files[0], "w") as o1, open(files[1], "w") as o2, \
            open(files[2], "w") as oi:
        for i in range(len(r1)):
            o1.write(f"@r{i}\n{acgt[r1[i]].tobytes().decode()}\n+\n{'I' * 100}\n")
            o2.write(f"@r{i}\n{acgt[r2[i]].tobytes().decode()}\n+\n{'I' * 100}\n")
            oi.write(f"@r{i}\n{encode_barcode(int(bcs[i]) + 1, 16).decode()}"
                     f"\n+\n{'I' * 16}\n")
    return files


def jax_build_0(cfg, out_dir=None):
    """The JAX build_0's accelerator branch, on the CPU."""
    u, c, n = j_count_device(jpipe._genomic_batches(cfg), cfg.k0,
                             min_count=cfg.device.min_kmer_count,
                             out_cap_log2=17)
    g = j_build_on_device(u, c, n, cfg.k0)
    jcheck(g, check_seq=False)
    jpipe.save_graph_info(g, cfg.out_dir, "level_0")
    return g


def out_files(d):
    """Every file an assembly3 run leaves in d, by relative path (the
    log aside)."""
    return sorted(os.path.relpath(p, d)
                  for p in glob.glob(os.path.join(d, "**"), recursive=True)
                  if os.path.isfile(p) and not p.endswith("assembly.log"))


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def assert_same_files(want_dir, got_dir, names):
    for name in names:
        want = file_bytes(os.path.join(want_dir, name))
        assert len(want) > 0, name
        assert file_bytes(os.path.join(got_dir, name)) == want, name


def local_caches(names):
    return [n for n in names if n.startswith("local_assembly_")
            and n.endswith("_local_lvl_1.bin")]


def run_port_cli(d, files, out, threads):
    """`python -m turingassembler_tpu_torch assembly3 ... --device cpu` in
    a fresh interpreter that must never import jax or the JAX package."""
    argv = ["turingassembler_tpu_torch", "assembly3", "-1", files[0],
            "-2", files[1], "-I", files[2], "-l", "ust", "-k0", str(K),
            "-mc", str(MC), "-t", str(threads), "-o", out, "--device", "cpu"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('turingassembler_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'turingassembler_tpu'\n"
        "       or m.startswith('turingassembler_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=d,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO,
                               "OMP_NUM_THREADS": "1"})


@pytest.fixture(scope="module")
def a3(tmp_path_factory):
    """The JAX run, and the port's through its CLI with -t 4 (only the
    bridge stage reads -t; the -t 1 runs are the stage's own tests)."""
    d = str(tmp_path_factory.mktemp("assembly3"))
    genome = repeat_genome()
    files = write_library(d, genome)
    jc = jcfg.Config(k0=K, files_1=(files[0],), files_2=(files[1],),
                     files_I=(files[2],), n_threads=4,
                     out_dir=os.path.join(d, "jax"))
    jc = jc.replace(device=dataclasses.replace(jc.device, min_kmer_count=MC))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "build_0", jax_build_0)
        jpipe.assembly3(jc)
    out = os.path.join(d, "port")
    res = run_port_cli(d, files, out, 4)
    cfg = tcfg.Config(k0=K, files_1=(files[0],), files_2=(files[1],),
                      files_I=(files[2],), n_threads=4, out_dir=out)
    return dict(dir=d, genome=genome, files=files, cfg=cfg, run=res,
                final=os.path.join(out, FINAL), names=out_files(jc.out_dir))


def test_assembly3_cli_same_files_without_jax(a3):
    """Every file of the JAX run, byte for byte, and neither jax nor the
    JAX package was imported on the way."""
    res = a3["run"]
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
    names = a3["names"]
    assert FINAL in names and len(local_caches(names)) == 2
    assert names == out_files(a3["cfg"].out_dir)
    assert_same_files(os.path.join(a3["dir"], "jax"), a3["cfg"].out_dir,
                      names)
    assert "bridging done: dump=0 trivial=0 path=2 no-path=0" in res.stderr


def test_assembly3_is_gapless(a3):
    contigs = [s for _, s in read_fasta(a3["final"])]
    genome = np.frombuffer(b"ACGT", np.uint8)[a3["genome"]].tobytes().decode()
    res = evaluate_assembly(contigs, genome)
    assert res.n_misassemblies == 0
    assert res.genome_fraction > 0.97
    assert res.nga50 >= 0.9 * len(genome), res
    assert "N" not in contigs[0]


def bridge_dir(a3, name):
    """A fresh output dir holding only the scaffold path file."""
    out = os.path.join(a3["dir"], name)
    os.makedirs(out)
    shutil.copy(os.path.join(a3["cfg"].out_dir, PATHS), out)
    return out


@pytest.mark.parametrize("cmd,threads", [("local_assembly", "4"),
                                         ("build_bridge", "1")])
def test_cli_local_assembly(a3, cmd, threads, capsys):
    """The stage alone from the aux-info graph and the sorted archive:
    it builds the local graphs anew, the JAX run's caches and final
    assembly."""
    src = a3["cfg"].out_dir
    out = bridge_dir(a3, f"stage_{cmd}")
    args = [cmd, "-i", os.path.join(src, ADDED), "-l", "sorted",
            "-1", os.path.join(src, "R1.sorted.fq"),
            "-2", os.path.join(src, "R2.sorted.fq"),
            "-I", os.path.join(src, "barcode.idx"),
            "-k0", str(K), "-t", threads, "-o", out, "--device", "cpu"]
    assert tcli.main(args) == 0
    assert capsys.readouterr().out.strip() == os.path.join(out, FINAL)
    assert TB.BRIDGE_COUNTS == {"dump": 0, "trivial": 0, "path": 2,
                                "no_path": 0}
    names = [FINAL] + local_caches(a3["names"])
    assert_same_files(os.path.join(a3["dir"], "jax"), out, names)


def test_duplicate_gaps_in_threads(a3):
    """A scaffold path listed twice: its gaps are jobs twice over.  The
    second job of a gap finds the local graph and the read set taken by
    the first and reloads / fetches them; with 4 threads the output is
    the one thread's, and both copies of the path bridge alike.  (The
    local graphs are the run's caches, copied in.)"""
    src = a3["cfg"].out_dir
    paths = TB.parse_scaffold_paths(os.path.join(src, PATHS))
    multi = [p for p in paths if len(p) > 1]
    g = asmg.load_graph(os.path.join(src, ADDED))
    rpath = ReadPath(*(os.path.join(src, n) for n in
                       ("R1.sorted.fq", "R2.sorted.fq", "barcode.idx")))
    outs = []
    for threads in (4, 1):
        out = os.path.join(a3["dir"], f"dup_t{threads}")
        for cache in local_caches(a3["names"]):
            os.makedirs(os.path.join(out, os.path.dirname(cache)))
            shutil.copy(os.path.join(src, cache), os.path.join(out, cache))
        pf = os.path.join(out, PATHS)
        with open(pf, "w") as fp:
            fp.write(f"{2 * len(multi)}\n")
            for p in multi + multi:
                fp.write(f"{len(p)}\n{' '.join(map(str, p))}\n")
        TB.build_bridge(a3["cfg"].replace(n_threads=threads), g, rpath, pf,
                        out_dir=out, device="cpu")
        outs.append(out)
    assert file_bytes(os.path.join(outs[0], FINAL)) == \
        file_bytes(os.path.join(outs[1], FINAL))
    recs = list(read_fasta(os.path.join(outs[0], FINAL)))
    final = dict(read_fasta(a3["final"]))
    for i in range(len(multi)):
        assert recs[i][1] == recs[len(multi) + i][1] == final[f"contig_{i}"]
    assert TB.BRIDGE_COUNTS["path"] == 2 * (sum(map(len, multi))
                                            - len(multi))


def test_assembly3_raises_without_gpu(a3):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    out = os.path.join(a3["dir"], "port_nogpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpipe.assembly3(a3["cfg"].replace(out_dir=out))
    src = a3["cfg"].out_dir
    for cmd in ("assembly3", "local_assembly", "build_bridge"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcli.main([cmd, "-i", os.path.join(src, ADDED), "-1",
                       a3["files"][0], "-o", out])
    assert not os.path.exists(out)
