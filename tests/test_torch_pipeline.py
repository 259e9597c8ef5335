"""The port's staged pipeline (FASTQ files -> level 0, 1, 2 graph files,
and on to the sorted archive, the extended contigs, the barcode graph
and the scaffolds) against the JAX package, through `assembly_basic`,
`assembly_to_scaffolds`, the CLI function and
`python -m turingassembler_tpu_torch`.

The reference run is the JAX package's accelerator branch of build_0,
made on the CPU by this file: count_kedges_megasort_device over
pipeline._genomic_batches -> device_build.build_graph_on_device ->
save_graph_info, then build_0_1 and build_1_2 on that graph.  (The JAX
build_0 itself builds on the host on a CPU backend, which numbers
nodes otherwise.)  Tolerance: the nine files byte for byte.

The linked-read stages' reference is the JAX package's stages run one by
one by this file on the level-2 .bin that the port wrote: sort_reads,
get_read_pair_counts, get_long_contigs_by_readpairs, graph_from_contigs,
recount_coverage_from_batches, construct_aux_info, scaffolding.
Tolerance: the seven files byte for byte.
"""

import dataclasses
import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import pipeline as jpipe
from turingassembler_tpu.graph import build as jbuild
from turingassembler_tpu.graph.device_build import \
    build_graph_on_device as j_build_on_device
from turingassembler_tpu.graph.invariants import check_graph as jcheck
from turingassembler_tpu.kmer.megasort import \
    count_kedges_megasort_device as j_count_device
from turingassembler_tpu_torch import cli as tcli
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import pipeline as tpipe
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.io.fastq import write_fastq
from turingassembler_tpu_torch.resolve import basic as tbasic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, MC = 45, 2
FILES = [f"graph_k_{K}_level_{lv}.{ext}" for lv in (0, 1, 2)
         for ext in ("bin", "gfa", "fasta")]

# (seed, library layout, R1 gzipped)
CASES = {"ust_plain": (40, "ust", False), "10x_gzip": (50, "10x", True)}


def write_library(d, seed, lib, gz):
    """Two haplotypes with variant clusters every 600 bp (bubbles that
    reach the alignment check), reads with 0.5% substitutions, half into
    R1 and half into R2.  A 10X-layout R1 carries 23 leading bases of
    barcode and UMI."""
    rng = np.random.default_rng(seed)
    a = tt.random_genome(14_000, seed=seed)
    b, _ = tt.second_haplotype(a, seed=seed + 1, cell=600)
    ra, la = tt.sim_reads(a, 18, 150, seed=seed + 2, error_rate=0.005)
    rb, lb = tt.sim_reads(b, 18, 150, seed=seed + 3, error_rate=0.005)
    reads = np.concatenate([ra, rb])[rng.permutation(len(ra) + len(rb))]
    half = len(reads) // 2
    r1 = list(reads[:half])
    if lib == "10x":
        r1 = [np.concatenate([rng.integers(0, 4, 23).astype(np.uint8), r])
              for r in r1]
    p1, p2 = os.path.join(d, "R1.fq"), os.path.join(d, "R2.fq")
    write_fastq(p1, [b"r%d" % i for i in range(half)], r1)
    write_fastq(p2, [b"r%d" % i for i in range(len(reads) - half)],
                list(reads[half:]))
    if gz:
        with open(p1, "rb") as src, gzip.open(p1 + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(p1)
        p1 += ".gz"
    return p1, p2


def jax_reference(cfg):
    """Level 0, 1, 2 files of the JAX package's accelerator branch."""
    u, c, n = j_count_device(jpipe._genomic_batches(cfg), cfg.k0,
                             min_count=cfg.device.min_kmer_count,
                             out_cap_log2=17)
    g = j_build_on_device(u, c, n, cfg.k0)
    jcheck(g, check_seq=False)
    jpipe.save_graph_info(g, cfg.out_dir, "level_0")
    g = jpipe.build_0_1(cfg, g)
    return jpipe.build_1_2(cfg, g)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    seed, lib, gz = CASES[request.param]
    d = str(tmp_path_factory.mktemp(request.param))
    p1, p2 = write_library(d, seed, lib, gz)
    cfg = jcfg.Config(k0=K, out_dir=os.path.join(d, "jax"), files_1=(p1,),
                      files_2=(p2,), lib_type=jcfg.LIB_TYPE_NAMES[lib])
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 min_kmer_count=MC))
    g2 = jax_reference(cfg)
    return dict(dir=d, lib=lib, p1=p1, p2=p2, jcfg=cfg, level2=g2)


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def assert_same_files(want_dir, got_dir, names=FILES):
    for name in names:
        want = file_bytes(os.path.join(want_dir, name))
        got = file_bytes(os.path.join(got_dir, name))
        assert len(want) > 0
        assert got == want, name


def test_assembly_basic_nine_files(case, monkeypatch):
    pairs = []
    real = tbasic.nw_align_scores_batch

    def counting(p, device="cuda"):
        pairs.append(len(p))
        return real(p, device)

    monkeypatch.setattr(tbasic, "nw_align_scores_batch", counting)
    out = os.path.join(case["dir"], "port_api")
    cfg = convert.config(case["jcfg"]).replace(out_dir=out)
    g2 = tpipe.assembly_basic(cfg, device="cpu")
    assert_same_files(case["jcfg"].out_dir, out)
    # the run was no walk-over: bubbles reached the DP, the graph shrank
    assert sum(pairs) >= 10
    g0 = tasmg.load_graph(os.path.join(out, FILES[0]))
    assert g2.n_e == case["level2"].n_e < g0.n_e // 4
    assert not os.path.exists(os.path.join(out, "spill"))


def test_cli_nine_files(case):
    out = os.path.join(case["dir"], "port_cli")
    rc = tcli.main(["basic", "-1", case["p1"], "-2", case["p2"], "-l",
                    case["lib"], "-k0", str(K), "-mc", str(MC), "-o", out,
                    "--device", "cpu"])
    assert rc == 0
    assert_same_files(case["jcfg"].out_dir, out)
    assert os.path.exists(os.path.join(out, "assembly.log"))


def test_cli_stage_by_stage_resumes_from_bin(case):
    """build_0, build_0_1, build_1_2 as three commands: each later stage
    starts from the .bin the one before left in the output directory."""
    out = os.path.join(case["dir"], "port_stages")
    common = ["-l", case["lib"], "-k0", str(K), "-mc", str(MC), "-o", out,
              "--device", "cpu"]
    assert tcli.main(["build_0", "-1", case["p1"], "-2", case["p2"]]
                     + common) == 0
    assert sorted(f for f in os.listdir(out) if f.startswith("graph")) \
        == sorted(FILES[:3])
    assert tcli.main(["build_0_1"] + common) == 0
    assert tcli.main(["build_1_2"] + common) == 0
    assert_same_files(case["jcfg"].out_dir, out)


def test_resume_from_jax_bin(case):
    """A level file written by the JAX package is a valid start for the
    port's next stage, and the other way round."""
    out = os.path.join(case["dir"], "port_resume")
    os.makedirs(out)
    shutil.copy(os.path.join(case["jcfg"].out_dir, FILES[0]), out)
    cfg = convert.config(case["jcfg"]).replace(out_dir=out)
    tpipe.build_0_1(cfg, device="cpu")
    assert_same_files(case["jcfg"].out_dir, out, FILES[3:6])
    back = os.path.join(case["dir"], "jax_resume")
    os.makedirs(back)
    shutil.copy(os.path.join(out, FILES[3]), back)
    jpipe.build_1_2(case["jcfg"].replace(out_dir=back))
    assert_same_files(case["jcfg"].out_dir, back, FILES[6:])


def test_spilled_count_same_level0(case, monkeypatch):
    """Budgets low enough for several disk runs: build_0 builds level 0
    on the host, and the level 0, 1, 2 files equal those of the JAX
    accelerator branch under the same budgets, whose count then returns
    host arrays and whose host build numbers nodes by first appearance
    with its committed C++ library."""
    lanes, host_mb = 50_000, 0.5
    out = os.path.join(case["dir"], "port_spill")
    cfg = convert.config(case["jcfg"]).replace(out_dir=out)
    cfg = cfg.replace(device=dataclasses.replace(
        cfg.device, sort_device_lanes=lanes, sort_host_mb=host_mb))
    tpipe.build_0(cfg, device="cpu")
    tpipe.build_0_1(cfg, device="cpu")
    tpipe.build_1_2(cfg)
    runs = [f for f in os.listdir(os.path.join(out, "spill"))
            if f.startswith("count_run") and f.endswith("_keys.npy")]
    assert len(runs) >= 2

    assert jbuild._NATIVE_GRAPH is not None
    jout = os.path.join(case["dir"], "jax_spill")
    monkeypatch.setenv("TA_SORT_DEVICE_LANES", str(lanes))
    monkeypatch.setenv("TA_SORT_HOST_MB", str(host_mb))
    monkeypatch.setenv("TA_SPILL_DIR", os.path.join(jout, "spill"))
    jc = case["jcfg"].replace(out_dir=jout)
    res = j_count_device(jpipe._genomic_batches(jc), K, min_count=MC,
                         out_cap_log2=17)
    assert len(res) == 2
    g = jbuild.build_graph_from_kedges(*res, K)
    jcheck(g, check_seq=False)
    jpipe.save_graph_info(g, jout, "level_0")
    jpipe.build_1_2(jc, jpipe.build_0_1(jc, g))
    assert len(os.listdir(os.path.join(jout, "spill"))) >= 2
    assert_same_files(jout, out)


def test_build_0_without_reads_exits():
    with pytest.raises(SystemExit):
        tpipe.build_0(tcfg.Config(), device="cpu")


def test_cli_cuda_without_gpu_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    out = os.path.join(case["dir"], "port_nogpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(["basic", "-1", case["p1"], "-k0", str(K), "-o", out])
    assert not os.path.exists(out)


def test_module_entry_point_runs_without_jax(case):
    """`python -m turingassembler_tpu_torch basic ... --device cpu` in a
    fresh interpreter: same nine files, and neither jax nor the JAX
    package was imported on the way."""
    out = os.path.join(case["dir"], "port_subprocess")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['turingassembler_tpu_torch', 'basic', '-1', {case['p1']!r},"
        f" '-2', {case['p2']!r}, '-l', {case['lib']!r}, '-k0', '{K}',"
        f" '-mc', '{MC}', '-o', {out!r}, '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('turingassembler_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'turingassembler_tpu'\n"
        "       or m.startswith('turingassembler_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=case["dir"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
    assert_same_files(case["jcfg"].out_dir, out)


# ---------------------------------------------------------------------------
# the linked-read stages: level 2 -> sorted archive -> extended contigs ->
# barcode aux info -> scaffolds
# ---------------------------------------------------------------------------

SEVEN = ["R1.sorted.fq", "R2.sorted.fq", "barcode.idx",
         f"graph_k_{K}_extend.fasta", f"graph_k_{K}_added_barcode.bin",
         "scaffolds.fasta", "local_assembly_scaffold_path.txt"]

# (seed, library type): an A-R-B-R-C genome of 21 kbp, R the same 1,500
# bases twice, so that level 2 keeps A, B, C and R apart
LINKED = {"ust": (60, "ust"), "10x": (61, "10x")}


def jax_linked_stages(cfg, level2_bin):
    """The JAX package's stages after level 2, one by one."""
    from turingassembler_tpu.barcode.builder import (construct_aux_info,
                                                     get_read_pair_counts)
    from turingassembler_tpu.barcode.sort_read import sort_reads
    from turingassembler_tpu.graph.from_contigs import graph_from_contigs
    from turingassembler_tpu.io import asmg as jasmg
    from turingassembler_tpu.io.fasta import read_fasta
    from turingassembler_tpu.kmer.coverage import \
        recount_coverage_from_batches
    from turingassembler_tpu.resolve.readpairs import \
        get_long_contigs_by_readpairs
    from turingassembler_tpu.scaffold.scaffolding import scaffolding
    g = jasmg.load_graph(level2_bin)
    rpath = sort_reads(cfg)
    rp_counts = get_read_pair_counts(cfg, g, rpath)
    ext = jpipe.graph_path(cfg.out_dir, cfg.k0, "extend", "fasta")
    get_long_contigs_by_readpairs(g, rp_counts, ext)
    g = graph_from_contigs([s for _, s in read_fasta(ext)], cfg.k0)
    g = recount_coverage_from_batches(g, jpipe._genomic_batches(cfg))
    jcheck(g, check_seq=False)
    g = construct_aux_info(cfg, g, rpath)
    jasmg.save_graph(g, jpipe.graph_path(cfg.out_dir, cfg.k0,
                                         "added_barcode"))
    scaffolding(cfg, g, cfg.out_dir)
    return rp_counts, g


@pytest.fixture(scope="module", params=list(LINKED))
def linked(request, tmp_path_factory):
    seed, lib = LINKED[request.param]
    d = str(tmp_path_factory.mktemp("linked_" + request.param))
    genome, files = tt.linked_read_library(
        21_000, seed, d, n_segments=3, repeat_len=1_500, coverage=60.0,
        molecule_len=5_000, pairs_per_molecule=8, lib=lib)
    out = os.path.join(d, "port_api")
    cfg = tcfg.Config(k0=K, out_dir=out, files_1=(files["R1"],),
                      files_2=(files["R2"],),
                      files_I=((files["I1"],) if lib == "ust" else ()),
                      lib_type=tcfg.LIB_TYPE_NAMES[lib])
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 min_kmer_count=MC))
    g, rpath, scaf_path = tpipe.assembly_to_scaffolds(cfg, device="cpu")
    jc = jcfg.Config(k0=K, out_dir=os.path.join(d, "jax"),
                     files_1=cfg.files_1, files_2=cfg.files_2,
                     files_I=cfg.files_I, lib_type=cfg.lib_type)
    rp_counts, jg = jax_linked_stages(
        jc, tpipe.graph_path(out, K, "level_2"))
    lib_args = ["-1", files["R1"], "-2", files["R2"], "-l", lib] + \
        (["-I", files["I1"]] if lib == "ust" else [])
    return dict(dir=d, lib=lib, cfg=cfg, jcfg=jc, g=g, rpath=rpath,
                scaf_path=scaf_path, j_rp=rp_counts, jg=jg,
                lib_args=lib_args, genome=genome)


def test_assembly_to_scaffolds_seven_files(linked):
    out = linked["cfg"].out_dir
    assert_same_files(linked["jcfg"].out_dir, out, SEVEN)
    g, jg = linked["g"], linked["jg"]
    assert list(g.candidates.items()) == list(jg.candidates.items())
    assert linked["rpath"].idx_path == os.path.join(out, "barcode.idx")
    assert linked["scaf_path"] == os.path.join(out, SEVEN[6])
    # no walk-over: the contigs were ordered by their barcodes
    lines = file_bytes(linked["scaf_path"]).split(b"\n")
    assert int(lines[0]) >= 1 and int(lines[1]) >= 2
    assert all(len(g.barcodes_scaf[e]) >= 75
               for e in np.flatnonzero(g.edge_len() >= 4_000))
    assert_same_files(out, out, FILES)            # levels 0-2 are there too


def test_read_pair_counts_of_the_pipeline_graph(linked):
    from turingassembler_tpu_torch.barcode.builder import \
        get_read_pair_counts
    g2 = tasmg.load_graph(tpipe.graph_path(linked["cfg"].out_dir, K,
                                           "level_2"))
    got = get_read_pair_counts(linked["cfg"], g2, linked["rpath"],
                               device="cpu")
    assert list(got.items()) == list(linked["j_rp"].items())
    assert len(got) >= 8


def test_without_extension_keeps_level_2_contigs(linked):
    out = os.path.join(linked["dir"], "port_noext")
    g, _, _ = tpipe.assembly_to_scaffolds(
        linked["cfg"].replace(out_dir=out), extend=False, device="cpu")
    assert not os.path.exists(os.path.join(out, SEVEN[3]))
    g2 = tasmg.load_graph(tpipe.graph_path(out, K, "level_2"))
    np.testing.assert_array_equal(g.seq_data, g2.seq_data)
    assert g.barcodes is not None and g2.barcodes is None
    assert_same_files(linked["cfg"].out_dir, out, SEVEN[:3])


def test_cli_linked_stages_one_by_one(linked, capsys):
    """sort_read, debug_current, build_barcode_coverage, scaffold as four
    commands from the port's own level-2 .bin: the same seven files."""
    out = os.path.join(linked["dir"], "port_cli_stages")
    os.makedirs(out)
    level2 = os.path.join(out, FILES[6])
    shutil.copy(os.path.join(linked["cfg"].out_dir, FILES[6]), level2)
    common = ["-k0", str(K), "-o", out, "--device", "cpu"]
    archive = ["-l", "sorted", "-1", os.path.join(out, SEVEN[0]), "-2",
               os.path.join(out, SEVEN[1]), "-I", os.path.join(out, SEVEN[2])]
    assert tcli.main(["sort_read"] + linked["lib_args"] + common) == 0
    assert tcli.main(["debug_current", "-i", level2] + archive + common) == 0
    assert capsys.readouterr().out.strip().endswith(SEVEN[3])
    assert_same_files(linked["jcfg"].out_dir, out, SEVEN[:4])
    # the contig graph of the extended sequences, as a .bin for -i
    from turingassembler_tpu_torch.graph.from_contigs import \
        graph_from_contigs
    from turingassembler_tpu_torch.io.fasta import read_fasta
    contigs = os.path.join(out, "contigs.bin")
    tasmg.save_graph(graph_from_contigs(
        [s for _, s in read_fasta(os.path.join(out, SEVEN[3]))], K), contigs)
    # build_barcode_coverage counts the library's reads and maps the
    # archive's: the raw files for the count go in a second call's place
    assert tcli.main(["build_coverage", "-i", contigs] + linked["lib_args"]
                     + common) == 0
    recount = os.path.join(out, f"graph_k_{K}_recount.bin")
    assert tcli.main(["build_barcode", "-i", recount] + archive
                     + common) == 0
    assert tcli.main(["scaffold", "-i", os.path.join(out, SEVEN[4])]
                     + common) == 0
    assert_same_files(linked["jcfg"].out_dir, out, SEVEN)
    twin = os.path.join(linked["dir"], "port_cli_twin")
    assert tcli.main(["build_scaffolding_1_2", "-i",
                      os.path.join(out, SEVEN[4]), "-k0", str(K), "-o", twin,
                      "--device", "cpu"]) == 0
    assert_same_files(out, twin, SEVEN[5:])


def test_cli_rp_count_and_side_commands(linked, capsys):
    """get_rp_count, count_bx, minimizers_hit, split_molecules,
    barcode_graph, reduce_reads against the JAX package's commands."""
    from turingassembler_tpu import cli as jcli
    out = os.path.join(linked["dir"], "port_cli_side")
    jout = os.path.join(linked["dir"], "jax_cli_side")
    src = linked["cfg"].out_dir
    level2 = os.path.join(src, FILES[6])
    archive = ["-l", "sorted", "-1", os.path.join(src, SEVEN[0]), "-2",
               os.path.join(src, SEVEN[1]), "-I", os.path.join(src, SEVEN[2])]
    runs = [(["get_rp_count", "-i", level2] + archive,
             ["readpair_counts.txt"]),
            (["minimizers_hit", "-i", level2] + archive,
             ["barcode_hits.csv"]),
            (["split_molecules", "-i", level2] + archive,
             ["molecules_by_barcode.txt"]),
            (["barcode_graph", "-i", level2] + archive, ["molecules.fasta"]),
            (["reduce_reads", "-f", os.path.join(src, SEVEN[3])]
             + linked["lib_args"], ["R1.reduced.0.fq", "R2.reduced.0.fq"])]
    if linked["lib"] != "10x":        # count_bx reads tags or index reads
        runs.append((["count_bx"] + linked["lib_args"],
                     ["barcode_frequencies.txt"]))
    for args, names in runs:
        assert tcli.main(args + ["-k0", str(K), "-o", out,
                                 "--device", "cpu"]) == 0
        assert jcli.main(args + ["-k0", str(K), "-o", jout]) == 0
        capsys.readouterr()
        assert_same_files(jout, out, names)
    assert file_bytes(os.path.join(out, "readpair_counts.txt")) == "".join(
        f"{a} {b} {c}\n" for (a, b), c in sorted(linked["j_rp"].items())
    ).encode()


def test_cli_barcode_coverage_in_one_command(linked):
    """build_barcode_coverage takes the reads to count from -1/-2, which
    for a sorted archive are the sorted files themselves."""
    out = os.path.join(linked["dir"], "port_cli_bc")
    jout = os.path.join(linked["dir"], "jax_cli_bc")
    src = linked["cfg"].out_dir
    from turingassembler_tpu import cli as jcli
    args = ["build_barcode_coverage", "-i", os.path.join(src, FILES[6]),
            "-l", "sorted", "-1", os.path.join(src, SEVEN[0]), "-2",
            os.path.join(src, SEVEN[1]), "-I", os.path.join(src, SEVEN[2]),
            "-k0", str(K)]
    assert tcli.main(args + ["-o", out, "--device", "cpu"]) == 0
    assert jcli.main(args + ["-o", jout]) == 0
    assert_same_files(jout, out, [SEVEN[4]])


def test_linked_entry_points_raise_without_gpu(linked):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    out = os.path.join(linked["dir"], "port_nogpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpipe.assembly_to_scaffolds(linked["cfg"].replace(out_dir=out))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(["sort_read"] + linked["lib_args"] + ["-o", out])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpipe.assembly3(linked["cfg"].replace(out_dir=out))
    assert not os.path.exists(out)


def test_linked_stages_run_without_jax(linked):
    """The whole path in a fresh interpreter, through the pipeline
    function: same seven files, and neither jax nor the JAX package was
    imported on the way."""
    out = os.path.join(linked["dir"], "port_subprocess")
    c = linked["cfg"]
    code = (
        "import dataclasses, sys\n"
        "from turingassembler_tpu_torch import config, pipeline\n"
        f"cfg = config.Config(k0={K}, out_dir={out!r}, files_1={c.files_1!r},"
        f" files_2={c.files_2!r}, files_I={c.files_I!r},"
        f" lib_type={c.lib_type!r})\n"
        "cfg = cfg.replace(device=dataclasses.replace(cfg.device,"
        f" min_kmer_count={MC}))\n"
        "pipeline.assembly_to_scaffolds(cfg, device='cpu')\n"
        "from turingassembler_tpu_torch import cli\n"
        "import turingassembler_tpu_torch.scaffold.molecules\n"
        "import turingassembler_tpu_torch.barcode.frequency\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'turingassembler_tpu'\n"
        "       or m.startswith('turingassembler_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=linked["dir"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
    assert_same_files(linked["jcfg"].out_dir, out, SEVEN)


# ---------------------------------------------------------------------------
# the workload generators of the port's testing.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_barcoded_pair_simulators_copy_same_arrays(fast):
    from turingassembler_tpu import testing as jt
    genome = tt.random_genome(30_000, seed=3)
    kw = dict(molecule_len=6_000, n_molecules=40, reads_per_molecule=9,
              read_len=100, insert=280, seed=5, error_rate=0.01)
    if fast:
        kw.update(collision_rate=0.2, chimera_rate=0.2)
        got = tt.sim_barcoded_pairs_fast(genome, **kw)
        want = jt.sim_barcoded_pairs_fast(genome, **kw)
    else:
        got = tt.sim_barcoded_pairs(genome, **kw)
        want = jt.sim_barcoded_pairs(genome, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[0].shape == (360, 100)


def test_apply_indel_errors_copies_same_arrays():
    from turingassembler_tpu import testing as jt
    reads, lengths = tt.sim_reads(tt.random_genome(5_000, seed=1), 3.0, 100,
                                  seed=2)
    got = tt.apply_indel_errors(reads, lengths, 0.01, 0.01, seed=3)
    want = jt.apply_indel_errors(reads, lengths, 0.01, 0.01, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] != 100).any()


def test_plant_single_indels():
    reads, _ = tt.sim_reads(tt.random_genome(20_000, seed=1), 6.0, 150, seed=2)
    out, lengths = tt.plant_single_indels(reads, 0.1, seed=3)
    hit = (out != reads).any(axis=1)
    assert 0.07 < hit.mean() < 0.13 and out.dtype == np.uint8
    assert set(np.unique(lengths)) == {149, 150}
    assert ((out[:, -1] == 255) == (lengths == 149)).all()
    for i in np.flatnonzero(hit)[:50]:
        p = int(np.flatnonzero(out[i] != reads[i])[0])
        assert 40 <= p < 150
        if lengths[i] == 149:                     # a base fell out
            np.testing.assert_array_equal(out[i, p:149], reads[i, p + 1:])
        else:                                     # a base came in
            np.testing.assert_array_equal(out[i, p + 1:], reads[i, p:149])
    same, l2 = tt.plant_single_indels(reads, 0.0, seed=3)
    np.testing.assert_array_equal(same, reads)
    assert (l2 == 150).all()


def test_molecule_pairs_cover_the_ends():
    """Read starts per base are even up to both ends of a linear genome,
    where sim_barcoded_pairs_fast thins out."""
    genome = tt.random_genome(60_000, seed=9)
    r1, r2, bcs = tt.sim_molecule_pairs(genome, 20_000, 3_000, 10, 100, 300,
                                        seed=1)
    assert r1.shape == r2.shape and r1.shape[1] == 100
    assert (np.diff(bcs) >= 0).all() and bcs[-1] == 2_999
    pos = {int(h): i for i, h in enumerate(tt.kmer_hashes(genome, 32))}
    starts = []
    for a, b in zip(r1, r2):
        for m in (a, b):
            at = pos.get(int(tt.kmer_hashes(m, 32)[0]))
            if at is not None:
                starts.append(at)
    hist = np.bincount(np.asarray(starts) // 10_000, minlength=6)[:6]
    assert hist.min() > 0.8 * hist.max()
    f1 = tt.sim_barcoded_pairs_fast(genome, 20_000, 3_000, 10, 100, 300,
                                    seed=1)[0]
    first = sum(int(tt.kmer_hashes(m, 32)[0]) in pos
                and pos[int(tt.kmer_hashes(m, 32)[0])] < 10_000 for m in f1)
    assert first < 0.5 * hist[0]


@pytest.mark.parametrize("lib", ["ust", "bioturing", "10x"])
def test_linked_read_library_files(lib, tmp_path):
    from turingassembler_tpu_torch.io.fastq import (decode_barcode_seq,
                                                    read_fastq_batches)
    genome, files = tt.linked_read_library(
        12_000, 4, str(tmp_path), n_segments=3, repeat_len=1_000,
        coverage=10.0, molecule_len=4_000, pairs_per_molecule=5, lib=lib)
    g2, starts, seg = tt.genome_with_exact_repeats(12_000, 3, 1_000, seed=4)
    np.testing.assert_array_equal(genome, g2)
    assert len(genome) == 3 * seg + 2_000 and list(starts) == [
        0, seg + 1_000, 2 * seg + 2_000]
    np.testing.assert_array_equal(genome[seg:seg + 1_000],
                                  genome[2 * seg + 1_000:2 * seg + 2_000])
    assert sorted(files) == (["I1", "R1", "R2"] if lib == "ust"
                             else ["R1", "R2"])
    b1 = next(read_fastq_batches(files["R1"], keep_text=True))
    b2 = next(read_fastq_batches(files["R2"], keep_text=True))
    n = len(b1.bases)
    assert n == len(b2.bases) and 250 <= n <= 400 and b1.names == b2.names
    extra = 23 if lib == "10x" else 0
    assert set(np.unique(b1.lengths)) <= {149 + extra, 150 + extra}
    assert all(len(q) == len(s) for q, s in zip(b1.quals, b1.raw_seqs))
    if lib == "ust":
        bi = next(read_fastq_batches(files["I1"], keep_text=True))
        bcs = [decode_barcode_seq(s) for s in bi.raw_seqs]
        assert all(len(s) == 18 for s in bi.raw_seqs)
    elif lib == "bioturing":
        assert b1.comments == b2.comments
        bcs = [decode_barcode_seq(c[5:]) for c in b1.comments]
    else:
        bcs = [decode_barcode_seq(s[:16]) for s in b1.raw_seqs]
    # 80 molecules, one barcode each, up to 5 pairs (fewer where the
    # genome's end cuts the molecule)
    assert len(set(bcs)) == 80 and min(bcs) == 1 and max(bcs) == 80
    assert bcs == sorted(bcs)
    per = np.bincount(bcs)[1:]
    assert per.max() == 5 and per.min() >= 1 and (per == 5).mean() > 0.4
    # a read pair lies on the genome, FR, `insert` apart: one mate's
    # first 30 bases at s, the reverse complement of the other's at
    # s + insert - 30 (reads with an error in those bases aside)
    pos = {int(h): i for i, h in enumerate(tt.kmer_hashes(genome, 30))}
    m1 = b1.bases[:, extra:extra + 30]
    m2 = b2.bases[:, :30]
    hits = 0
    for x, y in ((m1, m2), (m2, m1)):
        hx = [pos.get(int(tt.kmer_hashes(r, 30)[0])) for r in x]
        hy = [pos.get(int(tt.kmer_hashes((3 - r)[::-1], 30)[0])) for r in y]
        hits += sum(a is not None and b is not None and b - a == 270
                    for a, b in zip(hx, hy))
    assert hits >= 0.6 * n



def test_repeat_family_copies_same_arrays():
    from turingassembler_tpu import testing as jt
    seq = tt.random_genome(3_000, seed=1)
    np.testing.assert_array_equal(tt.mutate_identity(seq, 0.95, seed=2),
                                  jt.mutate_identity(seq, 0.95, seed=2))
    kw = dict(n_segments=3, segment_len=700, repeat_len=300, identity=0.9,
              seed=5)
    np.testing.assert_array_equal(tt.genome_with_repeat_family(**kw),
                                  jt.genome_with_repeat_family(**kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_second_haplotype_plants_bubbles_for_the_dp(seed):
    """Every cluster is a bubble of two branches at k = 45, the longer
    one about 100-150 bp: past the simple-bubble pass's 100 bp."""
    from turingassembler_tpu_torch.graph.build import build_graph_from_kedges
    from turingassembler_tpu_torch.kmer.megasort import count_kedges_megasort
    a = tt.random_genome(12_000, seed=seed)
    b, n = tt.second_haplotype(a, seed=seed + 1, cell=600)
    assert n == 20 and abs(len(b) - len(a)) < 60 * n
    b2, _ = tt.second_haplotype(a, seed=seed + 1, cell=600)
    np.testing.assert_array_equal(b, b2)
    reads = np.full((2, max(len(a), len(b))), 255, np.uint8)
    reads[0, :len(a)], reads[1, :len(b)] = a, b
    lengths = np.array([len(a), len(b)], np.int32)
    ke, c = count_kedges_megasort([(reads, lengths)], K, device="cpu")
    g = build_graph_from_kedges(ke, c, K)
    lens = g.edge_len()
    groups = {}
    for e in range(g.n_e):
        groups.setdefault((int(g.edge_source[e]), int(g.edge_target[e])),
                          []).append(int(lens[e]))
    bubbles = [v for v in groups.values() if len(v) == 2]
    assert len(bubbles) == 2 * n                     # both strands
    # an indel whose first bases repeat the bases after it sits a few
    # bases further on and leaves a branch that much shorter
    assert all(95 <= max(v) <= 150 for v in bubbles)
    assert sum(max(v) >= 100 for v in bubbles) >= 0.9 * len(bubbles)


def test_kmer_hashes():
    seq = tt.random_genome(500, seed=3)
    for k in (5, 32, 45, 46):
        h = tt.kmer_hashes(seq, k)
        assert h.shape == (500 - k + 1,) and h.dtype == np.uint64
        words = {seq[i:i + k].tobytes() for i in range(len(h))}
        assert len(np.unique(h)) == len(words)
        other = seq.copy()
        other[0] = (other[0] + 1) % 4         # only the first k-mer changes
        h2 = tt.kmer_hashes(other, k)
        assert h2[0] != h[0] and (h2[1:] == h[1:]).all()
    assert tt.kmer_hashes(seq[:10], 45).shape == (0,)


def test_diploid_reads_layout():
    a, b, n, reads, lengths = tt.diploid_reads(30_000, seed=7, coverage=2.0)
    assert len(a) == 30_000 and n == 15
    assert reads.shape[1] == 150 and (lengths == 150).all()
    assert len(reads) == -(-2 * len(a) // 150) + -(-2 * len(b) // 150)
