"""The port's staged pipeline (FASTQ files -> level 0, 1, 2 graph files)
against the JAX package, through `assembly_basic`, the CLI function and
`python -m turingassembler_tpu_torch`.

The reference run is the JAX package's accelerator branch of build_0,
made on the CPU by this file: count_kedges_megasort_device over
pipeline._genomic_batches -> device_build.build_graph_on_device ->
save_graph_info, then build_0_1 and build_1_2 on that graph.  (The JAX
build_0 itself builds on the host on a CPU backend, which numbers
nodes otherwise.)  Tolerance: the nine files byte for byte.
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


def test_spilled_count_same_level0(case):
    """Budgets low enough for several disk runs: build_0 builds level 0
    on the host, and its files equal the in-memory run's (the port's
    host and device builds number nodes alike)."""
    out = os.path.join(case["dir"], "port_spill")
    cfg = convert.config(case["jcfg"]).replace(out_dir=out)
    cfg = cfg.replace(device=dataclasses.replace(
        cfg.device, sort_device_lanes=50_000, sort_host_mb=0.5))
    tpipe.build_0(cfg, device="cpu")
    runs = [f for f in os.listdir(os.path.join(out, "spill"))
            if f.startswith("count_run") and f.endswith("_keys.npy")]
    assert len(runs) >= 2
    assert_same_files(case["jcfg"].out_dir, out, FILES[:3])


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
# the workload generators of the port's testing.py
# ---------------------------------------------------------------------------

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
