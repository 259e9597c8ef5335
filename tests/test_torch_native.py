"""The port's host C++ libraries (turingassembler_tpu_torch/native/*.cpp,
built by _build.build_host) against the JAX package's native libraries
and the port's plain Python/numpy versions: the FASTQ reader, the graph
kernels (ta_list_rank, ta_unique_ids), the level-0 build through them,
the read pack, tune_host_malloc, and an AddressSanitizer run of all four.

Inputs are made from numpy seeds and go into both packages as the same
files or arrays.  Tolerance: exact equality (bytes and integers).  The
one difference is pinned: the JAX loader drops the headers of a batch
past its fixed 256-bytes-a-record buffer; the port's reader does not.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_io_graph import (assert_graphs_equal, kedge_table,
                                 random_prev, write_odd_fastq)
from turingassembler_tpu.graph import build as jbuild
from turingassembler_tpu.io.native_loader import \
    read_fastq_batches_native as jax_reader
from turingassembler_tpu.kmer import count as jcount
from turingassembler_tpu_torch import _build
from turingassembler_tpu_torch import cli
from turingassembler_tpu_torch.graph import build as tbuild
from turingassembler_tpu_torch.io.fastq import read_fastq_batches_headers
from turingassembler_tpu_torch.io.native_loader import \
    read_fastq_batches_native as port_reader
from turingassembler_tpu_torch.kmer import count as tcount

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_fastq_text(path, records, tail=b""):
    """records: (header without '@', sequence) pairs; gzip on .gz."""
    data = b"".join(b"@%s\n%s\n+\n%s\n" % (h, s, b"I" * len(s))
                    for h, s in records) + tail
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fp:
        fp.write(data)


def mixed_records(seed, n=150):
    """Headers with and without a comment, reads of 1-299 bases with N,
    other bytes and lower case."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(1, 300))
        s = bytes(b"ACGTNacgtnRY"[c] for c in rng.integers(0, 12, ln))
        h = b"read%d" % i + (b" BX:Z:ACGT-%d QB:Z:IIII" % i if i % 3
                             else b"")
        out.append((h, s))
    return out


def batches_equal(got, want):
    assert len(got) == len(want)
    for (b, ln, h), (wb, wl, wh) in zip(got, want):
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(ln, wl)
        assert b.dtype == wb.dtype == np.uint8
        assert ln.dtype == wl.dtype == np.int32
        assert h == wh


# ---------------------------------------------------------------------------
# FASTQ reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", ["fq", "fq.gz"])
@pytest.mark.parametrize("batch_size,pad_to", [(64, 256), (32, 100),
                                               (150, 40), (7, 1)])
def test_reader_equals_jax_and_python(tmp_path, ext, batch_size, pad_to):
    path = str(tmp_path / f"mixed.{ext}")
    write_fastq_text(path, mixed_records(1))
    for with_headers in (True, False):
        got = list(port_reader(path, batch_size, pad_to, with_headers))
        batches_equal(got, list(jax_reader(path, batch_size, pad_to,
                                           with_headers)))
        batches_equal(got, list(read_fastq_batches_headers(
            path, batch_size, pad_to, with_headers)))
        assert len(got) == -(-150 // batch_size)
        assert (got[0][2] is None) != with_headers
    assert (np.concatenate([b[1] for b in got]) == pad_to).any()


@pytest.mark.parametrize("ext", ["fq", "fq.gz"])
def test_reader_on_odd_fastq(tmp_path, ext):
    """The reads of test_torch_io_graph's FASTQ cases (one longer than
    256, N, lower case, a comment), read in the pipeline's batches."""
    path = str(tmp_path / f"odd.{ext}")
    write_odd_fastq(path, seed=3)
    got = list(port_reader(path, 64, 256, True))
    batches_equal(got, list(jax_reader(path, 64, 256, True)))
    batches_equal(got, list(read_fastq_batches_headers(path, 64, 256, True)))
    assert got[0][1][7] == 256 and (got[0][0] == 4).any()


def test_reader_skips_blank_lines(tmp_path):
    """Blank lines before a header and at the end of the file are
    skipped, as the JAX loader skips them (the Python reader does not
    take them)."""
    recs = mixed_records(2, n=20)
    path = str(tmp_path / "blank.fq")
    body = b"".join(b"%s@%s\n%s\n+\n%s\n" % (b"\n" * (i % 3), h, s,
                                              b"I" * len(s))
                    for i, (h, s) in enumerate(recs))
    with open(path, "wb") as fp:
        fp.write(body + b"\n\n")
    got = list(port_reader(path, 8, 64, True))
    batches_equal(got, list(jax_reader(path, 8, 64, True)))
    clean = str(tmp_path / "clean.fq")
    write_fastq_text(clean, recs)
    batches_equal(got, list(read_fastq_batches_headers(clean, 8, 64, True)))


def test_reader_last_line_without_newline(tmp_path):
    path = str(tmp_path / "nonl.fq")
    with open(path, "wb") as fp:
        fp.write(b"@a\nACGT\n+\nIIII\n@b c\nGGN\n+\nIII")
    got = list(port_reader(path, 4, 8, True))
    batches_equal(got, list(jax_reader(path, 4, 8, True)))
    assert got[0][2] == [b"a", b"b c"]
    np.testing.assert_array_equal(got[0][1], [4, 3])


@pytest.mark.parametrize("text", [b"@a\nACGT\n+\nIIII\n@b\nACGT\n+\n",
                                  b"@a\nACGT\n+\nIIII\n@b\n",
                                  b"a\nACGT\n+\nIIII\n",
                                  b"@a\nACGT\n+\nIIII\nb\nAC\n+\nII\n"],
                         ids=["no_qual", "header_only", "no_at",
                              "second_no_at"])
def test_reader_malformed_raises(tmp_path, text):
    path = str(tmp_path / "bad.fq")
    with open(path, "wb") as fp:
        fp.write(text)
    for reader in (port_reader, jax_reader):
        with pytest.raises(ValueError, match="malformed"):
            list(reader(path, 8, 16))
    with pytest.raises(FileNotFoundError):
        list(port_reader(str(tmp_path / "absent.fq"), 8, 16))


def test_long_headers_arrive_whole(tmp_path):
    """The JAX loader's header buffer holds 256 bytes a record of the
    batch; once a batch's headers pass it, every later header of that
    batch comes back empty (so its barcode is lost).  The port's reader
    keeps them all."""
    path = str(tmp_path / "long.fq")
    write_fastq_text(path, [(b"r%d " % i + b"x" * 320, b"ACGTNacgt")
                            for i in range(8)])
    port = [h for _, _, hs in port_reader(path, 4, 16, True) for h in hs]
    jax = [h for _, _, hs in jax_reader(path, 4, 16, True) for h in hs]
    plain = [h for _, _, hs in read_fastq_batches_headers(path, 4, 16, True)
             for h in hs]
    assert [len(h) for h in port] == [323] * 8
    assert port == plain
    assert [len(h) for h in jax] == [323, 323, 323, 0] * 2
    assert jax[3] == b"" and port[3] == b"r3 " + b"x" * 320


# ---------------------------------------------------------------------------
# graph kernels
# ---------------------------------------------------------------------------

def pure_cycles(seed, n=500):
    """prev pointers made only of pure cycles (no head)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    prev = np.empty(n, np.int64)
    i = 0
    while i < n:
        c = perm[i:i + int(rng.integers(1, 40))]
        prev[c] = np.roll(c, 1)
        i += len(c)
    return prev


@pytest.mark.parametrize("case", ["chains0", "chains1", "chains2", "cycles",
                                  "one_cycle", "empty", "single"])
def test_list_rank(case, monkeypatch):
    prev = {"chains0": lambda: random_prev(0),
            "chains1": lambda: random_prev(1),
            "chains2": lambda: random_prev(2, n=20_000),
            "cycles": lambda: pure_cycles(3),
            "one_cycle": lambda: np.roll(np.arange(1000), 1),
            "empty": lambda: np.zeros(0, np.int64),
            "single": lambda: np.array([-1])}[case]()
    head, dist = tbuild._pointer_double_to_head(prev)
    assert head.dtype == dist.dtype == np.int32
    want = [tbuild._pointer_double_to_head_np(prev)]
    assert jbuild._NATIVE_GRAPH is not None
    want.append(jbuild._pointer_double_to_head(prev))
    monkeypatch.setattr(jbuild, "_NATIVE_GRAPH", None)
    want.append(jbuild._pointer_double_to_head(prev))
    for wh, wd in want:
        np.testing.assert_array_equal(head, wh)
        np.testing.assert_array_equal(dist, wd)


def jax_unique_ids(keys):
    """The JAX package's numbering, through its committed library with
    the capacity its build passes."""
    import ctypes
    n = len(keys)
    ids = np.empty(n, np.int32)
    cap = 1 << max(int(np.ceil(np.log2(max(2 * n, 2)))), 4)
    m = jbuild._NATIVE_GRAPH.ta_unique_ids(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(n), ctypes.c_int64(cap),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return ids.astype(np.int64), int(m)


@pytest.mark.parametrize("n,distinct", [(0, 1), (1, 1), (7, 3),
                                        (5_000, 900), (40_000, 2**62)])
def test_unique_ids(n, distinct):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, distinct, n, dtype=np.uint64)
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    if n >= 7:      # the all-ones key stands for all-ones minus one
        keys[[1, 4]] = top
        keys[5] = top - np.uint64(1)
    ids, m = tbuild._first_seen_ids(keys)
    assert ids.dtype == np.int64
    for wi, wm in (tbuild._first_seen_ids_np(keys), jax_unique_ids(keys)):
        np.testing.assert_array_equal(ids, wi)
        assert m == wm
    if n >= 7:
        assert ids[1] == ids[4] == ids[5]
    if n:
        assert ids[0] == 0 and ids.max() == m - 1


@pytest.mark.parametrize("seed,circular", [(20, False), (21, False),
                                           (22, True)])
def test_first_seen_build_through_twins(seed, circular, monkeypatch):
    """build_graph_from_kedges(first_seen=True) through the twins equals
    the JAX function with its library, and the port's build with the
    numpy versions, array for array."""
    ke, c = kedge_table(seed, circular=circular,
                        error_rate=0.0 if circular else 0.01)
    gt = tbuild.build_graph_from_kedges(ke, c, 31, first_seen=True)
    assert gt.n_e >= (2 if circular else 20)
    assert_graphs_equal(gt, jbuild.build_graph_from_kedges(ke, c, 31))
    monkeypatch.setattr(tbuild, "_pointer_double_to_head",
                        tbuild._pointer_double_to_head_np)
    monkeypatch.setattr(tbuild, "_first_seen_ids", tbuild._first_seen_ids_np)
    assert_graphs_equal(gt, tbuild.build_graph_from_kedges(
        ke, c, 31, first_seen=True))


# ---------------------------------------------------------------------------
# read pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 7, 8, 150, 152])
def test_pack_equals_jax(L):
    rng = np.random.default_rng(L)
    bases = rng.integers(0, 6, (37, L)).astype(np.uint8)
    bases[0] = 255
    bases[1, : L // 2] = 4
    packed, nmask = tcount.host_pack_reads(bases)
    jp, jm = jcount.host_pack_reads(bases)
    for got, want in ((packed, jp), (nmask, jm),
                      *zip(tcount.host_pack_reads_np(bases), (jp, jm))):
        assert got.dtype == np.uint8 and got.shape == np.asarray(want).shape
        np.testing.assert_array_equal(got, np.asarray(want))
    assert packed.shape == (37, (L + 3) // 4) and nmask.shape == (37, (L + 7)
                                                                 // 8)
    codes = tcount.device_unpack_reads(torch.from_numpy(packed),
                                       torch.from_numpy(nmask), L)
    assert codes.dtype == torch.uint8 and codes.shape == (37, L)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jcount.device_unpack_reads(jp, jm, L)))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.where(bases < 4, bases, 255))


def test_pack_empty_and_strided():
    for shape in ((0, 150), (5, 0)):
        p, m = tcount.host_pack_reads(np.zeros(shape, np.uint8))
        assert p.shape == (shape[0], (shape[1] + 3) // 4)
        assert m.shape == (shape[0], (shape[1] + 7) // 8)
    wide = np.random.default_rng(0).integers(0, 5, (9, 40)).astype(np.uint8)
    for got, want in zip(tcount.host_pack_reads(wide[:, ::2]),
                         tcount.host_pack_reads_np(wide[:, ::2])):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# tune_host_malloc
# ---------------------------------------------------------------------------

def test_tune_host_malloc_in_a_subprocess():
    code = ("from turingassembler_tpu_torch.ops.hostmem import "
            "tune_host_malloc\n"
            "import numpy as np\n"
            "print(tune_host_malloc(), tune_host_malloc())\n"
            "a = np.ones(1 << 24); print(int(a.sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", str(1 << 24)]


class Tuned(Exception):
    pass


def test_cli_main_tunes_malloc_first(monkeypatch):
    def tune():
        raise Tuned      # stop before anything else runs
    monkeypatch.setattr(cli, "tune_host_malloc", tune)
    with pytest.raises(Tuned):
        cli.main(["basic", "-1", "absent.fq", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def test_host_build_raises_with_the_command(tmp_path, monkeypatch):
    """A source that does not compile, or no compiler, raises with what
    was run; nothing falls back."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "graph_kernels.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="host build failed") as err:
        _build.build_host(["graph_kernels"])
    assert "graph_kernels.cpp" in str(err.value) and "-O3" in str(err.value)
    assert not list((tmp_path / "out").iterdir())
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        _build.build_host(["graph_kernels"])


def test_host_library_named_by_its_source(tmp_path, monkeypatch):
    """An edited source gets a library of its own name; an unchanged one
    is reused.  The unchanged source is the test run's own library, built
    once at first use, so only the edited copy is compiled here."""
    first = _build.build_host(["graph_kernels"])["graph_kernels"]
    assert first.exists() and first.parent == _build.HOST_BUILD_DIR
    built_at = first.stat().st_mtime_ns
    assert _build.build_host(["graph_kernels"])["graph_kernels"] == first
    assert first.stat().st_mtime_ns == built_at
    src = tmp_path / "native"
    src.mkdir()
    for name in ("graph_kernels.cpp", "zlib_decl.h"):
        (src / name).write_bytes((_build.NATIVE / name).read_bytes())
    monkeypatch.setattr(_build, "NATIVE", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "out")
    unedited = _build.host_lib_path("graph_kernels")
    with open(src / "graph_kernels.cpp", "a") as fp:
        fp.write("// edited\n")
    second = _build.build_host(["graph_kernels"])["graph_kernels"]
    assert second != unedited and second.exists()
    assert second.parent == tmp_path / "out" and not unedited.exists()
    assert _build.host_lib_path("graph_kernels", asan=True).parent \
        == _build.ASAN_BUILD_DIR


# ---------------------------------------------------------------------------
# AddressSanitizer run of the four libraries
# ---------------------------------------------------------------------------

_ASAN_WORKER = r"""
import ctypes, os, sys
import numpy as np
from turingassembler_tpu_torch import _build
libs = {}
def load_asan(name):
    if name not in libs:
        libs[name] = ctypes.CDLL(str(_build.host_lib_path(name, asan=True)))
    return libs[name]
_build.load_host = load_asan
from turingassembler_tpu_torch import config
from turingassembler_tpu_torch.barcode import sort_read
from turingassembler_tpu_torch.graph import build
from turingassembler_tpu_torch.io.native_loader import \
    read_fastq_batches_native
from turingassembler_tpu_torch.kmer import count

d = sys.argv[1]
for name in ("long.fq", "R1.fq", "R1.fq.gz"):
    n = 0
    for bases, lengths, hdrs in read_fastq_batches_native(
            os.path.join(d, name), 64, 100, with_headers=True):
        n += len(bases)
        assert len(hdrs) == len(bases)
    assert n > 64, (name, n)
os.environ["TA_SORT_MEM_BYTES"] = str(1 << 14)
sort_read.SORT_CHUNK_RECORDS = 64
cfg = config.Config(out_dir=os.path.join(d, "o"),
                    files_1=(os.path.join(d, "R1.fq"),),
                    files_2=(os.path.join(d, "R2.fq"),),
                    files_I=(os.path.join(d, "I1.fq"),),
                    lib_type=config.LIB_TYPE_UST)
os.makedirs(cfg.out_dir)
rp = sort_read._sort_reads_native(cfg, cfg.out_dir)
# the arenas' bytes are the two sorted files' bytes: four runs at least
assert os.path.getsize(rp.R1_path) + os.path.getsize(rp.R2_path) \
    > 4 * (1 << 14)
head, dist = build._pointer_double_to_head(
    np.array([-1, 0, 1, 4, 5, 3], np.int64))
assert head.tolist() == [0, 0, 0, 3, 3, 3], head
assert dist.tolist() == [0, 1, 2, 0, 2, 1], dist
keys = np.array([7, 9, 7, 2**64 - 1, 9, 7], np.uint64)
ids, m = build._first_seen_ids(keys)
assert m == 3 and ids.tolist() == [0, 1, 0, 2, 1, 0]
p, msk = count.host_pack_reads(
    np.random.default_rng(0).integers(0, 6, (33, 101)).astype(np.uint8))
print("asan smoke ok")
"""


def _libasan():
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=30).stdout
    except OSError:          # no ldconfig: libasan cannot be found
        return None
    for line in out.splitlines():
        if "libasan.so" in line and "=>" in line:
            return line.split("=>")[1].strip()
    return None


def test_asan_smoke(tmp_path):
    libasan = _libasan()
    if libasan is None:
        pytest.skip("libasan is not installed")
    _build.build_host(asan=True)
    d = tmp_path
    recs = mixed_records(4, n=300)
    write_fastq_text(d / "R1.fq", recs)
    write_fastq_text(d / "R1.fq.gz", recs)
    write_fastq_text(d / "R2.fq", mixed_records(5, n=300))
    write_fastq_text(d / "I1.fq", [(b"i%d" % i, b"ACGTACGTAC"[: i % 7 + 3])
                                   for i in range(300)])
    write_fastq_text(d / "long.fq", [(b"r%d " % i + b"x" * (i * 7), b"ACGT")
                                     for i in range(130)])
    worker = d / "worker.py"
    worker.write_text(_ASAN_WORKER)
    env = {**os.environ, "PYTHONPATH": REPO, "LD_PRELOAD": libasan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1"}
    p = subprocess.run([sys.executable, str(worker), str(d)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"ASan run failed:\n{p.stdout}\n{p.stderr}"
    assert "asan smoke ok" in p.stdout
