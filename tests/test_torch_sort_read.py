"""The port's barcode sorter (barcode/sort_read.py: its C++ sorter
native/sort_read.cpp, and the Python loop under TA_SORT_NATIVE=0) and its
FASTQ additions against the JAX package: the same library files go
through both, and R1.sorted.fq, R2.sorted.fq and barcode.idx are
compared byte for byte, with the JAX package's Python loop and with its
C++ sorter, from plain and gzipped files, and with a sort budget small
enough to spill several runs.  Tolerance: exact equality.
"""

import gzip
import os
import shutil
import struct

import numpy as np
import pytest

from turingassembler_tpu import config as jcfg
from turingassembler_tpu.barcode import sort_read as jsort
from turingassembler_tpu.io import fastq as jfq
from turingassembler_tpu.io.native_loader import read_fastq_batches_native
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.barcode import sort_read as tsort
from turingassembler_tpu_torch.io import fastq as tfq

ARCHIVE = ("R1.sorted.fq", "R2.sorted.fq", "barcode.idx")
LIBS = {"ust": 5, "bioturing": 6, "10x": 7}


def file_bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def strip_some_barcodes(files, lib):
    """Take the barcode off a few pairs, so that the no-barcode group
    (BX_NONE, sorted last, written without a tag) is exercised."""
    if lib == "bioturing":
        for key in ("R1", "R2"):
            lines = file_bytes(files[key]).split(b"\n")
            for i in range(0, 40, 8):
                lines[4 * i] = lines[4 * i].split(b" ")[0]
            with open(files[key], "wb") as fp:
                fp.write(b"\n".join(lines))
    elif lib == "10x":
        lines = file_bytes(files["R1"]).split(b"\n")
        for i in range(0, 40, 8):          # shorter than barcode + UMI
            lines[4 * i + 1] = lines[4 * i + 1][:20]
            lines[4 * i + 3] = lines[4 * i + 3][:20]
        with open(files["R1"], "wb") as fp:
            fp.write(b"\n".join(lines))


@pytest.fixture(scope="module", params=list(LIBS))
def library(request, tmp_path_factory):
    lib = request.param
    d = str(tmp_path_factory.mktemp(lib))
    _, files = tt.linked_read_library(
        9_000, LIBS[lib], d, n_segments=2, repeat_len=500, coverage=10.0,
        molecule_len=3_000, pairs_per_molecule=6, lib=lib)
    strip_some_barcodes(files, lib)
    kw = dict(files_1=(files["R1"],), files_2=(files["R2"],),
              files_I=((files["I1"],) if lib == "ust" else ()),
              lib_type=jcfg.LIB_TYPE_NAMES[lib])
    port = tcfg.Config(out_dir=os.path.join(d, "port"), **kw)
    rpath = tsort.sort_reads(port)
    return dict(dir=d, lib=lib, kw=kw, rpath=rpath, files=files)


@pytest.mark.parametrize("native", ["0", "1"], ids=["python_loop", "cpp"])
def test_archive_equals_jax(library, native, monkeypatch):
    if native == "1" and jsort._NATIVE_SORT is None:
        pytest.skip("the JAX package's libtasort.so does not load")
    monkeypatch.setenv("TA_SORT_NATIVE", native)
    out = os.path.join(library["dir"], "jax" + native)
    jr = jsort.sort_reads(jcfg.Config(out_dir=out, **library["kw"]))
    got = convert.read_path(jr)
    assert isinstance(got, tsort.ReadPath)
    for name in ARCHIVE:
        want = file_bytes(os.path.join(out, name))
        assert len(want) > 0
        assert file_bytes(os.path.join(library["dir"], "port", name)) \
            == want, name


def archive_bytes(d):
    return [file_bytes(os.path.join(d, name)) for name in ARCHIVE]


def test_port_loop_equals_twin(library, monkeypatch):
    """The fixture's archive came from the C++ sorter; the Python loop
    writes the same bytes."""
    monkeypatch.setenv("TA_SORT_NATIVE", "0")
    out = os.path.join(library["dir"], "port_loop")
    cfg = tcfg.Config(out_dir=out, **library["kw"])
    assert tsort.sort_reads(cfg) == tsort.ReadPath(
        *(os.path.join(out, name) for name in ARCHIVE))
    assert archive_bytes(out) == archive_bytes(
        os.path.join(library["dir"], "port"))


def test_gzipped_inputs(library, tmp_path, monkeypatch):
    kw = dict(library["kw"])
    for key in ("files_1", "files_2", "files_I"):
        gz = []
        for path in kw[key]:
            gz.append(str(tmp_path / (os.path.basename(path) + ".gz")))
            with open(path, "rb") as src, gzip.open(gz[-1], "wb") as dst:
                shutil.copyfileobj(src, dst)
        kw[key] = tuple(gz)
    want = archive_bytes(os.path.join(library["dir"], "port"))
    tsort.sort_reads(tcfg.Config(out_dir=str(tmp_path / "port"), **kw))
    assert archive_bytes(str(tmp_path / "port")) == want
    for native in ("0", "1"):
        monkeypatch.setenv("TA_SORT_NATIVE", native)
        out = str(tmp_path / ("jax" + native))
        jsort.sort_reads(jcfg.Config(out_dir=out, **kw))
        assert archive_bytes(out) == want


def test_spilled_runs_merge_to_the_same_archive(library, tmp_path,
                                               monkeypatch):
    """A budget of a fifth of the formatted records' bytes (the two
    sorted files) spills at least four sorted runs before the k-way
    merge; the archive is byte-identical, and so is the JAX C++ sorter's
    under the same budget.  The runs are removed."""
    want = archive_bytes(os.path.join(library["dir"], "port"))
    budget = (len(want[0]) + len(want[1])) // 5
    monkeypatch.setenv("TA_SORT_MEM_BYTES", str(budget))
    out = str(tmp_path / "port")
    tsort.sort_reads(tcfg.Config(out_dir=out, **library["kw"]))
    assert archive_bytes(out) == want
    assert sorted(os.listdir(out)) == sorted(ARCHIVE)
    if jsort._NATIVE_SORT is not None:
        jout = str(tmp_path / "jax")
        jsort.sort_reads(jcfg.Config(out_dir=jout, **library["kw"]))
        assert archive_bytes(jout) == want


@pytest.mark.parametrize("chunk", [1, 7, 10])
def test_parse_chunks(library, tmp_path, monkeypatch, chunk):
    """Parsed a few records of each file at a time, spilled or not, the
    archive is the same; a pair file cut short at a chunk's end is
    still a count mismatch."""
    monkeypatch.setattr(tsort, "SORT_CHUNK_RECORDS", chunk)
    want = archive_bytes(os.path.join(library["dir"], "port"))
    for budget in ("0", str((len(want[0]) + len(want[1])) // 5)):
        monkeypatch.setenv("TA_SORT_MEM_BYTES", budget)
        out = str(tmp_path / ("o" + budget))
        tsort.sort_reads(tcfg.Config(out_dir=out, **library["kw"]))
        assert archive_bytes(out) == want
    short = str(tmp_path / "R2.short.fq")
    with open(short, "wb") as fp:
        fp.write(b"\n".join(file_bytes(library["files"]["R2"])
                            .split(b"\n")[:4 * 70]) + b"\n")
    kw = dict(library["kw"], files_2=(short,))
    with pytest.raises(ValueError, match="different read counts"):
        tsort.sort_reads(tcfg.Config(out_dir=str(tmp_path / "s"), **kw))
    assert not [f for f in os.listdir(tmp_path / "s") if ".run" in f]


def test_sorter_failures_raise(library, tmp_path):
    """Every failure of the C++ sorter raises; nothing falls back to the
    Python loop."""
    kw = library["kw"]
    out = str(tmp_path / "o")
    bad = str(tmp_path / "bad.fq")
    with open(bad, "wb") as fp:
        fp.write(file_bytes(kw["files_1"][0])[:-200].replace(b"@", b"#", 1))
    for change, exc, match in (
            (dict(files_1=(str(tmp_path / "absent.fq"),)),
             FileNotFoundError, "does not open"),
            (dict(files_1=(bad,)), ValueError, "malformed"),
            (dict(lib_type=99), ValueError, "unknown lib type")):
        with pytest.raises(exc, match=match):
            tsort.sort_reads(tcfg.Config(out_dir=out, **dict(kw, **change)))
    os.makedirs(os.path.join(out, ARCHIVE[0]))   # a directory in the way
    with pytest.raises(OSError, match="cannot be written"):
        tsort.sort_reads(tcfg.Config(out_dir=out, **kw))


def test_index_fetch_and_verify(library):
    rp = library["rpath"]
    jr = jsort.ReadPath(rp.R1_path, rp.R2_path, rp.idx_path)
    index = tsort.load_barcode_index(rp.idx_path)
    assert index == jsort.load_barcode_index(rp.idx_path)
    assert len(index) > 20
    assert (tsort.BX_NONE in index) == (library["lib"] != "ust")
    some = sorted(index)[::7]
    blobs = tsort.fetch_reads_by_barcodes(rp, index, some + [12345678901])
    assert blobs == jsort.fetch_reads_by_barcodes(jr, index, some)
    assert tsort.parse_fastq_blob(blobs[0]) == jsort.parse_fastq_blob(blobs[0])
    names, seqs, quals, comments = tsort.parse_fastq_blob(blobs[1])
    assert len(names) == len(seqs) == len(quals) == len(comments) > 0
    n = tsort.verify_read_archive(rp)
    assert n == len(index) == jsort.verify_read_archive(jr)
    assert tsort.verify_read_archive(rp, max_barcodes=8) == 8


def test_verify_raises_on_corrupted_span(library, tmp_path):
    rp = library["rpath"]
    raw = file_bytes(rp.idx_path)
    recs = [list(struct.unpack("<QQQQQ", raw[i:i + 40]))
            for i in range(0, len(raw), 40)]

    def archive(mutate):
        rows = [list(r) for r in recs]
        mutate(rows)
        p = str(tmp_path / ("idx%d" % len(os.listdir(tmp_path))))
        with open(p, "wb") as fp:
            for r in rows:
                fp.write(struct.pack("<QQQQQ", *r))
        return tsort.ReadPath(rp.R1_path, rp.R2_path, p)

    def shift(rows):               # a span that starts inside a record
        rows[3][1] += 7

    def swap(rows):                # a span that holds another barcode
        rows[2][1:], rows[5][1:] = rows[5][1:], rows[2][1:]

    def past_end(rows):            # a span that runs past the file
        rows[-1][3] += 1000

    for mutate in (shift, swap, past_end):
        with pytest.raises(ValueError):
            tsort.verify_read_archive(archive(mutate))
    with pytest.raises(ValueError, match="missing"):
        tsort.verify_read_archive(rp, barcodes=[987654321987])


def test_sorted_library_is_taken_as_it_is(library):
    rp = library["rpath"]
    cfg = tcfg.Config(out_dir=os.path.join(library["dir"], "again"),
                      files_1=(rp.R1_path,), files_2=(rp.R2_path,),
                      files_I=(rp.idx_path,), lib_type=tcfg.LIB_TYPE_SORTED)
    assert tsort.sort_reads(cfg) == rp
    assert tsort.ReadPath.from_sorted(cfg.replace(files_I=())).idx_path \
        == os.path.join(cfg.out_dir, "barcode.idx")


def test_unequal_pair_files_raise(library, tmp_path):
    short = str(tmp_path / "R2.short.fq")
    with open(short, "wb") as fp:
        fp.write(b"\n".join(file_bytes(library["files"]["R2"])
                            .split(b"\n")[:40]) + b"\n")
    kw = dict(library["kw"], files_2=(short,))
    with pytest.raises(ValueError, match="different read counts"):
        tsort.sort_reads(tcfg.Config(out_dir=str(tmp_path / "o"), **kw))


# ---------------------------------------------------------------------------
# io/fastq.py additions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [b"", b"A", b"ACGTN", b"TTTTGGGGCCCCAAAANN",
                                 b"N" * 30, b"acgtxACGT"])
def test_barcode_codec(seq):
    bc = tfq.decode_barcode_seq(seq)
    assert bc == jfq.decode_barcode_seq(seq) == tsort._decode_bc_bytes(seq)
    for n in (16, 18):
        assert tfq.encode_barcode(bc, n) == jfq.encode_barcode(bc, n)
    if seq.isupper() and len(seq) <= 18:
        assert tfq.encode_barcode(bc, len(seq)) == seq


def test_header_batches_equal_native_loader(library):
    """(bases, lengths, headers) batch by batch, as the JAX package's
    loader gives them, with a batch size that leaves a tail batch."""
    path = library["rpath"].R1_path
    for with_headers in (True, False):
        got = list(tfq.read_fastq_batches_headers(path, 64, 256, with_headers))
        want = list(read_fastq_batches_native(path, 64, 256, with_headers))
        assert len(got) == len(want) > 1
        assert len(got[-1][0]) != 64
        for (b, l, h), (jb, jl, jh) in zip(got, want):
            np.testing.assert_array_equal(b, jb)
            np.testing.assert_array_equal(l, jl)
            assert b.dtype == jb.dtype and l.dtype == jl.dtype
            assert h == jh
    assert got[0][2] is None


def test_pair_batches_equal_jax(library):
    f = library["files"]
    fi = f.get("I1")
    got = list(tfq.read_fastq_pair_batches(f["R1"], f["R2"], 100,
                                           keep_text=True, path_index=fi))
    want = list(jfq.read_fastq_pair_batches(f["R1"], f["R2"], 100,
                                            keep_text=True, path_index=fi))
    assert len(got) == len(want) > 1
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g.bases, w.bases)
                np.testing.assert_array_equal(g.lengths, w.lengths)
                assert (g.names, g.comments, g.quals, g.raw_seqs) == \
                    (w.names, w.comments, w.quals, w.raw_seqs)
