"""Build the port's CUDA kernels and host C++ libraries at first use.

Each `csrc/<name>.cu` is compiled by nvcc, for sm_90a, into its own
shared library with a plain C interface, loaded with ctypes.  Libraries
go to `build/kernels/` at the repository root, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one
is reused.  Several sources build in parallel, one nvcc each.  Nothing
here runs on import, and the CPU path never looks for nvcc.

Kernels binds one library's C entries, declared once from a table, and
launches them on a device's current stream; LaunchCount is the tally
every wrapper keeps of its launches.

Each `native/<name>.cpp` (the FASTQ reader, the barcode sorter, the graph
kernels, the read pack) is compiled the same way by the host C++
compiler (`c++`, else `g++`) into `build/native/`, on the CPU as well:
`build_host`, `load_host`.  zlib is linked as libz.so.1.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

from . import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

NATIVE = Path(__file__).resolve().parent / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
ASAN_BUILD_DIR = BUILD_DIR.parent / "native-asan"
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
ASAN_FLAGS = ["-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer",
              "-std=c++17", "-fPIC", "-shared"]
# per source: (compile flags, link flags) beyond HOST_FLAGS / ASAN_FLAGS
HOST_EXTRA = {"fastq_reader": ([], ["-l:libz.so.1"]),
              "sort_read": (["-pthread"], ["-l:libz.so.1"]),
              "graph_kernels": ([], []),
              "pack_kernels": ([], [])}

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()   # one build at a time, whichever thread asks


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile every listed source (default: all of csrc/*.cu) that has
    no library for its current hash.  Returns {name: nvcc's output}
    (ptxas register and shared-memory report) for the sources built."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


# a pointer, or the stream, as c_void_p: an undeclared int argument is
# passed as a 32-bit C int and cuts a device pointer
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class Kernels:
    """The C entries of csrc/<name>.cu.

    entries: each launch entry's argument ctypes, the stream left out
    (launch appends it); each returns a CUDA error code.  queries: each
    host function's (argument ctypes, result ctype), the sizes and
    built constants the wrapper asks for.  Both are declared on a
    library once, when it is first loaded (or when `load` hands over
    another one)."""

    def __init__(self, name: str, entries: Dict[str, Sequence],
                 queries: Dict[str, Tuple[Sequence, type]] | None = None):
        self.name = name
        self.entries = entries
        self.queries = queries or {}
        self._bound = (None, {})     # (library, its declared functions)

    def _fns(self) -> dict:
        lib = load(self.name)
        bound_lib, fns = self._bound
        if lib is not bound_lib:
            fns = {}
            for entry, args in self.entries.items():
                fn = fns[entry] = getattr(lib, entry)
                fn.argtypes, fn.restype = [*args, P], I
            for entry, (args, res) in self.queries.items():
                fn = fns[entry] = getattr(lib, entry)
                fn.argtypes, fn.restype = list(args), res
            self._bound = (lib, fns)
        return fns

    def launch(self, entry: str, dev: torch.device, *args) -> None:
        """Call a launch entry on dev's current stream; raise on a CUDA
        error."""
        fn = self._fns()[entry]
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc}")

    def query(self, entry: str, *args):
        """A host function's value."""
        return self._fns()[entry](*args)


class LaunchCount:
    """A wrapper's launches (the CUDA path only): `launches`, `by_entry`,
    each launch's shape as (entry, *shape) in `shapes`, and each entry's
    named counts in `counts[entry]`, declared by `entries` (entry -> the
    names of its counts).  Safe to add to from several threads: the
    bridge launches NW and the map from worker threads."""

    def __init__(self, entries: Dict[str, Sequence[str]]):
        self._names = {e: tuple(n) for e, n in entries.items()}
        self.lock = threading.Lock()
        self.reset()

    @property
    def launches(self) -> int:
        return sum(self.by_entry.values())

    def reset(self) -> None:
        with self.lock:
            self.by_entry = dict.fromkeys(self._names, 0)
            self.shapes = []
            self.counts = {e: dict.fromkeys(n, 0)
                           for e, n in self._names.items()}

    def add(self, entry: str, *shape, **counts: int) -> None:
        """One launch of entry, its shape, and sums of entry's counts
        (pairs, lanes) that stay here."""
        with self.lock:
            self.by_entry[entry] += 1
            self.shapes.append((entry, *shape))
            self._add(entry, counts)

    def route(self, entry: str, **counts: int) -> None:
        """The route a call of entry took: adds to entry's counts and,
        under the same names, to the innermost open span."""
        with self.lock:
            self._add(entry, counts)
        tracing.add(**counts)

    def _add(self, entry: str, counts: dict) -> None:
        mine = self.counts[entry]
        for name, n in counts.items():
            mine[name] += n

    def total(self, name: str) -> int:
        """A count summed over the entries that keep it."""
        with self.lock:
            return sum(c.get(name, 0) for c in self.counts.values())


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: it is "
                       "needed to build the port's native/*.cpp libraries")


def _host_command(name: str, out: Path, asan: bool) -> list:
    cflags, ldflags = HOST_EXTRA[name]
    return [_cxx(), *(ASAN_FLAGS if asan else HOST_FLAGS), *cflags, "-o",
            str(out), str(NATIVE / f"{name}.cpp"), *ldflags]


def host_lib_path(name: str, asan: bool = False) -> Path:
    """Where native/<name>.cpp's library goes: named by a hash of the
    source, the headers beside it and the command's flags."""
    blob = (NATIVE / f"{name}.cpp").read_bytes()
    for h in sorted(NATIVE.glob("*.h")):
        blob += h.read_bytes()
    cmd = _host_command(name, Path("out"), asan)[1:]
    digest = hashlib.sha256(blob + " ".join(cmd).encode()).hexdigest()
    return (ASAN_BUILD_DIR if asan else HOST_BUILD_DIR) / \
        f"{name}-{digest[:16]}.so"


def build_host(names: Iterable[str] | None = None,
               asan: bool = False) -> Dict[str, Path]:
    """Compile every listed host source (default: all four) that has no
    library for its current hash, one compiler a source, all started
    together; with asan, the AddressSanitizer build into
    build/native-asan/.  Returns {name: library path}.  Raises with the
    command and the compiler's output if one fails."""
    names = list(HOST_EXTRA if names is None else names)
    procs = {}
    for name in names:
        out = host_lib_path(name, asan)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _host_command(name, tmp, asan)
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), cmd, tmp, out)
    failed = []
    for name, (proc, cmd, tmp, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("host build failed:\n" + "\n".join(failed))
    return {name: host_lib_path(name, asan) for name in names}


def load_host(name: str) -> ctypes.CDLL:
    """The ctypes handle of native/<name>.cpp's library, built if
    needed.  Its calls release the GIL."""
    with _load_lock:
        key = "host:" + name
        lib = _loaded.get(key)
        if lib is None:
            lib = _loaded[key] = ctypes.CDLL(str(build_host([name])[name]))
        return lib
