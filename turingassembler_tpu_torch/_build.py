"""Build the port's CUDA kernels and host C++ libraries at first use.

Each `csrc/<name>.cu` is compiled by nvcc, for sm_90a, into its own
shared library with a plain C interface, loaded with ctypes.  Libraries
go to `build/kernels/` at the repository root, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one
is reused.  Several sources build in parallel, one nvcc each.  Nothing
here runs on import, and the CPU path never looks for nvcc.

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
from typing import Dict, Iterable

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
