"""The ctypes tables of the port's five CUDA libraries against the C
signatures in turingassembler_tpu_torch/csrc/<name>.cu.

Each wrapper declares its library's entries once, as a table handed to
_build.Kernels.  A table that disagrees with its source passes an
argument at the wrong width: an undeclared or misdeclared pointer goes
as a 32-bit C int and is cut.  This parses every `extern "C"` function
of the source and holds the table to it: the same entries, the same
number of parameters, each pointer (and the launches' trailing stream)
a c_void_p, each `long long` a c_longlong, each `int` a c_int, and the
same result type.  CPU only: nothing is built or loaded.
"""

import ctypes
import importlib
import re

import pytest

from turingassembler_tpu_torch import _build

LIBRARIES = ("devhash", "kmer_sort", "mm_map", "nw_align", "unitig_build")


def _ctype(decl: str):
    """The ctype a C parameter or result declaration passes as."""
    if "*" in decl or "cudaStream_t" in decl:
        return ctypes.c_void_p
    words = [w for w in re.findall(r"\w+", decl) if w != "const"]
    if words[:2] == ["long", "long"]:
        return ctypes.c_longlong
    if words[:1] == ["int"]:
        return ctypes.c_int
    raise AssertionError(f"no ctype for C type {decl!r}")


def c_signatures(name: str) -> dict:
    """{function: (result ctype, [parameter ctypes])} of every
    `extern "C"` function of csrc/<name>.cu."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    out = {}
    pattern = r'extern\s+"C"\s+([^;{]*?)\s*(\w+)\s*\(([^)]*)\)\s*\{'
    for m in re.finditer(pattern, src):
        result, fn, params = m.groups()
        params = [p.strip() for p in params.split(",")
                  if p.strip() not in ("", "void")]
        # a parameter's type is its declaration less the name after it
        out[fn] = (_ctype(result),
                   [_ctype(re.sub(r"\w+\s*$", "", p)) for p in params])
    return out


@pytest.mark.parametrize("name", LIBRARIES)
def test_binding_matches_c_signatures(name):
    lib = importlib.import_module(f"turingassembler_tpu_torch.ops.{name}").LIB
    assert lib.name == name
    sigs = c_signatures(name)
    assert sigs, f"csrc/{name}.cu: no extern \"C\" function found"
    declared = {**lib.entries, **lib.queries}
    assert set(declared) == set(sigs), (
        f"declared, not in the source: {sorted(set(declared) - set(sigs))}; "
        f"in the source, not declared: {sorted(set(sigs) - set(declared))}")
    for entry, args in lib.entries.items():
        result, params = sigs[entry]
        assert result is ctypes.c_int, entry
        assert params[-1] is ctypes.c_void_p, f"{entry}: no trailing stream"
        assert list(args) == params[:-1], (entry, list(args), params)
    for entry, (args, res) in lib.queries.items():
        result, params = sigs[entry]
        assert res is result and list(args) == params, (entry, args, params)
