"""Build the CUDA kernels with nvcc and bind them through ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), at first use,
into ``ska_pst_dsp_tpu_torch/_build/`` under a name keyed on a hash of the
sources and flags: a source change rebuilds, an unchanged tree reuses the
library. Each source compiles in its own ``nvcc`` process, all started
together, and one more links the objects; ``ptxas -v``'s report of each
kernel's registers and spills is kept beside the library
(:func:`resource_usage`). Each C entry launches on the stream it is given
and returns ``cudaGetLastError()``; :func:`check` raises on anything but
success.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: argtypes of each C entry point, in csrc/ order.
SIGNATURES = {
    "analysis_fused_launch": [_P] * 7 + [_I, _L, _L] + [_I] * 10 + [_P],
    "synthesis_fused_launch": [_P] * 6 + [_L] * 3 + [_I] * 8 + [_P],
    "ifft_fused_launch": [_P] * 9 + [_L] * 2 + [_I] * 6 + [_F, _P],
    "ifft_fused_clusters": [_I, _P],
    "padded_fold_launch": [_P] * 3 + [_I, _L, _L] + [_I] * 8 + [_P],
    "padded_fold_slots": [_I] * 4 + [_P],
    "chan_dft_launch": [_P] * 5 + [_I] * 8 + [_P],
    "dada_unpack_launch": [_P] * 2 + [_I] * 3 + [_L, _I, _P],
    "lowcbf_unpack_launch": [_P] * 2 + [_I] * 3 + [_L, _I, _P],
    "dada_pack_launch": [_P] * 2 + [_I] * 3 + [_L, _I, _F, _P],
    "ifft_big_inner_launch": [_P] * 4 + [_L] * 2 + [_I] * 6 + [_P],
    "ifft_big_outer_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
    "inversion_fused_launch": [_P] * 13 + [_L] * 7 + [_I] * 11 + [_F, _P],
    "inversion_fused_clusters": [_I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libska_pst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, srcs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            _check_nvcc(cmd, proc.returncode, log)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        _check_nvcc(cmd, res.returncode, res.stdout)
        log_path(out).write_text("".join(f"// source: {src.name}\n{log}"
                                         for src, log in zip(srcs, logs)))
        os.replace(lib, out)
    return out


def log_path(lib: Path) -> Path:
    """The ``ptxas -v`` log kept beside a built library."""
    return lib.with_suffix(".log")


def _kernel_name(mangled: str) -> str:
    """``name<1,12>`` from an Itanium-mangled kernel name with integer and
    bool template arguments, also inside a class template's (the kernels'
    only kinds; a bool reads 0 or 1), up to the void return type."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + len(name):]
    if rest.startswith("I"):
        args = re.findall(r"L[ib](-?\d+)E", rest[:rest.find("Ev") + 1])
        name += "<" + ",".join(args) + ">"
    return name


def resource_usage() -> Dict[str, Dict[str, Dict[str, int]]]:
    """{source stem: {kernel: {"registers", "spill_stores", "spill_loads"}}}
    from the ``ptxas -v`` log of the built library (bytes for the spills),
    one entry per instantiated kernel."""
    return parse_ptxas(log_path(build()).read_text())


def parse_ptxas(text: str) -> Dict[str, Dict[str, Dict[str, int]]]:
    """:func:`resource_usage` of a build log: ``ptxas -v`` output, each
    source's part headed by a ``// source: <name>`` line."""
    usage: Dict[str, Dict[str, Dict[str, int]]] = {}
    source, current = "", None
    for line in text.splitlines():
        if line.startswith("// source: "):
            source, current = Path(line.split(": ", 1)[1]).stem, None
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            usage.setdefault(source, {})[_kernel_name(m.group(1))] = current
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return usage


def _check_nvcc(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{log}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {status}")
