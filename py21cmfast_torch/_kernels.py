"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exports plain C functions and is compiled by `nvcc` for
`sm_90a` into a shared library under `_build/` (git-ignored), keyed by a hash
of the source and flags, at first use.  `build()` starts one nvcc per missing
source, all at once, and waits for them.  The library is loaded with `ctypes`;
pointers and the stream are passed as `c_void_p`.  Nothing here runs at
import time: the CPU tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{key}.so"


def build(names=None) -> dict[str, str]:
    """Compile each named source (default: all of csrc/) unless its keyed
    library exists, with one nvcc process per source running in parallel.
    Returns nvcc's output (ptxas register and spill report) per source built."""
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """Build if needed, load, and return the C function `fn` with `argtypes`
    declared and an int (cudaError_t) result."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    f = getattr(_loaded[name], fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
