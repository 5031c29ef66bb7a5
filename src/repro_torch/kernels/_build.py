"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``src/repro_torch/**/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes).  A library is
named after its source and a hash of that source, the package's ``*.cuh``
headers and the flags, and lives under ``build/repro_torch/`` at the root
of the checkout; an edited source therefore rebuilds, an unchanged one
loads.  The compiler's report (``-Xptxas -v``: registers, spills) is kept
beside its library as ``.log``.  :func:`build_all` starts one ``nvcc`` per
library that is missing (or lacks its report), all at once, and waits for
them; :func:`load` builds one library if it is missing and opens it.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "sources"]

PKG_DIR = Path(__file__).resolve().parents[1]          # src/repro_torch
BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(PKG_DIR.rglob("csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(PKG_DIR.rglob("csrc/*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Build the named kernels (default: all) that are not built yet, one
    ``nvcc`` each, started together.  Returns name -> compiler output
    (``-Xptxas -v``: registers, shared memory, spills) for every named
    kernel, whether this call built it or read the report kept beside an
    earlier build; raises with the compiler's output on failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [nm for nm in names if nm not in srcs]
    if missing:
        raise KeyError(f"no kernel source for {missing}; have {sorted(srcs)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, built = {}, {}
    for nm in names:
        out = _lib_path(srcs[nm])
        if out.exists() and out.with_suffix(".log").exists():
            built[nm] = out.with_suffix(".log").read_text()
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        inc = str(srcs[nm].parent)
        procs[nm] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", inc, "-o", str(tmp), str(srcs[nm])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = {}
    for nm, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            tmp.with_suffix(".log").write_text(log)
            os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
            os.replace(tmp, out)
            built[nm] = log
        else:
            tmp.unlink(missing_ok=True)
            failed[nm] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {nm}\n{log}" for nm, log in failed.items()))
    return built


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(sources()[name])
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib

