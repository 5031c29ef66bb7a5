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
them; :func:`load` builds one library if it is missing and opens it.  A
library listed in :data:`PARTS` builds as that many objects side by side
(``nvcc -c`` with ``-D<NAME>_PARTS=n -D<NAME>_PART=p``, each holding its
share of the source's template instances) linked into one library.
Nothing here runs at import time.

The build directory is the port's persistent kernel-library cache, the
counterpart of jax's persistent compilation cache: :func:`set_build_dir`
repoints it at run time (the serving engine's ``compile_cache``), and
every lookup reads :data:`BUILD_DIR` when it is called.  While a listener
is set, :func:`load` reports each library it opens from that directory:
``"hit"`` when the library was on disk (built by an earlier process) and
``"miss"`` when ``nvcc`` built it in this process.  A library already
open in the process is neither.  Builds write a temporary file and
``os.replace`` it into place, so a process that reads the directory
while another builds sees a whole library or none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "DEFAULT_BUILD_DIR", "NVCC_FLAGS", "PARTS",
           "build_all", "load", "set_build_dir", "sources"]

PKG_DIR = Path(__file__).resolve().parents[1]          # src/repro_torch
DEFAULT_BUILD_DIR = PKG_DIR.parents[1] / "build" / "repro_torch"
BUILD_DIR = DEFAULT_BUILD_DIR     # where lookups go; see set_build_dir
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
# libraries built as several objects side by side: the mesh kernels'
# instances at fuse 1 to 8 take minutes of one nvcc
PARTS = {"colskip_mesh": 8}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_built_here: set[Path] = set()    # libraries nvcc built in this process
_listener = None                  # called with "hit" or "miss" by load


def set_build_dir(path=None, listener=None) -> Path:
    """Point every later lookup at ``path`` (None: the default
    ``build/repro_torch/``) and set the lookup listener (None: none).
    Libraries already open stay open.  Returns the directory."""
    global BUILD_DIR, _listener
    with _lock:
        BUILD_DIR = Path(path) if path is not None else DEFAULT_BUILD_DIR
        _listener = listener
        return BUILD_DIR


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
    h.update(str(PARTS.get(src.stem, 1)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _commands(name: str, src: Path, tmp: Path) -> tuple:
    """The ``nvcc`` commands that build ``src`` into ``tmp``, to run side
    by side, and the objects they leave for the link (none: they build the
    library itself)."""
    inc = ["-I", str(src.parent)]
    parts = PARTS.get(name, 1)
    if parts == 1:
        return [[_nvcc(), *NVCC_FLAGS, *inc, "-o", str(tmp), str(src)]], []
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    macro = name.upper()
    objs = [tmp.with_suffix(f".{p}.o") for p in range(parts)]
    return [[_nvcc(), *flags, "-c", f"-D{macro}_PARTS={parts}",
             f"-D{macro}_PART={p}", *inc, "-o", str(o), str(src)]
            for p, o in enumerate(objs)], objs


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
        cmds, objs = _commands(nm, srcs[nm], tmp)
        procs[nm] = ([subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in cmds], objs, tmp, out)
    failed = {}
    for nm, (running, objs, tmp, out) in procs.items():
        log = "".join(proc.communicate()[0] for proc in running)
        ok = all(proc.returncode == 0 for proc in running)
        if ok and objs:
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log += link.stdout
            ok = link.returncode == 0
        for o in objs:
            o.unlink(missing_ok=True)
        if ok:
            tmp.with_suffix(".log").write_text(log)
            os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
            os.replace(tmp, out)
            _built_here.add(out)
            built[nm] = log
        else:
            tmp.unlink(missing_ok=True)
            failed[nm] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {nm}\n{log}" for nm, log in failed.items()))
    return built


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing; the
    listener hears whether it came from disk or from ``nvcc``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(sources()[name])
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
            if _listener is not None:
                _listener("miss" if path in _built_here else "hit")
        return lib

