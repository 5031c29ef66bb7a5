"""Build the port's CUDA sources for the CPU emulation in tests/cuda_emu/.

The CPU has no nvcc and no card, so a CUDA kernel cannot run here.  This
helper rewrites the three constructs plain C++ lacks (``extern
__shared__`` arrays, ``<<<...>>>`` launches, ``#pragma unroll``) and
compiles the source with g++ against ``tests/cuda_emu/cuda_runtime.h``,
where the CUDA threads of a cluster are fibers on the calling thread and
warp collectives meet at barriers.  The library keeps the kernel's plain
C interface, so a test calls it with ctypes on CPU tensors exactly as the
wrapper calls the real library on the card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

EMU = Path(__file__).resolve().parent / "cuda_emu"


def compiler() -> str | None:
    """The C++ compiler the emulation needs, or None."""
    return shutil.which("g++")


def translate(src: str) -> str:
    """CUDA source -> C++ for the emulation header."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = EMU_SMEM(\1);", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(",
                 r"emu::launch(\1, \2, 1u, ", src)
    return re.sub(r"#pragma unroll.*", "", src)


def build(cu: Path, out_dir: Path, defines=()) -> ctypes.CDLL:
    """Compile ``cu`` for the emulation into ``out_dir`` and load it;
    ``defines`` are ``NAME=VALUE`` macros set on the command line, as
    ``nvcc -D`` would set them."""
    tag = "".join(f"_{d.replace('=', '')}" for d in defines)
    cpp = out_dir / (cu.stem + tag + "_emu.cpp")
    so = out_dir / ("lib" + cu.stem + tag + "_emu.so")
    cpp.write_text(translate(cu.read_text()))
    subprocess.run([compiler(), "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", *(f"-D{d}" for d in defines), "-I", str(EMU),
                    "-o", str(so), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(so))
