"""Build a CUDA source into a shared library with nvcc and load it with ctypes.

Each library is compiled at first use for ``sm_90a`` into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing falls back: a missing ``nvcc`` or a
failed compile raises.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``<name>.log``.  The
headers the sources share (``kernels/csrc/*.cuh``) are on nvcc's include path
and go into the hash too, so an edited header rebuilds every library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "are built at first use and need the CUDA toolkit")


def library_path(name: str, sources: tuple[Path, ...]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(INCLUDE_DIR.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[Path, ...]) -> Path:
    """Compile ``sources`` into one shared library unless it is already built."""
    so = library_path(name, sources)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent processes never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load(name: str, sources: tuple[Path, ...]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, sources)))
