"""Build and load the port's hand-written CUDA kernels and its host library.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
:mod:`ctypes`. Nothing is built at import: the first call of
:func:`load` builds into ``build/kernels/`` at the repository root, keyed
on a hash of the source and the flags, so a later process (or a later
run in the same checkout) reuses the library.

:func:`load_host` does the same for a host library ``csrc/<name>.cpp``
with ``g++`` into ``build/host/``: with ``-DVSRIO_OPENCV`` and OpenCV's
flags where the ``opencv4`` headers are found, without them otherwise.
No ``-march=native``: the build directory may move to another host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
OPENCV_INCLUDES = ("/usr/include/opencv4", "/usr/local/include/opencv4")
OPENCV_LIBS = ("-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc")


@dataclass
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc/ptxas output of the build ("" when reused)


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(cmd: Sequence[str], src: Path, out: Path, tool: str) -> tuple[float, str]:
    """Run ``cmd``, whose ``OUT`` is the library it writes, into a private
    name, then rename that to ``out``: a concurrent or cut build never
    leaves a half-written library under the final name. Returns the
    seconds and the compiler's output; raises on a failed compile."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([tmp if a == "OUT" else a for a in cmd], capture_output=True,
                          text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{tool} failed for {src}:\n{log}")
    os.replace(tmp, out)
    return seconds, log


@functools.cache
def load(name: str) -> Library:
    """The library of ``csrc/<name>.cu``, loaded once per process. It is
    compiled first unless a build of this exact source and these flags
    exists. Raises on a failed compile."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        seconds, log = _compile([_nvcc(), *NVCC_FLAGS, "-o", "OUT", str(src)], src, out, "nvcc")
    return Library(ctypes.CDLL(str(out)), out, seconds, log)


def opencv_include() -> str | None:
    """The ``opencv4`` include directory, where its headers are found."""
    for inc in OPENCV_INCLUDES:
        if os.path.isfile(os.path.join(inc, "opencv2", "imgcodecs.hpp")):
            return inc
    return None


_host_lock = threading.Lock()


def load_host(name: str) -> Library:
    """The host library of ``csrc/<name>.cpp``, loaded once per process
    (under a lock: a loader's worker threads may ask at once), built with
    ``g++`` unless a build of this source and these flags exists: with
    OpenCV where its headers are found, without it otherwise. Raises on a
    failed build."""
    with _host_lock:
        return _load_host(name)


@functools.cache
def _load_host(name: str) -> Library:
    src = CSRC / f"{name}.cpp"
    inc = opencv_include()
    flags, libs = (((*GXX_FLAGS, "-DVSRIO_OPENCV", f"-I{inc}"), OPENCV_LIBS) if inc
                   else (GXX_FLAGS, ()))
    key = " ".join((*flags, *libs)).encode()
    digest = hashlib.sha256(src.read_bytes() + key).hexdigest()[:16]
    out = HOST_BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
        # the libraries after the source: the linker reads them in order
        seconds, log = _compile([cxx, *flags, "-o", "OUT", str(src), *libs], src, out, "g++")
    return Library(ctypes.CDLL(str(out)), out, seconds, log)
