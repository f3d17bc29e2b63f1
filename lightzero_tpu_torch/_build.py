"""Build and load the port's native code.

Each CUDA kernel is one source ``csrc/<name>.cu`` with a plain C interface
(``extern "C"`` launchers that return ``cudaGetLastError()``), compiled with
``nvcc``. Host C++ (``csrc/<name>.cpp``, the replay buffer's core) is
compiled with ``g++ -O3 -std=c++17 -shared -fPIC``. At first use a source is
compiled into a shared library under ``_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, and loaded with ``ctypes``. No
PyTorch header is compiled, so a build takes seconds.

If the compiler is missing or the build fails this raises ``BuildError``
with the compiler's output; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels keep their plain versions' rounding
    "--fmad=false",
    "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 300
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each library's compiler run took in this process (absent when the
# library was already built)
build_seconds: Dict[str, float] = {}


class BuildError(RuntimeError):
    """A kernel could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    raise BuildError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the port's CUDA kernels are compiled at first use and need the CUDA toolkit"
    )


def find_gxx() -> str:
    """Path of ``g++`` on PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise BuildError(
        "g++ not found on PATH; the port's host C++ (csrc/*.cpp) is compiled at first use"
    )


def compile_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc, or else ``csrc/<name>.cpp`` with
    g++, unless its library is already built; return the library's path. The
    compiler's output is kept beside the library (``.log``): ``-Xptxas=-v``
    lists a kernel's registers, shared memory and spills."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if os.path.exists(src):
        compiler, flags = find_nvcc(), NVCC_FLAGS
    else:
        src = os.path.join(CSRC_DIR, f"{name}.cpp")
        compiler, flags = find_gxx(), GXX_FLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd: List[str] = [compiler, *flags, "-o", tmp, src]
    tool = os.path.basename(compiler)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        os.unlink(tmp)
        raise BuildError(f"{tool} did not finish in {BUILD_TIMEOUT_S} s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(
            f"{tool} failed (exit {proc.returncode}) for {src}:\n{proc.stdout}{proc.stderr}"
        )
    build_seconds[name] = time.perf_counter() - t0
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, compiled on first use."""
    if name not in _loaded:
        path = compile_library(name)
        try:
            _loaded[name] = ctypes.CDLL(path)
        except OSError as e:
            raise BuildError(f"could not load {path}: {e}") from e
    return _loaded[name]
