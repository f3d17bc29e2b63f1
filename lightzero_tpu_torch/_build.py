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

It is also the one boundary between Python and what it built: every entry
point's types are declared once, when its library loads (``ENTRY_POINTS``);
``launch`` passes the current stream, raises on a CUDA error and counts
successful calls in ``launches``; ``check`` validates a kernel argument;
``route`` sends CUDA tensors to a kernel and CPU tensors to its plain
version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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

_VOID, _INT, _I64, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_NP_I64, _NP_F64, _NP_F32, _NP_U8 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                                     for t in (np.int64, np.float64, np.float32, np.uint8))

# entry point -> (library, result type, argument types). Every launcher
# returns its cudaError_t and takes the stream last.
ENTRY_POINTS: Dict[str, Tuple[str, Optional[type], list]] = {
    "fused_traverse_launch": ("fused_traverse", _INT, (
        [_VOID] * 11 + [_INT] * 4 + [_FLOAT] * 4 + [_INT, _FLOAT, _VOID])),
    "fused_traverse_route": ("fused_traverse", _INT, [_INT]),
    "fused_traverse_check_div": ("fused_traverse", _INT, [_VOID] * 5 + [_INT, _VOID]),
    "fused_traverse_check_div_all": ("fused_traverse", _INT, [_INT, _INT, _VOID, _VOID, _VOID]),
    # the argument is a FusedBackupArgs (fused_backup.py:_Args), by reference
    "fused_backup_launch": ("fused_backup", _INT, [_VOID, _VOID]),
    "fused_backup_max_actions": ("fused_backup", _INT, []),
    "fused_backup_max_path": ("fused_backup", _INT, []),
    "channel_norm_blocks": ("channel_norm", _INT, [_I64, _INT, _INT]),
    "channel_norm_forward": ("channel_norm", _INT, [_VOID] * 7 + [_I64, _INT, _INT, _FLOAT, _VOID]),
    "channel_norm_backward": ("channel_norm", _INT, [_VOID] * 10 + [_I64, _INT, _INT, _VOID]),
    "channel_norm_max_channels": ("channel_norm", _INT, []),
    "latency_probe_launch": ("latency_probe", _INT, [_VOID, _INT, _VOID, _VOID]),
    "sample_prioritized": ("replay_core", None, [
        _NP_F64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_uint64, _NP_I64, _NP_F32]),
    "assemble_unroll": ("replay_core", None, [
        _NP_I64, _NP_I64, _NP_I64, _NP_U8, _NP_F32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double,
        _NP_I64, _NP_U8, _NP_I64, _NP_U8, _NP_F32, _NP_F32, _NP_I64, _NP_U8, _NP_F32]),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# the entry points of the loaded libraries, their types declared
_entries: Dict[str, Any] = {}
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
    """The loaded library of source ``name``, compiled on first use, its
    entry points' types declared."""
    if name not in _loaded:
        path = compile_library(name)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise BuildError(f"could not load {path}: {e}") from e
        for fn_name, (library, restype, argtypes) in ENTRY_POINTS.items():
            if library == name:
                fn = _entries[fn_name] = getattr(lib, fn_name)
                fn.restype, fn.argtypes = restype, argtypes
        _loaded[name] = lib
    return _loaded[name]


def entry(name: str):
    """The entry point ``name`` of ``ENTRY_POINTS``, its library compiled
    and loaded on first use."""
    fn = _entries.get(name)
    if fn is None:
        load(ENTRY_POINTS[name][0])
        fn = _entries[name]
    return fn


# calls of each entry point through ``launch`` that succeeded (a call of
# channel_norm_backward launches two kernels)
launches: Dict[str, int] = defaultdict(int)

# the current stream's handle without building a Stream object (CUDA builds)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device: torch.device, *args) -> None:
    """Call the launcher ``name`` with ``args`` and the current stream of
    ``device``, without synchronising; raise where it returns a CUDA error,
    and count the launch where it does not."""
    rc = entry(name)(*args, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    launches[name] += 1


def check(name: str, x: Optional[torch.Tensor], shape: Tuple[int, ...],
          device: torch.device, dtype: torch.dtype = torch.float32) -> Optional[int]:
    """The address of a kernel's input or output once it is on ``device``
    with ``dtype`` and ``shape``, contiguous; None for an absent one."""
    if x is None:
        return None
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return x.data_ptr()


def route(op: str, x: torch.Tensor) -> bool:
    """Whether ``x`` takes ``op``'s kernel (a CUDA tensor) rather than its
    plain version (a CPU tensor); a tensor on another device raises. (It
    reads no ``x.device``, which costs a few hundred ns a call.)"""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"{op} runs on cuda or cpu tensors, not {x.device}")
