"""Build the package's CUDA sources with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` (Hopper) by its own
``nvcc`` process, all started together, and the objects are linked into
``build/libmval_kernels.so`` inside the package.  Each source exposes plain
C entry points (pointers, ints, floats, a stream), so no PyTorch header is
compiled and the whole build takes seconds.  The library is built at first
use, never at import, and rebuilt when a source is newer than it, by one
process at a time.

Each entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a nonzero code (a refused launch never runs, and a later
synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmval_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# C entry points: name -> argument types.  Pointers and the stream are
# c_void_p (a Python int would otherwise be cut to 32 bits).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = ctypes.POINTER(ctypes.c_longlong)  # a kernel's launch plan, flattened
SIGNATURES: Dict[str, List] = {
    # (heatmaps, out, plan, plan length, stride, stream): kernels/decode.py::launch_plan
    "mval_fused_decode": [_P, _P, _PLAN, _I, _F, _P],
    # (features, center_mask, out, plan, plan length, stream): kernels/pairwise.py::launch_plan
    "mval_min_distance_to_centers": [_P, _P, _P, _PLAN, _I, _P],
    # (x, packed weights, scale, bias, out, plan, plan length, is_bf16, stream)
    "mval_fused_deconv_bn_relu": [_P, _P, _P, _P, _P, _PLAN, _I, _I, _P],
    # (x, s8 scratch, packed s8 weights, sx, ws, scale, bias, out, plan, plan length,
    #  is_bf16, stream)
    "mval_fused_deconv_bn_relu_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _PLAN, _I, _I, _P],
}


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> Tuple[float, str]:
    """Compile every source in parallel and link the shared library.

    Returns (seconds, compiler log).  Raises with the compiler's output when
    a source does not compile."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append("== %s\n%s" % (os.path.basename(src), out))
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                "nvcc failed for %s:\n%s" % (", ".join(failed), "\n".join(log))
            )
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib] + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n%s" % link.stdout)
        os.replace(tmp_lib, LIB_PATH)  # atomic: a concurrent loader sees old or new
    text = "\n".join(log)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(text)
    return time.perf_counter() - t0, text


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale.  The
    ranks of a multi-process run share one build directory: an exclusive
    lock on ``build/lock`` lets one of them build while the others wait
    (the kernel frees the lock when its holder exits, however it exits),
    and each then loads the fresh library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if code != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError_t %d" % (name, code))


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of the card `device` names (the current card for a bare "cuda"):
    the launch plans size their grids from it."""
    return _sm_count_of(torch.cuda.current_device() if device.index is None else device.index)
