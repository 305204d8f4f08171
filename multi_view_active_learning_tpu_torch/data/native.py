"""ctypes binding of the native host decoder (``native/mval_host.cc``).

One C call replaces the loader's PIL decode -> crop -> Lanczos resize ->
BGR flip chain (reference: dataset/dataset.py:158-214).  The port builds
its own copy of the library with ``g++ ... -ljpeg`` at first use, into the
package's gitignored ``build/`` (the flags of ``native/Makefile``), and
rebuilds it when the source is newer.  If the build or the load fails the
loader takes the PIL path and this module logs why, once a process; a
failed build is recorded and not retried until the source changes.  This
is host decode, not a device kernel.

``fast_scale=True`` lets libjpeg decode at 1/2^k resolution when the crop
is much larger than the output, trading bit-exactness with the
full-resolution path for speed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from ..utils import get_logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "mval_host.cc")
BUILD_DIR = os.path.join(_PKG, "build")
SO_PATH = os.path.join(BUILD_DIR, "libmval_host.so")
# A failed build's compiler output: no process builds again until the
# source is newer (or this file is deleted).
FAILED_PATH = os.path.join(BUILD_DIR, "libmval_host.failed")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_unavailable = False


def _newer(path: str) -> bool:
    """`path` exists and is at least as new as the source."""
    return os.path.isfile(path) and os.path.getmtime(path) >= os.path.getmtime(SOURCE)


def _build() -> None:
    """Compile into a temporary file and rename it over SO_PATH, so worker
    processes that build at once each see a whole library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, "-ljpeg"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            with open(FAILED_PATH, "w") as f:
                f.write(proc.stderr)
            raise OSError("g++ failed:\n" + proc.stderr)
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    try:
        if not _newer(SO_PATH):
            if _newer(FAILED_PATH):
                with open(FAILED_PATH) as f:
                    raise OSError("an earlier build failed:\n" + f.read())
            _build()
        lib = ctypes.CDLL(SO_PATH)
    except OSError as e:
        get_logger(__name__).warning("native decoder unavailable (%s); using the PIL path" % e)
        _unavailable = True
        return None
    lib.decode_crop_resize.restype = ctypes.c_int
    lib.decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library builds (or is built) and loads here."""
    return _load() is not None


def decode_crop_resize(jpeg_bytes: bytes, bbox, out_w: int, out_h: int, bgr_flip: bool = True,
                       fast_scale: bool = False) -> Optional[np.ndarray]:
    """JPEG bytes + (l, t, r, b) -> uint8 [out_h, out_w, 3], or None when the
    library is unavailable or the decode fails."""
    lib = _load()
    if lib is None:
        return None
    left, top, right, bottom = (int(v) for v in bbox)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.decode_crop_resize(
        jpeg_bytes, len(jpeg_bytes), left, top, right, bottom,
        out_w, out_h, int(bgr_flip), int(fast_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None

