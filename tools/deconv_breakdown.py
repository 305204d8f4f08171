#!/usr/bin/env python3
"""Where K3's and K4's time goes on one CUDA card (csrc/deconv.cu).

    python3 tools/deconv_breakdown.py

Builds ``csrc/deconv.cu`` three times, each into a library of its own under
the package's build directory, and times its tensor-core kernel in each at
the deconv head's three bench-width layers (chip_smoke.py's HEAD_SHAPES,
bf16 activations, L2 flushed before each launch):

  * ``full``: the kernel as it is;
  * ``no_mma`` (``-DDECONV_NO_MMA``): the wgmma products removed (the TMA
    loads, the ring and the epilogue stay; the output is garbage);
  * ``loads_only`` (and ``-DDECONV_LOADS_ONLY``): the products and the
    epilogue removed: the rate at which the producer can feed the ring.

Prints one JSON line per layer: the times in ms of (K3, K4) per version,
and the layer's operations and bytes bounds.  Nothing here is on any path
of the port; the versions exist only in the build directory.  Exits nonzero
without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"full": [], "no_mma": ["-DDECONV_NO_MMA"],
            "loads_only": ["-DDECONV_NO_MMA", "-DDECONV_LOADS_ONLY"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("deconv_breakdown: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from multi_view_active_learning_tpu_torch.kernels import _build, deconv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC, "deconv.cu")
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o",
         os.path.join(_build.BUILD_DIR, "breakdown_%s.so" % name), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defines in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        lib = ctypes.CDLL(os.path.join(_build.BUILD_DIR, "breakdown_%s.so" % name))
        for entry in ("mval_fused_deconv_bn_relu", "mval_fused_deconv_bn_relu_int8"):
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    load = _build.load_library
    try:
        for idx, shape in enumerate(cs.HEAD_SHAPES):
            x, weight, scale, bias, _ = cs._head_inputs(shape, torch.bfloat16, dev, 30 + idx)
            k3 = deconv.pack_k3(weight, scale, bias, x.dtype)
            wq, ws = deconv.quantize_deconv_weight(weight)
            k4 = deconv.pack_k4(wq, ws, scale, bias)
            sx = torch.amax(torch.abs(x.float())) / 127.0
            row = {}
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                row[name] = dict(k3_ms=cs.cuda_ms(lambda: deconv.launch(x, k3), 20, flush),
                                 k4_ms=cs.cuda_ms(lambda: deconv.launch(x, k4, sx), 20, flush))
            _build.load_library = load
            print(json.dumps({"shape": list(shape), "device": smi, **row,
                              "k3_bound_ms": cs._head_bound(shape, 2, 2, cs.BF16_OPS_PER_S),
                              "k4_bound_ms": cs._head_bound(shape, 2, 1, cs.INT8_OPS_PER_S)}),
                  flush=True)
    finally:
        _build.load_library = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
