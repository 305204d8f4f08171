"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

  * ``decode``   -- K1, fused heatmap decode (``csrc/decode.cu``);
  * ``pairwise`` -- K2, coreset min distance to centers (``csrc/pairwise.cu``);
  * ``deconv``   -- K3 and K4, the fused deconv + BN + ReLU head in float
    and int8 (``csrc/deconv.cu``).

``_build`` compiles ``csrc/*.cu`` with nvcc at first use and binds the C
entry points with ctypes; importing this package builds nothing.  ``ops``
registers K1, K3 and K4 as the operators ``torch.ops.mval.*``, which the
wrappers call (and an exported serving artifact needs registered).
"""

from . import decode, deconv, pairwise
from . import ops  # noqa: E402  (registers torch.ops.mval; needs decode and deconv)

KERNELS = {
    "fused_decode": decode.fused_decode,
    "min_distance_to_centers": pairwise.min_distance_to_centers,
    "fused_deconv_bn_relu": deconv.fused_deconv_bn_relu,
    "fused_deconv_bn_relu_int8": deconv.fused_deconv_bn_relu_int8,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
