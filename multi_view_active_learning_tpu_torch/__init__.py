"""PyTorch / CUDA port of multi_view_active_learning_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it (nor JAX).  Layout mirrors the reference so each
counterpart is easy to find:

  * ``config``            -- the same config tree (own copy);
  * ``ops``               -- geometry, heatmap decode and losses,
                             RANSAC-DLT triangulation, coreset selection;
  * ``models``            -- PoseResNet and HRNet in NCHW with the
                             reference's torch module names, their int8
                             forward, and the flax -> torch converter;
  * ``engine``            -- the scoring / eval steps and the train step;
  * ``strategy``, ``data`` -- the pool sweep, selection and the training
                             loop, over the host data path;
  * ``utils``             -- checkpoints, evaluation metrics, the metrics
                             writer and small host helpers;
  * ``kernels``, ``csrc`` -- hand-written CUDA kernels for sm_90a, each
                             beside its plain PyTorch version.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; there is no silent CPU fallback.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
