"""Pose estimators of the port: PoseResNet and HRNet."""

import torch

from .hrnet import PoseHighResolutionNet
from .pose_resnet import PoseResNet

__all__ = ["PoseHighResolutionNet", "PoseResNet", "build_model", "compute_dtype"]


def compute_dtype(cfg) -> torch.dtype:
    name = cfg.TPU.COMPUTE_DTYPE
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError("Unknown TPU.COMPUTE_DTYPE: %s" % name)


def build_model(cfg) -> torch.nn.Module:
    """Instantiate the configured pose estimator (reference:
    workflow.py:125-139)."""
    if cfg.POSE_ESTIMATOR.TYPE == "POSE_RESNET":
        return PoseResNet(
            num_joints=cfg.DATA.NUM_JOINTS,
            num_layers=cfg.POSE_ESTIMATOR.NUM_LAYERS,
            dtype=compute_dtype(cfg),
            fast_deconv=cfg.TPU.FAST_DECONV,
        )
    if cfg.POSE_ESTIMATOR.TYPE == "HRNET":
        return PoseHighResolutionNet.from_config(
            num_joints=cfg.DATA.NUM_JOINTS,
            hrnet_cfg=cfg.POSE_ESTIMATOR.HRNET,
            dtype=compute_dtype(cfg),
            packed_max_channels=cfg.TPU.HRNET_PACKED_MAX_CH,
        )
    raise ValueError("Unknown POSE_ESTIMATOR.TYPE: %s" % cfg.POSE_ESTIMATOR.TYPE)
