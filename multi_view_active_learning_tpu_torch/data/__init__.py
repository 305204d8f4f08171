"""Data layer of the port: active-learning frame pools, the dataset indexers
(CMU Panoptic, InterHand2.6M, synthetic), and the host side of the batch
pipeline.  Numpy, PIL and the native decoder only; the device work of a
batch runs in the engine."""

from .pipeline import FrameLoader, prepare_views_host
from .pools import FramePool

__all__ = ["FramePool", "FrameLoader", "prepare_views_host", "build_dataset"]


def build_dataset(cfg, split: str):
    """Instantiate the configured dataset (reference: workflow.py:105-122)."""
    dtype = cfg.DATA.TYPE
    if dtype == "panoptic":
        from .panoptic import CMUPanopticDataset

        return CMUPanopticDataset(cfg.DATA, cfg.POSE_ESTIMATOR.STRIDE, split=split)
    if dtype == "ih26m":
        from .ih26m import InterHand26MDataset

        return InterHand26MDataset(cfg.DATA, cfg.POSE_ESTIMATOR.STRIDE, split=split)
    if dtype == "synthetic":
        from .panoptic import CMUPanopticDataset

        return CMUPanopticDataset(cfg.DATA, cfg.POSE_ESTIMATOR.STRIDE, split=split,
                                  root=cfg.DATA.SYNTHETIC_ROOT)
    raise ValueError("Unknown DATA.TYPE: %s" % dtype)
