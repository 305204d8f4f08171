"""Checkpoints in the reference's ``.pth`` format.

One ``torch.save`` file a save point, the dict the reference writes
(strategy.py:697-706): ``{"epoch", "global_step", "state_dict",
"optimizer"}``.  ``state_dict`` holds the model's weights and BN statistics
under the reference's names with the DDP ``module.`` prefix and a
``num_batches_tracked`` per BN, so the file strict-loads into the
reference's estimators; ``optimizer`` is Adam's state in
``torch.optim.Adam.state_dict()``'s layout (``exp_avg`` = mu, ``exp_avg_sq``
= nu, ``step`` = the bias-correction count), because a resume here restores
it (the JAX package's utils/checkpoint.py does the same with orbax, :53-141;
the reference saves it and never reads it).

The paths keep the JAX package's names, ``CKPT-E<step>-MKPE<mkpe>`` and the
rolling ``CKPT-FINAL`` under ``<log_dir>/<expr_name>/checkpoints``; each is
a file here (an orbax directory there).  The readers take these files and
the ``.pth`` that ``tools/export_checkpoint.py`` writes, with the ``module.``
prefix or without it.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional, Tuple

import torch

from .. import parallel
from . import get_logger, storage

_PREFIX = "module."


def _payload(state, epoch: int, lr: Optional[float]) -> dict:
    host = state.clone_to("cpu")  # one copy a flat buffer, then host views
    step = int(host.step)
    sd: Dict[str, torch.Tensor] = {}
    for name, t in host.state_dict().items():
        sd[_PREFIX + name] = t.clone()
        if name.endswith(".running_var"):
            # What a momentum-BN run of `step` steps would have counted.
            sd[_PREFIX + name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
                step, dtype=torch.int64)
    names = list(host.params)
    optimizer = {
        "state": {i: {"step": torch.tensor(float(int(host.count))),
                      "exp_avg": host.mu[n].clone(), "exp_avg_sq": host.nu[n].clone()}
                  for i, n in enumerate(names)},
        "param_groups": [{"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.0,
                          "amsgrad": False, "params": list(range(len(names)))}],
    }
    return {"epoch": int(epoch), "global_step": step, "state_dict": sd, "optimizer": optimizer}


def _write(path: str, data: bytes) -> None:
    """Whole-file write; a local file is renamed into place, so a reader
    never sees half of it."""
    if storage.is_remote(path):
        with storage.open_file(path, "wb") as f:
            f.write(data)
        return
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoints(paths, state, epoch: int = 0, lr: Optional[float] = None) -> None:
    """Save `state` (an ``engine.TrainState``) under every path: one copy to
    the host and one serialization, then the same bytes to each file,
    overwriting (as the reference does).  Under a process group only rank 0
    writes (every rank holds the same state); the others return at once,
    and the caller's barrier keeps them from reading the files early."""
    if not parallel.is_main():
        return
    buf = io.BytesIO()
    torch.save(_payload(state, epoch, lr), buf)
    data = buf.getvalue()
    for path in paths:
        _write(path, data)
        get_logger(__name__).info("Checkpoint saved at %s." % path)


def save_checkpoint(path: str, state, epoch: int = 0, lr: Optional[float] = None) -> str:
    save_checkpoints([path], state, epoch, lr)
    return path


def _read(path: str) -> Tuple[Dict[str, torch.Tensor], dict, int]:
    """(state dict without the ``module.`` prefix and the BN counters,
    optimizer dict, global step) of a checkpoint or a bare state dict."""
    with storage.open_file(path, "rb") as f:
        ckpt = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    has_sd = isinstance(ckpt, dict) and "state_dict" in ckpt
    raw = ckpt["state_dict"] if has_sd else ckpt
    sd = {(k[len(_PREFIX):] if k.startswith(_PREFIX) else k): v for k, v in raw.items()
          if not k.endswith("num_batches_tracked")}
    optimizer = ckpt.get("optimizer", {}) if has_sd else {}
    return sd, optimizer, int(ckpt.get("global_step", 0)) if has_sd else 0


def _strict(sd: Dict[str, torch.Tensor], names, path: str) -> Dict[str, torch.Tensor]:
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError("%s lacks %d tensors, e.g. %s" % (path, len(missing), missing[:3]))
    return {n: sd[n] for n in names}


def restore_checkpoint(path: str, state):
    """A true resume: a new TrainState on `state`'s device with the file's
    weights, BN statistics, Adam moments and count, and step.  `state`
    gives the names and the device; every name must be in the file."""
    sd, optimizer, step = _read(path)
    params = _strict(sd, state.params, path)
    buffers = _strict(sd, state.buffers, path)
    adam = optimizer.get("state", {})
    names = list(state.params)
    if len(adam) != len(names):
        raise KeyError("%s holds Adam state for %d of %d parameters"
                       % (path, len(adam), len(names)))
    mu = {n: adam[i]["exp_avg"] for i, n in enumerate(names)}
    nu = {n: adam[i]["exp_avg_sq"] for i, n in enumerate(names)}
    count = int(adam[0]["step"]) if names else 0
    return type(state)(params, buffers, state.device, step, mu, nu, count)


def restore_params_only(path: str, state):
    """The reference's semantics (strategy.py:713-721 reads only
    state_dict): the file's weights and BN statistics; `state`'s step and
    optimizer stay."""
    sd, _, _ = _read(path)
    return type(state)(_strict(sd, state.params, path), _strict(sd, state.buffers, path),
                       state.device, state.step, state.mu, state.nu, state.count)


def load_pretrained(cfg, path: str, state):
    """TRAIN.INIT_WEIGHT (reference strategy.py:722-742; JAX
    models/convert.py:319-348): a ``.pth`` loads filtered and non-strict,
    PoseResNet without ``final_layer.*`` and HRNet with only the
    POSE_ESTIMATOR.HRNET.PRETRAINED_LAYERS prefixes (all with "*"), into
    a copy of `state`; any other path is a params-only restore."""
    if not str(path).endswith(".pth"):
        return restore_params_only(path, state)
    sd, _, _ = _read(path)
    if cfg.POSE_ESTIMATOR.TYPE == "POSE_RESNET":
        sd = {k: v for k, v in sd.items() if not k.startswith("final_layer.")}
    elif cfg.POSE_ESTIMATOR.TYPE == "HRNET":
        allowed = cfg.POSE_ESTIMATOR.HRNET.PRETRAINED_LAYERS
        if allowed and allowed[0] != "*":
            sd = {k: v for k, v in sd.items() if k.split(".")[0] in allowed}
    params, buffers = dict(state.params), dict(state.buffers)
    counts = [0, 0]
    for key, value in sd.items():
        target = params if key in params else buffers if key in buffers else None
        if target is None:
            get_logger(__name__).warning("Skipping unmatched pretrained entry: %s" % key)
            continue
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError("Shape mismatch at %s: %s vs %s"
                             % (key, tuple(target[key].shape), tuple(value.shape)))
        target[key] = value
        counts[target is buffers] += 1
    get_logger(__name__).info("Loaded %d param and %d stat tensors from %s"
                              % (counts[0], counts[1], path))
    return type(state)(params, buffers, state.device, state.step, state.mu, state.nu, state.count)


def checkpoint_exists(path: str) -> bool:
    return storage.exists(path)


def final_ckpt_path(log_dir: str, expr_name: str, sub: str = "") -> str:
    parts = [log_dir, expr_name] + ([sub] if sub else []) + ["checkpoints", "CKPT-FINAL"]
    return os.path.join(*parts)
