"""RandAugment on the device, for training batches.

The port's counterpart of the JAX package's data/augmentation.py (:38-235
there; reference: dataset/augmentation.py:15-116): ``num_aug`` steps a
sample, each applying one op drawn from the table ``rotate, autocontrast,
equalize, invert, posterize, solarize, color, contrast, brightness,
sharpness`` (rotate left out under ``use_rotation=False``, the nine image
ops under ``use_image_aug=False``).  Rotation turns the image and its GT
heatmaps together; the image ops leave the heatmaps as they are.

The draws are JAX's, bit for bit (utils/prng.py): ``split(rng_key, N)``,
per sample ``split(key, num_aug)``, per step ``split(key_i, 3)`` into the
op's ``randint``, the magnitude's ``uniform`` (when ``const_magnitude`` is
False) and the rotation sign's ``uniform > 0.5``.  They are made on the
host before any launch (`draw_ops`); the ops then run batched on the
device, one group of samples per op and step, with no host sync.

Images are float32 ``[N, H, W, 3]`` in [0, 255]; heatmaps are the port's
``[N, K, h, w]``.  Where rounding makes them differ, the arithmetic follows
the JAX package's on XLA's CPU backend: a step's result is
``img + (op(img) - img)`` (the JAX op is a one-hot sum of deltas), and the
grayscale dot and the Enhance blends round as its fused multiply-adds do
(emulated in float64: each product of two float32 values is exact there),
so the rounding ops after them (the grayscale's own, equalize,
posterize) see the same values.  The rotation's cosine and sine are
computed on the host, so the card and the CPU interpolate with the same
numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..utils import prng

OPS = ("rotate", "autocontrast", "equalize", "invert", "posterize", "solarize", "color",
       "contrast", "brightness", "sharpness")
# Magnitude ranges [lo, hi] of the image ops (JAX data/augmentation.py:163-173).
_RANGES = {"autocontrast": (0.0, 1.0), "equalize": (0.0, 1.0), "invert": (0.0, 1.0),
           "posterize": (0.0, 4.0), "solarize": (0.0, 256.0), "color": (0.1, 1.9),
           "contrast": (0.1, 1.9), "brightness": (0.1, 1.9), "sharpness": (0.1, 1.9)}
_GRAY = (0.299, 0.587, 0.114)
# -degrees * pi / 180 as XLA folds it: one multiply by f32(pi) * f32(1/180).
_RAD_PER_DEG = np.float32(np.float32(np.pi) * np.float32(1.0 / 180.0))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    return (a.double() * b + c.double()).float()


def _rotate_bilinear(img: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``[n, H, W, C]`` about the center, bilinear with zero fill
    (PIL Image.rotate's geometry), by the angle whose inverse map has
    cosine `cos` and sine `sin` (``[n]``)."""
    n, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = cos.view(n, 1, 1), sin.view(n, 1, 1)
    ys = (torch.arange(h, dtype=torch.float32, device=img.device) - cy).view(1, h, 1)
    xs = (torch.arange(w, dtype=torch.float32, device=img.device) - cx).view(1, 1, w)
    src_x = cos * xs + sin * ys + cx
    src_y = -sin * xs + cos * ys + cy
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = (src_x - x0).unsqueeze(-1), (src_y - y0).unsqueeze(-1)
    batch = torch.arange(n, device=img.device).view(n, 1, 1)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[batch, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * inb.unsqueeze(-1)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _autocontrast(img: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel min / max stretch (ImageOps.autocontrast,
    cutoff 0)."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-6)
    return torch.where(hi > lo, (img - lo) * scale, img)


def _equalize(img: torch.Tensor) -> torch.Tensor:
    """ImageOps.equalize's integer LUT, per sample and channel."""
    n, h, w, c = img.shape
    x = torch.clamp(torch.round(img), 0, 255).long().permute(0, 3, 1, 2).reshape(n, c, h * w)
    histo = torch.zeros((n, c, 256), dtype=torch.long, device=img.device)
    histo.scatter_add_(2, x, torch.ones_like(x))
    # The last nonzero bin's count.
    last_idx = 255 - torch.argmax((histo.flip(-1) > 0).to(torch.uint8), dim=-1, keepdim=True)
    last = histo.gather(2, last_idx)
    step = (histo.sum(-1, keepdim=True) - last) // 255
    lut = torch.cat([torch.zeros_like(last), torch.cumsum(histo, -1)[..., :-1]], -1)
    lut = torch.clamp((lut + step // 2) // torch.clamp(step, min=1), 0, 255)
    out = torch.where(step == 0, x, lut.gather(2, x))
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def _invert(img: torch.Tensor) -> torch.Tensor:
    return 255.0 - img


def _posterize(img: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep the top `bits` (``[n]``, truncated to an integer in [1, 8]) of
    each value (ImageOps.posterize)."""
    shift = 8 - torch.clamp(bits.to(torch.int32), 1, 8).view(-1, 1, 1, 1)
    mask = (255 >> shift) << shift
    x = torch.clamp(torch.round(img), 0, 255).to(torch.int32)
    return (x & mask).to(torch.float32)


def _solarize(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return torch.where(img >= threshold.view(-1, 1, 1, 1), 255.0 - img, img)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """PIL's "L" conversion, rounded, broadcast back to three channels; the
    dot sums as XLA's CPU dot does, in a chain of fused multiply-adds."""
    acc = img[..., 0] * _GRAY[0]
    acc = _fma(img[..., 1], np.float32(_GRAY[1]), acc)
    acc = _fma(img[..., 2], np.float32(_GRAY[2]), acc)
    return torch.round(acc).unsqueeze(-1).expand(img.shape)


def _blend(base: torch.Tensor, img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ImageEnhance's ``base + v * (img - base)``, clipped to [0, 255]."""
    return torch.clamp(_fma(img - base, v.view(-1, 1, 1, 1), base), 0.0, 255.0)


def _color(img, v):
    return _blend(_grayscale(img), img, v)


def _contrast(img, v):
    mean = torch.round(_grayscale(img)[..., 0].mean(dim=(1, 2)) + 0.5)
    return _blend(mean.view(-1, 1, 1, 1).expand(img.shape), img, v)


def _brightness(img, v):
    return _blend(torch.zeros_like(img), img, v)


def _sharpness(img, v):
    """ImageEnhance.Sharpness: a blend with PIL's SMOOTH filter (3x3, center
    5, the rest 1, over 13), which leaves a 1-pixel border as it was.  The
    filter is nine shifted adds: no convolution library (nor its TF32)."""
    _, h, w, _ = img.shape
    pad = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    smoothed = None
    for dy in range(3):
        for dx in range(3):
            tap = pad[:, dy:dy + h, dx:dx + w] * np.float32((5.0 if dy == dx == 1 else 1.0) / 13.0)
            smoothed = tap if smoothed is None else smoothed + tap
    edge = torch.ones((h, w, 1), dtype=torch.bool, device=img.device)
    edge[1:-1, 1:-1] = False
    return _blend(torch.where(edge, img, smoothed), img, v)


_IMAGE_FNS = {"autocontrast": lambda img, v: _autocontrast(img),
              "equalize": lambda img, v: _equalize(img),
              "invert": lambda img, v: _invert(img),
              "posterize": _posterize, "solarize": _solarize, "color": _color,
              "contrast": _contrast, "brightness": _brightness, "sharpness": _sharpness}


def draw_ops(rng_key: np.ndarray, n: int, num_aug: int, magnitude: int, use_rotation: bool = True,
             use_image_aug: bool = True, const_magnitude: bool = True) -> Dict[str, np.ndarray]:
    """Every step's draws, on the host, as the JAX package draws them:
    ``op`` ``[n, num_aug]`` indices into `OPS`, ``value`` the op's float32
    magnitude (degrees for rotate, sign applied), and the rotation's
    inverse-map ``cos`` / ``sin``."""
    ops = (["rotate"] if use_rotation else []) + (list(OPS[1:]) if use_image_aug else [])
    keys = prng.split(prng.split(prng.split(rng_key, n), num_aug), 3)  # [n, num_aug, 3, 2]
    op_idx = prng.randint(keys[..., 0, :], (), 0, len(ops))
    if const_magnitude:
        frac = np.full(op_idx.shape, np.float32(magnitude) / np.float32(30.0), np.float32)
    else:
        frac = prng.uniform(keys[..., 1, :]) * np.float32(magnitude) / np.float32(30.0)
    flip = prng.uniform(keys[..., 2, :]) > 0.5
    table = np.asarray([OPS.index(name) for name in ops])
    op = table[op_idx]
    value = np.zeros(op.shape, np.float32)
    rotate = op == 0
    degrees = frac * np.float32(30.0)
    value[rotate] = np.where(flip, -degrees, degrees)[rotate]
    for i, name in enumerate(OPS[1:], start=1):
        lo, hi = _RANGES[name]
        value[op == i] = (frac * np.float32(hi - lo) + np.float32(lo))[op == i]
    theta = (-value.astype(np.float32)) * _RAD_PER_DEG
    return {"op": op, "value": value, "cos": np.cos(theta.astype(np.float64)).astype(np.float32),
            "sin": np.sin(theta.astype(np.float64)).astype(np.float32)}


def apply_ops(draws: Dict[str, np.ndarray], images: torch.Tensor,
              heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The drawn steps on the device: for each step, each op on the group of
    samples that drew it.  Returns new tensors."""
    images, heatmaps = images.clone(), heatmaps.clone()
    dev = images.device
    for step in range(draws["op"].shape[1]):
        op = draws["op"][:, step]
        for index in np.unique(op):
            rows = np.flatnonzero(op == index)
            idx = to_device(rows, dev)
            img = images.index_select(0, idx)
            if OPS[index] == "rotate":
                cos = to_device(draws["cos"][rows, step], dev)
                sin = to_device(draws["sin"][rows, step], dev)
                heat = heatmaps.index_select(0, idx)  # [k, K, h, w]
                rot = _rotate_bilinear(heat.permute(0, 2, 3, 1), cos, sin).permute(0, 3, 1, 2)
                heatmaps.index_copy_(0, idx, heat + (rot - heat))
                out = _rotate_bilinear(img, cos, sin)
            else:
                out = _IMAGE_FNS[OPS[index]](img, to_device(draws["value"][rows, step], dev))
            images.index_copy_(0, idx, img + (out - img))
    return images, heatmaps


def rand_augment(rng_key: np.ndarray, images: torch.Tensor, heatmaps: torch.Tensor, num_aug: int,
                 magnitude: int, use_rotation: bool = True, use_image_aug: bool = True,
                 const_magnitude: bool = True, total_rows: Optional[int] = None,
                 rows: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`num_aug` random ops a sample (JAX data/augmentation.py:176-235;
    reference: dataset/augmentation.py:99-116) on float32 images
    ``[N, H, W, 3]`` in [0, 255] and heatmaps ``[N, K, h, w]``, from the
    threefry key `rng_key` (utils/prng.py).  The draws are keyed by row:
    with `total_rows`, the N samples are the rows `rows` (N indices) of a
    batch of `total_rows` (a rank's crops of the global batch), and take
    those rows' draws."""
    if num_aug == 0 or not (use_rotation or use_image_aug):
        return images, heatmaps
    n = images.shape[0]
    draws = draw_ops(rng_key, n if total_rows is None else total_rows, num_aug, magnitude,
                     use_rotation, use_image_aug, const_magnitude)
    if total_rows is not None:
        rows = np.asarray(rows)
        if rows.shape != (n,):
            raise ValueError("rows holds %s indices for %d samples" % (rows.shape, n))
        draws = {name: value[rows] for name, value in draws.items()}
    return apply_ops(draws, images, heatmaps)
