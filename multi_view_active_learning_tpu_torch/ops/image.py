"""On-device image ops: batched bilinear crop + resize, and space-to-depth.

The port's counterpart of the JAX package's ops/image.py.  Under
``DATA.DEVICE_CROP`` the loader ships full frames and the square-box crop
+ resize that the reference does per view with PIL on the host
(dataset/dataset.py:180, 208-211) runs here as one gather over the whole
batch, on the batch's device.  Out-of-bounds regions are zero-filled, as
the host crop fills them (reference: utils/triangulation.py:77-93).
"""

from __future__ import annotations

import torch


def crop_and_resize_bilinear(images: torch.Tensor, boxes: torch.Tensor, out_h: int,
                             out_w: int) -> torch.Tensor:
    """images: [N, H, W, C] (any dtype); boxes: [N, 4] (left, top, right,
    bottom) in pixels, which may exceed the image.  Returns
    [N, out_h, out_w, C] float32.

    Output pixel (i, j) samples the source at
    left + (j + 0.5) * box_w / out_w - 0.5 (and likewise in y): the host
    path's pixel-grid convention, so a same-size crop is an identity up to
    interpolation."""
    images = images.to(torch.float32)
    N, H, W, _ = images.shape
    boxes = boxes.to(device=images.device, dtype=torch.float32)
    left, top, right, bottom = boxes.unbind(-1)
    cols = torch.arange(out_w, dtype=torch.float32, device=images.device)
    rows = torch.arange(out_h, dtype=torch.float32, device=images.device)
    xs = left[:, None] + (cols + 0.5) * (right - left)[:, None] / out_w - 0.5  # [N, out_w]
    ys = top[:, None] + (rows + 0.5) * (bottom - top)[:, None] / out_h - 0.5  # [N, out_h]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx = (xs - x0)[:, None, :, None]  # [N, 1, out_w, 1]
    fy = (ys - y0)[:, :, None, None]  # [N, out_h, 1, 1]
    n = torch.arange(N, device=images.device)[:, None, None]

    def gather(yi, xi):
        inb = ((yi >= 0) & (yi < H))[:, :, None] & ((xi >= 0) & (xi < W))[:, None, :]
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)[:, :, None]
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)[:, None, :]
        return images[n, yc, xc] * inb[..., None]  # [N, out_h, out_w, C]

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top_row = v00 * (1 - fx) + v01 * fx
    bot_row = v10 * (1 - fx) + v11 * fx
    return top_row * (1 - fy) + bot_row * fy


def crop_resize_uint8(images: torch.Tensor, boxes: torch.Tensor, out_h: int,
                      out_w: int) -> torch.Tensor:
    """The DATA.DEVICE_CROP view crop: [B, V, H, W, 3] uint8 full frames and
    [B, V, 4] square boxes -> [B, V, out_h, out_w, 3] uint8 crops, the host
    crop path's dtype, so the engine takes either unchanged."""
    B, V = images.shape[0], images.shape[1]
    flat = images.reshape((B * V,) + tuple(images.shape[2:]))
    out = crop_and_resize_bilinear(flat, boxes.reshape(B * V, 4), out_h, out_w)
    out = torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
    return out.reshape(B, V, out_h, out_w, out.shape[-1])


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [N, H, W, C] -> [N, H/2, W/2, 4C], channels in (p, q, c) order
    (JAX models/pose_resnet.py:157-164): the input of PoseResNet's stem
    under TPU.SPACE_TO_DEPTH_STEM.  Cheap on uint8 frames, which is where
    the engine and the serve function apply it."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)
