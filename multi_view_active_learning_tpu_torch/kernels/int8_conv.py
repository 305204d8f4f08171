"""K5: the int8 conv unit (``csrc/int8_conv.cu``) and its plain twin.

The quantized backbones' conv unit, as models/quantize.py composes it:
the activation quantized per tensor, ``round(x / sx)`` clipped to +-127; an
s8 convolution over s8 weights [Cout, k, k, Cin] with per-Cout scales and
exact s32 sums; the folded BN ``acc * ((sx * ws) * bn_scale) + bn_bias``;
an optional ReLU; bf16; and, with a residual, ``relu(y + residual)`` in
float32, rounded to bf16 again.  Activations are bf16 NHWC.

``int8_conv_bn_plain`` is that composition in plain tensor ops (the im2col
of k x k strided taps and ``ops/int8.py::int8_matmul``), the CPU kernel of
the registered operator ``torch.ops.mval.int8_conv_bn`` (kernels/ops.py).
On a CUDA tensor the operator launches K5, bit for bit the same, or raises.
``int8_conv_bn`` is the wrapper the models call; ``int8_conv_bn.launches``
counts its kernel launches (one a conv: the pre-pass and the product).

``conv_plan`` is the kernel's plan (its TMA maps, boxes and tile counts),
computed here from the conv's shape alone and passed to the C entry point;
the CPU tests walk it.  The same algorithm gives the wide early layers and
the deep late ones their tiles: the Cout tile (64, 128 or 256) follows
Cout, the pixel box follows the output's width, height and count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.int8 import int8_matmul
from . import _build

CIN_ALIGN = 16  # q's channels and the B map's rows are padded to this
TILE_M, ROW_BYTES = 128, 128  # csrc/int8_conv.cu kTileM, kRowBytes
IM2COL_BELOW = 16  # a Cin under this has its taps gathered by the pre-pass
_BF16 = torch.bfloat16


# ----------------------------------------------------------------- the twin


def quant_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)


def im2col(xq: torch.Tensor, k: int, stride: int, pad=None) -> torch.Tensor:
    """NHWC [N, H, W, C] -> patches [N, Ho, Wo, k*k*C] ordered (ky, kx, c),
    with the convolution's padding k // 2, or `pad` = (before, after) on
    both spatial axes (F.unfold refuses s8)."""
    if k == 1 and (pad is None or tuple(pad) == (0, 0)):
        return xq[:, ::stride, ::stride, :]
    before, after = (k // 2, k // 2) if pad is None else pad
    xp = F.pad(xq, (0, 0, before, after, before, after))
    n, hp, wp, _ = xp.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    taps = [
        xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride, :]
        for ky in range(k) for kx in range(k)
    ]
    return torch.stack(taps, dim=3).reshape(n, ho, wo, k * k * xq.shape[-1])


def int8_conv_s32(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad=None) -> torch.Tensor:
    """s8 NHWC input times s8 weights [Cout, k, k, Cin] -> s32 [N, Ho, Wo, Cout]."""
    cols = im2col(xq, wq.shape[1], stride, pad)
    n, ho, wo, depth = cols.shape
    acc = int8_matmul(cols.reshape(n * ho * wo, depth), wq.reshape(wq.shape[0], depth))
    return acc.reshape(n, ho, wo, wq.shape[0])


def residual_relu(out: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    return torch.relu(out.to(torch.float32) + residual.to(torch.float32)).to(_BF16)


def int8_conv_bn_plain(x, wq, ws, scale, bias, act_scale, residual=None, stride: int = 1,
                       pad: Optional[Sequence[int]] = None, relu: bool = True) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch: x NHWC (bf16) -> bf16 NHWC."""
    acc = int8_conv_s32(quant_act(x, act_scale), wq, stride, pad)
    y = acc.to(torch.float32) * (act_scale * ws * scale) + bias
    if relu:
        y = torch.relu(y)
    y = y.to(_BF16)
    return y if residual is None else residual_relu(y, residual)


# ----------------------------------------------------------------- the plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def out_hw(h: int, w: int, k: int, stride: int, pad: Sequence[int]) -> Tuple[int, int]:
    return (h + pad[0] + pad[1] - k) // stride + 1, (w + pad[0] + pad[1] - k) // stride + 1


def tile_n_for(cout: int) -> int:
    """The Cout tile: one A tile serves the whole Cout up to 256."""
    return 64 if cout <= 64 else 128 if cout <= 128 else 256


class ConvPlan(NamedTuple):
    """csrc/int8_conv.cu's ``Plan``, field for field (flattened to int64 in
    this order).  dims are innermost first, strides in bytes of dims 1-3."""
    im2col: int  # 1: the pre-pass gathers the taps (Cin < IM2COL_BELOW)
    n: int
    h: int
    w: int
    cin: int
    ho: int
    wo: int
    cout: int
    k: int
    stride: int
    pad: int  # before; the pad after is the zero fill past x's end
    cin_a: int  # channels of q (x's padded to CIN_ALIGN, or the gathered taps')
    gk: int  # the product's taps over q: k, stride, pad
    gstride: int
    gpad: int
    gn: int  # the product's pixel grid: images, rows, columns
    gh: int
    gw: int
    tile_n: int
    kc: int  # K chunk: 128 bytes of channels
    chunks: int  # K chunks a tap
    bw: int  # pixel box: bw columns x rows x imgs images, at most TILE_M pixels
    rows: int
    imgs: int
    j_tiles: int
    i_tiles: int
    n_tiles: int
    tiles: int  # pixel tiles x Cout tiles
    a_bytes: int
    relu: int
    a_dims: Tuple[int, ...]
    a_strides: Tuple[int, ...]
    a_box: Tuple[int, ...]
    a_estr: Tuple[int, ...]
    b_dims: Tuple[int, ...]
    b_strides: Tuple[int, ...]
    b_box: Tuple[int, ...]

    def flat(self) -> List[int]:
        out: List[int] = []
        for v in self:
            out.extend(v if isinstance(v, tuple) else (v,))
        return out

    @property
    def q_shape(self) -> Tuple[int, ...]:
        """The pre-pass's s8 buffer."""
        if self.im2col:
            return (self.n * self.ho * self.wo, self.cin_a)
        return (self.n, self.h, self.w, self.cin_a)

    @property
    def taps(self) -> int:
        return self.gk * self.gk


PLAN_LEN = 56  # int64s of csrc/int8_conv.cu's Plan; the C entry point checks it


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, stride: int,
              pad_before: int, pad_after: int, relu: bool) -> ConvPlan:
    """K5's plan for x [n, h, w, cin] and weights [cout, k, k, cin].

    q is x quantized, channels padded to CIN_ALIGN; for Cin under
    IM2COL_BELOW it is the k x k taps gathered a pixel, [n*ho*wo,
    k*k*cin padded].  A tile is TILE_M output pixels -- a box of whole rows
    (imgs images x rows rows x bw columns) -- by ``tile_n`` channels; its K
    loop walks the taps x ``chunks`` chunks of 128 channels.  The A map
    spans q as [C, W, H, N] with element strides (1, s, s, 1), its box
    (128, bw*s, rows*s, imgs): tap (ky, kx) of the tile at output (i0, j0)
    starts at (i0*s + ky - pad, j0*s + kx - pad), and TMA reads zeros
    outside q, which is the pad, the ragged tile and the channel tail.  A
    1 x 1 stride-1 conv and a gathered q are one row of all pixels.  The B
    map spans the weights [Cin_pad, k*k (1 gathered), Cout], box (128, 1,
    tile_n)."""
    ho, wo = out_hw(h, w, k, stride, (pad_before, pad_after))
    gathered = cin < IM2COL_BELOW
    if gathered:
        cin_a = _cdiv(k * k * cin, CIN_ALIGN) * CIN_ALIGN
        gk, gs, gp = 1, 1, 0
        gn, gh, gw = 1, 1, n * ho * wo
        a_dims = (cin_a, gw, 1, 1)
    else:
        cin_a = _cdiv(cin, CIN_ALIGN) * CIN_ALIGN
        if k == 1 and stride == 1 and pad_before == pad_after == 0:
            gk, gs, gp = 1, 1, 0
            gn, gh, gw = 1, 1, n * h * w
            a_dims = (cin_a, gw, 1, 1)
        else:
            gk, gs, gp = k, stride, pad_before
            gn, gh, gw = n, ho, wo
            a_dims = (cin_a, w, h, n)
    kc = ROW_BYTES
    bw = min(gw, TILE_M)
    rows = min(gh, TILE_M // bw)
    imgs = min(gn, TILE_M // (bw * gh)) if rows == gh else 1
    j_tiles, i_tiles, img_tiles = _cdiv(gw, bw), _cdiv(gh, rows), _cdiv(gn, imgs)
    tile_n = tile_n_for(cout)
    n_tiles = _cdiv(cout, tile_n)
    taps = gk * gk
    return ConvPlan(
        int(gathered), n, h, w, cin, ho, wo, cout, k, stride, pad_before, cin_a,
        gk, gs, gp, gn, gh, gw, tile_n, kc, _cdiv(cin_a, kc),
        bw, rows, imgs, j_tiles, i_tiles, n_tiles, img_tiles * i_tiles * j_tiles * n_tiles,
        kc * bw * rows * imgs, int(relu),
        a_dims, (cin_a, a_dims[1] * cin_a, a_dims[1] * a_dims[2] * cin_a),
        (kc, bw * gs, rows * gs, imgs), (1, gs, gs, 1),
        (cin_a, taps, cout, 1), (cin_a, taps * cin_a, taps * cin_a * cout), (kc, 1, tile_n, 1),
    )


def tile_coords(plan: ConvPlan, tile: int) -> Tuple[int, int, int, int]:
    """Tile index -> (first image, first row, first column, first output
    channel) of the product's grid, the Cout tile fastest (csrc/int8_conv.cu
    tile_coords)."""
    nt, mt = tile % plan.n_tiles, tile // plan.n_tiles
    jb, rest = mt % plan.j_tiles, mt // plan.j_tiles
    ib, nb = rest % plan.i_tiles, rest // plan.i_tiles
    return nb * plan.imgs, ib * plan.rows, jb * plan.bw, nt * plan.tile_n


def pack_weight(wq: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The weights as the B map reads them: wq [Cout, k, k, Cin] itself when
    Cin is a multiple of CIN_ALIGN (every conv but the stems), else with Cin
    (gathered: k*k*Cin) zero-padded to the plan's cin_a."""
    if plan.im2col:
        wq = wq.reshape(wq.shape[0], -1)
    pad = plan.cin_a - wq.shape[-1]
    return F.pad(wq, (0, pad)).contiguous() if pad else wq


# ----------------------------------------------------------------- the kernel


def _check(x, wq, ws, scale, bias, act_scale, residual, stride, pad) -> None:
    if x.dim() != 4 or wq.dim() != 4 or wq.shape[1] != wq.shape[2] or x.shape[3] != wq.shape[3]:
        raise ValueError("int8_conv_bn expects x [N, H, W, Cin] and s8 weights [Cout, k, k, Cin], "
                         "got %s and %s" % (tuple(x.shape), tuple(wq.shape)))
    if wq.dtype != torch.int8:
        raise TypeError("int8_conv_bn takes s8 weights, got %s" % wq.dtype)
    cout = wq.shape[0]
    for v in (ws, scale, bias):
        if v.dim() != 1 or v.numel() != cout:
            raise ValueError("int8_conv_bn: per-channel operands must be [%d], got %s"
                             % (cout, tuple(v.shape)))
    if torch.as_tensor(act_scale).numel() != 1:
        raise ValueError("int8_conv_bn: the activation scale is one value")
    if stride not in (1, 2) or len(pad) != 2 or min(pad) < 0:
        raise ValueError("int8_conv_bn: stride 1 or 2 and two pads, got %s and %s" % (stride, pad))
    if residual is not None:
        ho, wo = out_hw(x.shape[1], x.shape[2], wq.shape[1], stride, pad)
        if tuple(residual.shape) != (x.shape[0], ho, wo, cout):
            raise ValueError("int8_conv_bn: the residual must be [%d, %d, %d, %d], got %s"
                             % (x.shape[0], ho, wo, cout, tuple(residual.shape)))


def _check_cuda(x, wq, ws, scale, bias, act_scale, residual) -> None:
    """What the kernel takes: everything on x's card, bf16 activations
    (16-byte aligned, contiguous), Cin a multiple of 8 (or under 16), Cout a
    multiple of 8, float32 per-channel operands and scale."""
    name = "int8_conv_bn kernel"
    operands = [wq, ws, scale, bias, act_scale] + ([residual] if residual is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError("%s: the operands lie on %s, x on %s"
                         % (name, [str(t.device) for t in operands], x.device))
    if x.dtype != _BF16 or (residual is not None and residual.dtype != _BF16):
        raise TypeError("%s takes bf16 activations, got %s" % (name, x.dtype))
    cin, cout = x.shape[3], wq.shape[0]
    if (cin % 8 and cin >= IM2COL_BELOW) or cout % 8:
        raise ValueError("%s needs Cin and Cout multiples of 8, got %d and %d" % (name, cin, cout))
    for t in [x, wq] + ([residual] if residual is not None else []):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s needs contiguous, 16-byte aligned tensors" % name)
    for t in (ws, scale, bias, act_scale):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s: scales and folds must be contiguous float32" % name)


@functools.lru_cache(maxsize=None)
def _plan_arg(plan: ConvPlan):
    return (ctypes.c_longlong * PLAN_LEN)(*plan.flat())


def launch(x, wq, ws, scale, bias, act_scale, residual, stride: int, pad: Sequence[int],
           relu: bool) -> torch.Tensor:
    """Launch K5 (the pre-pass, then the product); the operator's CUDA
    kernel (kernels/ops.py) counts the launch."""
    _check_cuda(x, wq, ws, scale, bias, act_scale, residual)
    n, h, w, cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    ho, wo = out_hw(h, w, k, stride, pad)
    out = torch.empty((n, ho, wo, cout), dtype=_BF16, device=x.device)
    if out.numel() == 0:
        return out
    plan = conv_plan(n, h, w, cin, cout, k, stride, pad[0], pad[1], bool(relu))
    q = torch.empty(plan.q_shape, dtype=torch.int8, device=x.device)
    wpk = pack_weight(wq, plan)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mval_int8_conv_bn(
            x.data_ptr(), q.data_ptr(), wpk.data_ptr(), act_scale.data_ptr(), ws.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), _plan_arg(plan), PLAN_LEN, stream)
    _build.check(code, "K5")
    return out


def int8_conv_bn(x, wq, ws, scale, bias, act_scale, residual=None, stride: int = 1,
                 pad: Optional[Sequence[int]] = None, relu: bool = True) -> torch.Tensor:
    """The int8 conv unit: x [N, H, W, Cin] bf16 NHWC, wq [Cout, k, k, Cin]
    s8 with per-Cout scales ws, scale / bias [Cout] (folded BN), act_scale
    the per-tensor activation scale (a float32 scalar tensor on x's device,
    static or dynamic), an optional residual [N, Ho, Wo, Cout] bf16, stride
    1 or 2, pad (before, after) on both spatial axes (default k // 2) ->
    bf16 [N, Ho, Wo, Cout].  A CPU tensor takes the plain twin; a CUDA
    tensor launches K5 or raises."""
    k = wq.shape[1]
    pad = (k // 2, k // 2) if pad is None else (int(pad[0]), int(pad[1]))
    _check(x, wq, ws, scale, bias, act_scale, residual, stride, pad)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError("int8_conv_bn has no path for device %s" % x.device)
    act_scale = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(())
    return torch.ops.mval.int8_conv_bn(x, wq, ws, scale, bias, act_scale, residual, int(stride),
                                       pad[0], pad[1], bool(relu))


int8_conv_bn.launches = 0
