"""K1: fused heatmap decode (``csrc/decode.cu``) and its plain version.

Replaces ops/pallas/decode.py::fused_decode of the JAX package.  One pass
over [M, h*w] heatmap rows yields the hard argmax (first index on ties),
the peak value and the soft-argmax, packed as [M, 8] rows
(x, y, peak, soft_x, soft_y, 0, 0, 0) with the stride applied.

``launch_plan`` is the kernel's launch geometry, computed here and passed
to C: whether the rows can be streamed into shared memory by bulk copies
(16-byte aligned rows of a multiple of 16 bytes that fit) and reduced by a
block each, several blocks per SM with an equal contiguous share of the
rows, or take the kernel's scalar path, one warp per row.  The wrapper
calls the registered operator ``torch.ops.mval.fused_decode``
(kernels/ops.py): a CPU tensor goes to ``fused_decode_plain``; a CUDA
tensor launches the kernel (``launch``) or raises.
``fused_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple, Union

import torch

from . import _build

OUT_COLS = 8
BULK_WARPS = 4  # csrc/decode.cu kBulkWarps: bulk path, warps on a row at most
HELD = 8  # csrc/decode.cu kHeld: float4s a bulk-path thread holds in registers
RAGGED_WARPS = 8  # csrc/decode.cu kRaggedWarps: scalar path, warps a block, one row each
BULK_MIN_BLOCKS = 6  # csrc/decode.cu kBulkMinBlocks: resident BULK_WARPS-warp blocks (registers)
WAVES = 3  # bulk path: the grid is this many rounds of the resident blocks
STATIC_SMEM = 128  # csrc/decode.cu Partials and the mbarrier, with the compiler's padding
SMEM_BLOCK = 232448  # shared memory one block may use on Hopper (227 KB)
SMEM_SM = 233472  # shared memory of one SM (228 KB); 1 KB of it is reserved per block
WARPS_SM = 64  # resident warps per SM
BLOCKS_SM = 32  # resident blocks per SM


class DecodePlan(NamedTuple):
    """csrc/decode.cu's ``Plan``, field for field (flattened to int64 in
    this order)."""
    m: int
    hw: int
    width: int
    row_stride: int  # floats between rows
    grid: int  # blocks
    warps: int  # warps per block: on one row (bulk), one row each (scalar)
    smem_bytes: int  # dynamic shared memory per block: the staged row (bulk)
    bulk: int  # 1: rows by bulk copy into shared memory; 0: the scalar path


PLAN_LEN = len(DecodePlan._fields)


def launch_plan(m: int, hw: int, width: int, row_stride: int, ptr: int,
                sm_count: int) -> DecodePlan:
    """K1's launch geometry for ``m`` rows of ``hw`` floats, ``row_stride``
    floats apart from byte address ``ptr``, on a card of ``sm_count`` SMs.

    A bulk copy needs a 16-byte aligned source and a size that is a
    multiple of 16 bytes, so the bulk path needs an aligned base, row
    stride and row length, and room for the one row a block stages (a
    block's next row is copied in once its threads hold the current one in
    registers, or once they are done with it).  A block then puts
    enough warps on a row for its threads to hold it in registers (HELD
    float4s a thread, at most BULK_WARPS warps; a longer row's rest is read
    twice from shared memory).  The grid is WAVES rounds of the blocks that
    fit on the card at once (by warps, shared memory and registers), at
    most one block per row; each block takes an equal contiguous share of
    the rows.  At the bench shape that is one row per block (three rounds
    of six a SM; on the card this ran faster than three-row blocks holding
    two rows in flight each).  Otherwise the scalar path:
    RAGGED_WARPS warps a block, one row each, as many blocks as fit on the
    card and the rows need."""
    row_bytes = 4 * hw
    aligned = ptr % 16 == 0 and (4 * row_stride) % 16 == 0 and row_bytes % 16 == 0
    if aligned and row_bytes + STATIC_SMEM <= SMEM_BLOCK:
        warps = min(BULK_WARPS, max(1, -(-hw // (4 * HELD * 32))))
        per_sm = min(WARPS_SM // warps, SMEM_SM // (row_bytes + STATIC_SMEM + 1024), BLOCKS_SM,
                     BULK_MIN_BLOCKS * BULK_WARPS // warps)
        grid = max(1, min(sm_count * per_sm * WAVES, m))
        return DecodePlan(m, hw, width, row_stride, grid, warps, row_bytes, 1)
    grid = max(1, min(sm_count * (WARPS_SM // RAGGED_WARPS), -(-m // RAGGED_WARPS)))
    return DecodePlan(m, hw, width, row_stride, grid, RAGGED_WARPS, 0, 0)


def plan_for(heatmaps_flat: torch.Tensor, width: int) -> DecodePlan:
    """``launch_plan`` for [M, h*w] rows on a card, as the wrapper launches
    them."""
    m, hw = heatmaps_flat.shape
    return launch_plan(m, hw, width, heatmaps_flat.stride(0) if m > 1 else hw,
                       heatmaps_flat.data_ptr(), _build.sm_count(heatmaps_flat.device))


def rows_of_block(plan: DecodePlan, block: int) -> List[int]:
    """Bulk path: the rows one block decodes, in order: an equal contiguous
    share, the first m % grid blocks one row more
    (csrc/decode.cu::decode_bulk_kernel)."""
    q, rem = divmod(plan.m, plan.grid)
    first = block * q + min(block, rem)
    return list(range(first, first + q + (block < rem)))


def rows_of_warp(plan: DecodePlan, block: int, warp: int) -> List[int]:
    """Scalar path: the rows one warp decodes, in order (a grid stride,
    csrc/decode.cu::decode_ragged_kernel)."""
    return list(range(block * plan.warps + warp, plan.m, plan.grid * plan.warps))


def fused_decode_plain(
    heatmaps_flat: torch.Tensor, width: int, stride: float
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [M, h*w] -> packed [M, 8]."""
    m, hw = heatmaps_flat.shape
    idx = torch.argmax(heatmaps_flat, dim=-1)  # first maximum
    peak = torch.gather(heatmaps_flat, 1, idx[:, None])[:, 0]
    x = (idx % width).to(torch.float32) * stride
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32) * stride
    e = torch.exp(heatmaps_flat - peak[:, None])
    s = torch.sum(e, dim=-1)
    cols = torch.arange(hw, device=heatmaps_flat.device)
    xs = (cols % width).to(torch.float32)
    ys = torch.div(cols, width, rounding_mode="floor").to(torch.float32)
    soft_x = torch.sum(e * xs, dim=-1) / s * stride
    soft_y = torch.sum(e * ys, dim=-1) / s * stride
    zero = torch.zeros_like(x)
    return torch.stack([x, y, peak, soft_x, soft_y, zero, zero, zero], dim=-1)


def launch(heatmaps_flat: torch.Tensor, width: int, stride: float) -> torch.Tensor:
    """Launch K1 on [M, h*w] float32 rows on a card: the launch plan from
    the tensor's address, strides and the card's SMs, then the packed
    [M, 8] result.  Raises on what the kernel does not take and on a
    refused launch.  Counts nothing: ``torch.ops.mval.fused_decode``'s
    CUDA kernel (kernels/ops.py) counts its launches."""
    m, hw = heatmaps_flat.shape
    if hw == 0:
        raise ValueError("fused_decode needs rows of at least one value")
    if m > 1 and hw > 1 and heatmaps_flat.stride(1) != 1:
        raise ValueError("fused_decode needs rows of unit stride")
    plan = plan_for(heatmaps_flat, width)
    plan_arg = (ctypes.c_longlong * PLAN_LEN)(*plan)
    device = heatmaps_flat.device
    packed = torch.empty((m, OUT_COLS), dtype=torch.float32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.mval_fused_decode(
            heatmaps_flat.data_ptr(), packed.data_ptr(), plan_arg, PLAN_LEN,
            float(stride), stream,
        )
    _build.check(code, "mval_fused_decode")
    return packed


def fused_decode(
    heatmaps_flat: torch.Tensor, width: int, stride: float
) -> Dict[str, torch.Tensor]:
    """[M, h*w] float32 rows -> {"coords" [M, 2], "peak" [M],
    "soft_coords" [M, 2]}, views of one packed [M, 8] result, through
    ``torch.ops.mval.fused_decode`` (kernels/ops.py): the plain version on
    a CPU tensor, K1 on a CUDA tensor, and a traced call in an exported
    graph."""
    if heatmaps_flat.dim() != 2:
        raise ValueError("expected [M, h*w] heatmaps, got %s" % (tuple(heatmaps_flat.shape),))
    hw = heatmaps_flat.shape[1]
    if width <= 0 or hw % width:
        raise ValueError("row length %d is not a multiple of width %d" % (hw, width))
    if heatmaps_flat.dtype != torch.float32:
        raise TypeError("fused_decode takes float32 heatmaps, got %s" % heatmaps_flat.dtype)
    if heatmaps_flat.device.type not in ("cpu", "cuda"):
        raise RuntimeError("fused_decode has no path for device %s" % heatmaps_flat.device)
    packed = torch.ops.mval.fused_decode(heatmaps_flat, width, float(stride))
    return {
        "coords": packed[:, 0:2],
        "peak": packed[:, 2],
        "soft_coords": packed[:, 3:5],
    }


fused_decode.launches = 0


def decode_keypoints(
    heatmaps: torch.Tensor,
    stride: float,
    valid: torch.Tensor,
    use_soft_argmax: bool = False,
    with_peak: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """[..., K, h, w] -> keypoints [..., K, 2] through one fused decode.

    Invalid joints (`valid` [..., K] False) decode to (0, 0) like the
    reference (utils/evaluation.py:21-23).  `with_peak=True` also returns the
    per-map peak [..., K] that the same pass computed."""
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(-1, h * w).to(torch.float32)
    out = fused_decode(flat, w, stride)
    coords = (out["soft_coords"] if use_soft_argmax else out["coords"]).reshape(lead + (2,))
    coords = torch.where(valid[..., None], coords, torch.zeros_like(coords))
    if with_peak:
        return coords, out["peak"].reshape(lead)
    return coords
