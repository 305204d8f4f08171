"""K2: min distance to masked centers (``csrc/pairwise.cu``) and its plain
version.

Replaces ops/pallas/pairwise.py::min_distance_to_centers of the JAX
package, the initial sweep of k-center-greedy coreset selection.  Held to
the plain version's semantics (ops/coreset.py::_min_dist_to_centers of the
JAX package): +inf where no center is set.

``launch_plan`` is the kernel's launch geometry, computed here and passed
to C: clusters of ``cluster`` CTAs, each cluster owning ROWS pool rows and
each rank a ``rank_slice`` of every compacted mask chunk, reduced in tiles
of TILE centers, the feature axis walked in ``k_steps`` pieces of
``k_width`` floats (``k_pieces``), so any feature width fits.  A CPU tensor
goes to ``min_distance_to_centers_plain``; a CUDA tensor launches the
kernel or raises (a cluster launch the CUDA runtime refuses raises too).
``min_distance_to_centers.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from . import _build

CHUNK = 1024  # centers per step of the plain version
ROWS = 32  # csrc/pairwise.cu kRows: pool rows per cluster, one per lane
WARPS = 4  # csrc/pairwise.cu kWarps
GROUP = 16  # csrc/pairwise.cu kGroup: centers per warp step
TILE = WARPS * GROUP  # csrc/pairwise.cu kTile: centers per staged tile, one group a warp
SCAN = WARPS * 32 * 16  # mask entries per compaction pass (16 per thread)
MASK_CHUNK = SCAN  # mask entries compacted at a time (a small list leaves room for more CTAs an SM)
# Feature-axis floats staged a step when a row is wider: 60,944 bytes of
# shared memory a CTA, so three fit an SM and a grid of clusters of four
# still fits one wave (at 128 floats, 112 KB a CTA, it did not).
K_WIDTH = 64
MAX_CLUSTER = 8  # the portable cluster size
CTAS_PER_SM = 2  # a small pool is split across the cluster until the grid fills this
SMEM_BLOCK = 232448  # shared memory one block may use on Hopper (227 KB)


class DistancePlan(NamedTuple):
    """csrc/pairwise.cu's ``Plan``, field for field (flattened to int64 in
    this order)."""
    n: int
    d: int
    row_blocks: int  # clusters, ROWS pool rows each
    cluster: int  # CTAs per cluster: the ranks that split the centers
    grid: int  # row_blocks * cluster CTAs
    chunk: int  # mask entries compacted at a time, a multiple of SCAN
    center_tile: int  # centers staged at a time: TILE
    tile_stride: int  # floats between the k-rows of a staged [k_width][tile] tile
    k_width: int  # feature-axis floats staged a step: d, or K_WIDTH when d is wider
    k_steps: int  # steps over the feature axis per tile
    smem_bytes: int


PLAN_LEN = len(DistancePlan._fields)


def _smem_bytes(k_width: int, chunk: int) -> int:
    """Dynamic shared memory of csrc/pairwise.cu: two step buffers of rows
    [k_width][ROWS] and centers [k_width][TILE + 4], the warps' partial
    minima, the ranks' minima (rank 0's), the scan's warp sums and the
    compacted list.  It does not grow with d past K_WIDTH."""
    floats = 2 * k_width * (ROWS + TILE + 4) + WARPS * ROWS + MAX_CLUSTER * ROWS
    return 4 * (floats + WARPS + chunk)


def launch_plan(n: int, d: int, sm_count: int) -> DistancePlan:
    """K2's launch geometry for a [n, d] pool on a card of ``sm_count`` SMs.

    Clusters of ROWS rows; a pool of few row blocks is split across up to
    MAX_CLUSTER ranks (powers of two) until the grid holds about
    CTAS_PER_SM CTAs per SM.  A row of up to K_WIDTH floats is staged
    whole, once; a wider one in pieces of K_WIDTH, so shared memory stays
    under SMEM_BLOCK at every width."""
    if d < 1:
        raise ValueError("feature width must be at least 1, got %d" % d)
    row_blocks = -(-n // ROWS)
    cluster = 1
    while cluster < MAX_CLUSTER and row_blocks * cluster * 2 <= CTAS_PER_SM * sm_count:
        cluster *= 2
    chunk = min(MASK_CHUNK, max(SCAN, -(-n // SCAN) * SCAN))
    k_width = min(d, K_WIDTH)
    return DistancePlan(n, d, row_blocks, cluster, row_blocks * cluster, chunk, TILE, TILE + 4,
                        k_width, -(-d // k_width), _smem_bytes(k_width, chunk))


def k_pieces(plan: DistancePlan) -> List[Tuple[int, int]]:
    """[k0, k1) of each step over the feature axis, in the kernel's order
    (k ascending, so each chain is the unchunked fmaf chain)."""
    return [(k0, min(k0 + plan.k_width, plan.d)) for k0 in range(0, plan.d, plan.k_width)]


def rank_slice(count: int, cluster: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of a chunk's ``count`` compacted centers that cluster rank
    ``rank`` takes (csrc/pairwise.cu): equal contiguous slices."""
    return count * rank // cluster, count * (rank + 1) // cluster


def min_distance_to_centers_plain(
    features: torch.Tensor, center_mask: torch.Tensor
) -> torch.Tensor:
    """min over masked centers c of ||x - c|| for every row x, swept over
    center chunks so no [n, n] matrix exists.

    features: [n, d] float32; center_mask: [n] bool -> [n] float32.
    """
    sq = torch.sum(features * features, dim=-1)  # [n]
    min_d2 = torch.full_like(sq, float("inf"))
    for start in range(0, features.shape[0], CHUNK):
        c = features[start:start + CHUNK]
        csq = sq[start:start + CHUNK]
        cmask = center_mask[start:start + CHUNK]
        d2 = sq[:, None] + csq[None, :] - 2.0 * features @ c.T  # [n, chunk]
        d2 = torch.where(cmask[None, :], torch.clamp(d2, min=0.0), float("inf"))
        min_d2 = torch.minimum(min_d2, torch.min(d2, dim=-1).values)
    return torch.sqrt(min_d2)


def min_distance_to_centers(
    features: torch.Tensor, center_mask: torch.Tensor
) -> torch.Tensor:
    """features [n, d] float32, center_mask [n] bool -> [n] float32."""
    if features.dim() != 2 or center_mask.shape != features.shape[:1]:
        raise ValueError(
            "expected features [n, d] and mask [n], got %s and %s"
            % (tuple(features.shape), tuple(center_mask.shape))
        )
    if features.dtype != torch.float32 or center_mask.dtype != torch.bool:
        raise TypeError(
            "expected float32 features and a bool mask, got %s and %s"
            % (features.dtype, center_mask.dtype)
        )
    if center_mask.device != features.device:
        raise ValueError("features and mask lie on different devices")
    device = features.device
    if device.type == "cpu":
        return min_distance_to_centers_plain(features, center_mask)
    if device.type != "cuda":
        raise RuntimeError("min_distance_to_centers has no path for device %s" % device)
    n, d = features.shape
    if d < 1:
        raise ValueError("min_distance_to_centers needs features at least 1 wide")
    if not (features.is_contiguous() and center_mask.is_contiguous()):
        raise ValueError("min_distance_to_centers needs contiguous inputs")
    plan = launch_plan(n, d, _build.sm_count(device))
    plan_arg = (ctypes.c_longlong * PLAN_LEN)(*plan)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.mval_min_distance_to_centers(
            features.data_ptr(), center_mask.data_ptr(), out.data_ptr(), plan_arg, PLAN_LEN,
            stream,
        )
    _build.check(code, "mval_min_distance_to_centers")
    min_distance_to_centers.launches += 1
    return out


min_distance_to_centers.launches = 0
