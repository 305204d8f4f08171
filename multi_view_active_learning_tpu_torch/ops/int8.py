"""s8 x s8 -> s32 matrix product through ``torch._int_mm``.

On the card ``_int_mm`` needs more than 16 rows and a depth and width that
are multiples of 8; this pads the operands with zeros (which add nothing to
the exact integer sums) so any shape goes through, on either device.  A
symbolic row count (a ``torch.export`` batch dimension) always gets the
row padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 17


def int8_matmul(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """a [M, K] s8 times b_nk [N, K] s8, transposed -> [M, N] s32, exact."""
    m, k = a.shape
    n = b_nk.shape[0]
    pad_k, pad_n = (-k) % 8, (-n) % 8
    if isinstance(m, torch.SymInt):
        # A symbolic row count (an exported batch dimension) may be below
        # the limit at some batch sizes and above it at others: pad always.
        pad_m = _MIN_ROWS
    else:
        pad_m = max(0, _MIN_ROWS - m)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b_nk = F.pad(b_nk, (0, pad_k, 0, pad_n))
    # Row-major a times a column-major b: the layout cuBLAS takes for s8.
    out = torch._int_mm(a.contiguous(), b_nk.contiguous().t())
    return out[:m, :n] if (pad_m or pad_n) else out
