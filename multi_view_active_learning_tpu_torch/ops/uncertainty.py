"""Active-learning uncertainty metrics, batched on the device.

Port of the JAX package's ops/uncertainty.py (reference:
strategy.py:1149-1215) over heatmaps in the port's layout [B, V, K, h, w]:

  * MPE -- multi-peak entropy: local peaks -> softmax over the peak values
    -> entropy (reference: strategy.py:1160-1176);
  * HP  -- highest probability: 1 - max of the row-softmaxed heatmap
    (reference: strategy.py:1178-1193);
  * BSB -- best-vs-second-best: |p0 - p1| of the two highest local peaks
    of the row-softmaxed heatmap (reference: strategy.py:1195-1215).

Peak finding is skimage.feature.peak_local_max(min_distance=2) at 0.19.3,
as the JAX package pins it (tests/oracle_ports.py): a point is a peak iff
it equals the (2d+1)^2 max filter (padded with -inf), lies strictly above
the map's minimum and at least `min_distance` from the border; then
skimage's ``ensure_spacing`` greedily thins candidates closer than
`min_distance`, which among the equal-valued plateau candidates it can
touch is row-major order (``_thin_plateaus``).

Softmax quirk kept from the reference: F.softmax on a 2D map without `dim`
is a softmax over each row, so HP and BSB softmax over `w` only.

AVG / STD aggregate over the valid (view, joint) entries; STD is the
population std, as the reference's numpy default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
AGGREGATES = ("AVG", "STD")


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x[..., i, j] -> x[..., i + dy, j + dx], `fill` outside bounds."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    out[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        x[..., max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def _thin_plateaus(cand: torch.Tensor, min_distance: int) -> torch.Tensor:
    """skimage 0.19.3 ``ensure_spacing`` over a candidate-peak mask.

    A candidate is accepted once every row-major-earlier candidate within
    Chebyshev distance < min_distance is rejected, and rejected once any of
    them is accepted; a rejected point rejects nothing.  The JAX package
    iterates this to a fixpoint in a ``lax.while_loop``; here each pass ends
    in one host sync on whether anything changed.  A pass that changes
    something decides at least one candidate, so h * w + 1 passes bound the
    loop for any map; reaching the bound raises."""
    earlier = [
        (dy, dx)
        for dy in range(-(min_distance - 1), min_distance)
        for dx in range(-(min_distance - 1), min_distance)
        if (dy, dx) != (0, 0) and (dy < 0 or (dy == 0 and dx < 0))
    ]
    if not earlier:
        return cand
    acc = torch.zeros_like(cand)
    rej = torch.zeros_like(cand)
    for _ in range(cand.shape[-2] * cand.shape[-1] + 1):
        live = cand & ~rej
        unrejected_earlier = torch.zeros_like(cand)
        accepted_earlier = torch.zeros_like(cand)
        for dy, dx in earlier:
            unrejected_earlier |= _shift2d(live, dy, dx, False)
            accepted_earlier |= _shift2d(acc, dy, dx, False)
        new_acc = acc | (live & ~unrejected_earlier)
        new_rej = rej | (cand & accepted_earlier)
        changed = bool(torch.any(new_acc != acc) | torch.any(new_rej != rej))
        acc, rej = new_acc, new_rej
        if not changed:
            return acc
    raise RuntimeError("plateau thinning did not reach its fixpoint")


def local_peak_mask(heatmaps: torch.Tensor, min_distance: int = 2) -> torch.Tensor:
    """Boolean mask of local maxima over the trailing (h, w) axes:
    [..., h, w] -> bool [..., h, w], skimage 0.19.3 peak_local_max's set."""
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    maxf = F.max_pool2d(heatmaps.reshape(-1, 1, h, w), 2 * min_distance + 1, stride=1,
                        padding=min_distance).reshape(heatmaps.shape)
    lowest = torch.amin(heatmaps, dim=(-2, -1), keepdim=True)
    is_peak = (heatmaps == maxf) & (heatmaps > lowest)
    ys = torch.arange(h, device=heatmaps.device)
    xs = torch.arange(w, device=heatmaps.device)
    interior = (((ys >= min_distance) & (ys < h - min_distance))[:, None]
                & ((xs >= min_distance) & (xs < w - min_distance))[None, :])
    return _thin_plateaus(is_peak & interior, min_distance)


def _row_softmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """torch F.softmax(x) on a 2D map without `dim`: a softmax over rows."""
    return torch.softmax(heatmaps, dim=-1)


def _masked_entropy(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Entropy of the softmax over `values` restricted to `mask`, over the
    trailing two axes: [..., h, w] -> [...]."""
    flat_v = values.reshape(values.shape[:-2] + (-1,))
    flat_m = mask.reshape(mask.shape[:-2] + (-1,))
    p = torch.softmax(torch.where(flat_m, flat_v, _NEG_INF), dim=-1)
    logp = torch.where(flat_m & (p > 0), torch.log(torch.clamp(p, min=1e-38)), 0.0)
    return -torch.sum(p * logp, dim=-1)


def _aggregate(per_vk: torch.Tensor, valid: torch.Tensor, aggregate: str) -> torch.Tensor:
    """AVG or STD over valid (view, joint) entries: per_vk [B, V, K],
    valid [B, K] -> [B]."""
    if aggregate not in AGGREGATES:
        raise ValueError("aggregate must be AVG or STD, got %s" % aggregate)
    mask = valid[:, None, :].expand(per_vk.shape).to(torch.float32)
    n = torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0)
    mean = torch.sum(per_vk * mask, dim=(1, 2)) / n
    if aggregate == "AVG":
        return mean
    var = torch.sum(torch.square(per_vk - mean[:, None, None]) * mask, dim=(1, 2)) / n
    return torch.sqrt(var)


def _valid(valid_joints, heatmaps: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(valid_joints, device=heatmaps.device).to(torch.bool)


def multi_peak_entropy(heatmaps: torch.Tensor, valid_joints, aggregate: str = "AVG",
                       min_distance: int = 2) -> torch.Tensor:
    """MPE scores: heatmaps [B, V, K, h, w], valid [B, K] -> [B]."""
    peaks = local_peak_mask(heatmaps, min_distance)
    return _aggregate(_masked_entropy(heatmaps, peaks), _valid(valid_joints, heatmaps), aggregate)


def highest_probability(heatmaps: torch.Tensor, valid_joints,
                        aggregate: str = "AVG") -> torch.Tensor:
    """HP scores: 1 - max of the row-softmaxed heatmap, aggregated -> [B]."""
    hp = 1.0 - torch.amax(_row_softmax(heatmaps), dim=(-2, -1))  # [B, V, K]
    return _aggregate(hp, _valid(valid_joints, heatmaps), aggregate)


def best_vs_second_best(heatmaps: torch.Tensor, valid_joints, aggregate: str = "AVG",
                        min_distance: int = 2) -> torch.Tensor:
    """BSB scores: |p0 - p1| of the two strongest local peaks of the
    row-softmaxed heatmap, aggregated over valid (view, joint) -> [B]."""
    probs = _row_softmax(heatmaps)
    peaks = local_peak_mask(probs, min_distance)
    flat_p = probs.reshape(probs.shape[:-2] + (-1,))
    flat_m = peaks.reshape(peaks.shape[:-2] + (-1,))
    top2 = torch.topk(torch.where(flat_m, flat_p, _NEG_INF), 2, dim=-1).values  # [B, V, K, 2]
    # A map with one peak or none (the reference would IndexError there):
    # the missing peak reads as probability 0.
    first = torch.where(top2[..., 0] <= _NEG_INF / 2, 0.0, top2[..., 0])
    second = torch.where(top2[..., 1] <= _NEG_INF / 2, 0.0, top2[..., 1])
    return _aggregate(torch.abs(first - second), _valid(valid_joints, heatmaps), aggregate)

