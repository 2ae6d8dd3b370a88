"""Visibility-guided probabilistic label assignment, batched over images on
the device (port of ``radet_tpu/core/assignment.py``).

The host supplies, per GT, the distance-map value at each anchor center
(``dist_vals``, (B, N, G); with GT masks the map is the binary visible
mask).  Per image and GT:

- candidacy: anchor center strictly inside the GT box (min TBLR side > 0.01)
  and max TBLR side within the anchor level's regress range;
- ambiguity: with ``impl='vectorized'`` each anchor belongs to its
  smallest-area (``min_area``) or highest-distance (``max_dis``) candidate
  GT, so candidate sets are disjoint and all GTs sample at once;
  ``impl='scan'`` is the sequential smallest-area-first claim loop, kept as
  the test twin;
- candidates with prob <= ``neg_threshold`` * max prob stay negative; from
  the rest (the pool) ``k`` cells are drawn without replacement in
  proportion to prob (Gumbel top-k); a pool smaller than ``k`` is drawn with
  replacement (``balance_sample``) and the multiplicity becomes the weight,
  or taken whole; undrawn pool members are ignores (weight 0).

Output: ``gt_idx`` (B, N) int32, >= 0 positive (0-based GT index), -1
negative, -2 ignore; ``weight`` (B, N) float32.

Randomness enters twice per GT: Gumbel scores over the anchors
(``gumbel_pool`` (B, G, N)) and ``cap`` categorical draws over the top
``cap`` slots, each the argmax of slot logits plus a row of
``gumbel_draw`` (B, G, cap, cap).  Both may be passed in (the tests hand in
the JAX package's own draws and get its result exactly); otherwise they
are drawn from ``generator`` on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

EPS = 1e-8
NEG_INF = -1e30


class AssignResult(NamedTuple):
    gt_idx: torch.Tensor  # (B, N) int32: >=0 pos, -1 neg, -2 ignore
    weight: torch.Tensor  # (B, N) float32


def candidate_mask(anchors, regress_ranges, gt_boxes, gt_valid):
    """(B, N, G) candidacy: anchors (N, 4), regress_ranges (N, 2),
    gt_boxes (B, G, 4), gt_valid (B, G)."""
    cx = ((anchors[:, 0] + anchors[:, 2]) * 0.5)[None, :, None]
    cy = ((anchors[:, 1] + anchors[:, 3]) * 0.5)[None, :, None]
    gb = gt_boxes[:, None]  # (B, 1, G, 4)
    tblr = torch.stack(
        [cx - gb[..., 0], cy - gb[..., 1], gb[..., 2] - cx, gb[..., 3] - cy], dim=-1
    )  # (B, N, G, 4)
    min_side = tblr.amin(-1)
    max_side = tblr.amax(-1)
    in_range = (max_side >= regress_ranges[None, :, None, 0]) & (
        max_side <= regress_ranges[None, :, None, 1]
    )
    return (min_side > 0.01) & in_range & gt_valid[:, None, :]


def _areas(gt_boxes, gt_valid):
    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    return torch.where(gt_valid, area, torch.full_like(area, float("inf")))


def _resolve_ambiguity(cand, dist_vals, areas, ambiguous_sample):
    """One GT per anchor: the candidate of least area (``min_area``) or of
    greatest distance value (``max_dis``); first index on ties."""
    g = cand.shape[-1]
    if ambiguous_sample == "max_dis":
        best = torch.where(cand, dist_vals, torch.full_like(dist_vals, -float("inf"))).argmax(-1)
    else:
        inf = torch.full_like(dist_vals, float("inf"))
        best = torch.where(cand, areas[:, None, :].expand_as(dist_vals), inf).argmin(-1)
    return cand & (best[..., None] == torch.arange(g, device=cand.device))


def _adaptive_k(anchor_sizes, cand, obj_size, positive_num):
    """Size-adaptive positive count per GT: positive_num times the candidate
    mean of exp((obj_size - anchor_size) / (2 anchor_size)), rounded.

    anchor_sizes (N,); cand (..., N) bool; obj_size (...)."""
    cand_f = cand.float()
    n_cand = cand_f.sum(-1).clamp(min=1.0)
    dk = torch.exp((obj_size[..., None] - anchor_sizes) / (2.0 * anchor_sizes))
    dk = (cand_f * dk).sum(-1) / n_cand
    return (positive_num * dk + 0.5).to(torch.int32)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U), U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _sample_counts(logits_t, pool_t, k, cap, balance_sample, gumbel_pool, gumbel_draw):
    """Per-GT sample counts (..., N) from masked logits (..., N).

    Without replacement: the Gumbel top-k, thresholded at the k-th score.
    With replacement (pool smaller than k): ``cap`` categorical draws over
    the top-``cap`` slots, of which the first k count."""
    scores = torch.where(pool_t, logits_t + gumbel_pool, torch.full_like(logits_t, NEG_INF))
    top_vals, top_idx = torch.topk(scores, cap, dim=-1)
    kth = torch.gather(top_vals, -1, (k.long() - 1).clamp(min=0)[..., None])
    counts_without = ((scores >= kth) & pool_t).to(scores.dtype)
    if not balance_sample:
        counts_with = pool_t.to(scores.dtype)
    else:
        # every pool member already sits in the top-cap slots when the pool
        # is smaller than k, so the draws range over the slots only
        slot_live = top_vals > NEG_INF * 0.5
        slot_logits = torch.where(
            slot_live, torch.gather(logits_t, -1, top_idx), torch.full_like(top_vals, NEG_INF)
        )
        draws = (gumbel_draw + slot_logits[..., None, :]).argmax(-1)  # (..., cap)
        draw_live = (torch.arange(cap, device=k.device) < k[..., None]).to(top_vals.dtype)
        slot_counts = torch.zeros_like(top_vals).scatter_add_(-1, draws, draw_live)
        counts_with = torch.zeros_like(logits_t).scatter_add_(-1, top_idx, slot_counts)
    pool_small = pool_t.sum(-1) < k
    return torch.where(pool_small[..., None], counts_with, counts_without)


def _logits(p_t, pool_t, by_distance):
    if by_distance:
        inside = torch.log(p_t.clamp(min=EPS))
    else:  # uniform over the pool
        inside = torch.zeros_like(p_t)
    return torch.where(pool_t, inside, torch.full_like(p_t, NEG_INF))


def _assign_vectorized(anchors, regress_ranges, gt_boxes, gt_valid, dist_vals,
                       gumbel_pool, gumbel_draw, *, positive_num, neg_threshold,
                       balance_sample, adapt_positive_num, random_sample_by_distance,
                       multiply_samplepro_for_weight, ambiguous_sample, k_cap):
    b, n, g = dist_vals.shape
    cand = candidate_mask(anchors, regress_ranges, gt_boxes, gt_valid)
    cand = _resolve_ambiguity(cand, dist_vals, _areas(gt_boxes, gt_valid), ambiguous_sample)

    p = torch.where(cand, dist_vals.clamp(min=EPS), torch.zeros_like(dist_vals))  # (B, N, G)
    pmax = p.amax(1)  # (B, G)
    pool = cand & (p > neg_threshold * pmax[:, None, :])
    has_pool = pool.any(1)  # (B, G)

    if adapt_positive_num:
        obj_size = torch.maximum(
            gt_boxes[..., 2] - gt_boxes[..., 0], gt_boxes[..., 3] - gt_boxes[..., 1]
        )
        k = _adaptive_k(anchors[:, 2] - anchors[:, 0], cand.transpose(1, 2), obj_size, positive_num)
        k = k.clamp(1, k_cap)
    else:
        k = torch.full((b, g), positive_num, dtype=torch.int32, device=dist_vals.device)

    p_t, pool_t = p.transpose(1, 2), pool.transpose(1, 2)  # (B, G, N)
    counts = _sample_counts(
        _logits(p_t, pool_t, random_sample_by_distance), pool_t, k, k_cap, balance_sample,
        gumbel_pool, gumbel_draw,
    )
    if multiply_samplepro_for_weight:
        counts = counts * p_t
    counts = torch.where(has_pool[..., None], counts, torch.zeros_like(counts))

    pos = counts > 0  # (B, G, N): at most one GT per anchor (disjoint sets)
    pos_any = pos.any(1)
    gt_pos = pos.to(torch.uint8).argmax(1)
    untouched = (pool_t & ~pos).any(1)
    gt_idx = torch.where(pos_any, gt_pos.to(torch.int32), torch.where(untouched, -2, -1).to(torch.int32))
    weight = torch.where(
        pos_any, counts.sum(1), torch.where(untouched, 0.0, 1.0).to(counts.dtype)
    )
    return AssignResult(gt_idx=gt_idx, weight=weight)


def _assign_scan(anchors, regress_ranges, gt_boxes, gt_valid, dist_vals,
                 gumbel_pool, gumbel_draw, *, positive_num, neg_threshold,
                 balance_sample, adapt_positive_num, random_sample_by_distance,
                 multiply_samplepro_for_weight, ambiguous_sample, k_cap):
    """GTs in order of increasing area; with ``min_area`` each sees only the
    anchors that smaller GTs left unclaimed (pool and positives claim)."""
    b, n, g = dist_vals.shape
    dev = dist_vals.device
    cand = candidate_mask(anchors, regress_ranges, gt_boxes, gt_valid)
    if ambiguous_sample == "max_dis":
        best = torch.where(cand, dist_vals, torch.full_like(dist_vals, -float("inf"))).argmax(-1)
        cand = cand & (best[..., None] == torch.arange(g, device=dev))
    order = torch.argsort(_areas(gt_boxes, gt_valid), dim=1, stable=True)  # (B, G)
    anchor_sizes = anchors[:, 2] - anchors[:, 0]
    rows = torch.arange(b, device=dev)

    gt_idx = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    weight = torch.ones((b, n), dtype=torch.float32, device=dev)
    claimed = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for t in range(g):
        gi = order[:, t]  # (B,)
        cand_g = cand[rows, :, gi] & gt_valid[rows, gi][:, None]  # (B, N)
        if ambiguous_sample == "min_area":
            cand_g = cand_g & ~claimed
        p = torch.where(cand_g, dist_vals[rows, :, gi].clamp(min=EPS), torch.zeros_like(weight))
        pool = cand_g & (p > neg_threshold * p.amax(1, keepdim=True))
        if adapt_positive_num:
            box = gt_boxes[rows, gi]
            obj_size = torch.maximum(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1])
            k = _adaptive_k(anchor_sizes, cand_g, obj_size, positive_num).clamp(1, k_cap)
        else:
            k = torch.full((b,), positive_num, dtype=torch.int32, device=dev)
        counts = _sample_counts(
            _logits(p, pool, random_sample_by_distance), pool, k, k_cap, balance_sample,
            gumbel_pool[rows, gi], gumbel_draw[rows, gi],
        )
        if multiply_samplepro_for_weight:
            counts = counts * p
        counts = torch.where(pool.any(1, keepdim=True), counts, torch.zeros_like(counts))
        pos = counts > 0
        untouched = pool & ~pos
        gt_idx = torch.where(untouched, -2, gt_idx).to(torch.int32)
        gt_idx = torch.where(pos, gi[:, None].to(torch.int32), gt_idx)
        weight = torch.where(pos, counts, torch.where(untouched, torch.zeros_like(weight), weight))
        claimed = claimed | pos | untouched
    return AssignResult(gt_idx=gt_idx, weight=weight)


def assign_labels(
    anchors,
    regress_ranges,
    gt_boxes,
    gt_valid,
    dist_vals,
    *,
    positive_num: int = 10,
    neg_threshold: float = 0.2,
    balance_sample: bool = True,
    adapt_positive_num: bool = False,
    random_sample_by_distance: bool = True,
    multiply_samplepro_for_weight: bool = False,
    ambiguous_sample: str = "min_area",
    impl: str = "auto",
    gumbel_pool: Optional[torch.Tensor] = None,
    gumbel_draw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> AssignResult:
    """Batched assignment.

    Args:
        anchors: (N, 4) xyxy; regress_ranges: (N, 2).
        gt_boxes: (B, G, 4) xyxy, padded; gt_valid: (B, G) bool.
        dist_vals: (B, N, G) distance value at each anchor center (any float
            dtype; computed in float32, or in the given noise's dtype when
            that is wider).
        impl: 'auto'/'vectorized' (exclusive candidates, one pass) or 'scan'
            (sequential claim loop).
        gumbel_pool: (B, G, N) and gumbel_draw: (B, G, cap, cap) noise, with
            ``cap = positive_num * 4`` under ``adapt_positive_num`` and
            ``positive_num`` otherwise; drawn from ``generator`` when None.
    """
    if ambiguous_sample not in ("min_area", "max_dis"):
        raise ValueError(f"unknown ambiguous_sample: {ambiguous_sample!r}")
    if impl not in ("auto", "vectorized", "scan"):
        raise ValueError(f"unknown assignment impl: {impl!r}")
    dist_vals = dist_vals.to(torch.float32 if gumbel_pool is None else torch.promote_types(torch.float32,
                                                                                          gumbel_pool.dtype))
    b, n, g = dist_vals.shape
    k_cap = positive_num * 4 if adapt_positive_num else positive_num
    dev = dist_vals.device
    if gumbel_pool is None:
        gumbel_pool = gumbel((b, g, n), generator, dev)
    if gumbel_draw is None:
        gumbel_draw = gumbel((b, g, k_cap, k_cap), generator, dev)
    if gumbel_pool.shape != (b, g, n) or gumbel_draw.shape != (b, g, k_cap, k_cap):
        raise ValueError(
            f"noise shapes {tuple(gumbel_pool.shape)}, {tuple(gumbel_draw.shape)}; "
            f"expected {(b, g, n)} and {(b, g, k_cap, k_cap)}"
        )
    fn = _assign_scan if impl == "scan" else _assign_vectorized
    return fn(
        anchors, regress_ranges, gt_boxes, gt_valid, dist_vals, gumbel_pool, gumbel_draw,
        positive_num=positive_num, neg_threshold=neg_threshold, balance_sample=balance_sample,
        adapt_positive_num=adapt_positive_num, random_sample_by_distance=random_sample_by_distance,
        multiply_samplepro_for_weight=multiply_samplepro_for_weight,
        ambiguous_sample=ambiguous_sample, k_cap=k_cap,
    )
