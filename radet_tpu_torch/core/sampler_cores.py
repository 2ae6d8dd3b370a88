"""mmdet's samplers beyond Pseudo and Random as mask operations (port of
``radet_tpu/core/sampler_cores.py``), batched over the images: every mask
is (B, N) over the anchor grid, every quota a (B,) tensor, so a batch is
sampled without a round trip to the host (ScoreHLR's grouping loop aside:
it checks on the host once per ``GROUP_CHUNK`` groups).

- :func:`ohem_sample_masks`: the top of each set by the per-anchor loss;
- :func:`iou_balanced_neg_masks`: negatives spread over IoU bins;
- :func:`instance_balanced_pos_masks`: positives spread over their GTs;
- :func:`nms_match_groups` and :func:`score_hlr_neg_masks`: ScoreHLR's
  grouping of the scored negatives and its label weights;
- :func:`sample_with` and :func:`combined_sample_masks`: the dispatch by
  mmdet's class name.

Uniform subsampling of a masked set ranks its members by an i.i.d. uniform
key and keeps the ranks below the quota.  Every uniform comes from one
source, ``draws(role, mask) -> (B, N) float32 in [0, 1)``, keyed by the
draw's role: 'pos' and 'neg' (the two sides), 'groups', 'extra' and 'down'
(the instance-balanced positives), 'bin<b>', 'topup', 'floor' and 'rest'
(the IoU-balanced negatives), 'rand' and 'inv' (ScoreHLR).  In training
the source is the step's ``torch.Generator`` (:func:`generator_draws`);
tests inject the JAX package's own draws (:func:`injected_draws`).  Ranks
sort ``-where(mask, v, -inf)`` ascending and stably, as the JAX package
does, so ties break to the lower index.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .box_ops import bbox_iou_pairwise

INF = float("inf")
GROUP_CHUNK = 16  # ScoreHLR grouping steps between the host's checks (a finished image's steps change nothing)
HLR_MAX_ANCHORS = 8192

Draws = Callable[[str, torch.Tensor], torch.Tensor]


def generator_draws(generator: Optional[torch.Generator] = None) -> Draws:
    """A draw source that takes ``torch.rand`` of each mask's shape from
    ``generator`` (on the mask's device), in the order of the calls."""
    def draw(role: str, mask: torch.Tensor) -> torch.Tensor:
        return torch.rand(mask.shape, generator=generator, device=mask.device)
    return draw


def injected_draws(table: Dict[str, object]) -> Draws:
    """A draw source that reads each role's (B, N) uniforms from ``table``."""
    def draw(role: str, mask: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(table[role], dtype=torch.float32).to(mask.device).reshape(mask.shape)
    return draw


def as_draws(rng) -> Draws:
    """``rng`` as a draw source: a ``torch.Generator`` (or None: torch's
    default generator) through :func:`generator_draws`, a callable as it is."""
    return rng if callable(rng) else generator_draws(rng)


def _ranks_by(mask, values, descending: bool = False):
    """(B, N) rank of each member of ``mask`` by ``values`` (largest first
    with ``descending``; ties to the lower index); non-members rank after
    every member."""
    v = values if descending else -values
    order = torch.argsort(-torch.where(mask, v, -INF), dim=-1, stable=True)
    ranks = torch.empty_like(order)
    return ranks.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))


def _uniform_ranks(draws: Draws, role: str, mask):
    return _ranks_by(mask, draws(role, mask), descending=True)


def _col(q):
    """A (B,) quota against (B, N) ranks; a Python number as it is."""
    return q[:, None] if isinstance(q, torch.Tensor) else q


def neg_quota(pos_s, num: int, neg_pos_ub: float = -1.0):
    """(B,) negatives to draw after ``pos_s``: ``num`` less the sampled
    positives, at most ``neg_pos_ub * max(sampled, 1)`` (truncated) when
    ``neg_pos_ub >= 0``."""
    sampled = pos_s.sum(-1)
    quota = num - sampled
    if neg_pos_ub >= 0:
        quota = torch.minimum(quota, (neg_pos_ub * sampled.clamp(min=1)).to(quota.dtype))
    return quota


def random_side(draws: Draws, role: str, mask, quota):
    """Uniform draw without replacement of up to ``quota`` members of ``mask``."""
    return mask & (_uniform_ranks(draws, role, mask) < _col(quota))


def ohem_sample_masks(pos, neg, loss, *, num: int, pos_fraction: float, neg_pos_ub: float = -1.0):
    """OHEMSampler: the ``int(num * pos_fraction)`` positives of largest
    ``loss``, then the negatives of largest loss up to :func:`neg_quota`; a
    set under its quota is kept whole.  Draws nothing."""
    pos_s = pos & (_ranks_by(pos, loss, descending=True) < int(num * pos_fraction))
    neg_s = neg & (_ranks_by(neg, loss, descending=True) < _col(neg_quota(pos_s, num, neg_pos_ub)))
    return pos_s, neg_s


def iou_balanced_neg_masks(draws: Draws, neg, max_overlaps, num_expected, *, floor_thr: float = -1.0,
                           floor_fraction: float = 0.0, num_bins: int = 3):
    """IoUBalancedNegSampler's negatives: the floor set (IoU below
    ``floor_thr``; none when it is -1) and the IoU set; the IoU set's quota
    ``floor(num_expected * (1 - floor_fraction))`` spread over ``num_bins``
    equal IoU intervals up to the image's largest IoU (positives included),
    each drawing up to ``quota // num_bins`` ('bin<b>'), under-full bins
    topped up from the rest of the IoU set ('topup'); the floor set fills to
    ``num_expected`` ('floor'), any shortfall from every unsampled negative
    ('rest').  Negatives under quota are kept whole."""
    eff_floor = 0.0 if floor_thr < 0 else floor_thr
    if floor_thr > 0:
        floor_set = neg & (max_overlaps >= 0) & (max_overlaps < floor_thr)
        iou_set = neg & (max_overlaps >= floor_thr)
    elif floor_thr == 0:
        floor_set = neg & (max_overlaps == 0)
        iou_set = neg & (max_overlaps > 0)
    else:
        floor_set = None
        iou_set = neg & (max_overlaps > floor_thr)
    quota_iou = torch.floor(num_expected * (1 - floor_fraction)).to(num_expected.dtype)
    if num_bins >= 2:
        interval = (max_overlaps.amax(-1, keepdim=True) - eff_floor) / num_bins
        per_bin = quota_iou[:, None] // num_bins
        scaled = torch.floor((max_overlaps - eff_floor) / interval.clamp(min=1e-12))
        bin_idx = torch.where(interval > 0, scaled, torch.zeros((), device=scaled.device)).long()
        # half-open bins [start, end): the largest IoU lies in none
        in_bin = iou_set & (bin_idx >= 0) & (bin_idx < num_bins)
        binned = torch.zeros_like(neg)
        for b in range(num_bins):
            m = in_bin & (bin_idx == b)
            binned = binned | (m & (_uniform_ranks(draws, f"bin{b}", m) < per_bin))
        iou_sel = binned | random_side(draws, "topup", iou_set & ~binned, quota_iou - binned.sum(-1))
    else:
        iou_sel = random_side(draws, "topup", iou_set, quota_iou)
    sel = iou_sel
    if floor_set is not None:
        sel = sel | random_side(draws, "floor", floor_set, num_expected - iou_sel.sum(-1))
    sel = sel | random_side(draws, "rest", neg & ~sel, num_expected - sel.sum(-1))
    return torch.where(_col(neg.sum(-1) <= num_expected), neg, sel)


def instance_balanced_pos_masks(draws: Draws, pos, assigned_gt, num_expected: int, *, max_gt: int):
    """InstanceBalancedPosSampler's positives: ``round(num_expected /
    num_gts) + 1`` from each GT's positives ('groups'; half to even, as
    Python rounds), then a uniform top-up from the rest ('extra') or a
    uniform cut to ``num_expected`` ('down').  ``assigned_gt`` is the
    1-based (B, N) assignment; ``max_gt`` bounds the GT count."""
    b, n = pos.shape
    dev = pos.device
    gidx = torch.where(pos, assigned_gt.long() - 1, torch.full((), max_gt, device=dev))  # max_gt: no GT
    counts = torch.zeros((b, max_gt + 1), dtype=torch.long, device=dev).scatter_add_(1, gidx, torch.ones_like(gidx))
    num_gts = (counts[:, :max_gt] > 0).sum(-1).clamp(min=1)
    num_per_gt = (torch.round(num_expected / num_gts) + 1).long()
    # rank within each GT: one sort, group-major and uniform-minor
    u = draws("groups", pos)
    order = torch.argsort(torch.where(pos, gidx.float() * 2.0 + u, INF), dim=-1, stable=True)
    grank = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=dev).expand_as(order))
    start = torch.full((b, max_gt + 1), n, dtype=torch.long, device=dev).scatter_reduce(1, gidx, grank, "amin")
    sel = pos & (grank - start.gather(1, gidx) < num_per_gt[:, None])
    count = sel.sum(-1)
    sel_up = sel | random_side(draws, "extra", pos & ~sel, (num_expected - count).clamp(min=0))
    sel_down = random_side(draws, "down", sel, num_expected)
    sel = torch.where(_col(count < num_expected), sel_up, sel_down)
    return torch.where(_col(pos.sum(-1) <= num_expected), pos, sel)


def nms_match_groups(boxes, scores, valid, iou_thr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmcv's ``nms_match`` as group ids, per image: greedy by descending
    score (ties to the lower index), each unmatched valid box seeds a group
    and takes every unmatched box with IoU above ``iou_thr``.

    ``boxes`` (B, N, 4), ``scores`` and ``valid`` (B, N).  Returns
    (group_seed (B, N): the index of each box's seed, -1 where not valid;
    rank (B, N): its place within its group by descending score, ties to
    the lower index; 0 where not valid)."""
    b, n = valid.shape
    dev = valid.device
    cols = torch.arange(n, device=dev)
    score_order = torch.where(valid, scores, -INF)
    group_seed = torch.full((b, n), -1, dtype=torch.long, device=dev)
    unmatched = valid.clone()
    while bool(unmatched.any()):
        for _ in range(GROUP_CHUNK):  # once an image has no unmatched box its steps change nothing
            seed = torch.where(unmatched, score_order, -INF).argmax(-1)
            seed_box = boxes.gather(1, seed[:, None, None].expand(b, 1, 4))
            iou = bbox_iou_pairwise(seed_box, boxes)[:, 0]
            members = unmatched & ((iou > iou_thr) | (cols == seed[:, None]))
            group_seed = torch.where(members, seed[:, None], group_seed)
            unmatched = unmatched & ~members
    # rank within the group: sort by score (descending, stable), then by group (stable)
    by_score = torch.argsort(-score_order, dim=-1, stable=True)
    order = by_score.gather(1, torch.argsort(group_seed.gather(1, by_score), dim=-1, stable=True))
    place = torch.empty_like(order).scatter_(-1, order, cols.expand_as(order))
    start = torch.full((b, n + 1), n, dtype=torch.long, device=dev).scatter_reduce(1, group_seed + 1, place, "amin")
    rank = place - start.gather(1, group_seed + 1)
    return group_seed, torch.where(valid, rank, torch.zeros_like(rank))


def score_hlr_neg_masks(draws: Draws, neg, max_fg_score, decoded_boxes, num_expected, *, score_thr: float = 0.05,
                        iou_thr: float = 0.5, k: float = 0.5, bias: float = 0.0):
    """ScoreHLRSampler's negatives and their label weights: negatives
    scoring above ``score_thr`` are grouped (:func:`nms_match_groups`) and
    ranked by importance ``num_valid - rank_in_group + score``; the top
    ``min(num_valid, quota)`` are taken, the rest of the quota drawn from
    the low-scoring negatives ('rand'), with weights ``(bias + (1 - bias) *
    w) ** k`` (w the importance rank's share, the lowest one for the drawn
    part).  With no negative above ``score_thr``, a uniform draw ('inv')
    with unit weights.  The loss-sum renormalisation is the caller's
    (:func:`sample_with`).  Returns (selected (B, N), weights (B, N))."""
    valid = neg & (max_fg_score > score_thr)
    invalid = neg & ~valid
    num_valid = valid.sum(-1)
    num_exp = torch.minimum(neg.sum(-1), num_expected)
    num_hlr = torch.minimum(num_valid, num_exp)

    _, grank = nms_match_groups(decoded_boxes, max_fg_score, valid, iou_thr)
    imp = torch.where(valid, num_valid[:, None].float() - grank + max_fg_score, -INF)
    imp_rank = _ranks_by(valid, imp, descending=True)
    hlr_sel = valid & (imp_rank < num_hlr[:, None])
    rand_sel = random_side(draws, "rand", invalid, num_exp - num_hlr)
    selected = hlr_sel | rand_sel

    up_bound = torch.maximum(num_exp, num_valid).float()[:, None]
    imp_w = (up_bound - imp_rank.float()) / up_bound
    lowest = torch.where(hlr_sel, imp_w, INF).amin(-1, keepdim=True)
    min_w = torch.where(num_hlr[:, None] > 0, lowest, torch.ones_like(lowest))
    w = torch.where(hlr_sel, imp_w, torch.where(rand_sel, min_w, torch.zeros_like(imp_w)))
    weights = torch.where(selected, (bias + (1 - bias) * w) ** k, torch.zeros_like(w))
    fallback = random_side(draws, "inv", invalid, num_exp)
    some = num_valid[:, None] > 0
    return torch.where(some, selected, fallback), torch.where(some, weights, fallback.float())


def sample_with(sampler_type: str, draws: Draws, pos, neg, *, num: int, pos_fraction: float,
                neg_pos_ub: float = -1.0, per_loss=None, max_overlaps=None, assigned=None, max_gt: int = 0,
                decoded_boxes=None, max_fg_score=None, extra=()):
    """The sampler of mmdet class ``sampler_type`` on (B, N) ``pos`` and
    ``neg``: OHEMSampler, IoUBalancedNegSampler, InstanceBalancedPosSampler,
    ScoreHLRSampler or CombinedSampler; ``extra`` holds its options as
    (name, value) items.  Side information, each (B, N): ``per_loss`` (the
    current classification loss), ``max_overlaps`` (the assignment's best
    IoU), ``assigned`` (1-based GT), ``decoded_boxes`` (B, N, 4) and
    ``max_fg_score``.  Returns (pos_mask, neg_mask, neg_weights or None)."""
    extra = dict(extra)
    num_expected_pos = int(num * pos_fraction)
    if sampler_type == "OHEMSampler":
        if per_loss is None:
            raise AssertionError("OHEMSampler ranks by the per-anchor loss")
        return (*ohem_sample_masks(pos, neg, per_loss, num=num, pos_fraction=pos_fraction,
                                   neg_pos_ub=neg_pos_ub), None)
    if sampler_type == "IoUBalancedNegSampler":
        if max_overlaps is None:
            raise AssertionError("IoUBalancedNegSampler needs the assignment's max overlaps")
        pos_s = random_side(draws, "pos", pos, num_expected_pos)
        neg_s = iou_balanced_neg_masks(
            draws, neg, max_overlaps, neg_quota(pos_s, num, neg_pos_ub),
            floor_thr=float(extra.get("floor_thr", -1)), floor_fraction=float(extra.get("floor_fraction", 0)),
            num_bins=int(extra.get("num_bins", 3)))
        return pos_s, neg_s, None
    if sampler_type == "InstanceBalancedPosSampler":
        if assigned is None or max_gt <= 0:
            raise AssertionError("InstanceBalancedPosSampler needs the assignment and the GT count")
        pos_s = instance_balanced_pos_masks(draws, pos, assigned, num_expected_pos, max_gt=max_gt)
        return pos_s, random_side(draws, "neg", neg, neg_quota(pos_s, num, neg_pos_ub)), None
    if sampler_type == "ScoreHLRSampler":
        if max_fg_score is None or decoded_boxes is None:
            raise AssertionError("ScoreHLRSampler needs the scores and the decoded boxes")
        # the grouping compares each seed with every anchor, once per group:
        # mmdet runs it over a few hundred sampled RoIs, not a dense grid
        n_anchors = int(neg.shape[-1])
        if n_anchors > HLR_MAX_ANCHORS:
            raise AssertionError(
                f"ScoreHLRSampler's pairwise-IoU grouping is quadratic in the anchor count (got N={n_anchors}; "
                f"(N,N) f32 = {n_anchors * n_anchors * 4 / 1e9:.2f} GB per image)")
        pos_s = random_side(draws, "pos", pos, num_expected_pos)
        neg_s, w = score_hlr_neg_masks(
            draws, neg, max_fg_score, decoded_boxes, neg_quota(pos_s, num, neg_pos_ub),
            score_thr=float(extra.get("score_thr", 0.05)), iou_thr=float(extra.get("iou_thr", 0.5)),
            k=float(extra.get("k", 0.5)), bias=float(extra.get("bias", 0.0)))
        if per_loss is not None:  # mmdet keeps the negatives' loss sum
            ori = torch.where(neg_s, per_loss, torch.zeros_like(per_loss)).sum(-1, keepdim=True)
            new = (per_loss * w).sum(-1, keepdim=True)
            w = w * torch.where(new > 0, ori / new.clamp(min=1e-12), torch.ones_like(new))
        return pos_s, neg_s, w
    if sampler_type == "CombinedSampler":
        pos_s, neg_s = combined_sample_masks(
            draws, pos, neg, num=num, pos_fraction=pos_fraction, neg_pos_ub=neg_pos_ub,
            pos_sampler=str(extra.get("pos_sampler", "instance_balanced")),
            neg_sampler=str(extra.get("neg_sampler", "iou_balanced")), assigned_gt=assigned, max_gt=max_gt,
            max_overlaps=max_overlaps, loss=per_loss, floor_thr=float(extra.get("floor_thr", -1)),
            floor_fraction=float(extra.get("floor_fraction", 0)), num_bins=int(extra.get("num_bins", 3)))
        return pos_s, neg_s, None
    raise ValueError(f"unknown sampler_type {sampler_type!r}")


def combined_sample_masks(draws: Draws, pos, neg, *, num: int, pos_fraction: float, neg_pos_ub: float = -1.0,
                          pos_sampler: str = "instance_balanced", neg_sampler: str = "iou_balanced",
                          assigned_gt=None, max_gt: int = 0, max_overlaps=None, loss=None,
                          floor_thr: float = -1.0, floor_fraction: float = 0.0, num_bins: int = 3):
    """CombinedSampler: a positive component ('instance_balanced', 'random'
    or 'ohem') and a negative one ('iou_balanced', 'random' or 'ohem')
    under the shared quotas."""
    num_expected_pos = int(num * pos_fraction)
    if pos_sampler == "instance_balanced":
        if assigned_gt is None or max_gt <= 0:
            raise AssertionError("the instance-balanced component needs the assignment and the GT count")
        pos_s = instance_balanced_pos_masks(draws, pos, assigned_gt, num_expected_pos, max_gt=max_gt)
    elif pos_sampler == "random":
        pos_s = random_side(draws, "pos", pos, num_expected_pos)
    elif pos_sampler == "ohem":
        if loss is None:
            raise AssertionError("the OHEM component ranks by the per-anchor loss")
        pos_s = pos & (_ranks_by(pos, loss, descending=True) < num_expected_pos)
    else:
        raise ValueError(f"pos_sampler {pos_sampler!r}")
    quota = neg_quota(pos_s, num, neg_pos_ub)
    if neg_sampler == "iou_balanced":
        if max_overlaps is None:
            raise AssertionError("the IoU-balanced component needs the assignment's max overlaps")
        neg_s = iou_balanced_neg_masks(draws, neg, max_overlaps, quota, floor_thr=floor_thr,
                                       floor_fraction=floor_fraction, num_bins=num_bins)
    elif neg_sampler == "random":
        neg_s = random_side(draws, "neg", neg, quota)
    elif neg_sampler == "ohem":
        if loss is None:
            raise AssertionError("the OHEM component ranks by the per-anchor loss")
        neg_s = neg & (_ranks_by(neg, loss, descending=True) < quota[:, None])
    else:
        raise ValueError(f"neg_sampler {neg_sampler!r}")
    return pos_s, neg_s
