"""Batched vote-NMS over presorted candidates.

:func:`vote_nms` is the entry point: for CUDA tensors it launches the
hand-written kernel (``ops/vote_nms_cuda.py``, ``csrc/vote_nms.cu``), for
CPU tensors it runs :func:`vote_nms_plain`, and on anything else it raises.
The plain version is the CPU path and the kernel's test twin.

:func:`vote_nms_plain` is a (B, K) port of
``radet_tpu/ops/vote_nms.py::vote_nms_device_fast`` with ``presorted=True``
(the function ``radet_tpu/ops/pallas_nms.py::vote_nms_pallas`` computes):

1. exact greedy same-label suppression at IoU > thr, as the fixed point of
   ``keep_i = valid_i and no kept j < i overlaps i``;
2. in global mode, only the first kept box of each label survives (judged
   on the pre-dedup keep);
3. every box joins the lowest-index kept box that overlaps it; a kept box
   always joins itself, even at zero area;
4. per kept seed, a weighted mean and (centered) variance of the members'
   coordinates by vote score (times ``exp(-(1-iou)^2/sigma)`` with
   ``iou_enable``), then the weighted mean over the members within one sigma
   per coordinate, falling back to the mean; all in float32;
5. the kept seeds, in index (= cluster score) order, fill ``max_out`` slots.

Inputs: boxes (B, K, 4) float32 xyxy sorted by cluster score descending
with invalid slots last, cluster and vote scores (B, K) float32, labels
(B, K) int32, valid (B, K) bool.  Returns (boxes (B, M, 4), labels (B, M)
int32, scores (B, M), valid (B, M) bool) with M = ``max_out``.
"""

from __future__ import annotations

import torch

from .vote_nms_cuda import vote_nms_cuda


def vote_nms(
    boxes,
    cluster_scores,
    vote_scores,
    labels,
    valid,
    *,
    iou_threshold: float = 0.65,
    max_out: int = 100,
    iou_enable: bool = False,
    sigma: float = 0.025,
    global_mode: bool = False,
):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    kwargs = dict(
        iou_threshold=iou_threshold,
        max_out=max_out,
        iou_enable=iou_enable,
        sigma=sigma,
        global_mode=global_mode,
    )
    if boxes.is_cuda:
        return vote_nms_cuda(boxes, cluster_scores, vote_scores, labels, valid, **kwargs)
    if boxes.device.type != "cpu":
        raise ValueError(f"vote_nms has no implementation for device {boxes.device}")
    return vote_nms_plain(boxes, cluster_scores, vote_scores, labels, valid, **kwargs)


def pairwise_iou(boxes):
    """(B, K, 4) -> (B, K, K) IoU, with the JAX package's arithmetic."""
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0
    )
    return inter / torch.clamp(areas[:, :, None] + areas[:, None, :] - inter, min=1e-12)


def vote_nms_plain(
    boxes,
    cluster_scores,
    vote_scores,
    labels,
    valid,
    *,
    iou_threshold: float = 0.65,
    max_out: int = 100,
    iou_enable: bool = False,
    sigma: float = 0.025,
    global_mode: bool = False,
):
    """Plain PyTorch vote-NMS (see the module docstring); any device."""
    b, k, _ = boxes.shape
    dev = boxes.device
    iou = pairwise_iou(boxes)
    idx = torch.arange(k, device=dev)
    same_label = (labels[:, :, None] == labels[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    overlap = same_label & (iou > iou_threshold)
    earlier = idx[None, :] < idx[:, None]  # [i, j]: j scores higher than i
    blockers = overlap & earlier

    keep = valid
    while True:
        new_keep = valid & ~(blockers & keep[:, None, :]).any(-1)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    if global_mode:
        keep = keep & ~(same_label & earlier & keep[:, None, :]).any(-1)

    # membership: [seed i, box m], the lowest-index kept seed overlapping m
    cand = overlap & keep[:, :, None] & (idx[:, None] <= idx[None, :])
    cand[:, idx, idx] = keep
    seed = cand.to(torch.uint8).argmax(dim=1)  # first True along seeds
    member = cand.any(dim=1)  # a box joins at most one (kept) seed

    # voting: each member adds into its seed's row, so sums run over (B, K)
    w = torch.where(member, vote_scores, torch.zeros((), device=dev))
    if iou_enable:
        iou_seed = iou.gather(1, seed[:, None, :])[:, 0]
        w = w * torch.exp(-((1.0 - iou_seed) ** 2) / sigma)
    seed4 = seed[..., None].expand(b, k, 4)

    def per_seed(v):
        return torch.zeros_like(v).scatter_add_(1, seed4 if v.dim() == 3 else seed, v)

    w4 = w[..., None]
    wsum = torch.clamp(per_seed(w), min=1e-12)[..., None]
    mean = per_seed(w4 * boxes) / wsum
    mean_m = mean.gather(1, seed4)  # each member's seed mean
    # centered second moment, as the numpy oracle: E[x^2] - mean^2 at
    # 300-px coordinates cancels to ~3 digits and flips ~1% of the 1-sigma
    # inlier tests between two float32 implementations
    sig_m = torch.sqrt(torch.clamp(per_seed(w4 * (boxes - mean_m) ** 2) / wsum, min=0)).gather(1, seed4)
    w2 = w4 * ((boxes >= mean_m - sig_m) & (boxes <= mean_m + sig_m))
    den = per_seed(w2)
    voted = torch.where(den > 0, per_seed(w2 * boxes) / torch.clamp(den, min=1e-12), mean)

    rank = keep.cumsum(1) - 1
    slot = torch.where(keep & (rank < max_out), rank, max_out)

    def pack(values, fill):
        out = torch.full((b, max_out + 1) + values.shape[2:], fill, dtype=values.dtype, device=dev)
        index = slot.view(b, k, *([1] * (values.dim() - 2))).expand_as(values)
        return out.scatter_(1, index, values)[:, :max_out]

    kept = keep[..., None]
    return (
        pack(torch.where(kept, voted, torch.zeros((), device=dev)), 0.0),
        pack(torch.where(keep, labels, torch.full((), -1, dtype=labels.dtype, device=dev)), -1),
        pack(torch.where(keep, cluster_scores, torch.zeros((), device=dev)), 0.0),
        pack(keep, False),
    )
