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

:func:`batched_nms` is plain class-aware greedy NMS (the generic anchor
heads' ``nms.type='nms'``): the kernel in its no-vote mode on CUDA tensors,
:func:`batched_nms_plain` (a port of ``radet_tpu/ops/vote_nms.py::
batched_nms_device``) on CPU tensors.  Its slots hold the kept boxes
themselves, in score order.

Both entry points reach their implementations through one PyTorch operator
each, ``torch.ops.radet_tpu_torch.vote_nms`` and ``...batched_nms``
(``torch.library``: the kernel's wrapper for CUDA tensors, the plain
version for CPU tensors, and a fake implementation that gives the
(B, max_out, ...) output shapes), so that ``torch.export`` carries the
kernel inside an exported program as one opaque call instead of tracing
the plain version's data-dependent loop.  The operators return fresh
tensors and mutate no input.  A process that loads such a program imports
this module first, which registers them.
"""

from __future__ import annotations

import torch

from .vote_nms_cuda import batched_nms_cuda, vote_nms_cuda

NEG_INF = -1e30


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
    if boxes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"vote_nms has no implementation for device {boxes.device}")
    return _vote_nms_op(boxes, cluster_scores, vote_scores, labels, valid, float(iou_threshold), int(max_out),
                        bool(iou_enable), float(sigma), bool(global_mode))


def _vote_nms_cpu(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold, max_out, iou_enable, sigma,
                  global_mode):
    out = vote_nms_plain(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold=iou_threshold,
                         max_out=max_out, iou_enable=iou_enable, sigma=sigma, global_mode=global_mode)
    return tuple(t.contiguous() for t in out)


def _vote_nms_kernel(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold, max_out, iou_enable, sigma,
                     global_mode):
    return vote_nms_cuda(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold=iou_threshold,
                         max_out=max_out, iou_enable=iou_enable, sigma=sigma, global_mode=global_mode)


def _vote_nms_fake(boxes, cluster_scores, vote_scores, labels, valid, iou_threshold, max_out, iou_enable, sigma,
                   global_mode):
    return _fake_outputs(boxes, cluster_scores, labels, valid, max_out)


def _fake_outputs(boxes, scores, labels, valid, max_out: int):
    b = boxes.shape[0]
    return (boxes.new_empty((b, max_out, 4)), labels.new_empty((b, max_out)), scores.new_empty((b, max_out)),
            valid.new_empty((b, max_out)))


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


def batched_nms(boxes, scores, labels, valid, *, iou_threshold: float = 0.6, max_out: int = 100):
    """Class-aware greedy NMS: the kernel's no-vote mode on CUDA tensors,
    the plain version on CPU tensors.

    Inputs as :func:`vote_nms`'s with one score, sorted by it descending,
    ties in index order, invalid slots last (the kernel keeps in index
    order; the plain version picks the highest score, the lowest index on
    ties, which is the same on such input).  Returns (boxes (B, M, 4),
    labels (B, M) int32, scores (B, M), valid (B, M) bool)."""
    if boxes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"batched_nms has no implementation for device {boxes.device}")
    return _batched_nms_op(boxes, scores, labels, valid, float(iou_threshold), int(max_out))


def _batched_nms_cpu(boxes, scores, labels, valid, iou_threshold, max_out):
    out = batched_nms_plain(boxes, scores, labels, valid, iou_threshold=iou_threshold, max_out=max_out)
    return tuple(t.contiguous() for t in out)


def _batched_nms_kernel(boxes, scores, labels, valid, iou_threshold, max_out):
    return batched_nms_cuda(boxes, scores, labels, valid, iou_threshold=iou_threshold, max_out=max_out)


def _batched_nms_fake(boxes, scores, labels, valid, iou_threshold, max_out):
    return _fake_outputs(boxes, scores, labels, valid, max_out)


# The operators, defined through torch.library's low-level API, without the
# Python autograd wrapper of a torch.library.custom_op: as one, a call took
# 42-67 us more host time on the card with autograd on (PERF.md §6), more
# than the kernel's device time at the deploy shapes.  Neither op has a
# gradient.
_LIB = torch.library.Library("radet_tpu_torch", "DEF")
_LIB.define("vote_nms(Tensor boxes, Tensor cluster_scores, Tensor vote_scores, Tensor labels, Tensor valid, "
            "float iou_threshold, int max_out, bool iou_enable, float sigma, bool global_mode) "
            "-> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("batched_nms(Tensor boxes, Tensor scores, Tensor labels, Tensor valid, float iou_threshold, "
            "int max_out) -> (Tensor, Tensor, Tensor, Tensor)")
for _name, _cpu, _cuda, _fake in (("vote_nms", _vote_nms_cpu, _vote_nms_kernel, _vote_nms_fake),
                                  ("batched_nms", _batched_nms_cpu, _batched_nms_kernel, _batched_nms_fake)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"radet_tpu_torch::{_name}", _fake, lib=_LIB)
_vote_nms_op = torch.ops.radet_tpu_torch.vote_nms.default
_batched_nms_op = torch.ops.radet_tpu_torch.batched_nms.default


def batched_nms_plain(boxes, scores, labels, valid, *, iou_threshold: float = 0.6, max_out: int = 100):
    """Plain PyTorch class-aware greedy NMS over (B, K) candidates, in any
    order; any device.  Step t emits the highest-scoring candidate not yet
    suppressed (the lowest index on ties) and suppresses the candidates of
    its label that overlap it at IoU > ``iou_threshold``."""
    b, k, _ = boxes.shape
    dev = boxes.device
    if not max_out:
        return (boxes.new_zeros((b, 0, 4)), labels.new_zeros((b, 0)), scores.new_zeros((b, 0)),
                valid.new_zeros((b, 0)))
    rows = torch.arange(b, device=dev)
    suppressed = ~valid
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    out_boxes, out_labels, out_scores, out_valid = [], [], [], []
    neg_inf = torch.full((), NEG_INF, dtype=scores.dtype, device=dev)
    for _ in range(max_out):
        avail = torch.where(suppressed, neg_inf, scores)
        i = avail.argmax(dim=1)  # the first maximum
        emit = avail[rows, i] > NEG_INF
        box = boxes[rows, i]  # (B, 4)
        lt = torch.maximum(box[:, None, :2], boxes[..., :2])
        rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / torch.clamp(areas[rows, i][:, None] + areas - inter, min=1e-12)
        member = ~suppressed & (labels == labels[rows, i][:, None]) & (iou > iou_threshold)
        member[rows, i] = True
        suppressed = suppressed | (member & emit[:, None])
        out_boxes.append(torch.where(emit[:, None], box, torch.zeros((), dtype=box.dtype, device=dev)))
        out_labels.append(torch.where(emit, labels[rows, i], torch.full((), -1, dtype=labels.dtype, device=dev)))
        out_scores.append(torch.where(emit, scores[rows, i], torch.zeros((), dtype=scores.dtype, device=dev)))
        out_valid.append(emit)
    return (torch.stack(out_boxes, 1), torch.stack(out_labels, 1), torch.stack(out_scores, 1),
            torch.stack(out_valid, 1))
