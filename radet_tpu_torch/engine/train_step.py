"""The training steps (port of ``radet_tpu/engine/train_step.py``'s
``build_train_step`` for RADet and ``build_train_step_anchor`` for the
generic anchor heads).

One call does what the JAX package's jitted step does: uint8 -> normalized
input, the forward pass with autograd (convolutions in ``model.dtype``,
GroupNorm, head outputs and the loss in float32), batched label assignment
under ``no_grad`` (RADet's sampled draw from the distance maps, or the
anchor heads' ATSS / MaxIoU on IoU), the loss, backward, global-norm clip,
the optimizer update and the schedule's step.

A model with quantization-aware training (``qat``) runs its forward and
backward with cuDNN's TF32 off (``ops.quant.qat_precision``): its fake-quantized
convolutions are float32 on the deploy grid.  A ``frozen_int8`` model's step
is a float model's: its frozen prefix's int8 convolutions sum exactly in
int32 and take no gradient.

The assignment noise comes from a device generator seeded by (seed, step),
the counterpart of ``fold_in(rng_key, step)``: a run resumed from a
checkpoint draws the same noise as one that was never interrupted.  Nothing
in a step waits for the device: the metrics are device tensors, read (one
sync) only when the caller converts them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.anchor_assign import atss_assign, max_iou_assign
from ..core.assignment import AssignResult, assign_labels
from ..models.anchor_heads import flatten_anchor_outputs
from ..models.anchor_loss import anchor_head_loss, atss_loss
from ..models.detector import flatten_head_outputs, preprocess_images
from ..models.radet_loss import radet_loss
from ..ops.quant import qat_precision
from .optim import ClippedOptimizer

BATCH_KEYS = ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")
ANCHOR_BATCH_KEYS = BATCH_KEYS[:4]  # the anchor heads assign on IoU: no distance maps


class TrainState:
    """Mutable training state: the model, its optimizer (with schedule and
    clip), the number of steps taken, and the seed of the assignment noise."""

    def __init__(self, model: torch.nn.Module, tx: ClippedOptimizer, step: int = 0, seed: int = 0):
        self.model = model
        self.tx = tx
        self.step = int(step)
        self.seed = int(seed)
        device = next(model.parameters()).device
        self.generator = torch.Generator(device=device)

    def step_generator(self) -> torch.Generator:
        """The generator of this step's assignment noise, seeded by (seed, step)."""
        return self.generator.manual_seed((self.seed * 1_000_003 + self.step) % 2**63)


def batch_to_device(batch: Dict[str, Any], device, keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """Stage numpy (or tensor) batch arrays on ``device``; from pinned host
    memory when the device is a card, so the copy does not wait for it."""
    device = torch.device(device)
    out = {}
    for k in keys:
        t = torch.as_tensor(batch[k])
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def build_train_step(
    model,
    anchors: np.ndarray,
    regress_ranges: np.ndarray,
    *,
    img_norm: Dict[str, Any],
    num_classes: int,
    assignment_cfg: Dict[str, Any] | None = None,
    normalizer: float = 1.0 / 8.0,
    loss_cfg: Dict[str, Any] | None = None,
) -> "TrainStep":
    """Returns ``train_step(state, batch, noise=None) -> metrics`` for
    models on the device of ``model``'s parameters.

    ``batch``: device tensors under :data:`BATCH_KEYS` (see
    :func:`batch_to_device`).  ``noise``: optional (gumbel_pool,
    gumbel_draw) for the assignment (``core.assignment.assign_labels``)."""
    return TrainStep(model, anchors, regress_ranges, img_norm=img_norm, num_classes=num_classes,
                     assignment_cfg=assignment_cfg, normalizer=normalizer, loss_cfg=loss_cfg)


class TrainStep:
    batch_keys = BATCH_KEYS

    def __init__(self, model, anchors, regress_ranges, *, img_norm, num_classes,
                 assignment_cfg=None, normalizer=1.0 / 8.0, loss_cfg=None):
        acfg = dict(assignment_cfg or {})
        self.assign_kwargs = dict(
            positive_num=int(acfg.get("positive_num", 10)),
            neg_threshold=float(acfg.get("neg_threshold", 0.2)),
            balance_sample=bool(acfg.get("balance_sample", True)),
            adapt_positive_num=bool(acfg.get("adapt_positive_num", False)),
            random_sample_by_distance=bool(acfg.get("random_sample_by_distance", True)),
            multiply_samplepro_for_weight=bool(acfg.get("multiply_samplepro_for_weight", False)),
            ambiguous_sample=str(acfg.get("ambiguous_sample", "min_area")),
            impl=str(acfg.get("impl", "auto")),
        )
        lc = dict(cls=1.0, bbox=2.0, iou=1.0, focal_gamma=2.0, focal_alpha=0.25,
                  bbox_type="GIoULoss", bbox_extra=())
        lc.update(loss_cfg or {})
        self.loss_kwargs = dict(
            num_classes=num_classes, normalizer=normalizer,
            focal_gamma=lc["focal_gamma"], focal_alpha=lc["focal_alpha"],
            cls_loss_weight=lc["cls"], bbox_loss_weight=lc["bbox"], iou_loss_weight=lc["iou"],
            bbox_loss_type=lc["bbox_type"], bbox_loss_extra=tuple(lc["bbox_extra"]),
        )
        device = next(model.parameters()).device
        self.anchors = torch.as_tensor(anchors, dtype=torch.float32, device=device)
        self.ranges = torch.as_tensor(regress_ranges, dtype=torch.float32, device=device)
        # in preprocess_images' working dtype: float32, or float64 for a float64 model
        work = torch.promote_types(model.dtype, torch.float32)
        self.mean = torch.tensor(img_norm["mean"], dtype=work, device=device)
        self.std = torch.tensor(img_norm["std"], dtype=work, device=device)
        self.precision = step_precision(model)

    @torch.no_grad()
    def assign(self, batch, noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> AssignResult:
        pool, draw = noise if noise is not None else (None, None)
        return assign_labels(
            self.anchors, self.ranges, batch["gt_boxes"], batch["gt_valid"], batch["dist_vals"],
            gumbel_pool=pool, gumbel_draw=draw, generator=generator, **self.assign_kwargs,
        )

    def loss(self, model, batch, assign: AssignResult) -> Dict[str, torch.Tensor]:
        """The RADet losses of ``model``'s forward on ``batch``, with autograd."""
        x = preprocess_images(batch["image"], self.mean, self.std, model.dtype)
        cls_flat, reg_flat, iou_flat = flatten_head_outputs(*model(x))
        return radet_loss(
            cls_flat, reg_flat, iou_flat, self.anchors, batch["gt_boxes"], batch["gt_labels"],
            assign.gt_idx, assign.weight, **self.loss_kwargs,
        )

    def __call__(self, state: TrainState, batch, noise=None) -> Dict[str, torch.Tensor]:
        generator = None if noise is not None else state.step_generator()
        assign = self.assign(batch, noise, generator)
        state.tx.zero_grad()
        with self.precision():
            return _update(state, self.loss(state.model, batch, assign))


def step_precision(model):
    """The scope a step of ``model`` runs its forward and backward in:
    :func:`ops.quant.qat_precision` (cuDNN's TF32 off) for a model with
    quantization-aware training, else none."""
    return qat_precision if any(getattr(m, "qat", False) for m in model.modules()) else contextlib.nullcontext


def _update(state: TrainState, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Backward of the sum of the ``loss_*`` entries, clip and optimizer
    step; returns the detached losses, ``loss`` and ``grad_norm``."""
    total = sum(v for k, v in losses.items() if k.startswith("loss_"))
    total.backward()
    grad_norm = state.tx.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics


def build_train_step_anchor(
    model,
    anchors: np.ndarray,
    num_level_anchors,
    *,
    img_norm: Dict[str, Any],
    num_classes: int,
    spec: Dict[str, Any],
) -> "AnchorTrainStep":
    """Returns ``train_step(state, batch) -> metrics`` for ATSSHead and
    AnchorHead models.  ``spec``: ``apis.common.anchor_head_spec`` of the
    config.  ``batch``: device tensors under :data:`ANCHOR_BATCH_KEYS`.
    The assignment is deterministic (IoU-based): the step draws no random
    numbers."""
    return AnchorTrainStep(model, anchors, num_level_anchors, img_norm=img_norm, num_classes=num_classes,
                           spec=spec)


class AnchorTrainStep:
    batch_keys = ANCHOR_BATCH_KEYS

    def __init__(self, model, anchors, num_level_anchors, *, img_norm, num_classes, spec):
        device = next(model.parameters()).device
        self.head_type = spec["head_type"]
        self.num_classes = num_classes
        self.counts = tuple(int(c) for c in num_level_anchors)
        self.spec = spec
        self.anchors = torch.as_tensor(anchors, dtype=torch.float32, device=device)
        mask = spec.get("valid_mask")
        self.valid_mask = None if mask is None else torch.as_tensor(mask, device=device)
        # in preprocess_images' working dtype: float32, or float64 for a float64 model
        work = torch.promote_types(model.dtype, torch.float32)
        self.mean = torch.tensor(img_norm["mean"], dtype=work, device=device)
        self.std = torch.tensor(img_norm["std"], dtype=work, device=device)
        self.precision = step_precision(model)

    @torch.no_grad()
    def assign(self, batch) -> torch.Tensor:
        """The step's assignment of ``batch`` alone: (B, N) gt_inds."""
        kw = self.spec["loss_kwargs"]
        if self.head_type == "ATSSHead":
            return atss_assign(self.anchors, self.counts, batch["gt_boxes"], batch["gt_valid"],
                               topk=kw["topk"], inside_mask=self.valid_mask)[0]
        return max_iou_assign(
            self.anchors, batch["gt_boxes"], batch["gt_valid"], pos_iou_thr=kw["pos_iou_thr"],
            neg_iou_thr=kw["neg_iou_thr"], min_pos_iou=kw["min_pos_iou"],
            gt_max_assign_all=kw["gt_max_assign_all"], match_low_quality=kw["match_low_quality"],
        )[0]

    def loss(self, model, batch) -> Dict[str, torch.Tensor]:
        """The head's losses of ``model``'s forward on ``batch``, with autograd."""
        x = preprocess_images(batch["image"], self.mean, self.std, model.dtype)
        outs = model(x)
        common = dict(num_classes=self.num_classes, encode_fn=self.spec["encode_fn"],
                      decode_fn=self.spec["decode_fn"], valid_mask=self.valid_mask, **self.spec["loss_kwargs"])
        cls_flat = flatten_anchor_outputs(outs[0], self.num_classes)
        reg_flat = flatten_anchor_outputs(outs[1], 4)
        gts = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
        if self.head_type == "ATSSHead":
            ctr_flat = flatten_anchor_outputs(outs[2], 1)[..., 0]
            return atss_loss(cls_flat, reg_flat, ctr_flat, self.anchors, self.counts, *gts, **common)
        return anchor_head_loss(cls_flat, reg_flat, self.anchors, *gts, **common)

    def __call__(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        state.tx.zero_grad()
        with self.precision():
            return _update(state, self.loss(state.model, batch))
