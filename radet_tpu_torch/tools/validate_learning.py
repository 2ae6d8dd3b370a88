"""Closed-loop learning check on synthetic BOP scenes (port of
``tools/validate_learning.py``).

Trains a small RADet from scratch (ResNet-18 with live BatchNorm, nothing
frozen) on generated scenes of filled rectangles and evaluates COCO mAP
through the strict inference path (vote-NMS at K = 2048): does training
produce a working detector.

    python -m radet_tpu_torch.tools.validate_learning [--iters 400] [--depth 18] [--device cpu]

Prints ``RESULT mAP50=... mAP=...``, then ``PASS``, or ``FAIL`` and exits 1
when mAP50 is below ``--min-map50`` (0.5).  ``--cpu`` is ``--device cpu``.
``--int8-eval`` then evaluates the same trained weights through the int8
deploy path three times (head tower only; with the trunk's 3x3 convs,
``int8_conv2``; with its 3x3 and 1x1 convs, ``int8``) and prints each
``RESULT int8-... mAP50=... mAP=...`` with its deltas.  ``--qat`` then
runs the quantization-aware loop from the same float weights: their PTQ
eval through the int8 deploy config (``--qat-quant``: ``auto`` is
int8_stream at bottleneck depths, int8 for ResNet-18/34), a QAT fine-tune
(``--qat-iters`` steps, ``norm_eval=True``, a tenth of the learning rate,
OneCycle), and the deploy eval of the fine-tuned weights; it prints
``RESULT ptq[...]`` and ``RESULT qat[...]``.  ``--frozen-int8`` (depth 50
or more) A/B-measures frozen-stage int8 training: from the same float
weights, two fine-tunes of ``--frozen-int8-iters`` steps with the stem and
layer1 frozen (``norm_eval=True``, OneCycle), one on the float path and one
with ``frozen_int8``, each evaluated on the float path; it prints
``RESULT frozen-float``, ``RESULT frozen-int8`` and ``RESULT
frozen-int8-delta``.
"""

from __future__ import annotations

import argparse
import copy
import math
import os.path as osp
import sys
import tempfile

import torch

from ..apis.common import build_model_and_anchors
from ..apis.test import test_from_config
from ..apis.train import train_detector
from ..data.synthetic import make_synthetic_bop
from ..engine.checkpoint import save_weights
from ..utils.config import Config
from ..utils.logging import get_root_logger

# --int8-eval's variants: (tag, backbone.quant), each with the head's tower in int8
INT8_EVALS = (("int8-head", None), ("int8-conv2", "int8_conv2"), ("int8-full", "int8"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a small detector on synthetic scenes and check its mAP")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--depth", type=int, default=18)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min-map50", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--img-size", type=int, nargs=2, default=(128, 160), metavar=("H", "W"))
    p.add_argument("--feat", type=int, default=64)
    p.add_argument("--stacked-convs", type=int, default=2)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--int8-eval", action="store_true",
                   help="also evaluate the trained weights through the int8 deploy path (head; + conv2; full)")
    p.add_argument("--qat", action="store_true",
                   help="then PTQ-eval the float weights through the int8 deploy path, fine-tune them with QAT "
                        "and deploy-eval the result")
    p.add_argument("--qat-iters", type=int, default=200, help="QAT fine-tune steps")
    p.add_argument("--qat-quant", default="auto",
                   help="backbone quant level of the QAT loop: int8_stream | int8 | int8_conv2 | auto "
                        "(int8_stream at bottleneck depths, int8 for ResNet-18/34)")
    p.add_argument("--frozen-int8", action="store_true",
                   help="then fine-tune the float weights twice with the stem and layer1 frozen, on the float "
                        "path and with frozen_int8, and report the mAP delta (depth 50 or more)")
    p.add_argument("--frozen-int8-iters", type=int, default=200, help="frozen-int8 A/B fine-tune steps")
    return p.parse_args(argv)


def learning_config(args, root: str) -> Config:
    """The tool's recipe over the scenes under ``root``: RADet-R18 trained
    from scratch (``frozen_stages=-1, norm_eval=False``), TBLR at 1/8,
    vote-NMS keeping 20, AdamW with OneCycle, the distance-map train
    pipeline; the test split is the training scenes."""
    h, w = args.img_size
    ann_file = osp.join(root, "detector_annotations/train_pbr.json")
    img_prefix = osp.join(root, "train_pbr/")
    return Config(dict(
        img_norm_cfg=dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
        model=dict(
            type="RADet",
            backbone=dict(depth=args.depth, out_indices=(0, 1, 2, 3), frozen_stages=-1, norm_eval=False),
            neck=dict(out_channels=args.feat, start_level=1, num_outs=5),
            bbox_head=dict(
                num_classes=args.num_classes, in_channels=args.feat,
                stacked_convs=args.stacked_convs, feat_channels=args.feat,
                anchor_generator=dict(ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
                                      strides=[8, 16, 32, 64, 128]),
                bbox_coder=dict(type="TBLRBBoxCoder", normalizer=1 / 8),
            ),
        ),
        test_cfg=dict(
            nms_pre=1000, score_thr=0.05, max_per_img=20,
            nms=dict(type="vote", iou_threshold=0.65, cluster_score=["cls", "iou"],
                     vote_score=["iou", "cls"], iou_enable=False, sigma=0.025),
        ),
        label_assignment=dict(neg_threshold=0.2, positive_num=10, balance_sample=True, max_gt=8),
        optimizer=dict(type="adamw", lr=args.lr, betas=(0.9, 0.999), weight_decay=0.01, eps=1e-8),
        lr_config=dict(policy="onecycle", max_lr=args.lr, total_steps=args.iters + 10, pct_start=0.1),
        runner=dict(max_iters=args.iters),
        checkpoint_config=dict(interval=100000, max_to_keep=1),
        evaluation=dict(interval=0),
        grad_clip=dict(max_norm=35.0),
        log_config=dict(interval=50),
        seed=0,
        compute_dtype=args.dtype,
        input_size=(h, w),
        data=dict(
            samples_per_gpu=args.batch,
            workers_per_gpu=args.workers,
            train=dict(
                ann_file=ann_file,
                img_prefix=img_prefix,
                pipeline=[
                    dict(type="LoadImageFromFile"),
                    dict(type="LoadAnnotations", with_bbox=True, with_bop_mask=True),
                    dict(type="Resize", img_scale=(w, h), keep_ratio=True),
                    dict(type="RandomFlip", flip_ratio=0.5),
                    dict(type="GenerateDistanceMap"),
                    dict(type="SampleDistanceAtAnchors"),
                    dict(type="Pad", size_divisor=16),
                ],
            ),
            test=dict(
                ann_file=ann_file,
                img_prefix=img_prefix,
                pipeline=[
                    dict(type="LoadImageFromFile"),
                    dict(type="Resize", img_scale=(w, h), keep_ratio=True),
                    dict(type="Pad", size_divisor=32),
                ],
            ),
        ),
    ))


def int8_eval(cfg, model, metrics, batch: int, device) -> dict:
    """The trained ``model``'s weights evaluated through each variant of
    ``INT8_EVALS``; prints each one's RESULT line, returns their metrics."""
    out = {}
    weights = model.state_dict()
    for tag, trunk in INT8_EVALS:
        cfg_q = copy.deepcopy(cfg)
        cfg_q.model["bbox_head"]["quant"] = "int8"
        if trunk:
            cfg_q.model["backbone"]["quant"] = trunk
        model_q = build_model_and_anchors(cfg_q, dtype=model.dtype)[0]
        model_q.load_state_dict(weights)
        _, _, m = test_from_config(cfg_q, model_q.to(device), split="test", batch_size=batch)
        print(f"RESULT {tag} mAP50={m['bbox_mAP_50']:.3f} mAP={m['bbox_mAP']:.3f} "
              f"(delta mAP50 {m['bbox_mAP_50'] - metrics['bbox_mAP_50']:+.3f}, "
              f"mAP {m['bbox_mAP'] - metrics['bbox_mAP']:+.3f})", flush=True)
        out[tag] = m
    return out


def qat_loop(args, cfg, model, metrics, root: str, device) -> dict:
    """The QAT recovery loop on the trained float ``model``: (a) its weights
    through the int8 deploy config, (b) a QAT fine-tune from them, (c) the
    fine-tuned weights through the same deploy config.  Prints the
    ``RESULT ptq[...]`` and ``RESULT qat[...]`` lines; returns both evals'
    metrics."""
    trunk = args.qat_quant
    if trunk == "auto":
        trunk = "int8_stream" if args.depth >= 50 else "int8"

    def deploy(weights):
        cfg_q = copy.deepcopy(cfg)
        cfg_q.model["backbone"]["quant"] = trunk
        cfg_q.model["bbox_head"]["quant"] = "int8"
        model_q = build_model_and_anchors(cfg_q, dtype=model.dtype)[0]
        model_q.load_state_dict(weights)
        return test_from_config(cfg_q, model_q.to(device), split="test", batch_size=args.batch)[2]

    m_ptq = deploy(model.state_dict())
    print(f"RESULT ptq[{trunk}] mAP50={m_ptq['bbox_mAP_50']:.3f} mAP={m_ptq['bbox_mAP']:.3f} "
          f"(delta vs float: mAP50 {m_ptq['bbox_mAP_50'] - metrics['bbox_mAP_50']:+.3f}, "
          f"mAP {m_ptq['bbox_mAP'] - metrics['bbox_mAP']:+.3f})", flush=True)

    float_weights = osp.join(root, "float_weights.pth")
    save_weights(float_weights, model.state_dict())
    cfg_t = copy.deepcopy(cfg)
    for part, opts in (("backbone", dict(quant=trunk, qat=True, norm_eval=True)),
                       ("bbox_head", dict(quant="int8", qat=True))):
        for key, value in opts.items():
            cfg_t.model[part][key] = value
    cfg_t["load_from"] = float_weights
    cfg_t.optimizer["lr"] = args.lr / 10
    cfg_t["lr_config"] = dict(policy="onecycle", max_lr=args.lr / 10, total_steps=args.qat_iters + 10,
                              pct_start=0.1)
    cfg_t["runner"] = dict(max_iters=args.qat_iters)
    state = train_detector(cfg_t, work_dir=osp.join(root, "work_qat"), eval_during_train=False, device=device)

    m_qat = deploy(state.model.state_dict())
    d_ptq = m_qat["bbox_mAP"] - m_ptq["bbox_mAP"]
    gap = metrics["bbox_mAP"] - m_ptq["bbox_mAP"]
    rec = d_ptq / gap if abs(gap) > 1e-9 else math.nan
    print(f"RESULT qat[{trunk}] mAP50={m_qat['bbox_mAP_50']:.3f} mAP={m_qat['bbox_mAP']:.3f} "
          f"(vs ptq: mAP {d_ptq:+.3f}; recovered {rec:.0%} of the {-gap:+.3f} PTQ gap after {args.qat_iters} "
          f"steps)", flush=True)
    return {f"ptq[{trunk}]": m_ptq, f"qat[{trunk}]": m_qat}


def frozen_int8_ab(args, cfg, model, root: str, device) -> dict:
    """Frozen-stage int8 training against the same recipe on the float path:
    the trained float ``model``'s weights fine-tuned twice for
    ``--frozen-int8-iters`` steps with the stem and layer1 frozen
    (``norm_eval=True``: the static scales read the fitted running
    statistics; OneCycle over the steps + 10), once with ``frozen_int8``;
    both evaluated on the float path (the flag does nothing at eval).
    Prints the three RESULT lines; returns both arms' metrics."""
    float_weights = osp.join(root, "float_weights_fi8.pth")
    save_weights(float_weights, model.state_dict())
    ab = {}
    for tag, fi8 in (("frozen-float", False), ("frozen-int8", True)):
        cfg_t = copy.deepcopy(cfg)
        for key, value in dict(frozen_stages=1, norm_eval=True, frozen_int8=fi8).items():
            cfg_t.model["backbone"][key] = value
        cfg_t["load_from"] = float_weights
        cfg_t["lr_config"] = dict(policy="onecycle", max_lr=args.lr, total_steps=args.frozen_int8_iters + 10,
                                  pct_start=0.1)
        cfg_t["runner"] = dict(max_iters=args.frozen_int8_iters)
        state = train_detector(cfg_t, work_dir=osp.join(root, f"work_{tag}"), eval_during_train=False,
                               device=device)
        _, _, m = test_from_config(cfg_t, state.model, split="test", batch_size=args.batch)
        ab[tag] = m
        print(f"RESULT {tag} mAP50={m['bbox_mAP_50']:.3f} mAP={m['bbox_mAP']:.3f}", flush=True)
    d50 = ab["frozen-int8"]["bbox_mAP_50"] - ab["frozen-float"]["bbox_mAP_50"]
    d = ab["frozen-int8"]["bbox_mAP"] - ab["frozen-float"]["bbox_mAP"]
    print(f"RESULT frozen-int8-delta mAP50={d50:+.3f} mAP={d:+.3f} (frozen_int8 training vs the identical "
          f"frozen-float recipe, {args.frozen_int8_iters} fine-tune steps each)", flush=True)
    return ab


def main(argv=None) -> dict:
    """Run the check; returns the COCO metrics (exits 1 below ``--min-map50``)."""
    args = parse_args(argv)
    if args.frozen_int8 and args.depth < 50:
        raise AssertionError("--frozen-int8 reuses the int8_stream Bottleneck path: run with --depth 50")
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu (or --cpu) to run on the CPU")
    logger = get_root_logger()
    with tempfile.TemporaryDirectory(prefix="radet_learn_") as root:
        make_synthetic_bop(root, num_scenes=1, images_per_scene=args.images, img_hw=tuple(args.img_size),
                           num_classes=args.num_classes, max_objects=3)
        cfg = learning_config(args, root)
        state = train_detector(cfg, work_dir=osp.join(root, "work"), eval_during_train=False, device=device)
        _, _, metrics = test_from_config(cfg, state.model, split="test", batch_size=args.batch)
        logger.info("final metrics: " + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
        map50 = metrics["bbox_mAP_50"]
        print(f"RESULT mAP50={map50:.3f} mAP={metrics['bbox_mAP']:.3f}", flush=True)
        if args.int8_eval:
            metrics["int8_eval"] = int8_eval(cfg, state.model, metrics, args.batch, device)
        if args.qat:
            metrics["qat"] = qat_loop(args, cfg, state.model, metrics, root, device)
        if args.frozen_int8:
            metrics["frozen_int8"] = frozen_int8_ab(args, cfg, state.model, root, device)
    if map50 < args.min_map50:
        print(f"FAIL: mAP50 {map50:.3f} < {args.min_map50}", flush=True)
        sys.exit(1)
    print("PASS", flush=True)
    return metrics


if __name__ == "__main__":
    main()
