"""Test a detector: batched inference, COCO bbox evaluation and result export
(port of ``tools/test.py``).

    python -m radet_tpu_torch.tools.test CONFIG [CHECKPOINT] --eval bbox
    python -m radet_tpu_torch.tools.test CONFIG CHECKPOINT --format-only --json-prefix out/p

``CHECKPOINT`` is any of the port's weight files (``engine.checkpoint.load_weights``):
a ``.pth`` state dict, a trainer's checkpoint directory or step directory,
or ``best_weights.pth``; without one the weights are random.  Outputs:
``--out results.pkl`` (pickled per-image results); ``--format-only`` /
``--json-prefix p`` writes ``p.bbox.json`` (COCO results) and, for a dataset
with ``bop_submission=True``, ``p.bop.json`` (BOP submission format).
``--eval bbox`` prints the metrics as JSON on stdout; logs go to stderr.
``--show-dir D`` draws each image's detections at or above
``--show-score-thr`` (``utils/visualization.py::imshow_det_bboxes``) into
``D/<file name with "/" as "_">``, in the format of its extension (PNG for
the BOP test sets); ``--show`` draws into ``work_dir/shown`` (no display).
``--fuse-conv-bn`` folds the trunk's frozen BatchNorms into its
convolutions before testing (``models/fuse.py``; exact).  Test-time
augmentation is the config's: ``--cfg-options test_cfg.flip_tta=True``
(horizontal flip), or ``test_cfg.tta.scales=...`` with
``test_cfg.tta.flip`` (several scales, optionally flipped), each batch's
views fused on the vote-NMS kernel; and ``test_cfg.nms_impl=scan`` runs
vote-NMS over every candidate.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle

import torch

from ..apis.common import build_model_and_anchors
from ..apis.test import test_from_config
from ..data.image_io import imread_rgb
from ..engine.checkpoint import load_weights
from ..models.fuse import fuse_conv_bn
from ..utils.config import Config, parse_kv_options
from ..utils.logging import get_root_logger
from ..utils.visualization import imshow_det_bboxes

_MULTI_GPU = "ROADMAP.md Queue 1 item 13, multi-GPU"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a radet_tpu_torch detector")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None, help="weights (.pth, checkpoint directory)")
    p.add_argument("--out", help="output results pickle")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--json-prefix", default=None)
    p.add_argument("--eval", nargs="+", default=None, choices=["bbox"], help="metrics: bbox")
    p.add_argument("--split", default="test", choices=["test", "val"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--fast", action="store_true",
                   help="the deploy candidate path (one global top-k) instead of the default "
                        "strict reference semantics (apis/test.py::strict_eval_overrides)")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--eval-options", "--options", nargs="+", default=None,
                   help="evaluation kwargs as key=value, e.g. classwise=True")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # --show before --show-dir, which it would otherwise abbreviate
    p.add_argument("--show", action="store_true", help="draw into work_dir/shown (no display)")
    p.add_argument("--show-dir", default=None, help="draw the detections onto the images and save them here")
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--fuse-conv-bn", action="store_true",
                   help="fold the frozen BatchNorms into the preceding convolutions "
                        "(exact: they are constant affines at eval; models/fuse.py)")
    # the reference CLI's launcher flags: one process, results gathered in it
    for flag in ("--gpu-collect", "--shuffle"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tmpdir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--launcher", default="none", help=f"only 'none' ({_MULTI_GPU})")
    p.add_argument("--local_rank", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher} is not ported ({_MULTI_GPU})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to test on the CPU")
    cfg = Config.fromfile(args.config, args.cfg_options)
    if args.fuse_conv_bn and cfg.get("model", {}).get("backbone", {}).get("quant"):
        raise ValueError(
            "--fuse-conv-bn is incompatible with backbone.quant='int8': the int8 trunk derives static "
            "activation scales from the frozen BN affine params, which folding erases (resnet._bn_act_scale)")
    logger = get_root_logger()
    eval_options = parse_kv_options(args.eval_options)
    if args.show and not args.show_dir:
        args.show_dir = osp.join(cfg.get("work_dir", "work_dirs"), "shown")
        logger.info(f"--show: rendering to {args.show_dir} (no display)")
    # convolutions in the config's compute dtype on a card, float32 on the CPU
    model = build_model_and_anchors(cfg, dtype=None if device.type == "cuda" else "float32")[0]
    if args.checkpoint:
        model.load_state_dict(load_weights(args.checkpoint), strict=True)
        logger.info(f"loaded checkpoint {args.checkpoint}")
    else:
        model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        logger.warning("no checkpoint given: random weights")
    if args.fuse_conv_bn:
        weights, report = fuse_conv_bn(model.state_dict())
        model.load_state_dict(weights, strict=True)
        logger.info(f"--fuse-conv-bn: folded {report['fused']} frozen BNs into conv weights "
                    f"({report['skipped']} left in place: {report['skipped_paths'] or 'none'})")
    model.to(device).eval()

    dataset, results, metrics = test_from_config(
        cfg, model, split=args.split, batch_size=args.batch_size, fmt_only=args.eval is None,
        strict=not args.fast, eval_options=eval_options,
    )
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"results written to {args.out}")
    if args.format_only or args.json_prefix:
        prefix = args.json_prefix or (osp.splitext(args.out)[0] if args.out else "results")
        with open(prefix + ".bbox.json", "w") as f:
            json.dump(dataset.det2json(results), f)
        logger.info(f"COCO results: {prefix}.bbox.json")
        if dataset.bop_submission:
            with open(prefix + ".bop.json", "w") as f:
                json.dump(dataset.bop_det2json(results), f)
            logger.info(f"BOP submission: {prefix}.bop.json")
    if args.show_dir:
        os.makedirs(args.show_dir, exist_ok=True)
        id_to_info = {info["id"]: info for info in dataset.data_infos}
        for r in results:
            info = id_to_info[r["img_id"]]
            img = imread_rgb(osp.join(dataset.img_prefix, info["filename"]))
            imshow_det_bboxes(img, r["boxes"], r["labels"], r["scores"], class_names=dataset.CLASSES,
                              score_thr=args.show_score_thr,
                              out_file=osp.join(args.show_dir, info["filename"].replace("/", "_")))
        logger.info(f"rendered {len(results)} images to {args.show_dir}")
    if args.eval:
        for k, v in metrics.items():
            logger.info(f"{k}: {v:.4f}")
        print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
