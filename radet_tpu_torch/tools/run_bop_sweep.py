"""Run the BOP-core seven-dataset sweep: train and/or test each dataset's
config in turn on one device (port of ``tools/run_bop_sweep.py``).

    python -m radet_tpu_torch.tools.run_bop_sweep --mode test --checkpoint-root work_dirs
    python -m radet_tpu_torch.tools.run_bop_sweep --mode train --max-iters 100000
    python -m radet_tpu_torch.tools.run_bop_sweep --datasets ycbv lmo --mode both [--device cpu]

Datasets: ycbv, lmo, tless, itodd, hb, icbin, tudl (``configs/bop/r50_<dataset>_<suffix>.py``,
whose data roots are relative to the working directory).  ``--checkpoint-root R`` tests the
trainer's checkpoints under ``R/<basename of the config's work_dir>/checkpoints``; without one a
dataset is tested with the seeded random weights.  A dataset that fails is logged and recorded,
and the sweep goes on.  Writes the summary json (``--out``) and prints a table.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
import traceback

import torch

from ..apis.common import build_model_and_anchors
from ..apis.test import test_from_config
from ..apis.train import train_detector
from ..engine.checkpoint import load_weights
from ..utils.config import Config
from ..utils.logging import get_root_logger

DATASETS = ["ycbv", "lmo", "tless", "itodd", "hb", "icbin", "tudl"]
CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), "configs", "bop")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train and/or test the BOP datasets' configs in turn")
    p.add_argument("--datasets", nargs="+", default=DATASETS, choices=DATASETS)
    p.add_argument("--mode", choices=["train", "test", "both"], default="both")
    p.add_argument("--config-dir", default=CONFIG_DIR)
    p.add_argument("--suffix", default="pbr", help="config suffix: pbr or mixpbr")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--checkpoint-root", default=None,
                   help="for --mode test: root containing <work_dir>/checkpoints per dataset")
    p.add_argument("--out", default="work_dirs/bop_sweep_summary.json")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _test_model(cfg, ds: str, args, device, entry: dict, logger):
    """The model to test when this run trained none: the seeded random init,
    or the weights under ``--checkpoint-root``."""
    # convolutions in the config's compute dtype on a card, float32 on the CPU
    model = build_model_and_anchors(cfg, dtype=None if device.type == "cuda" else "float32")[0]
    model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    ckpt = None
    if args.checkpoint_root:
        cand = osp.join(args.checkpoint_root, osp.basename(cfg.get("work_dir", f"work_dirs/{ds}")), "checkpoints")
        ckpt = cand if osp.isdir(cand) else None
    if ckpt:
        model.load_state_dict(load_weights(ckpt), strict=True)
        entry["checkpoint"] = ckpt
    else:
        logger.warning(f"{ds}: no checkpoint found — testing random weights")
    return model.to(device)


def main(argv=None) -> dict:
    """Run the sweep; returns the summary it writes."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the sweep on the CPU")
    logger = get_root_logger()
    summary = {}
    for ds in args.datasets:
        cfg_path = osp.join(args.config_dir, f"r50_{ds}_{args.suffix}.py")
        entry = {"config": cfg_path}
        t0 = time.time()
        try:
            cfg = Config.fromfile(cfg_path, args.cfg_options)
            state = None
            if args.mode in ("train", "both"):
                logger.info(f"=== sweep: training {ds} ===")
                state = train_detector(cfg, max_iters=args.max_iters, device=device)
            if args.mode in ("test", "both"):
                logger.info(f"=== sweep: testing {ds} ===")
                model = state.model if state is not None else _test_model(cfg, ds, args, device, entry, logger)
                _, _, metrics = test_from_config(cfg, model)
                entry["metrics"] = metrics
            entry["status"] = "ok"
        except Exception as e:  # noqa: BLE001 - the sweep goes on past a failed dataset, and records it
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"
            logger.error(f"{ds} failed:\n{traceback.format_exc()}")
        entry["seconds"] = round(time.time() - t0, 1)
        summary[ds] = entry

    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"\n{'dataset':<8} {'status':<8} {'mAP':>7} {'mAP50':>7} {'sec':>8}")
    for ds, e in summary.items():
        m = e.get("metrics", {})
        print(
            f"{ds:<8} {e['status']:<8} "
            f"{m.get('bbox_mAP', float('nan')):>7.3f} "
            f"{m.get('bbox_mAP_50', float('nan')):>7.3f} "
            f"{e['seconds']:>8.1f}"
        )
    print(f"summary written to {args.out}")
    return summary


if __name__ == "__main__":
    main()
