"""Train a detector from a config file (port of ``tools/train.py``).

    python -m radet_tpu_torch.tools.train CONFIG [--work-dir DIR] [--resume-from [CKPT]]
        [--seed N] [--max-iters N] [--no-validate] [--cfg-options k=v ...] [--device cuda|cpu]

The training data is ``cfg.data.train`` read from its files
(``apis.train.train_detector``).  ``--resume-from`` without a value resumes
from the work dir's latest checkpoint.  Runs on the card unless
``--device cpu``.  ``--gpus``, ``--gpu-ids`` and a ``--launcher`` other than
``none`` are multi-GPU options, which are not ported; ``--deterministic``
is accepted, as the JAX package's CLI accepts it.
"""

from __future__ import annotations

import argparse

from ..apis.train import train_detector
from ..utils.config import Config
from ..utils.logging import get_root_logger

_MULTI_GPU = "ROADMAP.md Queue 1 item 13, multi-GPU"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a radet_tpu_torch detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", nargs="?", const="auto", default=None,
                   help="resume from a checkpoint, or from the latest in work_dir without a value")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-iters", type=int, default=None, help="override runner.max_iters")
    p.add_argument("--no-validate", action="store_true", help="skip eval during training")
    p.add_argument("--cfg-options", "--options", nargs="+", default=None,
                   help="override config entries, e.g. data.samples_per_gpu=8")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--deterministic", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--gpus", type=int, default=None, help=f"not ported ({_MULTI_GPU})")
    p.add_argument("--gpu-ids", type=int, nargs="+", default=None, help=f"not ported ({_MULTI_GPU})")
    p.add_argument("--launcher", default="none", help=f"only 'none' ({_MULTI_GPU})")
    p.add_argument("--local_rank", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, given in (("--gpus", args.gpus is not None), ("--gpu-ids", args.gpu_ids is not None),
                        (f"--launcher {args.launcher}", args.launcher != "none")):
        if given:
            raise NotImplementedError(f"{flag} is not ported ({_MULTI_GPU})")
    cfg = Config.fromfile(args.config, args.cfg_options)
    get_root_logger().info(f"config: {args.config}")
    state = train_detector(
        cfg,
        work_dir=args.work_dir,
        resume_from=args.resume_from,
        max_iters=args.max_iters,
        seed=args.seed,
        eval_during_train=not args.no_validate,
        device=args.device,
    )
    get_root_logger().info(f"trained to step {state.step}")


if __name__ == "__main__":
    main()
