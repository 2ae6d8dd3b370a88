"""Offline evaluation of pickled results against a config's dataset (port of
``tools/eval_metric.py``).

    python -m radet_tpu_torch.tools.eval_metric CONFIG RESULTS.pkl [--split test]
        [--eval-options classwise=True]

``RESULTS.pkl`` is what ``python -m radet_tpu_torch.tools.test --out``
writes (per-image dicts of boxes, scores, labels and img_id); the pickle is
unpickled, so read only files that the test CLI wrote.  Prints the COCO
bbox metrics as JSON, the same numbers the test CLI prints with ``--eval
bbox``.  Runs on the host alone: no card is needed.
"""

from __future__ import annotations

import argparse
import json
import pickle

from ..apis.common import build_dataset
from ..apis.test import evaluate_results
from ..utils.config import Config, parse_kv_options


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate pickled radet_tpu_torch results")
    p.add_argument("config")
    p.add_argument("results", help="pickle written by python -m radet_tpu_torch.tools.test --out")
    p.add_argument("--split", default="test", choices=["test", "val"])
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--eval-options", nargs="+", default=None, help="e.g. classwise=True for per-class AP")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config, args.cfg_options)
    dataset = build_dataset(cfg, args.split)
    with open(args.results, "rb") as f:
        results = pickle.load(f)
    eval_options = parse_kv_options(args.eval_options)
    metrics = evaluate_results(dataset, results, classwise=bool(eval_options.get("classwise", False)))
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
