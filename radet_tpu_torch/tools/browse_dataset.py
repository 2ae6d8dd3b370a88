"""Show the training pipeline's output (port of ``tools/browse_dataset.py``).

    python -m radet_tpu_torch.tools.browse_dataset CONFIG [--split train] [--output-dir D]
        [--num 10] [--show-dist] [--show-assignment] [--device cuda|cpu] [--cfg-options ...]

Writes ``D/sample_{i:04d}.jpg`` (default ``work_dirs/browse``) for the first
``--num`` samples of ``cfg.data[split]`` and prints each path: the image
after the pipeline with its valid GT boxes and labels in green;
``--show-dist`` adds a dot at every anchor centre where the largest of the
sample's distance values is above 0, red by that value; ``--show-assignment``
runs the label assignment (``core/assignment.py::assign_labels``) on
``--device`` and paints each positive anchor centre in its GT's colour,
the dot's radius its rounded sample weight, with the counts of positive
and ignored anchors in the corner.  The assignment draws its noise from
``torch.Generator(device).manual_seed(i)``; the JAX tool draws from
``PRNGKey(i)``, so the two tools' dots differ.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Tuple

import numpy as np
import torch

from ..apis.common import anchor_cfg_from_model, build_dataset
from ..core.anchors import anchor_centers, generate_anchors
from ..core.assignment import assign_labels
from ..utils.config import Config
from ..utils.image_write import imwrite
from ..utils.profiling import resolve_device
from ..utils.raster import FILLED, FONT_HERSHEY_SIMPLEX, circle, put_text, rectangle

_GT_COLORS = [
    (255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64),
    (255, 64, 255), (64, 255, 255), (255, 160, 64), (160, 64, 255),
]
# the label-assignment options the JAX tool passes through from the config
ASSIGN_KEYS = ("positive_num", "neg_threshold", "balance_sample", "adapt_positive_num",
               "random_sample_by_distance", "multiply_samplepro_for_weight", "ambiguous_sample")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Show the training pipeline's output")
    p.add_argument("config")
    p.add_argument("--split", default="train")
    p.add_argument("--output-dir", default="work_dirs/browse")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--show-dist", action="store_true", help="overlay distance values at anchor centers")
    p.add_argument("--show-assignment", action="store_true",
                   help="run the label assignment on --device and paint the sampled positive cells per GT")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: where the assignment runs")
    p.add_argument("--cfg-options", nargs="+", default=None)
    return p.parse_args(argv)


def draw_sample(sample, centers: np.ndarray, show_dist: bool = False,
                assignment: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
    """One sample drawn as the JAX tool's loop draws it: ``sample``'s RGB
    ``image`` with its valid GTs, then (``show_dist``) the distance dots at
    ``centers``, then the ``assignment``'s (gt_idx (N,), weight (N,))
    dots and counts.  Returns the BGR image."""
    img = np.ascontiguousarray(sample["image"][..., ::-1])
    for box, label, valid in zip(sample["gt_boxes"], sample["gt_labels"], sample["gt_valid"]):
        if not valid:
            continue
        x1, y1, x2, y2 = [int(v) for v in box]
        rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        put_text(img, str(int(label)), (x1, max(0, y1 - 4)), FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    if show_dist and "dist_vals" in sample:
        v = sample["dist_vals"].max(axis=1)  # max over GTs per anchor
        for (cx, cy), val in zip(centers, v):
            if val > 0:
                c = int(255 * min(1.0, val))
                circle(img, (int(cx), int(cy)), 1, (0, 0, c), FILLED)
    if assignment is not None:
        gt_idx, weight = assignment
        for (cx, cy), g, w in zip(centers, gt_idx, weight):
            if g >= 0:
                circle(img, (int(cx), int(cy)), max(1, int(round(w))), _GT_COLORS[int(g) % len(_GT_COLORS)], FILLED)
        n_pos = int((gt_idx >= 0).sum())
        n_ign = int((gt_idx == -2).sum())
        put_text(img, f"pos {n_pos} ign {n_ign}", (4, 14), FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1)
    return img


def assign_sample(sample, anchors: torch.Tensor, ranges: torch.Tensor, assign_kwargs: dict, seed: int):
    """``assign_labels`` of one sample on ``anchors``' device, its noise from
    ``torch.Generator(device).manual_seed(seed)``: numpy (gt_idx, weight)."""
    device = anchors.device
    res = assign_labels(
        anchors, ranges,
        torch.as_tensor(sample["gt_boxes"], device=device)[None],
        torch.as_tensor(sample["gt_valid"], device=device)[None],
        torch.as_tensor(sample["dist_vals"].astype(np.float32), device=device)[None],
        generator=torch.Generator(device).manual_seed(seed), **assign_kwargs,
    )
    return res.gt_idx[0].cpu().numpy(), res.weight[0].cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config, args.cfg_options)
    dataset = build_dataset(cfg, args.split, test_mode=(args.split != "train"))
    os.makedirs(args.output_dir, exist_ok=True)
    # the anchors the dataset pipeline sampled its distance values at
    la = cfg.get("label_assignment")
    la = la.to_dict() if la is not None else None
    anchors, ranges, _, _ = generate_anchors(
        tuple(cfg.get("input_size", (480, 640))), anchor_cfg_from_model(cfg.model.to_dict(), la))
    centers = anchor_centers(anchors)
    assign_kwargs = {k: la[k] for k in ASSIGN_KEYS if k in (la or {})}
    anchors_t = torch.as_tensor(anchors, device=device)
    ranges_t = torch.as_tensor(ranges, device=device)
    for i in range(min(args.num, len(dataset))):
        s = dataset[i]
        assignment = None
        if "gt_boxes" in s and args.show_assignment and "dist_vals" in s:
            assignment = assign_sample(s, anchors_t, ranges_t, assign_kwargs, seed=i)
        if "gt_boxes" in s:
            img = draw_sample(s, centers, show_dist=args.show_dist, assignment=assignment)
        else:
            img = np.ascontiguousarray(s["image"][..., ::-1])
        out = osp.join(args.output_dir, f"sample_{i:04d}.jpg")
        imwrite(out, img)
        print(out)


if __name__ == "__main__":
    main()
