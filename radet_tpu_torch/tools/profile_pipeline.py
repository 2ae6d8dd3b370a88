"""Host input-pipeline throughput (port of ``tools/profile_pipeline.py``).

    python -m radet_tpu_torch.tools.profile_pipeline [--config CFG] [--samples 40]
        [--workers 1 2 4] [--mode thread process] [--pipeline train|test] [--target-img-s R]

Can the host feed the card?  Measures, on this machine's CPU:

1. each transform's wall time per sample over the pipeline (decode, masks,
   ``RandomBackground``, ``CosyPoseAug``, resize, flip, distance map, the
   anchor-centre samples, pad; for ``--pipeline test`` decode, resize and
   pad),
2. the cost per sample end to end and the single-core img/s,
3. the loader's img/s (``data.loader.DataLoader``) over ``--workers`` in
   each ``--mode`` (threads, spawned processes),
4. the busy cores needed to sustain ``--target-img-s``, the card's rate.

The default targets are the port's own card numbers (PERF.md §6, the
backbone zoo's entry; NVIDIA H100 80GB HBM3 at 700 W): 222.6 img/s for
``train`` (the flagship's train step at batch 16, 71.87 ms) and 918.8
img/s for ``test`` (inference at batch 128, 139.32 ms).  With no ``--config`` the scenes are synthetic
(``data/synthetic.py``: 480x640 PNG images of up to 8 rectangles with their
``mask_visib`` PNGs, one PNG background) in ``--work-dir`` (default: a
temporary directory, removed at the end).  Prints a table, then one JSON
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import tempfile
import time

import numpy as np

from ..apis.common import build_dataset
from ..data.bop import BOPDataset
from ..data.loader import DataLoader
from ..data.synthetic import make_synthetic_bop
from ..utils.config import Config
from ..utils.image_write import write_png

TARGET_IMG_S = {"train": 222.6, "test": 918.8}  # PERF.md §6, the flagship on the H100 at 700 W


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Profile the radet_tpu_torch host input pipeline")
    p.add_argument("--config", default=None, help="config with data.train / data.test; synthetic scenes without")
    p.add_argument("--samples", type=int, default=40)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--mode", nargs="+", default=["thread", "process"], choices=["thread", "process"])
    p.add_argument("--pipeline", choices=["train", "test"], default="train",
                   help="the training chain (decode, masks, augmentation, distance maps) or the eval chain "
                        "(decode, resize, pad)")
    p.add_argument("--target-img-s", type=float, default=None,
                   help="device rate to sustain (default: the H100's train step at batch 16, 222.6 img/s, "
                        "for train, and its batch-128 inference, 918.8 img/s, for test; PERF.md §6)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--work-dir", default=None, help="where to write the synthetic scenes")
    p.add_argument("--input-size", type=int, nargs=2, default=(480, 640))
    return p.parse_args(argv)


def synthetic_dataset(args, root: str) -> BOPDataset:
    """The JAX tool's synthetic scene set and pipelines, written without cv2."""
    h, w = args.input_size
    ann = osp.join(root, "detector_annotations", "train_pbr.json")
    if not osp.exists(ann):
        make_synthetic_bop(root, num_scenes=1, images_per_scene=8, img_hw=(h, w), num_classes=10, max_objects=8)
    bg_dir = osp.join(root, "bg")
    os.makedirs(bg_dir, exist_ok=True)
    bg_file = osp.join(bg_dir, "bg0.png")
    if not osp.exists(bg_file):
        write_png(bg_file, np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8))
    if args.pipeline == "test":
        pipeline = [
            dict(type="LoadImageFromFile"),
            dict(type="Resize", img_scale=(w, h), keep_ratio=True),
            dict(type="Pad", size_divisor=32),
        ]
    else:
        pipeline = [
            dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True, with_bop_mask=True),
            dict(type="Resize", img_scale=(w, h), keep_ratio=True),
            dict(type="RandomBackground", background_dir=bg_dir, prob=0.3),
            dict(type="CosyPoseAug", p=0.8, pipelines=[
                dict(type="PillowBlur", p=1.0, factor_interval=(1, 3)),
                dict(type="PillowSharpness", p=0.3, factor_interval=(0.0, 50.0)),
                dict(type="PillowContrast", p=0.3, factor_interval=(0.2, 50.0)),
                dict(type="PillowBrightness", p=0.5, factor_interval=(0.1, 6.0)),
                dict(type="PillowColor", p=0.3, factor_interval=(0.0, 20.0)),
            ]),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="GenerateDistanceMap"),
            dict(type="SampleDistanceAtAnchors"),
            dict(type="Pad", size_divisor=16),
        ]
    return BOPDataset(ann, img_prefix=osp.join(root, "train_pbr/"), pipeline=pipeline,
                      test_mode=args.pipeline == "test", input_size=(h, w))


def config_dataset(args):
    cfg = Config.fromfile(args.config)
    if args.pipeline == "test":
        return build_dataset(cfg, "test", test_mode=True)
    return build_dataset(cfg, "train", test_mode=False)


class _Timed:
    def __init__(self, t, acc):
        self.t = t
        self.acc = acc
        self.name = type(t).__name__

    def __call__(self, results):
        t0 = time.perf_counter()
        out = self.t(results)
        self.acc[self.name] = self.acc.get(self.name, 0.0) + (time.perf_counter() - t0)
        return out


def profile_transforms(ds, n: int):
    """(seconds by transform name, total seconds) over ``n`` samples."""
    acc = {}
    orig = ds.pipeline.transforms
    ds.pipeline.transforms = [_Timed(t, acc) for t in orig]
    try:
        t0 = time.perf_counter()
        for i in range(n):
            ds[i % len(ds)]
        total = time.perf_counter() - t0
    finally:
        ds.pipeline.transforms = orig
    return acc, total


def loader_rate(ds, batch: int, workers: int, mode: str, n_batches: int = 6) -> float:
    loader = DataLoader(ds, batch_size=batch, shuffle=True, num_workers=workers, infinite=True,
                        worker_mode=mode, prefetch_batches=2)
    it = iter(loader)
    try:
        next(it)  # start the workers
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return n_batches * batch / (time.perf_counter() - t0)
    finally:
        it.close()


def run(args, ds) -> dict:
    n = min(args.samples, max(8, len(ds)))
    print(f"dataset: {len(ds)} images, pipeline: {[type(t).__name__ for t in ds.pipeline.transforms]}")
    for i in range(min(len(ds), n)):  # page cache warm: decode times are CPU, not first-touch disk
        ds[i]
    acc, total = profile_transforms(ds, n)
    per_sample = total / n
    rows = sorted(acc.items(), key=lambda kv: -kv[1])
    t_sum = sum(acc.values())
    print(f"\nper-transform cost over {n} samples ({per_sample * 1000:.2f} ms/sample end-to-end):")
    print(f"{'transform':<28}{'ms/sample':>10}{'share':>8}")
    for name, t in rows:
        print(f"{name:<28}{t / n * 1000:>10.2f}{t / t_sum * 100:>7.1f}%")
    other = total - t_sum
    print(f"{'(dataset overhead)':<28}{other / n * 1000:>10.2f}{other / total * 100:>7.1f}%")

    single_core_img_s = 1.0 / per_sample
    cores_needed = args.target_img_s / single_core_img_s
    print(f"\nsingle-thread: {single_core_img_s:.1f} img/s -> ~{cores_needed:.1f} busy cores to sustain "
          f"{args.target_img_s} img/s (assuming linear scaling; measured below)")
    scaling = {}
    for mode in args.mode:
        for wk in args.workers:
            r = loader_rate(ds, args.batch, wk, mode)
            scaling[f"{mode}x{wk}"] = r
            print(f"loader {mode} x{wk}: {r:.1f} img/s")
    return dict(
        pipeline=args.pipeline,
        samples=n,
        per_sample_ms=per_sample * 1000,
        single_core_img_s=single_core_img_s,
        target_img_s=args.target_img_s,
        cores_needed=cores_needed,
        transforms={k: v / n * 1000 for k, v in rows},
        loader_scaling=scaling,
        host_cores=os.cpu_count(),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.target_img_s is None:
        args.target_img_s = TARGET_IMG_S[args.pipeline]
    if args.config:
        summary = run(args, config_dataset(args))
    elif args.work_dir:
        summary = run(args, synthetic_dataset(args, args.work_dir))
    else:
        with tempfile.TemporaryDirectory(prefix="radet_pipeline_") as root:
            summary = run(args, synthetic_dataset(args, root))
    print("\n" + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
