#!/usr/bin/env python3
"""Drive the PyTorch port (``radet_tpu_torch``) once on a CUDA card.

Run from the repository root, with one card:  python3 chip_smoke.py

1. prints the card and builds, in parallel, the vote-NMS kernel and the host
   PNG unfilter from ``radet_tpu_torch/csrc``;
2. holds the kernel against its plain PyTorch version, run in float64 on
   the CPU (the reference of every comparison below), on synthetic
   clustered candidates (B=128, K in {512, 1024}, global_mode x iou_enable);
3. runs the flagship inference path: ``init_detector`` on
   ``configs/bop/r50_ycbv_pbr.py`` at full width (seeded random weights,
   bf16 convolutions) and ``inference_detector`` on 8 synthetic 480x640
   images, counting the kernel's launches; checks the NMS inputs of that run
   through the plain version, the float32 forward against the CPU
   forward, and the untouched random init for NaNs;
4. times the main path at batch 8 and 128 and the kernel against the plain
   version at B=128, K=512 with CUDA events;
5. evaluates: the kernel against the plain version at K in
   {1024, 1025, 2048, 4420}, both modes, timing both on the card (the
   shared-memory bound, and the global-scratch path the strict eval's
   K = 2048 takes); a synthetic BOP test set written as PNG by
   ``tests/synthetic_bop.py`` (96 images at
   480x640, 16 at T-LESS's 540x720, 16 portrait 640x480; filled rectangles
   of 21 classes, COCO json), decoded by the C++ unfilter and its numpy
   twin; the test CLI (``python -m radet_tpu_torch.tools.test --eval bbox
   --format-only``, strict, full width, bf16, random weights with the cls
   bias at 0) in a subprocess, checking its jsons and kernel launches; then
   ``test_from_config`` in this process through the kernel (timed, files
   to metrics), whose vote-NMS inputs and outputs are recorded and held to
   the plain version, and through the plain version, whose labels, boxes
   and metrics must agree, and the set's ground truth as detections, which
   must score mAP 1;
6. trains: ``train_detector`` on the flagship config at full width, batch 16,
   bf16, for 30 steps, from an in-memory synthetic BOP source (filled
   rectangles at 480x640 with visible masks, through the port's transforms,
   sample packing and loader), evaluating every 10 steps on the PNG set's
   landscape images with ``save_best``; checks losses, frozen stages, moved
   weights, the checkpoint and ``best_weights.pth``; runs
   ``inference_detector`` with the trained weights, counting the kernel's
   launches; overfits one fixed batch of 16 with the train step; times the
   train step at batch 16; and holds one float32 step on the card against
   the CPU at batch 1 (same weights, batch, assignment noise and ReLU
   decisions).

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.  Without a CUDA card, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = "configs/bop/r50_ycbv_pbr.py"
SEED = 0
BOX_ATOL = 1e-2  # px; keep sets, labels and scores must match exactly
BOX_TAIL = 0.005  # share of voted coordinates allowed past BOX_ATOL (1-sigma flips)
MAP_RTOL = 1e-3  # float32 card forward vs CPU forward, relative to each map's max
TRAIN_STEPS = 30
LOSS_RTOL = 1e-4  # float32 train step, card vs CPU, relative
GRAD_RTOL = 1e-3  # its gradients, relative to each tensor's max abs
FLIP_RTOL = 1e-5  # |x| / max |x| of a ReLU input the two sides put on opposite sides of 0
WEIGHT_ATOL = 1e-6  # assignment weights, card vs CPU
# the PNG test set: YCB-V's size, T-LESS's (resized into the input) and
# portrait (the per-orientation views), (images, (h, w)) per scene
EVAL_GROUPS = ((96, (480, 640)), (16, (540, 720)), (16, (640, 480)))
METRIC_ATOL = 1e-3  # COCO metrics, kernel vs plain vote-NMS in the same eval
EVAL_INTERVAL = 10  # trainer steps between evaluations


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def clustered_candidates(rng, b, k, num_labels=5):
    """(boxes, cluster, vote, labels, valid) numpy arrays of B images with
    60-100% valid candidates in 8 clusters, sorted by cluster score."""
    boxes = np.zeros((b, k, 4), np.float32)
    cluster = np.zeros((b, k), np.float32)
    vote = np.zeros((b, k), np.float32)
    labels = np.zeros((b, k), np.int32)
    valid = np.zeros((b, k), bool)
    for i in range(b):
        n = int(rng.randint(int(0.6 * k), k + 1))
        centers = rng.uniform(50, 400, (8, 2))
        idx = rng.randint(0, 8, n)
        cx = centers[idx, 0] + rng.randn(n) * 3
        cy = centers[idx, 1] + rng.randn(n) * 3
        w = rng.uniform(40, 60, n)
        h = rng.uniform(40, 60, n)
        boxes[i, :n] = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        cluster[i, :n] = np.sort(rng.uniform(0.1, 1.0, n))[::-1]
        vote[i, :n] = rng.uniform(0.1, 1.0, n)
        labels[i, :n] = idx % num_labels
        valid[i, :n] = True
    return boxes, cluster, vote, labels, valid


def plain_reference(arrays, **kw):
    """``vote_nms_plain`` in float64 on the CPU, 8 images at a time, with
    boxes and scores back in float32: what every kernel output is held to.
    The float32 plain versions on the card and on the CPU each stray from
    float64 on a few coordinates at clusters of hundreds (a 1-sigma inlier
    test that rounds the other way), and not on the same ones (PERF.md,
    findings on vote-NMS at K > 1024)."""
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    outs = []
    for i in range(0, arrays[0].shape[0], 8):
        chunk = [a[i:i + 8].cpu() for a in arrays]
        chunk[:3] = [t.double() for t in chunk[:3]]
        outs.append(vote_nms_plain(*chunk, **kw))
    boxes, labels, scores, valid = (torch.cat(t) for t in zip(*outs))
    return boxes.float(), labels, scores.float(), valid


def compare(kern, plain, what: str) -> float:
    """Kernel vs plain vote-NMS outputs; returns the max abs box error."""
    kb, kl, ks, kv = (t.cpu() for t in kern)
    pb, pl, ps, pv = (t.cpu() for t in plain)
    if not torch.equal(kv, pv):
        fail(f"{what}: keep sets differ ({int((kv != pv).sum())} slots)")
    if not torch.equal(kl, pl) or not torch.equal(ks, ps):
        fail(f"{what}: labels or scores differ")
    err = (kb - pb).abs()[kv]
    if not torch.isfinite(kb).all():
        fail(f"{what}: non-finite kernel boxes")
    past = int((err > BOX_ATOL).sum())
    tail = past / err.numel() if err.numel() else 0.0
    max_err = float(err.max()) if err.numel() else 0.0
    print(
        f"  {what}: kept {int(kv.sum())}, keep/labels/scores equal, box max abs err "
        f"{max_err:.3g} px, share > {BOX_ATOL} px {tail:.4%} ({past} of {err.numel()})"
    )
    if tail > BOX_TAIL:
        fail(f"{what}: {tail:.4%} of voted coordinates off by more than {BOX_ATOL} px")
    return max_err


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(kernel_fn, plain_fn, kernel_iters: int, plain_iters: int):
    """Plain, kernel, kernel, plain, each warmed up and timed by CUDA events;
    returns (kernel ms, plain ms, kernel runs, plain runs)."""
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kernel_fn, kernel_iters) if name == "kernel" else (plain_fn, plain_iters)
        fn()
        runs[name].append(cuda_ms(fn, iters))
    return float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])), runs["kernel"], runs["plain"]


class LogLines(logging.Handler):
    """Keeps the messages of the trainer's logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def relu_decisions(masks, replay: bool):
    """Within the block, ``F.relu`` records which inputs are > 0 into
    ``masks`` (``replay=False``), or applies the recorded decisions in the
    same call order (``replay=True``: x * mask), so that two runs of one
    network take every ReLU on the same side.  Yields the replayed calls'
    disagreements: (count, max |x| there / max |x|)."""
    relu = F.relu
    recorded = iter(masks)
    flips = []

    def shared_relu(x, inplace=False):
        if not replay:
            masks.append((x > 0).detach().cpu())
            return relu(x, inplace=inplace)
        m = next(recorded).to(x.device)
        other = (x > 0) != m
        if other.any():
            flips.append((int(other.sum()), float(x.detach()[other].abs().max() / x.detach().abs().max())))
        return x * m.to(x.dtype)

    F.relu = shared_relu
    try:
        yield flips
    finally:
        F.relu = relu


def parity_steps(cfg, one, anchors, ranges, model_args, runs):
    """One train step (zero-lr SGD, no clip, in the model's dtype) of each
    (name, model, device) in ``runs`` on the numpy batch ``one`` with the
    same assignment noise; returns {name: (assignment, metrics, gradients
    on the CPU)}."""
    from radet_tpu_torch.apis.common import assignment_cfg_from
    from radet_tpu_torch.core.assignment import gumbel
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device

    acfg = assignment_cfg_from(cfg)
    cap = int(acfg.get("positive_num", 10)) * (4 if acfg.get("adapt_positive_num") else 1)
    _, n, g = one["dist_vals"].shape
    gen = torch.Generator().manual_seed(SEED + 3)
    noise = (gumbel((1, g, n), gen, "cpu"), gumbel((1, g, cap, cap), gen, "cpu"))
    out = {}
    for name, m, d in runs:
        st = build_train_step(m, anchors, ranges, **model_args)
        b1 = batch_to_device(one, d)
        nz = tuple(t.to(d) for t in noise)
        assign = st.assign(b1, nz)
        sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, m)
        metrics = st(TrainState(m, sgd0), b1, nz)
        out[name] = (assign, {k: float(v) for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in m.named_parameters() if p.requires_grad})
    return out


def grad_errors(grads, ref):
    """[(max |g - ref| / max |ref|, name)] over the tensors, worst first."""
    return sorted(((float((grads[k] - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-30)), k)
                   for k in ref), reverse=True)


def train_phases(config: str, gpu: str, eval_opts) -> None:
    """Training on the card: the trainer with periodic eval (``eval_opts``:
    config options naming the val data), an overfit batch, card-vs-CPU
    parity, the train step's time, and inference with the trained weights."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector, train_detector
    from radet_tpu_torch.apis.common import (
        assignment_cfg_from,
        build_model_and_anchors,
        loss_cfg_from,
        normalizer_from_cfg,
    )
    from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
    from radet_tpu_torch.engine import build_optimizer, build_train_step, load_weights, save_weights
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
    from radet_tpu_torch.utils import Config, get_root_logger
    from synthetic_bop import synthetic_bop_records

    dev = torch.device("cuda")
    cfg = Config.fromfile(config, [f"runner.max_iters={TRAIN_STEPS}", "checkpoint_config.interval=10",
                                   "log_config.interval=1", f"evaluation.interval={EVAL_INTERVAL}",
                                   "evaluation.save_best='mAP'", *eval_opts])
    h, w = cfg.input_size
    batch_size = int(cfg.data.samples_per_gpu)
    max_gt = int(assignment_cfg_from(cfg).get("max_gt", 32))
    seed = int(cfg.get("seed", 0))

    # 5a. the in-memory source: the port's transforms, packing and loader
    t0 = time.perf_counter()
    records = synthetic_bop_records(np.random.RandomState(SEED + 2), 64, (h, w))
    dataset = InMemoryBOPDataset(records, train_transforms((h, w), max_gt=max_gt, seed=SEED),
                                 max_gt=max_gt, classes=cfg.CLASS_NAMES)
    n_gt = [len(r["gt_bboxes"]) for r in records]
    print(f"train: synthetic BOP source, {len(records)} images {h}x{w}, {sum(n_gt)} objects "
          f"({min(n_gt)}-{max(n_gt)} per image, labels 0-20), built in "
          f"{time.perf_counter() - t0:.1f} s")

    def init_model(dtype):
        model = build_model_and_anchors(cfg, dtype=dtype)[0]
        model.init_weights(torch.Generator().manual_seed(seed))
        return model

    # 5b. the trainer at full width, batch 16, bf16
    with tempfile.TemporaryDirectory() as tmp:
        work_dir = osp.join(tmp, "work_dir")
        logs = LogLines()
        get_root_logger().addHandler(logs)
        t0 = time.perf_counter()
        vnc.LAUNCHES = 0
        state = train_detector(cfg, work_dir=work_dir, dataset=dataset, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        eval_launches = vnc.LAUNCHES
        get_root_logger().removeHandler(logs)
        iters = [ln for ln in logs.lines if ln.startswith("iter ")]
        evals = [ln for ln in logs.lines if ln.startswith("eval: ")]
        history = [
            {k: float(v) for k, v in re.findall(r"(loss_cls|loss_bbox|loss_iou|loss|grad_norm) (\S+)", ln)}
            for ln in iters
        ]
        model = state.model
        print(f"train: train_detector({CONFIG!r}) batch {batch_size}, compute dtype {model.dtype}, "
              f"{state.step} steps in {train_s:.1f} s (model build, data and {len(evals)} evals "
              f"included) [{gpu}]")
        for ln in (iters[0], iters[len(iters) // 2], iters[-1]):
            print(f"  {ln}")
        with open(cfg.data.val.ann_file) as f:
            n_val = len(json.load(f)["images"])
        print(f"  eval every {EVAL_INTERVAL} steps on {n_val} PNG images (test_cfg as configured, "
              f"nms_topk {cfg.test_cfg.nms_topk}): vote_nms kernel launches {eval_launches}")
        for ln in evals:
            print(f"  {ln}")
        for ln in logs.lines:
            if ln.startswith("new best"):
                print(f"  {ln}")
        best = osp.join(work_dir, "best_weights.pth")
        if len(evals) != TRAIN_STEPS // EVAL_INTERVAL or eval_launches < 1:
            fail(f"{len(evals)} evals with {eval_launches} kernel launches during training")
        if not osp.exists(best) or load_weights(best).keys() != model.state_dict().keys():
            fail("save_best did not write best_weights.pth with the model's weights")
        print(f"  {osp.basename(best)} written by save_best, loads as the model's state dict")
        if state.step != TRAIN_STEPS or len(history) != TRAIN_STEPS:
            fail(f"the trainer took {state.step} steps and logged {len(history)}, not {TRAIN_STEPS}")
        if model.dtype != torch.bfloat16 or batch_size != 16:
            fail(f"the trainer ran {model.dtype} at batch {batch_size}; the flagship is bf16 at 16")
        bad = [(i + 1, k, v) for i, m in enumerate(history) for k, v in m.items() if not math.isfinite(v)]
        if bad or any(len(m) != 5 for m in history):
            fail(f"non-finite or missing losses/grad_norm in the trainer's log: {bad[:5]}")
        init = init_model("float32").state_dict()
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        now = model.state_dict()
        changed = [n for n in frozen + [b for b, _ in model.named_buffers()]
                   if not torch.equal(now[n].cpu(), init[n])]
        moved = sum(not torch.equal(p.detach().cpu(), init[n])
                    for n, p in model.named_parameters() if p.requires_grad)
        n_train = sum(p.requires_grad for p in model.parameters())
        print(f"  frozen parameters (stem, layer1): {len(frozen)}, unchanged bit for bit: "
              f"{not changed}; trainable tensors moved: {moved} of {n_train}")
        if changed:
            fail(f"frozen parameters or buffers changed: {changed[:5]}")
        if moved == 0:
            fail("no trainable parameter moved")
        ckpts = sorted(int(d) for d in os.listdir(osp.join(work_dir, "checkpoints")) if d.isdigit())
        print(f"  checkpoints written at steps {ckpts}")
        if TRAIN_STEPS not in ckpts:
            fail("no checkpoint of the last step was written")
        weights = osp.join(tmp, "trained.pth")
        save_weights(weights, load_weights(osp.join(work_dir, "checkpoints")),
                     meta=dict(CLASSES=list(cfg.CLASS_NAMES)))
        del state, model
        torch.cuda.empty_cache()

        # 5c. inference with the trained weights
        det = init_detector(cfg, checkpoint=weights, device="cuda")
        imgs = [r["img"] for r in records[:8]]
        vnc.LAUNCHES = 0
        results = inference_detector(det, imgs)
        torch.cuda.synchronize()
        launches = vnc.LAUNCHES
        print(f"inference after training: inference_detector on 8 images, vote_nms kernel launches "
              f"{launches}, detections per image {[len(r['boxes']) for r in results]}")
        if launches < 1:
            fail("inference with the trained weights did not launch the vote_nms kernel")
        for r in results:
            if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
                fail("NaN in the trained model's detections")
        raw = det._infer(det.model, np.stack(imgs), np.tile([[h, w]], (8, 1)), np.ones((8, 4)))
        if any(torch.isnan(t.float()).any() for t in raw[:4]):
            fail("NaN in the trained model's inference output")
        del det, raw

    model_args = dict(
        img_norm=cfg.img_norm_cfg.to_dict(), num_classes=int(cfg.model.bbox_head.num_classes),
        assignment_cfg=assignment_cfg_from(cfg), normalizer=normalizer_from_cfg(cfg),
        loss_cfg=loss_cfg_from(cfg),
    )
    _, anchors, ranges, _ = build_model_and_anchors(cfg)

    # 5d. overfit one fixed batch of 16: flagship AdamW and clip at a constant lr
    model = init_model(None).to(dev)
    tx, _ = build_optimizer(dict(cfg.optimizer.to_dict(), lr=1e-4), dict(policy="fixed"),
                            cfg.grad_clip.to_dict(), model)
    state = TrainState(model, tx, seed=seed + 1)
    step = build_train_step(model, anchors, ranges, **model_args)
    batch = batch_to_device(collate([dataset[i] for i in range(batch_size)]), dev)
    losses = torch.stack([step(state, batch)["loss"] for _ in range(TRAIN_STEPS)]).tolist()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"train: overfit one batch of {batch_size}, {TRAIN_STEPS} steps (AdamW lr 1e-4, clip 35): "
          f"mean loss of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if not all(math.isfinite(v) for v in losses) or not last < first:
        fail("the loss did not fall on the overfit batch")

    # 5e. the train step's time at batch 16 (batch already on the card)
    for _ in range(3):
        step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"timing: train step batch {batch_size} {str(model.dtype)[6:]} (batch on the card): "
          f"{ms:.2f} ms/step, "
          f"{batch_size * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB [{gpu}]")
    del state, model, tx, step, batch
    torch.cuda.empty_cache()

    # 5f. float32 step at batch 1, card vs CPU: same weights, batch and
    # assignment noise, and the same side of every ReLU (a pre-activation
    # within rounding of 0 otherwise moves a channel's gradient by several
    # percent: PERF.md, PR 2)
    cpu_model = init_model("float32")
    gpu_model = init_model("float32").to(dev)
    raw_model = init_model("float32")
    one = collate([dataset[0]])
    cpu = torch.device("cpu")
    masks = []
    with relu_decisions(masks, replay=False):
        out = parity_steps(cfg, one, anchors, ranges, model_args, (("card", gpu_model, dev),))
    with relu_decisions(masks, replay=True) as flips:
        out.update(parity_steps(cfg, one, anchors, ranges, model_args, (("cpu", cpu_model, cpu),)))
    out.update(parity_steps(cfg, one, anchors, ranges, model_args, (("raw", raw_model, cpu),)))
    (ac, mc, gc), (ag, mg, gg) = out["cpu"], out["card"]
    if not torch.equal(ag.gt_idx.cpu(), ac.gt_idx):
        fail(f"assignment gt_idx differs between card and CPU in "
             f"{int((ag.gt_idx.cpu() != ac.gt_idx).sum())} cells")
    w_err = float((ag.weight.cpu() - ac.weight).abs().max())
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    errs = grad_errors(gg, gc)
    raw = grad_errors(out["raw"][2], gg)
    flip_max = max((r for _, r in flips), default=0.0)
    print(f"train parity, float32 batch 1, card vs CPU (TF32 off, same noise and ReLU sides): "
          f"assignment gt_idx equal ({int((ac.gt_idx >= 0).sum())} positives), weight max abs err "
          f"{w_err:.3g}; losses max rel err {loss_err:.3g} (loss {mg['loss']:.6f} vs {mc['loss']:.6f}); "
          f"gradients max err {errs[0][0]:.3g} of the tensor's max abs ({errs[0][1]}) [{gpu}]")
    print(f"  ReLU inputs on opposite sides of 0: {sum(c for c, _ in flips)} of "
          f"{sum(m.numel() for m in masks)} in {len(masks)} calls, at most {flip_max:.3g} of their tensor's max |x|; with each side's own "
          f"ReLU decisions the gradients differ by up to {raw[0][0]:.3g} ({raw[0][1]}), "
          f"{sum(e > GRAD_RTOL for e, _ in raw)} tensors past {GRAD_RTOL}")
    if flip_max > FLIP_RTOL:
        fail(f"a ReLU input differs in sign by more than rounding ({flip_max:.3g} > {FLIP_RTOL})")
    if w_err > WEIGHT_ATOL or loss_err > LOSS_RTOL or errs[0][0] > GRAD_RTOL:
        fail(f"card vs CPU train step beyond tolerance (weights {WEIGHT_ATOL}, losses {LOSS_RTOL}, "
             f"gradients {GRAD_RTOL})")
    del cpu_model, gpu_model, raw_model, out, masks
    torch.cuda.empty_cache()


def kernel_by_k() -> None:
    """The kernel against the plain version in float64 at the
    shared-memory bound (K = 1024) and on the global-scratch path
    (K > 1024), with the kernel's and the plain version's times on the
    card."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    gpu = card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 4)
    print("kernel on the card vs plain in float64 on the CPU around K = 1024 (K > 1024: bitmask "
          "in a global scratch), synthetic clustered candidates:")
    for b, k in ((8, 1024), (8, 1025), (8, 2048), (8, 4420), (128, 2048)):
        arrays = [torch.from_numpy(a).to(dev) for a in clustered_candidates(rng, b, k)]
        for global_mode in (False, True):
            kw = dict(iou_threshold=0.65, max_out=100, iou_enable=False, sigma=0.025,
                      global_mode=global_mode)
            kern = vnc.vote_nms_cuda(*arrays, **kw)
            torch.cuda.synchronize()
            compare(kern, plain_reference(arrays, **kw), f"B={b} K={k} global_mode={global_mode}")
        kw["global_mode"] = False
        kernel_ms, plain_ms, _, _ = alternate_ms(
            lambda: vnc.vote_nms_cuda(*arrays, **kw), lambda: vote_nms_plain(*arrays, **kw), 10, 1)
        print(f"timing: vote_nms B={b} K={k}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms [{gpu}]")
        del arrays, kern
        torch.cuda.empty_cache()


def eval_phases(config: str, gpu: str, work: str):
    """The evaluation path on a synthetic PNG test set written into
    ``work``: decode, the test CLI, and ``test_from_config`` through the
    kernel and through the plain version.  Returns the config options that
    make the set's landscape images the val split (for periodic eval)."""
    import radet_tpu_torch.apis.test as port_test
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.data import image_io
    from radet_tpu_torch.engine import save_weights
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain
    from radet_tpu_torch.utils import Config
    from synthetic_bop import write_bop_test_set

    dev = torch.device("cuda")
    cfg = Config.fromfile(config)
    t0 = time.perf_counter()
    ann = write_bop_test_set(work, np.random.RandomState(SEED + 5), EVAL_GROUPS, cfg.CLASS_NAMES)
    with open(ann) as f:
        coco = json.load(f)
    print(f"eval: synthetic BOP test set, {len(coco['images'])} PNG images "
          f"({', '.join(f'{n} at {h}x{w}' for n, (h, w) in EVAL_GROUPS)}), {len(coco['annotations'])} "
          f"objects of 21 classes, rows cycling the five PNG filters, written in "
          f"{time.perf_counter() - t0:.1f} s")
    # the val split: the landscape images (periodic eval runs one view at the input size)
    landscape = {i["id"] for i in coco["images"] if i["height"] <= i["width"]}
    val = dict(coco, images=[i for i in coco["images"] if i["id"] in landscape],
               annotations=[a for a in coco["annotations"] if a["image_id"] in landscape])
    val_file = osp.join(work, "val.json")
    with open(val_file, "w") as f:
        json.dump(val, f)
    prefix = osp.join(work, "test") + "/"
    opts = [f"data.test.ann_file={ann!r}", f"data.test.img_prefix={prefix!r}"]
    val_opts = [f"data.val.ann_file={val_file!r}", f"data.val.img_prefix={prefix!r}"]

    # decode: the C++ unfilter and its numpy twin on the first scene's files (480x640)
    hw = EVAL_GROUPS[0][1]
    files = [osp.join(prefix, i["file_name"]) for i in coco["images"] if (i["height"], i["width"]) == hw]
    blobs = []
    for path in files[:24]:
        with open(path, "rb") as f:
            blobs.append(f.read())
    t0 = time.perf_counter()
    decoded = [image_io.decode_png(b) for b in blobs]
    cpp_ms = (time.perf_counter() - t0) * 1000 / len(blobs)
    t0 = time.perf_counter()
    twin = image_io.decode_png(blobs[0], image_io.unfilter_plain)
    plain_ms = (time.perf_counter() - t0) * 1000
    if not np.array_equal(decoded[0], twin):
        fail("the C++ unfilter and its numpy twin disagree")
    print(f"decode: {hw[0]}x{hw[1]} RGB PNG, one thread: C++ unfilter {cpp_ms:.2f} ms/image "
          f"(mean of {len(blobs)}), numpy twin {plain_ms:.1f} ms/image, equal byte for byte "
          f"[host of {gpu}]")

    # weights: the seeded random init with the cls bias at 0, so that scores
    # clear score_thr and the strict eval's K = 2048 candidates reach the kernel
    model = build_model_and_anchors(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()
    ckpt = osp.join(work, "random_cls0.pth")
    save_weights(ckpt, model.state_dict(), meta=dict(CLASSES=list(cfg.CLASS_NAMES)))

    # the test CLI, strict by default, in its own process
    out = osp.join(work, "eval")
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.test", config, ckpt, "--eval", "bbox",
           "--format-only", "--json-prefix", out, "--cfg-options", *opts]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(Path(__file__).resolve().parent),
                          timeout=900)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the test CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    cli_metrics = json.loads(proc.stdout[proc.stdout.index("{"):])
    cli_launches = sum(int(n) for n in re.findall(r"vote_nms kernel launches (\d+)", proc.stderr))
    with open(out + ".bbox.json") as f:
        bbox_json = json.load(f)
    with open(out + ".bop.json") as f:
        bop_json = json.load(f)
    print(f"eval: python -m radet_tpu_torch.tools.test (strict, full width, bf16, random weights, cls "
          f"bias 0): {cli_s:.1f} s in its own process (start-up, model build and CUDA init included); "
          f"vote_nms kernel launches {cli_launches}; {len(bbox_json)} COCO results in "
          f"{osp.basename(out)}.bbox.json, {len(bop_json)} in {osp.basename(out)}.bop.json "
          f"(scenes {sorted({d['scene_id'] for d in bop_json})})")
    for ln in proc.stderr.splitlines():
        if "inference done" in ln:
            print(f"  {ln.split(' - ')[-1]}")
    if cli_launches < 1 or not bbox_json or len(bop_json) != len(bbox_json):
        fail("the CLI launched no kernel or wrote empty or mismatched jsons")
    if {d["scene_id"] for d in bop_json} != set(range(len(EVAL_GROUPS))):
        fail("the BOP submission misses a scene")

    # test_from_config in this process: through the kernel (files -> metrics
    # timed), then through the plain version; the candidates' K is recorded,
    # and so are the kernel run's NMS inputs and outputs (copies on the card)
    model.to(dev).eval()
    ks = set()
    calls = []
    kernel_nms = postprocess.vote_nms

    def recording(nms):
        def run(*args, **kw):
            ks.add(int(args[0].shape[1]))
            out = nms(*args, **kw)
            if nms is kernel_nms:
                calls.append(([a.clone() for a in args], kw, [t.clone() for t in out]))
            return out
        return run

    eval_cfg = Config.fromfile(config, opts)
    workers = int(eval_cfg.data.workers_per_gpu)
    postprocess.vote_nms = recording(kernel_nms)
    try:
        vnc.LAUNCHES = 0
        t0 = time.perf_counter()
        dataset, results, _ = port_test.test_from_config(eval_cfg, model, fmt_only=True)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        metrics = port_test.evaluate_results(dataset, results)
        eval_s = time.perf_counter() - t0
        launches = vnc.LAUNCHES
        kernel_ks = sorted(ks)
        postprocess.vote_nms = recording(vote_nms_plain)
        ks.clear()
        t0 = time.perf_counter()
        _, plain_results, plain_metrics = port_test.test_from_config(eval_cfg, model)
        plain_s = time.perf_counter() - t0
    finally:
        postprocess.vote_nms = kernel_nms
    n = len(results)
    print(f"eval: test_from_config strict, full width, bf16, {n} PNG images, files -> metrics: "
          f"{eval_s:.2f} s, {n / eval_s:.1f} img/s (datasets and inference {infer_s:.2f} s, "
          f"{n / infer_s:.1f} img/s; COCO evaluation {eval_s - infer_s:.2f} s; loader {workers} "
          f"threads, decode {cpp_ms:.2f} ms/image on one); vote_nms kernel launches {launches} at K "
          f"{kernel_ks} [{gpu}]")
    print(f"  the same through the plain vote-NMS: {plain_s:.2f} s, {n / plain_s:.1f} img/s, K {sorted(ks)}")
    # the kernel on this eval's own candidates, against the plain version in float64
    if len({repr(kw) for _, kw, _ in calls}) != 1:
        fail(f"the strict eval called vote-NMS with differing options: {[kw for _, kw, _ in calls]}")
    args, kw = [torch.cat(t) for t in zip(*(a for a, _, _ in calls))], calls[0][1]
    compare([torch.cat(t) for t in zip(*(o for _, _, o in calls))], plain_reference(args, **kw),
            f"strict eval's vote-NMS calls ({len(calls)} of B<={max(a[0].shape[0] for a, _, _ in calls)}, "
            f"K={args[0].shape[1]}, {int(args[4].sum())} valid candidates), kernel vs plain in float64")
    del calls, args
    diff = max(abs(metrics[k] - plain_metrics[k]) for k in metrics)
    cli_diff = max(abs(metrics[k] - cli_metrics[k]) for k in metrics)
    same = [np.array_equal(a["labels"], b["labels"]) for a, b in zip(results, plain_results)]
    box_err = np.concatenate([np.abs(a["boxes"] - b["boxes"]).ravel()
                              for a, b, s in zip(results, plain_results, same) if s] + [np.zeros(0)])
    box_tail = float((box_err > BOX_ATOL).mean()) if box_err.size else 0.0
    print("  metrics (kernel): " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    print(f"  kernel vs plain on the card, whole eval: max |metric difference| {diff:.3g} (limit "
          f"{METRIC_ATOL}); detections {sum(len(r['boxes']) for r in results)} vs "
          f"{sum(len(r['boxes']) for r in plain_results)}, labels equal on {sum(same)} of {n} images, box "
          f"max abs err {box_err.max(initial=0.0):.3g} px, share > {BOX_ATOL} px {box_tail:.4%}; "
          f"in-process vs CLI {cli_diff:.3g}")
    if not all(same) or box_tail > BOX_TAIL:
        fail(f"kernel vs plain eval: labels differ on {n - sum(same)} images, or {box_tail:.4%} of box "
             f"coordinates are off by more than {BOX_ATOL} px")
    if cli_diff > METRIC_ATOL:
        fail(f"the CLI's metrics differ from the same eval in this process by {cli_diff:.3g}")
    # the evaluator on this set: its ground truth as detections scores mAP 1
    gt = [dict(img_id=img_id, boxes=ann["bboxes"], labels=ann["labels"],
               scores=np.ones(len(ann["labels"]), np.float32))
          for img_id, ann in ((i, dataset.parse_ann_info(info))
                              for i, info in zip(dataset.img_ids, dataset.data_infos))]
    gt_map = port_test.evaluate_results(dataset, gt)["bbox_mAP"]
    print(f"  ground truth as detections: bbox_mAP {gt_map:.6f} (expected 1)")
    if launches < 1 or 2048 not in kernel_ks:
        fail(f"the strict eval did not launch the kernel at K = 2048 (K {kernel_ks}, launches {launches})")
    if n != len(coco["images"]) or diff > METRIC_ATOL:
        fail(f"{n} results for {len(coco['images'])} images, or metrics off by {diff:.3g}")
    if not all(math.isfinite(v) for v in metrics.values()) or abs(gt_map - 1.0) > 1e-9:
        fail("non-finite metrics, or the ground truth does not score mAP 1")
    del model
    torch.cuda.empty_cache()
    return val_opts


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    repo = Path(__file__).resolve().parent
    if not (repo / "radet_tpu_torch").is_dir() or not (repo / CONFIG).is_file():
        print(f"chip_smoke: no radet_tpu_torch package or {CONFIG} beside {__file__}",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(repo))
    sys.path.append(str(repo / "tests"))  # synthetic_bop: the test data writers
    config = str(repo / CONFIG)

    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.apis.common import normalizer_from_cfg
    from radet_tpu_torch.data import image_io
    from radet_tpu_torch.models.detector import preprocess_images
    from radet_tpu_torch.utils import native
    from radet_tpu_torch.models.postprocess import vote_nms_inputs
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = card()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")

    # 1. build the kernel and the host unfilter together
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        builds = [(src, flags, pool.submit(timed, fn)) for src, flags, fn in (
            (vnc.SOURCE, f"nvcc {' '.join(vnc.NVCC_FLAGS)}", vnc.build),
            (image_io.SOURCE, f"c++ {' '.join(image_io.CXX_FLAGS)}", image_io.build))]
        for src, flags, fut in builds:
            print(f"build: {src.relative_to(repo)} -> {native.BUILD_DIR.relative_to(repo)} "
                  f"with {flags}: {fut.result():.2f} s [{gpu}]")
    if vnc.BUILD_LOG is not None:
        for line in vnc.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain on synthetic candidates at the bench batch
    print("kernel vs plain in float64 on the CPU, synthetic clustered candidates, B=128:")
    rng = np.random.RandomState(SEED)
    bench_inputs = None
    for k in (512, 1024):
        arrays = [torch.from_numpy(a).to(dev) for a in clustered_candidates(rng, 128, k)]
        if k == 512:
            bench_inputs = arrays
        for global_mode in (False, True):
            for iou_enable in (False, True):
                kw = dict(iou_threshold=0.65, max_out=100, iou_enable=iou_enable,
                          sigma=0.025, global_mode=global_mode)
                kern = vnc.vote_nms_cuda(*arrays, **kw)
                torch.cuda.synchronize()
                compare(kern, plain_reference(arrays, **kw),
                        f"K={k} global_mode={global_mode} iou_enable={iou_enable}")

    # 3. the main path at full width
    det = init_detector(config, device="cuda", seed=SEED)
    model = det.model
    n_params = sum(p.numel() for p in model.parameters())
    print(f"main path: init_detector({CONFIG!r}, device='cuda', seed={SEED}): "
          f"{n_params} parameters, compute dtype {model.dtype}, input {det.input_size}")
    if model.dtype != torch.bfloat16:
        fail(f"compute dtype is {model.dtype}, the config asks for bfloat16")
    # random init puts every score at sigmoid(-log 99) = 0.01 < score_thr;
    # a zero cls bias gives the NMS a full candidate set
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()
    print("  bbox_head.atss_cls.bias set to 0 so that scores clear score_thr")
    h, w = det.input_size
    img_rng = np.random.RandomState(SEED + 1)
    imgs = [img_rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(8)]

    vnc.LAUNCHES = 0
    results = inference_detector(det, imgs)
    torch.cuda.synchronize()
    launches = vnc.LAUNCHES
    print(f"  inference_detector on 8 images {h}x{w}: vote_nms kernel launches {launches}, "
          f"detections per image {[len(r['boxes']) for r in results]}")
    if launches < 1:
        fail("the main path did not launch the vote_nms kernel")
    for r in results:
        if not len(r["boxes"]):
            fail("an image has no detections")
        if r["boxes"].shape[1:] != (4,) or not (
            np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
        ):
            fail("non-finite or misshapen detections")
        if (r["labels"] < 0).any() or (r["labels"] >= 21).any():
            fail("labels outside the 21 classes")

    # the same NMS inputs, through the kernel and through the plain version on the CPU
    cfg = det.cfg
    level_anchors = [
        torch.as_tensor(a, device=dev)
        for a in np.split(det.anchors, np.cumsum(det.level_counts)[:-1])
    ]
    images = torch.from_numpy(np.stack(imgs)).to(dev)
    shapes = torch.tensor([[h, w]] * len(imgs), dtype=torch.float32, device=dev)
    scales = torch.ones((len(imgs), 4), dtype=torch.float32, device=dev)
    norm = cfg.img_norm_cfg
    with torch.inference_mode():
        x = preprocess_images(images, norm.mean, norm.std, model.dtype)
        outs = model(x)
        args, kw = vote_nms_inputs(
            *outs, level_anchors, shapes, scales, test_cfg=cfg.test_cfg.to_dict(),
            normalizer=normalizer_from_cfg(cfg),
        )
        n_cand = args[4].sum(1).tolist()
        print(f"  NMS input: K={args[0].shape[1]}, valid candidates per image {n_cand}")
        main_err = compare(
            vnc.vote_nms_cuda(*args, **kw),
            plain_reference(args, **kw),
            "main-path candidates, kernel on the card vs plain in float64 on the CPU",
        )

        # float32 forward on the card vs the CPU forward, 1 image
        model.dtype = torch.float32
        gpu_maps = [m.cpu() for maps in model(x[:1].float()) for m in maps]
        cpu_model = init_detector(config, device="cpu", seed=SEED).model
        cpu_model.load_state_dict(model.state_dict())
        cpu_maps = [m for maps in cpu_model(x[:1].float().cpu()) for m in maps]
        model.dtype = torch.bfloat16
        rel = max(
            float((g - c).abs().max() / c.abs().max().clamp(min=1e-6))
            for g, c in zip(gpu_maps, cpu_maps)
        )
        print(f"  float32 head maps, card vs CPU: max error relative to each map's max "
              f"{rel:.3g} (limit {MAP_RTOL})")
        if rel > MAP_RTOL:
            fail("the card's float32 forward disagrees with the CPU forward")
        del cpu_model

    # the untouched random init: no score clears score_thr, nothing may be NaN
    det0 = init_detector(config, device="cuda", seed=SEED)
    out0 = det0._infer(det0.model, images, shapes, scales)
    if any(torch.isnan(t.float()).any() for t in out0[:4]):
        fail("NaN in the untouched random init's output")
    print(f"  untouched init (cls bias -log 99): detections per image "
          f"{out0.valid.sum(1).tolist()}, no NaN")
    del det0, out0

    # 4. timing
    for batch, iters in ((8, 20), (128, 5)):
        u8 = torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
        shp = torch.tensor([[h, w]] * batch, dtype=torch.float32, device=dev)
        scl = torch.ones((batch, 4), dtype=torch.float32, device=dev)

        def step():
            det._infer(model, u8, shp, scl)

        for _ in range(2):
            step()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, iters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"timing: main path batch {batch} (uint8 on the card): {ms:.2f} ms/batch, "
              f"{batch * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB [{gpu}]")
        del u8

    kw = dict(iou_threshold=0.65, max_out=100, iou_enable=False, sigma=0.025, global_mode=False)
    kernel_ms, plain_ms, kernel_runs, plain_runs = alternate_ms(
        lambda: vnc.vote_nms_cuda(*bench_inputs, **kw), lambda: vote_nms_plain(*bench_inputs, **kw), 50, 5)
    print(f"timing: vote_nms B=128 K=512: kernel {kernel_ms:.4f} ms (runs {kernel_runs}), "
          f"plain {plain_ms:.3f} ms (runs {plain_runs}) [{gpu}]")
    del det, model, bench_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        kernel_by_k()
        eval_opts = eval_phases(config, gpu, work)
        train_phases(config, gpu, eval_opts)

    print(f"card: {gpu}")
    print(json.dumps({"kernels": [{
        "name": "vote_nms",
        "route": "cuda",
        "source": "radet_tpu_torch/csrc/vote_nms.cu",
        "replaces": "radet_tpu/ops/pallas_nms.py:382",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
