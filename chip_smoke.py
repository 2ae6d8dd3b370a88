#!/usr/bin/env python3
"""Drive the PyTorch port (``radet_tpu_torch``) once on a CUDA card.

Run from the repository root, with one card:  python3 chip_smoke.py

1. prints the card and builds the vote-NMS kernel from ``radet_tpu_torch/csrc``;
2. holds the kernel against its plain PyTorch version on synthetic clustered
   candidates (B=128, K in {512, 1024}, global_mode x iou_enable);
3. runs the flagship inference path: ``init_detector`` on
   ``configs/bop/r50_ycbv_pbr.py`` at full width (seeded random weights,
   bf16 convolutions) and ``inference_detector`` on 8 synthetic 480x640
   images, counting the kernel's launches; checks the NMS inputs of that run
   through the plain version on the CPU, the float32 forward against the CPU
   forward, and the untouched random init for NaNs;
4. times the main path at batch 8 and 128 and the kernel against the plain
   version at B=128, K=512 with CUDA events;
5. trains: ``train_detector`` on the flagship config at full width, batch 16,
   bf16, for 30 steps, from an in-memory synthetic BOP source (filled
   rectangles at 480x640 with visible masks, through the port's transforms,
   sample packing and loader), checking losses, frozen stages, moved
   weights and the checkpoint; runs ``inference_detector`` with the trained
   weights, counting the kernel's launches; overfits one fixed batch of 16
   with the train step; times the train step at batch 16; and holds one
   float32 step on the card against the CPU at batch 1 (same weights, batch,
   assignment noise and ReLU decisions).

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
    tail = float((err > BOX_ATOL).float().mean()) if err.numel() else 0.0
    max_err = float(err.max()) if err.numel() else 0.0
    print(
        f"  {what}: kept {int(kv.sum())}, keep/labels/scores equal, box max abs err "
        f"{max_err:.3g} px, share > {BOX_ATOL} px {tail:.4%}"
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


def synthetic_bop_records(rng, n, hw, num_classes=21, max_objects=6):
    """In-memory BOP-style training records: uint8 RGB images with filled
    rectangles (as tests/fixtures.py draws them), their xyxy boxes, labels
    and binary visible masks (a later rectangle hides what it covers)."""
    h, w = hw
    lo, hi = max(16, min(h, w) // 8), max(24, min(h, w) // 3)
    records = []
    for _ in range(n):
        img = rng.randint(0, 80, (h, w, 3), dtype=np.uint8)
        boxes, labels, masks = [], [], []
        for _ in range(rng.randint(1, max_objects + 1)):
            bw, bh = (int(v) for v in rng.randint(lo, hi, 2))
            x1, y1 = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            c = int(rng.randint(num_classes))
            img[y1:y1 + bh, x1:x1 + bw] = [(60 + 60 * c) % 256, (200 - 50 * c) % 256, 255]
            for m in masks:
                m[y1:y1 + bh, x1:x1 + bw] = 0
            m = np.zeros((h, w), np.uint8)
            m[y1:y1 + bh, x1:x1 + bw] = 1
            boxes.append([x1, y1, x1 + bw, y1 + bh])
            labels.append(c)
            masks.append(m)
        records.append(dict(img=img, gt_bboxes=np.asarray(boxes, np.float32),
                            gt_labels=np.asarray(labels, np.int64), gt_masks=np.stack(masks)))
    return records


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


def train_phases(config: str, gpu: str) -> None:
    """Training on the card: the trainer, an overfit batch, card-vs-CPU
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

    dev = torch.device("cuda")
    cfg = Config.fromfile(config, [f"runner.max_iters={TRAIN_STEPS}",
                                   "checkpoint_config.interval=10", "log_config.interval=1"])
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
        state = train_detector(cfg, work_dir=work_dir, dataset=dataset, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        get_root_logger().removeHandler(logs)
        iters = [ln for ln in logs.lines if ln.startswith("iter ")]
        history = [
            {k: float(v) for k, v in re.findall(r"(loss_cls|loss_bbox|loss_iou|loss|grad_norm) (\S+)", ln)}
            for ln in iters
        ]
        model = state.model
        print(f"train: train_detector({CONFIG!r}) batch {batch_size}, compute dtype {model.dtype}, "
              f"{state.step} steps in {train_s:.1f} s (model build and data included) [{gpu}]")
        for ln in (iters[0], iters[len(iters) // 2], iters[-1]):
            print(f"  {ln}")
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
    config = str(repo / CONFIG)

    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.apis.common import normalizer_from_cfg
    from radet_tpu_torch.models.detector import preprocess_images
    from radet_tpu_torch.models.postprocess import vote_nms_inputs
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = card()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    vnc.build()
    build_s = time.perf_counter() - t0
    print(f"build: {vnc.SOURCE.relative_to(repo)} -> {vnc.BUILD_DIR.relative_to(repo)} "
          f"with nvcc {' '.join(vnc.NVCC_FLAGS)}: {build_s:.2f} s [{gpu}]")
    if vnc.BUILD_LOG is not None:
        for line in vnc.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain on synthetic candidates at the bench batch
    print("kernel vs plain, synthetic clustered candidates, B=128:")
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
                compare(kern, vote_nms_plain(*arrays, **kw),
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
            vote_nms_plain(*(a.cpu() for a in args), **kw),
            "main-path candidates, kernel on the card vs plain on the CPU",
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
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            fn, iters = (lambda: vnc.vote_nms_cuda(*bench_inputs, **kw)), 50
        else:
            fn, iters = (lambda: vote_nms_plain(*bench_inputs, **kw)), 5
        fn()
        runs[name].append(cuda_ms(fn, iters))
    kernel_ms = float(np.mean(runs["kernel"]))
    plain_ms = float(np.mean(runs["plain"]))
    print(f"timing: vote_nms B=128 K=512: kernel {kernel_ms:.4f} ms (runs {runs['kernel']}), "
          f"plain {plain_ms:.3f} ms (runs {runs['plain']}) [{gpu}]")

    train_phases(config, gpu)

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
