#!/usr/bin/env python3
"""Drive the PyTorch port (``radet_tpu_torch``) once on a CUDA card.

Run from the repository root, with one card:  python3 chip_smoke.py

1. prints the card and builds, in parallel, the vote-NMS and int8 conv
   kernels, the host PNG unfilter, the host JPEG decoder and encoder, the
   host CosyPose ops, the host distance transforms and the host TIFF
   decompressors from ``radet_tpu_torch/csrc``; holds the decoder to cv2's recorded SHA-256 of
   the committed fixtures (``tests/data/jpeg``; this machine has no cv2)
   and times JPEG decode beside PNG decode of the same pixels; holds
   ``csrc/color_aug.cpp`` and its numpy twins (every CosyPose op at fixed
   factors, the blur at sigma 1-3, on those fixtures) and ``fill_poly``
   (fixed polygons) to cv2's recorded hashes (``tests/data/color_aug``)
   and times each op;
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
   version at B=128, K=512 with CUDA events, beside the call's bound; then
   serves that detector: ``BatchingDetector`` at batch 16 and a 5 ms
   budget against ``inference_detector`` (480x640, 540x720 resized,
   427x640 padded; a portrait request raises in ``submit``), one vote-NMS
   launch per served batch, img/s, fill and p50/p99 latency at 1, 16 and
   64 submitter threads beside the bare step from pinned memory,
   cancellation while queued and after dispatch, and ``python -m
   radet_tpu_torch.tools.serve`` in a subprocess over HTTP (the JPEG
   fixtures and a PNG against the in-process batcher, status codes, 16
   client threads, SIGTERM);
5. evaluates: the kernel against the plain version at every (B, K) of
   ``KERNEL_SHAPES`` (K 512, 2048 and 4420), both modes, timing both on the
   card in turns, each beside the call's bound and its share of it, and
   the call's device time split by its three CUDA kernels (from
   torch.profiler, or "not measured"); a synthetic BOP test set written as PNG by
   ``tests/synthetic_bop.py`` (48 images at
   480x640, 16 at T-LESS's 540x720, 16 portrait 640x480; filled rectangles
   of 21 classes, COCO json), decoded by the C++ unfilter and its numpy
   twin; the test CLI (``python -m radet_tpu_torch.tools.test --eval bbox
   --format-only``, strict, full width, bf16, random weights with the cls
   bias at 0) in a process of its own (most other CLIs here run as their
   ``main`` in this process), checking its jsons and kernel launches; then
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
   decisions);
7. trains from files: writes a JPEG ``train_pbr`` split (64 copies of the
   480x640 fixtures with their records' boxes and ``mask_visib`` PNGs), a
   ``train_real`` split of 32 more, and a background directory (JPEG, and
   PNG at 427x640, which are resized), and a config whose ``_base_`` is
   the flagship training from ``train_pbr`` through its own
   ``train_pipeline`` (``RandomBackground`` and ``CosyPoseAug`` included);
   times each transform of that pipeline, and each of CosyPoseAug's ops,
   on one thread and the loader at 4 and 8 threads; times the train step
   with that loader idle and busy in the background (thread and process
   workers), in turns; runs ``python -m radet_tpu_torch.tools.train`` on
   it (full width, bf16, batch 16, 4 loader workers, ``FILES_STEPS``
   steps, one eval on the PNG set's landscape images), with thread workers
   in a process of its own and then with process workers, checks each
   run's checkpoint and its eval's vote-NMS launches, and prints its img/s
   beside the in-memory trainer's and the share of each step spent
   waiting on the loader;
8. fine-tunes from files as the paper's second stage: the train CLI on a
   config whose ``_base_`` is ``configs/bop/r50_ycbv_mixpbr.py``
   (``MixDataset`` of train_pbr x 2 and train_real x 1), full width, bf16,
   batch 16, ``MIX_STEPS`` steps, one eval, ``load_from`` the thread run's
   checkpoints; checks the 2:1 layout and the draws from both splits, the
   load of every tensor, finite losses, the frozen stages kept and the
   head moved, and the eval's vote-NMS launches, and prints its img/s and
   wait share;
9. runs the anchor-head family (``configs/atss``: ATSS and RetinaNet's
   ``AnchorHead``): the kernel's no-vote mode (class-aware greedy NMS)
   against ``batched_nms_plain`` in float64, bit for bit, at the (B, K) of
   ``NMS_SHAPES`` with 21 labels, timed beside the plain version and the
   bound; ``init_detector`` on each config at full width (seeded random
   weights, bf16) and ``inference_detector`` on 8 random 480x640 images,
   one no-vote launch per batch, the run's NMS inputs through the plain
   version, the float32 forward against the CPU's; ATSS inference timed at
   batch 8 and 128; the train CLI on each config from the JPEG
   ``train_pbr`` split through its own pipeline (10 steps ATSS, 10
   RetinaNet, batch 16, bf16, one eval on the PNG set): finite losses,
   checkpoint, frozen stages kept, head moved, and the test CLI (``--eval
   bbox``) on that checkpoint; each train step's time with
   its IoU assignment's share; and ATSS's float32 step on the card against
   the CPU at batch 1 (same ReLU sides);
10. runs ``configs/bop``'s backbone zoo (ResNeXt-50 32x4d, Res2Net-50,
   ResNeSt-50, RegNetX-3.2GF; ``ZOO_CONFIGS``): ``init_detector`` on each at
   full width (seeded random weights, bf16, cls bias 0), its parameter
   count and FPN input widths (RegNet's [96, 192, 432, 1008]),
   ``inference_detector`` on 8 random 480x640 images with the vote-NMS
   launches counted, that run's NMS inputs through the kernel and the plain
   version in float64, the float32 forward against the CPU's, inference at
   batch 8 and 128 and the train step at batch 16 timed with peak memory,
   and the float32 step on the card against the CPU at batch 1 (same ReLU
   sides); then RegNet through the train CLI (``ZOO_STEPS`` steps from the
   JPEG ``train_pbr`` split, one eval), the test CLI (strict) on its
   checkpoint and ``init_detector`` on its work dir;
11. trains the flagship with live BatchNorm (``norm_eval=False``) at
   ``frozen_stages`` -1 and 1: the bf16 step at batch 16 with and without
   ``with_cp``, time and peak memory beside the ``norm_eval=True`` step;
   the float32 step at batch 1 against the CPU (same ReLU sides: losses,
   gradients, every running mean and variance); ``with_cp`` against the
   plain float32 step on the card; then ``python -m
   radet_tpu_torch.tools.validate_learning --qat`` at its defaults (mAP50
   at least 0.5, or the smoke fails; then its QAT loop: the PTQ eval, 200
   QAT steps and the deploy eval, with both RESULT lines) and ``python -m
   radet_tpu_torch.tools.run_bop_sweep --mode test`` over the seven BOP
   datasets' synthetic PNG sets (each BOP submission's category ids that
   config's), both evals' vote-NMS calls held to the plain version;
12. runs the measuring and deploy tools, each CLI's ``main`` at full
   width: vote-NMS through its operator against the kernel's wrapper
   alone at ``DISPATCH_SHAPES`` (the operator's dispatch cost); ``python -m
   radet_tpu_torch.tools.get_flops`` (32,159,327 parameters, the FLOPs
   equal to the same tool's CPU count); ``tools.profile_infer`` at batch
   128 and 8 (time by module, top kernels with vote-NMS's three under
   ``postprocess``, the roofline bound and the busy share);
   ``tools.profile_train`` at batch 16 (the step, its parts, its MFU);
   ``tools.export_model --verify`` at batch 8 in bf16, the program loaded
   in a fresh process and run on the main path's images (launches counted
   per call, outputs held to the eager step, both timed);
   ``tools.eval_metric`` on the phase-5 test CLI's ``--out`` pickle (its
   metrics equal to the CLI's); ``tools.profile_pipeline`` for the train
   and test pipelines at 4 workers, threads and processes;
13. runs the int8 deploy family (``configs/bop/r50_ycbv_pbr_int8*.py``):
   builds ``csrc/int8_conv.cu`` with the other sources and holds it to its
   plain version (float64 on the card without cuDNN, exact) bit for bit,
   int32 sums and bf16 outputs, at every distinct int8 conv shape of
   int8_full and int8_stream at 480x640 (the inputs recorded from their
   forward on the main path's 8 images) and at a grouped shape with 4
   channels a group, each timed at batch 8 (the kernel the plan picks) and
   128 (both kernels) beside its bound,
   ``torch._int_mm`` (1x1 stride-1 shapes) and the bf16 cuDNN conv;
   ``init_detector`` and ``inference_detector`` on int8, int8_conv2,
   int8_full, int8_stream and the QAT config at full width (int8 launches
   per forward 40, 56, 72, 92, 92), each one's float32 forward against the
   CPU's (int8 levels and head maps); serves int8_stream (one full batch of
   16 through ``BatchingDetector`` against ``inference_detector``: the
   head's dynamic absmax spans the batch); the test CLI on it over the
   eval phase's PNG set; ``profile_infer --quant int8_stream`` at batch
   128; ``export_model`` of it, its program loaded in a fresh process
   (int8 and vote-NMS launches per call, bit for bit against the eager
   step); and times the flagship, int8, int8_full and int8_stream at batch
   8 and 128;
14. draws, each tool through its CLI's ``main`` in this process:
   ``radet_tpu_torch.tools.test --show-dir --show-score-thr 0`` (strict
   eval, its vote-NMS launches counted) on 4 synthetic 480x640 PNG test
   images, each PNG held bit for bit to ``imshow_det_bboxes`` of the run's
   ``--out`` detections, with the host ms per image to draw and to encode
   PNG and JPEG; ``tools.show_bop_detbbox`` on that run's BOP json; and
   ``tools.browse_dataset --show-dist --show-assignment`` (the assignment
   on the card) on the train_pbr split through the flagship's pipeline,
   each JPEG held byte for byte to the script's rebuild from the same
   seeds;
15. trains quantization-aware (``configs/bop/r50_ycbv_pbr_int8_qat.py``):
   its float32 step at batch 1, full width, on the card against the CPU
   (same weights, batch, noise, ReLU sides and fake-quantized levels, the
   CPU's own level flips counted: losses, gradients with the BN and GN
   affines', running statistics); its bf16 step at batch 16 timed with its
   peak memory beside the flagship's before and after it, launching no
   int8 kernel; ``tools.train`` on it in this process, with cuDNN's TF32
   on as PyTorch starts and every QAT conv's forward and backward checked
   to run with it off, from the JPEG ``train_pbr`` split
   (``QAT_CLI_STEPS`` steps, ``load_from`` the flagship's from-files
   checkpoint, one periodic eval on the deploy arithmetic) and
   ``tools.test`` with ``r50_ycbv_pbr_int8_stream.py`` on its checkpoint:
   92 int8 launches per forward, all on the wgmma kernel, and every
   vote-NMS call held to the plain version;
16. trains with the frozen prefix on int8 (``configs/bop/
   r50_ycbv_pbr_frozen_int8.py``): its float32 step at batch 1, full width,
   on the card against the CPU (same weights, batch, noise, ReLU sides and
   int8 levels); its bf16 step at batch 16 timed with its peak memory
   beside the flagship's before and after it, 10 int8 launches a step, all
   on the wgmma kernel; one step's 10 int8 convolutions each held bit for
   bit to the plain version, and their distinct shapes (layer1's, batch 16)
   timed beside the bound, ``torch._int_mm`` and cuDNN's bf16 conv; the
   trunk with every stage frozen in training mode against the
   ``int8_stream`` trunk at eval, bit for bit; ``tools.train`` on it in
   this process (``FI8_CLI_STEPS`` steps from the JPEG ``train_pbr`` split,
   ``load_from`` the flagship's from-files checkpoint: every tensor loaded,
   the frozen ones kept, the others moved; one periodic eval on the float
   path, without an int8 launch, its vote-NMS calls held to the plain
   version); ``tools.profile_train --frozen-int8``; ``python -m
   radet_tpu_torch.tools.validate_learning --depth 50 --frozen-int8``
   (ResNet-50 from scratch, mAP50 at least 0.5; then two 100-step frozen
   fine-tunes of its weights, one with ``frozen_int8`` at 10 int8 launches
   a step, each evaluated on the float path, with their RESULT lines);
17. runs the eval path's test-time variants, each through
   ``radet_tpu_torch.tools.test``'s ``main`` on 32 landscape images of the
   eval phase's PNG set with its weights (strict, full width, bf16, batch
   16): the plain strict eval (first and last), ``test_cfg.flip_tta=True``,
   ``test_cfg.tta.scales`` (640x480 and 800x600) with ``flip=True``,
   ``--fuse-conv-bn`` and ``test_cfg.nms_impl=scan``, every vote-NMS call
   counted by K (the views' K 2048, the fusion's K 200 and 400, the scan's
   4420) and held to the plain version in float64, each run's img/s
   beside the strict eval's; the fused float32 forward on the card (TF32
   off) against the unfused one; and the fusion's and the scan's kernel
   calls timed beside the plain version and the bound;
18. trains from boxes alone (``GenerateDistanceMap(with_gt_mask=False)``,
   ROADMAP item 17): the C++ MBD and GDT against their numpy twins on the
   crops of two training images' boxes (spawned processes), bit for bit;
   the train pipeline's ms per sample on one thread with masks and
   mask-free (GDT, MBD); ``tools.train`` on the flagship's mask-free GDT
   config at full width (``MF_STEPS`` steps, each step's ms and data wait
   printed, one periodic eval, its vote-NMS calls at K 512 held to the
   plain version); then that step's two halves alone: the train step on a
   batch on the card, and the loader with no step running;
19. tests the ITODD config on gray TIFFs (ROADMAP item 20): the committed
   TIFF fixtures against cv2's recorded hashes; 32 synthetic 1280x960 gray
   Deflate TIFFs in BOP's layout; their decode timed beside an
   uncompressed TIFF and a PNG of the same pixels; ``tools.test`` on
   ``configs/bop/r50_itodd_pbr.py`` (28 classes, full width, bf16, batch
   16, ``--eval bbox`` with the BOP json), its two vote-NMS launches at K
   2048 held to the plain version.
   Each phase prints its wall time.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.  Without a CUDA card, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import os.path as osp
import pickle
import random
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
EVAL_GROUPS = ((48, (480, 640)), (16, (540, 720)), (16, (640, 480)))
METRIC_ATOL = 1e-3  # COCO metrics, kernel vs plain vote-NMS in the same eval
EVAL_INTERVAL = 10  # trainer steps between evaluations
# training from files: a JPEG train_pbr split of FILES_IMAGES copies of the
# committed 480x640 fixtures (tests/data/jpeg) with their records' boxes and
# mask_visib PNGs, backgrounds of BACKGROUNDS JPEG copies and as many PNGs at
# COCO's common 427x640 (decoded and resized); FILES_STEPS steps, one eval
FILES_IMAGES = 64
BACKGROUNDS = 48
FILES_STEPS = 20
FILES_WORKERS = 4
# the mixpbr fine-tune: a train_real split of REAL_IMAGES fixture copies
# beside train_pbr, MIX_CONFIG (configs/bop) over both, MIX_STEPS steps
REAL_IMAGES = 32
MIX_CONFIG = "r50_ycbv_mixpbr.py"
MIX_STEPS = 10
# the bound of a vote-NMS call: H100 SXM peaks (NVIDIA's data sheet) and
# float32 operations per unit of work
F32_PEAK = 67e12  # FLOP/s, float32 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s
IOU_OPS = 15  # per same-label IoU test
VOTE_OPS = 36  # per member: weight, 3 passes over 4 coordinates
# kernel_by_k's (B, K): deploy and interactive inference (K = 512), the
# strict eval (K = 2048, its batch 16), and the flagship's largest per-level
# set (4420, a partial last 32-box word); (16, 512) is the serving batch
KERNEL_SHAPES = ((8, 512), (16, 512), (128, 512), (8, 2048), (16, 2048), (8, 4420))
# the anchor family (configs/atss): train CLI steps per config; the no-vote
# kernel's (B, K): interactive and deploy inference at nms_topk 1024, the
# train CLI's periodic eval (B = 16), and the strict eval (K = 2048)
ANCHOR_CONFIGS = ("configs/atss/atss_r50_fpn_ycbv_pbr.py", "configs/atss/retina_r50_fpn_ycbv_pbr.py")
ANCHOR_STEPS = {"atss_r50_fpn_ycbv_pbr": 10, "retina_r50_fpn_ycbv_pbr": 10}
NMS_SHAPES = ((8, 1024), (16, 1024), (128, 1024), (16, 2048))
NMS_LABELS = 21
ANCHOR_MAIN_SHAPE = (8, 1024)  # the kernels line's times: the main path's call (inference_detector, 8 images)
# serving: the CLI's default batch and latency budget; the bit-for-bit
# check's images at YCB-V's size, T-LESS's (resized) and COCO's common
# 427x640 (padded); submitter threads of the sweep, SERVE_REQUESTS each
# 10. configs/bop's backbone zoo (full width, bf16, seeded random weights)
ZOO_CONFIGS = ("configs/bop/x50_32x4d_ycbv_pbr.py", "configs/bop/r2_50_ycbv_pbr.py",
               "configs/bop/s50_ycbv_pbr.py", "configs/bop/regnetx32_ycbv_pbr.py")
ZOO_WIDTHS = {"regnetx32_ycbv_pbr": [96, 192, 432, 1008]}  # C2..C5; the others ResNet-50's
# the zoo config furthest from the flagship (own stem, no max-pool, grouped
# expansion-1 blocks, FPN inputs of other widths) goes through the CLIs
ZOO_CLI_CONFIG = "configs/bop/regnetx32_ycbv_pbr.py"
ZOO_STEPS = 10
# 11. live BatchNorm and checkpointing on the flagship (norm_eval=False at
# these frozen_stages), the learning check, the BOP sweep
LIVE_FROZEN = (-1, 1)
STAT_RTOL = 1e-4  # BN running statistics after the float32 step, card vs CPU, relative to each tensor's max
CP_RTOL = 1e-6  # with_cp against the same float32 step without it on the card: gradients and statistics
# |x| / max |x| of a ReLU input the card and the CPU put on opposite sides of 0 behind a BN on batch
# statistics: their float32 E[x^2] - mean^2 over ~1e5 values (flax's formula) differs by ~1e-6 of
# mean^2 between the two reduction orders, which reaches 1e-5-1e-4 of the output where |mean| >> std
LIVE_FLIP_RTOL = 1e-4
# the gradient of a one-element parameter (the head's per-level Scale) behind those BNs, relative to
# itself: a sum of the regression positives' terms of either sign, whose cancellation amplifies the
# card's and the CPU's 1e-5 forward differences; every tensor of more elements keeps GRAD_RTOL
LIVE_SCALAR_RTOL = 1e-2
LEARN_MIN_MAP50 = 0.5  # validate_learning's own gate, at its defaults
SWEEP_IMAGES = 4  # PNG test images per BOP dataset, 480x640
SERVE_BATCH = 16
SERVE_LATENCY_MS = 5.0
SERVE_SIZES = ((480, 640), (540, 720), (427, 640))
SERVE_SUBMITTERS = (1, 16, 64)
SERVE_REQUESTS = 128
SERVE_CLIENTS = 16  # HTTP client threads against the CLI


def phase(name: str, fn, *args):
    """``fn(*args)``, printing its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    from radet_tpu_torch.utils.profiling import card as nvidia_smi_card

    return nvidia_smi_card()


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


def nms_bound(arrays, max_out: int, vote: bool = True):
    """The least time the card could take for one vote-NMS call on these
    inputs: the larger of the bytes (each input read once, each output
    written once) over HBM3's 3.35 TB/s, and the float32 operations this
    data needs over 67 TFLOP/s (a label compare per pair of valid
    candidates, ~15 operations per same-label IoU test, ~36 per member's
    votes).  ``vote=False``: the no-vote mode's call on (boxes, scores,
    labels, valid), one score in, no votes.  Returns (ms, "bytes" or
    "operations", operations, bytes)."""
    labels, valid = (a.cpu() for a in arrays[-2:])
    b, k = labels.shape
    n_valid = valid.sum(1).double()
    same = 0.0
    for i in range(b):
        counts = torch.unique(labels[i][valid[i]], return_counts=True)[1].double()
        same += float((counts * (counts - 1) / 2).sum())
    ops = float((n_valid * (n_valid - 1) / 2).sum()) + IOU_OPS * same + VOTE_OPS * vote * float(n_valid.sum())
    nbytes = b * k * (16 + 4 * vote + 4 + 4 + 1) + b * max_out * (16 + 4 + 4 + 1)
    by_ops, by_bytes = ops / F32_PEAK, nbytes / HBM_RATE
    return max(by_ops, by_bytes) * 1e3, "operations" if by_ops >= by_bytes else "bytes", ops, nbytes


def kernel_split(fn, calls: int = 10) -> str:
    """The vote-NMS call's device ms (CUDA events around a loop of calls
    also count the host's time per call where that is longer), and each of
    its CUDA kernels' ms and share, from torch.profiler's key_averages();
    "not measured" when it shows no device time."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = dict.fromkeys(vnc.CUDA_KERNELS, 0.0), dict.fromkeys(vnc.CUDA_KERNELS, 0)
    for e in prof.key_averages():
        for name in vnc.CUDA_KERNELS:
            if name in e.key:
                us[name] += getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                count[name] += e.count
    total = sum(us.values())
    if total <= 0:
        return "not measured (no device time in key_averages())"
    caught, launched = sum(count.values()), calls * len(vnc.CUDA_KERNELS)
    if 2 * caught < launched:
        return f"not measured (the profiler caught {caught} of {launched} kernel events)"
    return (f"{total / calls / 1e3:.4f} ms per call in {sum(count.values()) / calls:g} CUDA kernels: "
            + ", ".join(f"{n} {us[n] / calls / 1e3:.4f} ms ({us[n] / total:.1%})" for n in vnc.CUDA_KERNELS))


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


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` back-to-back calls:
    a spin kernel (~5 ms) keeps the card busy while the host queues them
    all, so the host's time per call does not pace the reading (it is
    measured apart, e.g. ``int8_host_us``)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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


@contextlib.contextmanager
def level_decisions(levels, replay: bool):
    """Within the block, every fake quantization (``quant.quant_levels``)
    records its int8 levels into ``levels`` (``replay=False``, kept on the
    CPU as int8), or takes the recorded levels in the same call order
    (``replay=True``), so that two runs of a QAT network put every element
    on the same level.  Yields the replayed calls' own disagreements: the
    count of elements this run would have put on another level, per call."""
    from radet_tpu_torch.ops import quant

    inner = quant.quant_levels
    recorded = iter(levels)
    flips = []

    def record(x, scale):
        out = inner(x, scale)
        levels.append(out.to(torch.int8).cpu())
        return out

    def shared(x, scale):
        own = inner(x, scale)
        out = next(recorded).to(x.device, torch.float32)
        flips.append(int((own != out).sum()))
        return out

    quant.quant_levels = shared if replay else record
    try:
        yield flips
    finally:
        quant.quant_levels = inner


def parity_steps(cfg, one, anchors, ranges, model_args, runs):
    """One train step (zero-lr SGD, no clip, in the model's dtype and mode)
    of each (name, model, device) in ``runs`` on the numpy batch ``one``
    with the same assignment noise; returns {name: (assignment, metrics,
    gradients on the CPU)}."""
    from radet_tpu_torch.apis.common import assignment_cfg_from
    from radet_tpu_torch.core.assignment import gumbel
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device

    acfg = assignment_cfg_from(cfg)
    cap = int(acfg.get("positive_num", 10)) * (4 if acfg.get("adapt_positive_num") else 1)
    b, n, g = one["dist_vals"].shape
    gen = torch.Generator().manual_seed(SEED + 3)
    noise = (gumbel((b, g, n), gen, "cpu"), gumbel((b, g, cap, cap), gen, "cpu"))
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


def forward_checks(det, config: str, images, what: str = "") -> float:
    """The vote-NMS inputs of ``det``'s forward on ``images`` (uint8 NHWC on
    the card, at the input size) through the kernel and through the plain
    version in float64 on the CPU; the float32 forward of the first image
    on the card against a CPU model of ``config`` holding the same weights,
    within MAP_RTOL.  Returns the kernel's max abs box error."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import init_detector
    from radet_tpu_torch.apis.common import normalizer_from_cfg
    from radet_tpu_torch.models.detector import preprocess_images
    from radet_tpu_torch.models.postprocess import vote_nms_inputs

    dev = torch.device("cuda")
    model, cfg = det.model, det.cfg
    n, h, w = images.shape[:3]
    level_anchors = [torch.as_tensor(a, device=dev)
                     for a in np.split(det.anchors, np.cumsum(det.level_counts)[:-1])]
    shapes = torch.tensor([[h, w]] * n, dtype=torch.float32, device=dev)
    scales = torch.ones((n, 4), dtype=torch.float32, device=dev)
    norm = cfg.img_norm_cfg
    with torch.inference_mode():
        x = preprocess_images(images, norm.mean, norm.std, model.dtype)
        args, kw = vote_nms_inputs(
            *model(x), level_anchors, shapes, scales, test_cfg=cfg.test_cfg.to_dict(),
            normalizer=normalizer_from_cfg(cfg),
        )
        print(f"  {what}NMS input: K={args[0].shape[1]}, valid candidates per image {args[4].sum(1).tolist()}")
        err = compare(vnc.vote_nms_cuda(*args, **kw), plain_reference(args, **kw),
                      f"{what}main-path candidates, kernel on the card vs plain in float64 on the CPU")

        # float32 forward on the card vs the CPU forward, 1 image
        model.dtype = torch.float32
        gpu_maps = [m.cpu() for maps in model(x[:1].float()) for m in maps]
        cpu_model = init_detector(config, device="cpu", seed=SEED).model
        cpu_model.load_state_dict(model.state_dict())
        cpu_maps = [m for maps in cpu_model(x[:1].float().cpu()) for m in maps]
        model.dtype = torch.bfloat16
    rel = max(float((g - c).abs().max() / c.abs().max().clamp(min=1e-6)) for g, c in zip(gpu_maps, cpu_maps))
    print(f"  {what}float32 head maps, card vs CPU: max error relative to each map's max "
          f"{rel:.3g} (limit {MAP_RTOL})")
    if rel > MAP_RTOL:
        fail(f"{what}the card's float32 forward disagrees with the CPU forward")
    return err


def train_phases(config: str, gpu: str, eval_opts) -> float:
    """Training on the card: the trainer with periodic eval (``eval_opts``:
    config options naming the val data), an overfit batch, card-vs-CPU
    parity, the train step's time, and inference with the trained weights.
    Returns the trainer's median ms per step."""
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
        memory_ms, memory_wait = median_iter(iters)
        print(f"  median of steps 6-{TRAIN_STEPS}: {memory_ms:.1f} ms/step ({batch_size * 1000 / memory_ms:.1f} "
              f"img/s), loader wait {memory_wait:.1f} ms/step")
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
    return memory_ms


def decode_phase(gpu: str, work: str) -> None:
    """The card machine's build of the JPEG decoder against the committed
    cv2 hashes of tests/data/jpeg, and JPEG decode timed beside PNG decode
    of the same pixels (``imread`` from the file, one thread)."""
    import hashlib

    from radet_tpu_torch.data import image_io
    from synthetic_bop import JPEG_FIXTURES, write_png

    with open(osp.join(JPEG_FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    for name, want in sorted(hashes.items()):
        path = osp.join(JPEG_FIXTURES, name)
        for flag, key in ((image_io.IMREAD_COLOR, "rgb_sha256"), (image_io.IMREAD_GRAYSCALE, "gray_sha256")):
            if hashlib.sha256(image_io.imread(path, flag).tobytes()).hexdigest() != want[key]:
                fail(f"JPEG decode of {name} ({key[:-7]}) differs from cv2 {want['cv2']}'s recorded hash")
    print(f"decode: JPEG fixtures {sorted(hashes)}: RGB and gray decodes equal cv2 {want['cv2']}'s "
          f"recorded SHA-256, byte for byte")

    def per_image_ms(path, reps=10):
        image_io.imread(path)
        t0 = time.perf_counter()
        for _ in range(reps):
            image_io.imread(path)
        return (time.perf_counter() - t0) * 1000 / reps

    parts = []
    for name in sorted(hashes):
        path = osp.join(JPEG_FIXTURES, name)
        png = osp.join(work, name.replace(".jpg", ".png"))
        write_png(png, image_io.imread(path))
        parts.append(f"{name} ({os.path.getsize(path) // 1024} KB) {per_image_ms(path):.2f} ms, as PNG "
                     f"({os.path.getsize(png) // 1024} KB) {per_image_ms(png):.2f} ms")
    print(f"timing: imread 480x640 RGB, one thread, mean of 10: " + "; ".join(parts) + f" [host of {gpu}]")


def color_aug_phase(gpu: str) -> None:
    """The card machine's build of ``csrc/color_aug.cpp`` (and the numpy
    twins) and ``data/poly.py::fill_poly`` against the committed cv2 hashes
    of tests/data/color_aug: every CosyPose op at the recorded factors and
    the blur at sigma 1-3 on the JPEG fixtures, and the masks of the fixed
    polygons; then each op's ms per call on a 480x640 image, one thread."""
    import hashlib

    from radet_tpu_torch.data import color_aug, image_io
    from radet_tpu_torch.data.pipeline import LoadAnnotations
    from synthetic_bop import JPEG_FIXTURES

    with open(osp.join(osp.dirname(JPEG_FIXTURES), "color_aug", "hashes.json")) as f:
        hashes = json.load(f)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def run(key, img, ops):
        op, arg = key.split()
        return ops.blur(img, int(arg)) if op == "Blur" else color_aug.enhance(op, img, float(arg), ops)

    checked = 0
    for name, rec in sorted(hashes["images"].items()):
        img = image_io.imread(osp.join(JPEG_FIXTURES, name))
        if sha(img) != rec["rgb_sha256"]:
            fail(f"the decode of {name} differs from cv2's recorded hash")
        for key, want in rec["ops"].items():
            for label, ops in (("C++", color_aug.NATIVE), ("numpy twin", color_aug.PLAIN)):
                if sha(run(key, img, ops)) != want:
                    fail(f"{label} {key} on {name} differs from cv2 {hashes['cv2']}'s recorded hash")
                checked += 1
    polys = hashes["polygons"]
    h, w = polys["hw"]
    n = len(polys["masks"])
    ann = dict(bboxes=np.zeros((n, 4), np.float32), labels=np.zeros(n, np.int64),
               segmentations=polys["segmentations"])
    load = LoadAnnotations(with_bop_mask=True)
    masks = load(dict(img_info=dict(height=h, width=w), ann_info=ann))["gt_masks"]
    if [sha(m) for m in masks] != polys["masks"]:
        fail(f"fill_poly's masks differ from cv2 {hashes['cv2']}'s recorded fillPoly hashes")
    print(f"color_aug: {checked} outputs of csrc/color_aug.cpp and its numpy twins on "
          f"{sorted(hashes['images'])} and {n} polygon masks equal cv2 {hashes['cv2']}'s recorded SHA-256")

    img = image_io.imread(osp.join(JPEG_FIXTURES, "ycbv_420.jpg"))
    parts = []
    for key in ["Blur 1", "Blur 2", "Blur 3"] + [f"{op} {f[1]}" for op, f in hashes["factors"].items()]:
        run(key, img, color_aug.NATIVE)
        t0 = time.perf_counter()
        for _ in range(10):
            run(key, img, color_aug.NATIVE)
        parts.append(f"{key} {(time.perf_counter() - t0) * 100:.2f}")
    t0 = time.perf_counter()
    for _ in range(10):
        load(dict(img_info=dict(height=h, width=w), ann_info=ann))
    print(f"timing: CosyPose ops on a 480x640 RGB image, ms per call, one thread, mean of 10: "
          + ", ".join(parts) + f"; fill_poly of the {n} fixed polygons "
          f"{(time.perf_counter() - t0) * 100 / n:.2f} per object [host of {gpu}]")


def median_iter(lines, skip: int = 5):
    """(median ms/iter, median data-wait ms/iter) of the trainer's log lines
    after the first ``skip``."""
    ms = [float(m) for ln in lines[skip:] for m in re.findall(r"\| (\S+) ms/iter", ln)]
    wait = [float(m) for ln in lines[skip:] for m in re.findall(r"data wait (\S+) ms/iter", ln)]
    return float(np.median(ms)), float(np.median(wait))


def write_train_files(config: str, work: str):
    """The from-files training splits and backgrounds in ``work``: a
    ``train_pbr`` split of FILES_IMAGES images and a ``train_real`` split of
    REAL_IMAGES.  Returns (the run-time config of ``config`` training from
    ``train_pbr`` through its own train_pipeline, that of MIX_CONFIG's
    ``MixDataset`` over both splits)."""
    from radet_tpu_torch.data import image_io
    from radet_tpu_torch.utils import Config
    from synthetic_bop import (
        JPEG_FIXTURE_SEED,
        JPEG_FIXTURES,
        synthetic_bop_records,
        write_bop_train_set,
        write_png,
        write_train_config,
    )

    with open(osp.join(JPEG_FIXTURES, "hashes.json")) as f:
        fixtures = sorted(json.load(f).items(), key=lambda kv: kv[1]["record"])
    jpegs = []
    for name, _ in fixtures:
        with open(osp.join(JPEG_FIXTURES, name), "rb") as f:
            jpegs.append(f.read())
    records = synthetic_bop_records(np.random.RandomState(JPEG_FIXTURE_SEED), len(jpegs), (480, 640))
    names = Config.fromfile(config).CLASS_NAMES
    t0 = time.perf_counter()
    ann = write_bop_train_set(work, [records[i % len(jpegs)] for i in range(FILES_IMAGES)], jpegs, names)
    real = write_bop_train_set(work, [records[i % len(jpegs)] for i in range(REAL_IMAGES)], jpegs, names,
                               split="train_real")
    bg_dir = osp.join(work, "backgrounds")
    os.makedirs(bg_dir)
    smooth = image_io.imread(osp.join(JPEG_FIXTURES, fixtures[0][0]))[:427]
    rng = np.random.RandomState(SEED + 6)
    for i in range(BACKGROUNDS):
        with open(osp.join(bg_dir, f"{i:06d}.jpg"), "wb") as f:
            f.write(jpegs[i % len(jpegs)])
        write_png(osp.join(bg_dir, f"{i:06d}.png"), np.roll(smooth, 37 * i, axis=1) // rng.randint(1, 4))
    with open(ann) as f:
        n_obj = len(json.load(f)["annotations"])
    print(f"train from files: {FILES_IMAGES} JPEG images 480x640 in train_pbr and {REAL_IMAGES} in train_real "
          f"(copies of the {len(jpegs)} fixtures; train_pbr {n_obj} objects with mask_visib PNGs), "
          f"{BACKGROUNDS} JPEG and {BACKGROUNDS} PNG (427x640) backgrounds, written in "
          f"{time.perf_counter() - t0:.1f} s")
    prefix = osp.join(work, "train_pbr") + "/"
    return (write_train_config(osp.join(work, "train_config.py"), config, ann, prefix, bg_dir),
            write_train_config(osp.join(work, "mix_config.py"), str(Path(config).parent / MIX_CONFIG), ann,
                               prefix, bg_dir, real=(real, osp.join(work, "train_real") + "/")))


def loader_phase(train_config: str, gpu: str) -> None:
    """The from-files host path alone: each transform's ms per sample on one
    thread, and the loader's ms per batch of 16 at 4 and 8 threads."""
    from radet_tpu_torch.apis.common import build_dataset
    from radet_tpu_torch.data import DataLoader
    from radet_tpu_torch.utils import Config

    from radet_tpu_torch.data.color_aug import CosyPoseAug

    cfg = Config.fromfile(train_config)
    dataset = build_dataset(cfg, "train")
    transforms = dataset.pipeline.transforms
    spent = dict.fromkeys((type(t).__name__ for t in transforms), 0.0)
    cosy = next(t for t in transforms if isinstance(t, CosyPoseAug))
    cosy_ops = cosy.ops
    op_names = [getattr(op, "name", type(op).__name__) for op in cosy_ops]
    op_spent = dict.fromkeys(op_names, 0.0)

    def timed(t, name, into):
        def run(x):
            t0 = time.perf_counter()
            out = t(x)
            into[name] += time.perf_counter() - t0
            return out
        return run

    n = 48
    dataset.pipeline.transforms = [timed(t, type(t).__name__, spent) for t in transforms]
    cosy.ops = [timed(op, name, op_spent) for op, name in zip(cosy_ops, op_names)]
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i % len(dataset)]
    total = (time.perf_counter() - t0) * 1000 / n
    dataset.pipeline.transforms, cosy.ops = transforms, cosy_ops
    print(f"loader: one thread, the flagship's train_pipeline, {total:.2f} ms per sample (mean of {n}): "
          + ", ".join(f"{k} {v * 1000 / n:.2f}" for k, v in spent.items())
          + f", packing and the rest {total - sum(spent.values()) * 1000 / n:.2f} [host of {gpu}]")
    print(f"loader: CosyPoseAug (p {cosy.p}) by op, ms per sample over all {n} samples: "
          + ", ".join(f"{k} {v * 1000 / n:.2f}" for k, v in op_spent.items()) + f" [host of {gpu}]")
    batch = int(cfg.data.samples_per_gpu)
    for workers in (FILES_WORKERS, 8):
        it = iter(DataLoader(dataset, batch_size=batch, num_workers=workers, seed=SEED, infinite=True))
        for _ in range(3):  # the prefetched batches
            next(it)
        t0 = time.perf_counter()
        for _ in range(10):
            next(it)
        ms = (time.perf_counter() - t0) * 100
        it.close()
        print(f"loader: {workers} threads, {ms:.1f} ms per batch of {batch} ({batch * 1000 / ms:.1f} img/s, "
              f"mean of 10) [host of {gpu}]")


def contention_phase(train_config: str, gpu: str, device: str = "cuda") -> None:
    """The train step's ms at batch 16 (the batch already on the card, CUDA
    events, 10 steps) with the from-files loader idle and with it running
    flat out in the background (FILES_WORKERS thread or process workers,
    batches drained as they come), in turns: idle, thread, process, idle."""
    import threading

    from radet_tpu_torch.apis.common import (
        assignment_cfg_from,
        build_dataset,
        build_model_and_anchors,
        loss_cfg_from,
        normalizer_from_cfg,
    )
    from radet_tpu_torch.data import DataLoader, collate
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
    from radet_tpu_torch.utils import Config

    cfg = Config.fromfile(train_config)
    model, anchors, ranges, _ = build_model_and_anchors(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to(device).train()
    tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
    state = TrainState(model, tx, seed=SEED + 1)
    step = build_train_step(model, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(),
                            num_classes=int(cfg.model.bbox_head.num_classes),
                            assignment_cfg=assignment_cfg_from(cfg), normalizer=normalizer_from_cfg(cfg),
                            loss_cfg=loss_cfg_from(cfg))
    dataset = build_dataset(cfg, "train")
    batch_size = int(cfg.data.samples_per_gpu)
    batch = batch_to_device(collate([dataset[i] for i in range(batch_size)]), device)
    for _ in range(3):
        step(state, batch)

    def drain(stop, count, mode):
        it = iter(DataLoader(dataset, batch_size=batch_size, num_workers=FILES_WORKERS, seed=SEED, infinite=True,
                             worker_mode=mode))
        while not stop.is_set():
            next(it)
            count.append(1)
        it.close()

    runs = {"idle": [], "thread": [], "process": []}
    produced = {"thread": [], "process": []}
    for mode in ("idle", "thread", "process", "idle"):
        stop, count, loader = threading.Event(), [], None
        if mode != "idle":
            loader = threading.Thread(target=drain, args=(stop, count, mode))
            loader.start()
            while len(count) < 3:  # past the start-up and the prefetched batches
                time.sleep(0.05)
        t0, before = time.perf_counter(), len(count)
        runs[mode].append(cuda_ms(lambda: step(state, batch), 10))
        if loader is not None:
            produced[mode].append((len(count) - before) * batch_size / (time.perf_counter() - t0))
            stop.set()
            loader.join()
    idle = float(np.mean(runs["idle"]))
    print(f"timing: train step batch {batch_size} (batch on the card), from-files loader idle {idle:.2f} ms "
          f"(runs {[round(v, 2) for v in runs['idle']]}); busy in the background with {FILES_WORKERS} "
          + "; ".join(f"{m} workers ({np.mean(produced[m]):.1f} img/s drained) {np.mean(runs[m]):.2f} ms "
                      f"(runs {[round(v, 2) for v in runs[m]]}, {np.mean(runs[m]) / idle - 1:+.1%})"
                      for m in ("thread", "process")) + f" [{gpu}]")
    del state, model, tx, step, batch
    if device == "cuda":
        torch.cuda.empty_cache()


def train_cli(config: str, work_dir: str, steps: int, mode: str, eval_opts, *opts, device: str = "cuda",
              nms: str = "vote_nms", fresh: bool = False):
    """``python -m radet_tpu_torch.tools.train`` on ``config`` (its ``main``,
    or with ``fresh`` in a process of its own: ``tool_run``) for ``steps``
    steps with ``data.workers_per_gpu`` = FILES_WORKERS workers of
    ``mode``, one eval at the last step and a checkpoint there; checks its
    steps, eval, the launches of the NMS kernel's ``nms`` mode ('vote_nms'
    or 'batched_nms') in it, losses and checkpoint.  Returns (iter lines,
    the 'train dataset:' line, launches, seconds, the log)."""
    from radet_tpu_torch.engine import load_weights

    cmd = ["-m", "radet_tpu_torch.tools.train", config, "--work-dir", work_dir,
           "--device", device, "--max-iters", str(steps), "--cfg-options", "log_config.interval=1",
           f"checkpoint_config.interval={steps}", f"evaluation.interval={steps}",
           f"data.workers_per_gpu={FILES_WORKERS}", f"data.worker_mode={mode!r}", *eval_opts, *opts]
    _, err, run_s = tool_run(Path(__file__).resolve().parent, cmd,
                             f"the train CLI on {osp.basename(config)} ({mode} workers)", fresh)
    log = err.splitlines()
    iters = [ln for ln in log if ln.startswith("iter ")]
    evals = [ln for ln in log if ln.startswith("eval: ")]
    launches = sum(int(n) for ln in log for n in re.findall(nms + r" kernel launches (\d+)", ln))
    dataset = next((ln for ln in log if ln.startswith("train dataset:")), "")
    ckpt = osp.join(work_dir, "checkpoints")
    saved = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) if osp.isdir(ckpt) else []
    for ln in (iters[0], iters[len(iters) // 2], iters[-1]):
        print(f"  {ln}")
    for ln in evals:
        print(f"  {ln}; {nms} kernel launches {launches}")
    if len(iters) != steps or len(evals) != 1 or launches < 1:
        fail(f"{len(iters)} steps, {len(evals)} evals, {launches} {nms} launches in the run on "
             f"{osp.basename(config)}")
    if steps not in saved or not load_weights(ckpt):
        fail(f"the run on {osp.basename(config)} wrote checkpoints {saved}, not step {steps}")
    history = [float(v) for ln in iters for v in re.findall(r" loss (\S+)", ln)]
    if len(history) != steps or not all(math.isfinite(v) for v in history):
        fail(f"non-finite or missing losses in the run on {osp.basename(config)}")
    return iters, dataset, launches, run_s, log


def files_phase(train_config: str, gpu: str, eval_opts, memory_ms: float, device: str = "cuda") -> str:
    """``python -m radet_tpu_torch.tools.train`` on the from-files config at
    full width, bf16, batch 16, FILES_WORKERS loader workers, FILES_STEPS
    steps with one periodic eval, once with thread workers (the config's
    default) and once with process workers: checks each run's checkpoint
    and its eval's vote-NMS launches, and prints its img/s beside the
    in-memory trainer's (``memory_ms`` per step, same log) and the share of
    each step spent waiting on the loader.  Returns the thread run's
    checkpoint directory."""
    for mode in ("thread", "process"):
        work_dir = osp.join(osp.dirname(train_config), f"work_dir_{mode}")
        print(f"train from files: python -m radet_tpu_torch.tools.train {CONFIG} from train_pbr (full width, "
              f"bf16, batch 16, {FILES_WORKERS} loader {mode} workers):")
        # the thread run in a process of its own, as a user starts it
        iters, dataset, _, run_s, _ = train_cli(train_config, work_dir, FILES_STEPS, mode, eval_opts,
                                                device=device, fresh=mode == "thread")
        ms, wait = median_iter(iters)
        print(f"timing: training from files, {mode} workers: {16 * 1000 / ms:.1f} img/s ({ms:.1f} ms/step, median "
              f"of steps 6-{FILES_STEPS}), loader wait {wait:.1f} ms/step ({wait / ms:.1%} of the step); in "
              f"memory (same call, same log) {16 * 1000 / memory_ms:.1f} img/s ({memory_ms:.1f} ms/step); "
              f"{len(iters)} steps in {run_s:.1f} s ({'start-up, ' if mode == 'thread' else ''}model build and "
              f"eval included); {dataset}; checkpoint of step {FILES_STEPS} loads [{gpu}]")
    return osp.join(osp.dirname(train_config), "work_dir_thread", "checkpoints")


def mix_phase(mix_config: str, pbr_checkpoints: str, gpu: str, eval_opts, memory_ms: float,
              device: str = "cuda") -> None:
    """The paper's second stage: ``python -m radet_tpu_torch.tools.train``
    on the run-time config whose ``_base_`` is MIX_CONFIG (``MixDataset``
    of train_pbr x 2 and train_real x 1, the flagship's pipeline), full
    width, bf16, batch 16, MIX_STEPS steps with FILES_WORKERS thread
    workers and one eval, ``load_from`` the first from-files run's
    checkpoints.  Checks the 2:1 layout and that the run's loader draws
    both splits, that every tensor was loaded, and that the frozen stem and
    first stage kept the loaded weights while the head moved from them."""
    from radet_tpu_torch.apis.common import build_dataset
    from radet_tpu_torch.data import DataLoader
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.utils import Config

    cfg = Config.fromfile(mix_config)
    dataset = build_dataset(cfg, "train")
    sizes = dataset.cumulative_sizes
    if type(dataset).__name__ != "MixDataset" or sizes != [2 * FILES_IMAGES, 2 * FILES_IMAGES + REAL_IMAGES]:
        fail(f"the mixpbr config built {type(dataset).__name__} with cumulative sizes {sizes}")
    batch = int(cfg.data.samples_per_gpu)
    drawn = DataLoader(dataset, batch_size=batch, seed=int(cfg.get("seed", 0)))._epoch_indices(0)
    drawn = drawn[:MIX_STEPS * batch]
    n_real = sum(i >= sizes[0] for i in drawn)
    work_dir = osp.join(osp.dirname(mix_config), "work_dir_mix")
    print(f"train mixpbr: python -m radet_tpu_torch.tools.train with _base_ configs/bop/{MIX_CONFIG} (full "
          f"width, bf16, batch {batch}, {FILES_WORKERS} loader thread workers), load_from {pbr_checkpoints}: "
          f"MixDataset cumulative sizes {sizes} (train_pbr x 2, train_real x 1); the run's {len(drawn)} samples "
          f"draw {len(drawn) - n_real} from train_pbr, {n_real} from train_real")
    if not 0 < n_real < len(drawn):
        fail("the mixpbr run does not draw from both splits")
    iters, line, _, run_s, log = train_cli(mix_config, work_dir, MIX_STEPS, "thread", eval_opts,
                                           f"load_from={pbr_checkpoints!r}", device=device)
    loaded = load_weights(pbr_checkpoints)
    after = load_weights(osp.join(work_dir, "checkpoints"))
    note = f"loaded {len(loaded)}/{len(loaded)} tensors from pretrained weights"
    if not any(note in ln for ln in log):
        fail(f"the mixpbr run did not load every tensor of {pbr_checkpoints}")
    frozen = [k for k in loaded if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
    head = [k for k in loaded if k.startswith("bbox_head.") and loaded[k].is_floating_point()]
    kept = all(torch.equal(after[k], loaded[k]) for k in frozen)
    moved = max(float((after[k].float() - loaded[k].float()).abs().max()) for k in head)
    print(f"  {note}; after {MIX_STEPS} steps the {len(frozen)} frozen tensors equal the loaded ones: {kept}; "
          f"the head's largest move from them {moved:.3g}")
    if not frozen or not kept or moved <= 0:
        fail("the mixpbr run did not start from the loaded weights or did not train")
    ms, wait = median_iter(iters, skip=3)
    print(f"timing: mixpbr fine-tune from files, thread workers: {batch * 1000 / ms:.1f} img/s ({ms:.1f} ms/step, "
          f"median of steps 4-{MIX_STEPS}), loader wait {wait:.1f} ms/step ({wait / ms:.1%} of the step); in memory "
          f"{batch * 1000 / memory_ms:.1f} img/s; {len(iters)} steps in {run_s:.1f} s; {line} "
          f"[{gpu}]")


def compare_results(got, want, what: str) -> bool:
    """Per-image detection dicts against a reference, as :func:`compare`
    holds kernel outputs: the same kept detections with equal labels and
    scores, boxes within BOX_ATOL but a BOX_TAIL share.  Returns whether
    they are equal bit for bit."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} results for {len(want)} images")
    for i, (g, w) in enumerate(zip(got, want)):
        if (len(g["boxes"]) != len(w["boxes"]) or not np.array_equal(g["labels"], w["labels"])
                or not np.array_equal(g["scores"], w["scores"])):
            fail(f"{what}: image {i}: kept detections, labels or scores differ")
    err = np.concatenate([np.abs(g["boxes"] - w["boxes"]).ravel() for g, w in zip(got, want)] + [np.zeros(0)])
    tail = float((err > BOX_ATOL).mean()) if err.size else 0.0
    bit_equal = all(np.array_equal(g[k], w[k]) for g, w in zip(got, want) for k in ("boxes", "scores", "labels"))
    print(f"  {what}: {len(got)} images, {sum(len(g['boxes']) for g in got)} detections, kept sets, labels and "
          f"scores equal, box max abs err {err.max(initial=0.0):.3g} px, share > {BOX_ATOL} px {tail:.4%}; "
          f"bit for bit equal: {bit_equal}")
    if not sum(len(g["boxes"]) for g in got):
        fail(f"{what}: no detections")
    if tail > BOX_TAIL:
        fail(f"{what}: {tail:.4%} of box coordinates off by more than {BOX_ATOL} px")
    return bit_equal


class Gate:
    """Stands in front of a detector's step: records that the dispatcher
    reached it and holds it there until opened."""

    def __init__(self, infer):
        import threading

        self.infer = infer
        self.entered = threading.Event()
        self.open = threading.Event()

    def __call__(self, *args):
        self.entered.set()
        if not self.open.wait(120):
            fail("the gate in front of the serving step was never opened")
        return self.infer(*args)


def position_diff(got, want) -> str:
    """How far per-image detections of the same images at other batch
    positions are from a reference (the bf16 forward depends on the
    position): images with equal kept sets and labels, bit-equal images,
    and the largest score difference among the former."""
    same = [len(a["boxes"]) == len(b["boxes"]) and np.array_equal(a["labels"], b["labels"])
            for a, b in zip(got, want)]
    bits = sum(all(np.array_equal(a[k], b[k]) for k in b) for a, b in zip(got, want))
    err = max((float(np.abs(a["scores"] - b["scores"]).max(initial=0.0))
               for a, b, ok in zip(got, want, same) if ok), default=0.0)
    return (f"kept sets and labels equal on {sum(same)} of {len(want)} images, bit for bit equal {bits}, "
            f"score max abs difference {err:.3g}")


def percentiles(lat_s):
    p50, p99 = np.percentile(np.asarray(lat_s) * 1e3, [50, 99])
    return f"p50 {p50:.2f} ms, p99 {p99:.2f} ms"


def serving_phase(det, gpu: str, work: str) -> None:
    """Serving on the card with ``det`` (the flagship at full width, bf16,
    cls bias 0): ``BatchingDetector`` at batch SERVE_BATCH and
    SERVE_LATENCY_MS against ``inference_detector``, vote-NMS launches per
    batch, img/s and latency at SERVE_SUBMITTERS threads beside the bare
    step from pinned memory, cancellation, and ``python -m
    radet_tpu_torch.tools.serve`` in a subprocess over HTTP."""
    import copy
    import http.client
    import socket
    import threading

    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import BatchingDetector, inference_detector
    from radet_tpu_torch.data import image_io
    from synthetic_bop import JPEG_FIXTURES, write_png

    h, w = det.input_size
    rng = np.random.RandomState(SEED + 7)
    imgs = [rng.randint(0, 256, (*SERVE_SIZES[i % len(SERVE_SIZES)], 3), np.uint8) for i in range(SERVE_BATCH)]
    pool = [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(SERVE_BATCH)]
    t0 = time.perf_counter()
    srv = BatchingDetector(det, batch_size=SERVE_BATCH, max_latency_ms=SERVE_LATENCY_MS)
    print(f"serving: BatchingDetector(batch {SERVE_BATCH}, max latency {SERVE_LATENCY_MS} ms) on the main path's "
          f"detector ({det.model.dtype}, cls bias 0): built with its warm-up batch in "
          f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    try:
        # a. 32 requests from one submitter (the 16 images twice) against
        # inference_detector on the 16 at once.  The bf16 forward on the card
        # depends on an image's position in the batch, not on the other rows
        # (PERF.md, serving): a gate holds the dispatcher on a primer request
        # while the 32 queue, so that they run as two full batches in
        # submission order, each image at its position in the reference batch
        want = inference_detector(det, imgs)
        zeros = [np.zeros((h, w, 3), np.uint8)] * SERVE_BATCH
        alone = inference_detector(det, imgs[:1] + zeros[1:])[:1]
        rev = inference_detector(det, imgs[::-1])[::-1]
        print(f"  inference_detector on the same 16 reversed: {position_diff(rev, want)}; image 0 at its "
              f"position beside zero rows: bit for bit equal "
              f"{all(np.array_equal(alone[0][k], want[0][k]) for k in want[0])}")
        held = copy.copy(det)
        gated = BatchingDetector(held, batch_size=SERVE_BATCH, max_latency_ms=SERVE_LATENCY_MS)
        gate = held._infer = Gate(det._infer)
        try:
            primer = gated.submit(pool[0])
            if not gate.entered.wait(120):
                fail("the gated server never dispatched")
            vnc.LAUNCHES = 0
            futs = [gated.submit(im) for im in imgs + imgs]
            gate.open.set()
            primer.result(timeout=120)
            got = [f.result(timeout=120) for f in futs]
            launches, batches = vnc.LAUNCHES, gated.stats()["batches"]
        finally:
            gate.open.set()
            gated.close()
        compare_results(got, want + want, f"served vs inference_detector ({len(futs)} requests at "
                                          f"{', '.join(f'{a}x{b}' for a, b in SERVE_SIZES)}, behind a primer, "
                                          f"{batches} batches)")
        if batches != 3 or launches != batches:
            fail(f"{batches} served batches (expected the primer's and 2 full ones) launched vote_nms "
                 f"{launches} times")
        # the same 16 where the 5 ms budget puts them: other batch positions
        free = [srv.submit(im) for im in imgs]
        free = [f.result(timeout=120) for f in free]
        print(f"  the 16 submitted freely at a 5 ms budget (batch positions as they came) against "
              f"inference_detector: {position_diff(free, want)}")
        portrait = np.ascontiguousarray(imgs[0].transpose(1, 0, 2))
        try:
            srv.submit(portrait)
            fail("a portrait 640x480 request was taken at a landscape input size")
        except ValueError as e:
            print(f"  a portrait {portrait.shape[0]}x{portrait.shape[1]} request raises in submit, as "
                  f"radet_tpu's inference does: {str(e)[:60]}...")

        # b. the bare step at the serving batch from pinned host memory, then
        # the sweep of submitter threads (closed loop: each waits for its answer)
        u8 = torch.from_numpy(np.stack(pool)).pin_memory()
        shp = torch.tensor([[h, w]] * SERVE_BATCH, dtype=torch.float32).pin_memory()
        scl = torch.ones((SERVE_BATCH, 4), dtype=torch.float32).pin_memory()
        for _ in range(3):
            det._infer(det.model, u8, shp, scl)
        step_ms = cuda_ms(lambda: det._infer(det.model, u8, shp, scl), 20)
        print(f"timing: serving step batch {SERVE_BATCH} (uint8 from pinned host memory, CUDA events, mean of 20): "
              f"{step_ms:.2f} ms, {SERVE_BATCH * 1000 / step_ms:.1f} img/s [{gpu}]")
        for threads in SERVE_SUBMITTERS:
            lat = []
            lock = threading.Lock()

            def submitter(i):
                mine = []
                for j in range(i, SERVE_REQUESTS, threads):
                    t = time.perf_counter()
                    srv.detect(pool[j % len(pool)], timeout=120)
                    mine.append(time.perf_counter() - t)
                with lock:
                    lat.extend(mine)

            vnc.LAUNCHES = 0
            before = srv.stats()
            workers = [threading.Thread(target=submitter, args=(i,)) for i in range(threads)]
            t0 = time.perf_counter()
            for t in workers:
                t.start()
            for t in workers:
                t.join(300)
            wall = time.perf_counter() - t0
            after = srv.stats()
            n, b = after["requests"] - before["requests"], after["batches"] - before["batches"]
            print(f"timing: serving {threads} submitter threads, {n} requests {h}x{w}: {b} batches, fill "
                  f"{n / (b * SERVE_BATCH):.3f}, {n / wall:.1f} img/s, latency submit to result "
                  f"{percentiles(lat)}; vote_nms kernel launches {vnc.LAUNCHES}; bare step {step_ms:.2f} ms "
                  f"({SERVE_BATCH * 1000 / step_ms:.1f} img/s) [{gpu}]")
            if any(t.is_alive() for t in workers) or n != SERVE_REQUESTS or len(lat) != n:
                fail(f"{threads} submitters: {n} of {SERVE_REQUESTS} requests answered")
            if vnc.LAUNCHES != b:
                fail(f"{b} served batches launched vote_nms {vnc.LAUNCHES} times")
        del u8, shp, scl

        # c. cancellation: one future cancelled after dispatch, one while queued
        held = copy.copy(det)
        gated = BatchingDetector(held, batch_size=SERVE_BATCH, max_latency_ms=0)
        gate = held._infer = Gate(det._infer)
        try:
            dispatched = gated.submit(imgs[0])
            if not gate.entered.wait(120):
                fail("the gated server never dispatched")
            queued = [gated.submit(im) for im in imgs[1:4]]
            late_cancel, queued_cancel = dispatched.cancel(), queued[0].cancel()
            gate.open.set()
            rest = [dispatched.result(timeout=120)] + [f.result(timeout=120) for f in queued[1:]]
            after = gated.detect(imgs[4], timeout=120)
        finally:
            gate.open.set()
            gated.close()
        if late_cancel or not queued_cancel or not queued[0].cancelled():
            fail(f"cancel after dispatch gave {late_cancel}, while queued {queued_cancel}")
        # each batch padded with zero rows: held to inference_detector on the
        # same rows at the same positions, zero images after them
        at_positions = (inference_detector(det, imgs[2:4] + zeros[2:])[:2]
                        + inference_detector(det, imgs[4:5] + zeros[1:])[:1])
        compare_results(rest + [after], [want[0]] + at_positions,
                        "cancellation: the dispatched (cancel refused), the queued beside the cancelled one, "
                        "and a later request, in batches padded with zero rows")
        print(f"  cancellation: cancel() after dispatch returned False, while queued True; the server answered "
              f"on and closed with {gated.stats()['requests']} requests run")
    finally:
        srv.close()
    print(f"  BatchingDetector.close() drained: {srv.stats()}")

    # d. the CLI in a subprocess, over HTTP
    ckpt = osp.join(work, "serve.pth")
    torch.save({k: v.cpu() for k, v in det.model.state_dict().items()}, ckpt)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_path = osp.join(work, "serve.log")
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.serve", CONFIG, ckpt, "--batch", str(SERVE_BATCH),
           "--max-latency-ms", str(SERVE_LATENCY_MS), "--port", str(port)]
    bodies = []
    for name in sorted(n for n in os.listdir(JPEG_FIXTURES) if n.endswith(".jpg")):
        with open(osp.join(JPEG_FIXTURES, name), "rb") as f:
            bodies.append((name, f.read()))
    write_png(osp.join(work, "serve.png"), imgs[1])
    with open(osp.join(work, "serve.png"), "rb") as f:
        bodies.append((f"{imgs[1].shape[0]}x{imgs[1].shape[1]} PNG", f.read()))

    def request(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.putrequest(method, path, skip_accept_encoding=True)
            for k, v in (headers or ({"Content-Length": str(len(body))} if body is not None else {})).items():
                conn.putheader(k, v)
            conn.endheaders(body)
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
    try:
        while True:
            if proc.poll() is not None:
                with open(log_path) as f:
                    fail(f"the serve CLI exited {proc.returncode} before it answered /healthz:\n{f.read()[-3000:]}")
            try:
                if request("GET", "/healthz") == (200, {"ok": True}):
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                fail("the serve CLI did not answer /healthz within 300 s")
            time.sleep(0.5)
        print(f"serving: python -m radet_tpu_torch.tools.serve {CONFIG} serve.pth --batch {SERVE_BATCH} "
              f"--max-latency-ms {SERVE_LATENCY_MS:g}: /healthz answered {time.perf_counter() - t0:.1f} s after "
              f"start (start-up, model build, load and warm-up included)")
        local = BatchingDetector(det, batch_size=SERVE_BATCH, max_latency_ms=SERVE_LATENCY_MS)
        try:
            for name, body in bodies:
                status, out = request("POST", "/detect", body)
                if status != 200 or out.get("classes") != list(det.classes):
                    fail(f"POST /detect of {name}: {status} {str(out)[:300]}")
                got = dict(boxes=np.asarray(out["boxes"], np.float32).reshape(-1, 4),
                           scores=np.asarray(out["scores"], np.float32), labels=np.asarray(out["labels"]))
                compare_results([got], [local.detect(image_io.imdecode(body), timeout=120)],
                                f"CLI answer to {name} vs the in-process batcher")
        finally:
            local.close()
        _, stats = request("GET", "/stats")
        garbage, _ = request("POST", "/detect", b"not an image")
        bad_length, _ = request("POST", "/detect", b"", {"Content-Length": "twelve"})
        print(f"  /stats {stats}; a garbage body gets {garbage}, a malformed Content-Length {bad_length}")
        if stats.get("requests") != len(bodies) or garbage != 400 or bad_length != 400:
            fail("the CLI's stats or status codes are wrong")
        jpegs = [b for n, b in bodies if n.endswith(".jpg")]
        lat, lock = [], threading.Lock()

        def client(i):
            mine = []
            for j in range(i, SERVE_REQUESTS, SERVE_CLIENTS):
                t = time.perf_counter()
                status, _ = request("POST", "/detect", jpegs[j % len(jpegs)])
                if status == 200:
                    mine.append(time.perf_counter() - t)
            with lock:
                lat.extend(mine)

        clients = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        before = request("GET", "/stats")[1]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(300)
        wall = time.perf_counter() - t0
        after = request("GET", "/stats")[1]
        n, b = after["requests"] - before["requests"], after["batches"] - before["batches"]
        print(f"timing: serve CLI, {SERVE_CLIENTS} HTTP client threads, {SERVE_REQUESTS} POSTs of the 480x640 JPEG "
              f"fixtures: {len(lat) / wall:.1f} req/s, latency {percentiles(lat)}; {b} batches, fill "
              f"{n / (b * SERVE_BATCH):.3f} [{gpu}]")
        if len(lat) != SERVE_REQUESTS:
            fail(f"{len(lat)} of {SERVE_REQUESTS} POSTs answered 200")
        proc.terminate()
        code = proc.wait(120)
        print(f"  SIGTERM: the server drained and exited {code}")
        if code != 0:
            with open(log_path) as f:
                fail(f"the serve CLI exited {code} on SIGTERM:\n{f.read()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)


def kernel_by_k() -> None:
    """The kernel against the plain version in float64 on the CPU at
    ``KERNEL_SHAPES``, both modes, with the kernel's and the plain version's
    times on the card (in turns), each beside the call's bound, and the
    call's device time split by CUDA kernel."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    gpu = card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 4)
    print("kernel on the card vs plain in float64 on the CPU by (B, K), synthetic clustered "
          "candidates (5 labels, 60-100% valid):")
    for b, k in KERNEL_SHAPES:
        arrays = [torch.from_numpy(a).to(dev) for a in clustered_candidates(rng, b, k)]
        for global_mode in (False, True):
            kw = dict(iou_threshold=0.65, max_out=100, iou_enable=False, sigma=0.025,
                      global_mode=global_mode)
            kern = vnc.vote_nms_cuda(*arrays, **kw)
            torch.cuda.synchronize()
            compare(kern, plain_reference(arrays, **kw), f"B={b} K={k} global_mode={global_mode}")
            # no float atomics: a second call gives the same bits
            if not all(torch.equal(x, y) for x, y in zip(kern, vnc.vote_nms_cuda(*arrays, **kw))):
                fail(f"B={b} K={k} global_mode={global_mode}: two kernel calls differ")
        print(f"  B={b} K={k}: a second call gives the same outputs bit for bit, both modes")
        kw["global_mode"] = False
        kernel_ms, plain_ms, _, _ = alternate_ms(
            lambda: vnc.vote_nms_cuda(*arrays, **kw), lambda: vote_nms_plain(*arrays, **kw), 20, 1)
        bound_ms, bound_by, ops, nbytes = nms_bound(arrays, kw["max_out"])
        print(f"timing: vote_nms B={b} K={k}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms; "
              f"bound {bound_ms * 1e3:.3f} us by {bound_by} ({ops:.4g} ops, {nbytes} bytes), kernel at "
              f"{bound_ms / kernel_ms:.2%} of it [{gpu}]")
        print(f"  device time B={b} K={k}: {kernel_split(lambda: vnc.vote_nms_cuda(*arrays, **kw))}")
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

    # the test CLI, strict by default, in a process of its own as a user starts it
    out = osp.join(work, "eval")
    stdout, stderr, cli_s = tool_run(Path(__file__).resolve().parent, [
        "-m", "radet_tpu_torch.tools.test", config, ckpt, "--eval", "bbox", "--format-only", "--json-prefix", out,
        "--out", out + ".pkl", "--cfg-options", *opts], "the test CLI", fresh=True)
    cli_metrics = json.loads(stdout[stdout.index("{"):])
    with open(out + ".metrics.json", "w") as f:  # phase 12 holds eval_metric on eval.pkl to them
        json.dump(cli_metrics, f)
    cli_launches = sum(int(n) for n in re.findall(r"vote_nms kernel launches (\d+)", stderr))
    with open(out + ".bbox.json") as f:
        bbox_json = json.load(f)
    with open(out + ".bop.json") as f:
        bop_json = json.load(f)
    print(f"eval: python -m radet_tpu_torch.tools.test (strict, full width, bf16, random weights, cls "
          f"bias 0): {cli_s:.1f} s in its own process (start-up, model build and CUDA init included); "
          f"vote_nms kernel launches {cli_launches}; {len(bbox_json)} COCO results in "
          f"{osp.basename(out)}.bbox.json, {len(bop_json)} in {osp.basename(out)}.bop.json "
          f"(scenes {sorted({d['scene_id'] for d in bop_json})})")
    for ln in stderr.splitlines():
        if "inference done" in ln:
            print(f"  {ln}")
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


def nms_plain_reference(arrays, **kw):
    """``batched_nms_plain`` in float64 on the CPU, 16 images at a time,
    with boxes and scores back in float32 (copies of the inputs, so exact):
    what the no-vote kernel's outputs are held to, bit for bit."""
    from radet_tpu_torch.ops.vote_nms import batched_nms_plain

    outs = []
    for i in range(0, arrays[0].shape[0], 16):
        boxes, scores, labels, valid = (a[i:i + 16].cpu() for a in arrays)
        outs.append(batched_nms_plain(boxes.double(), scores.double(), labels, valid, **kw))
    return [t.float() if t.is_floating_point() else t for t in (torch.cat(x) for x in zip(*outs))]


def compare_exact(kern, plain, what: str) -> float:
    """No-vote kernel vs plain outputs, every slot equal bit for bit;
    returns the max abs box error (0)."""
    got = [t.cpu() for t in kern]
    for name, g, p in zip(("boxes", "labels", "scores", "valid"), got, plain):
        if not torch.equal(g, p):
            fail(f"{what}: {name} differ in {int((g != p).sum())} places")
    print(f"  {what}: kept {int(got[3].sum())}, every slot equal bit for bit")
    return float((got[0] - plain[0]).abs().max()) if got[0].numel() else 0.0


def nms_by_k(gpu: str) -> dict:
    """The no-vote kernel against ``batched_nms_plain`` in float64 at
    NMS_SHAPES (21 labels), timed in turns with the plain version on the
    card, beside the call's bound.  Returns {(B, K): (kernel ms, plain ms,
    bound ms, bound by, max abs err)}."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import batched_nms_plain

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 8)
    kw = dict(iou_threshold=0.6, max_out=100)
    out = {}
    print(f"no-vote kernel (batched_nms) on the card vs plain in float64 on the CPU by (B, K), synthetic "
          f"clustered candidates ({NMS_LABELS} labels, 60-100% valid), iou_threshold 0.6, max_out 100:")
    for b, k in NMS_SHAPES:
        boxes, scores, _, labels, valid = clustered_candidates(rng, b, k, num_labels=NMS_LABELS)
        arrays = [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels, valid)]
        kern = vnc.batched_nms_cuda(*arrays, **kw)
        torch.cuda.synchronize()
        err = compare_exact(kern, nms_plain_reference(arrays, **kw), f"B={b} K={k}")
        # profiled before the plain version's thousands of small launches
        split = kernel_split(lambda: vnc.batched_nms_cuda(*arrays, **kw))
        kernel_ms, plain_ms, _, _ = alternate_ms(
            lambda: vnc.batched_nms_cuda(*arrays, **kw), lambda: batched_nms_plain(*arrays, **kw), 20, 2)
        bound_ms, bound_by, ops, nbytes = nms_bound(arrays, kw["max_out"], vote=False)
        print(f"timing: batched_nms B={b} K={k}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by} ({ops:.4g} ops, {nbytes} bytes), kernel at "
              f"{bound_ms / kernel_ms:.2%} of it [{gpu}]")
        print(f"  device time B={b} K={k}: {split}")
        out[(b, k)] = (kernel_ms, plain_ms, bound_ms, bound_by, err)
        del arrays, kern
    torch.cuda.empty_cache()
    return out


def anchor_inference_phase(gpu: str, repo: Path, test_opts) -> tuple:
    """Both anchor-head configs at full width: ``init_detector`` (seeded
    random weights, bf16; ATSS's cls bias at 0 so that scores clear
    score_thr), ``inference_detector`` on 8 random 480x640 images with the
    launches counted, the NMS inputs of that run through the plain version
    in float64, and the float32 forward against the CPU's; the ATSS step's
    time at batch 8 and 128, and ATSS's strict eval of the PNG set
    (``test_opts``) through the kernel and through the plain version.
    Returns the ATSS run's (launches, max abs err)."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.models.detector import preprocess_images

    dev = torch.device("cuda")
    img_rng = np.random.RandomState(SEED + 9)
    main = None
    for config in ANCHOR_CONFIGS:
        name = osp.basename(config)
        det = init_detector(str(repo / config), device="cuda", seed=SEED)
        model = det.model
        head = type(model.bbox_head).__name__
        print(f"anchor family: init_detector({config!r}, device='cuda', seed={SEED}): {head}, "
              f"{sum(p.numel() for p in model.parameters())} parameters, {det.anchors.shape[0]} anchors, "
              f"compute dtype {model.dtype}, input {det.input_size}")
        if model.dtype != torch.bfloat16:
            fail(f"{name}: compute dtype is {model.dtype}, the config asks for bfloat16")
        if head == "ATSSHead":
            with torch.no_grad():
                model.bbox_head.atss_cls.bias.zero_()
            print("  bbox_head.atss_cls.bias set to 0 so that scores clear score_thr")
        h, w = det.input_size
        imgs = [img_rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(8)]
        calls = []
        kernel_nms = postprocess.batched_nms

        def recording(*args, **kw):
            out = kernel_nms(*args, **kw)
            calls.append(([a.clone() for a in args], kw, [t.clone() for t in out]))
            return out

        postprocess.batched_nms = recording
        try:
            vnc.LAUNCHES = vnc.NMS_LAUNCHES = 0
            results = inference_detector(det, imgs)
            torch.cuda.synchronize()
            launches, vote_launches = vnc.NMS_LAUNCHES, vnc.LAUNCHES
        finally:
            postprocess.batched_nms = kernel_nms
        print(f"  inference_detector on 8 images {h}x{w}: batched_nms kernel launches {launches} (vote_nms "
              f"{vote_launches}), detections per image {[len(r['boxes']) for r in results]}")
        if launches != 1 or vote_launches != 0 or len(calls) != 1:
            fail(f"{name}: the main path launched the no-vote kernel {launches} times (vote mode "
                 f"{vote_launches}) for one batch")
        for r in results:
            if not len(r["boxes"]) or r["boxes"].shape[1:] != (4,):
                fail(f"{name}: an image has no detections, or misshapen ones")
            if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
                fail(f"{name}: non-finite detections")
            if (r["labels"] < 0).any() or (r["labels"] >= 21).any():
                fail(f"{name}: labels outside the 21 classes")
        args, kw, kern = calls[0]
        print(f"  NMS input: K={args[0].shape[1]}, valid candidates per image {args[3].sum(1).tolist()}")
        err = compare_exact(kern, nms_plain_reference(args, **kw),
                            "main-path candidates, no-vote kernel on the card vs plain in float64 on the CPU")
        if head == "ATSSHead":
            main = (launches, err)

        # float32 forward on the card vs the CPU forward, 1 image
        x = torch.from_numpy(imgs[0][None]).to(dev)
        norm = det.cfg.img_norm_cfg
        with torch.inference_mode():
            x = preprocess_images(x, norm.mean, norm.std, torch.float32)
            model.dtype = torch.float32
            gpu_maps = [m.cpu() for maps in model(x) for m in maps]
            model.dtype = torch.bfloat16
            cpu_model = init_detector(str(repo / config), device="cpu", seed=SEED).model
            cpu_model.load_state_dict(model.state_dict())
            cpu_maps = [m for maps in cpu_model(x.cpu()) for m in maps]
        rel = max(float((g - c).abs().max() / c.abs().max().clamp(min=1e-6)) for g, c in zip(gpu_maps, cpu_maps))
        print(f"  float32 head maps ({len(gpu_maps)}), card vs CPU: max error relative to each map's max "
              f"{rel:.3g} (limit {MAP_RTOL})")
        if rel > MAP_RTOL:
            fail(f"{name}: the card's float32 forward disagrees with the CPU forward")
        del cpu_model

        if head == "ATSSHead":
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
                print(f"timing: ATSS inference batch {batch} (uint8 on the card): {ms:.2f} ms/batch, "
                      f"{batch * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB [{gpu}]")
                del u8
            anchor_strict_eval(str(repo / config), test_opts, model, gpu)
        del det, model, calls
        torch.cuda.empty_cache()
    return main


def anchor_strict_eval(config: str, test_opts, model, gpu: str) -> None:
    """Strict ``test_from_config`` (nms_topk 2048) of ``model`` on the PNG
    set, files to metrics, through the no-vote kernel and then through the
    plain version on the card: the same labels on every image, boxes equal,
    metrics within METRIC_ATOL."""
    import radet_tpu_torch.apis.test as port_test
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import batched_nms_plain
    from radet_tpu_torch.utils import Config

    cfg = Config.fromfile(config, test_opts)
    ks = set()
    kernel_nms = postprocess.batched_nms

    def recording(nms):
        def run(*args, **kw):
            ks.add(int(args[0].shape[1]))
            return nms(*args, **kw)
        return run

    postprocess.batched_nms = recording(kernel_nms)
    try:
        vnc.NMS_LAUNCHES = 0
        t0 = time.perf_counter()
        dataset, results, metrics = port_test.test_from_config(cfg, model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches, kernel_ks = vnc.NMS_LAUNCHES, sorted(ks)
        postprocess.batched_nms = recording(batched_nms_plain)
        t0 = time.perf_counter()
        _, plain_results, plain_metrics = port_test.test_from_config(cfg, model)
        plain_s = time.perf_counter() - t0
    finally:
        postprocess.batched_nms = kernel_nms
    n = len(results)
    same = all(np.array_equal(a["labels"], b["labels"]) and np.array_equal(a["boxes"], b["boxes"])
               for a, b in zip(results, plain_results))
    diff = max(abs(metrics[k] - plain_metrics[k]) for k in metrics)
    print(f"eval: ATSS test_from_config strict, full width, bf16, {n} PNG images, files -> metrics: {eval_s:.2f} s, "
          f"{n / eval_s:.1f} img/s; batched_nms kernel launches {launches} at K {kernel_ks}; through the plain "
          f"version {plain_s:.2f} s, {n / plain_s:.1f} img/s; detections {sum(len(r['boxes']) for r in results)}, "
          f"equal bit for bit: {same}, max |metric difference| {diff:.3g} [{gpu}]")
    print("  metrics (kernel): " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    if launches < 1 or 2048 not in kernel_ks or not same or diff > METRIC_ATOL:
        fail(f"the ATSS strict eval: launches {launches} at K {kernel_ks}, kernel and plain equal: {same}, "
             f"metrics off by {diff:.3g}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail("the ATSS strict eval's metrics are not finite")


def anchor_step_timing(cfg, dataset, gpu: str) -> None:
    """The anchor head's train step at batch 16 (bf16, the config's AdamW and
    clip, the batch on the card) and its assignment alone, by CUDA events."""
    from radet_tpu_torch.apis.common import anchor_head_spec, build_model_and_anchors
    from radet_tpu_torch.data import collate
    from radet_tpu_torch.engine import build_optimizer
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device, build_train_step_anchor

    model, anchors, _, counts = build_model_and_anchors(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to("cuda").train()
    tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
    state = TrainState(model, tx)
    step = build_train_step_anchor(model, anchors, counts, img_norm=cfg.img_norm_cfg.to_dict(),
                                   num_classes=int(cfg.model.bbox_head.num_classes), spec=anchor_head_spec(cfg))
    batch_size = int(cfg.data.samples_per_gpu)
    batch = batch_to_device(collate([dataset[i] for i in range(batch_size)]), "cuda", step.batch_keys)
    for _ in range(3):
        step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assign_ms = cuda_ms(lambda: step.assign(batch), 10)
    n_pos = int((step.assign(batch) > 0).sum())
    print(f"timing: {step.head_type} train step batch {batch_size} {str(model.dtype)[6:]} (batch on the card): "
          f"{ms:.2f} ms/step, {batch_size * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB; its assignment "
          f"({'ATSS' if step.head_type == 'ATSSHead' else 'MaxIoU'}, {anchors.shape[0]} anchors x "
          f"{batch['gt_boxes'].shape[1]} GT slots, {n_pos} positives) alone {assign_ms:.3f} ms, "
          f"{assign_ms / ms:.1%} of the step [{gpu}]")
    del state, model, tx, step, batch
    torch.cuda.empty_cache()


def anchor_parity(cfg, dataset, gpu: str) -> None:
    """One float32 train step of the anchor head at batch 1, card vs CPU:
    same weights and batch, the same side of every ReLU (the CPU replays
    the card's decisions); and the CPU with its own decisions beside it."""
    from radet_tpu_torch.apis.common import anchor_head_spec, build_model_and_anchors
    from radet_tpu_torch.data import collate
    from radet_tpu_torch.engine import build_optimizer
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device, build_train_step_anchor

    one = collate([dataset[0]])
    spec = anchor_head_spec(cfg)

    def run(device):
        model, anchors, _, counts = build_model_and_anchors(cfg, dtype="float32")
        model.init_weights(torch.Generator().manual_seed(SEED))
        model.to(device).train()
        step = build_train_step_anchor(model, anchors, counts, img_norm=cfg.img_norm_cfg.to_dict(),
                                       num_classes=int(cfg.model.bbox_head.num_classes), spec=spec)
        batch = batch_to_device(one, device, step.batch_keys)
        sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, model)
        metrics = step(TrainState(model, sgd0), batch)
        return (step.assign(batch).cpu(), {k: float(v) for k, v in metrics.items()},
                {k: p.grad.cpu() for k, p in model.named_parameters() if p.requires_grad})

    masks = []
    with relu_decisions(masks, replay=False):
        ag, mg, gg = run(torch.device("cuda"))
    with relu_decisions(masks, replay=True) as flips:
        ac, mc, gc = run(torch.device("cpu"))
    raw = grad_errors(run(torch.device("cpu"))[2], gg)
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    errs = grad_errors(gg, gc)
    flip_max = max((r for _, r in flips), default=0.0)
    print(f"anchor train parity, {spec['head_type']} float32 batch 1, card vs CPU (TF32 off, same ReLU sides): "
          f"assignment equal: {torch.equal(ag, ac)} ({int((ac > 0).sum())} positives); losses max rel err "
          f"{loss_err:.3g} (loss {mg['loss']:.6f} vs {mc['loss']:.6f}); gradients max err {errs[0][0]:.3g} of the "
          f"tensor's max abs ({errs[0][1]}) [{gpu}]")
    print(f"  ReLU inputs on opposite sides of 0: {sum(c for c, _ in flips)} of {sum(m.numel() for m in masks)} "
          f"in {len(masks)} calls, at most {flip_max:.3g} of their tensor's max |x|; with each side's own ReLU "
          f"decisions the gradients differ by up to {raw[0][0]:.3g} ({raw[0][1]})")
    if not torch.equal(ag, ac):
        fail(f"the anchor assignment differs between card and CPU in {int((ag != ac).sum())} anchors")
    if flip_max > FLIP_RTOL:
        fail(f"a ReLU input differs in sign by more than rounding ({flip_max:.3g} > {FLIP_RTOL})")
    if loss_err > LOSS_RTOL or errs[0][0] > GRAD_RTOL:
        fail(f"card vs CPU anchor train step beyond tolerance (losses {LOSS_RTOL}, gradients {GRAD_RTOL})")
    torch.cuda.empty_cache()


def anchor_train_phase(files: str, gpu: str, eval_opts, test_opts, repo: Path) -> None:
    """Both anchor-head configs through ``python -m radet_tpu_torch.tools.train``
    on the JPEG ``train_pbr`` split of ``files`` through each config's own
    train_pipeline (full width, bf16, batch 16, ANCHOR_STEPS steps, one eval
    on the PNG set's landscape images): finite losses, the checkpoint, the
    frozen stem and first stage kept and the head moved from the seeded
    init, the eval's no-vote kernel launches; ``python -m
    radet_tpu_torch.tools.test --eval bbox`` on that checkpoint and the PNG
    set (``test_opts``); then each train step's time and its assignment's
    share, and ATSS's float32 step against the CPU."""
    from radet_tpu_torch.apis.common import build_dataset, build_model_and_anchors
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.utils import Config
    from synthetic_bop import write_train_config

    ann, prefix = osp.join(files, "train_pbr.json"), osp.join(files, "train_pbr") + "/"
    for config in ANCHOR_CONFIGS:
        name = osp.splitext(osp.basename(config))[0]
        steps = ANCHOR_STEPS[name]
        train_config = write_train_config(osp.join(files, f"{name}.py"), str(repo / config), ann, prefix,
                                          osp.join(files, "backgrounds"))
        cfg = Config.fromfile(train_config)
        print(f"train anchor family: python -m radet_tpu_torch.tools.train {config} from train_pbr (its own "
              f"train_pipeline, full width, bf16, batch {cfg.data.samples_per_gpu}, {FILES_WORKERS} loader "
              f"thread workers, {steps} steps, one eval):")
        work_dir = osp.join(files, f"work_dir_{name}")
        iters, dataset_line, launches, run_s, _ = train_cli(train_config, work_dir, steps, "thread", eval_opts,
                                                            nms="batched_nms")
        keys = ("loss_cls", "loss_bbox", "loss_centerness") if "atss" in name else ("loss_cls", "loss_bbox")
        if any(f"{k} " not in ln for ln in iters for k in keys + ("num_pos",)):
            fail(f"{name}: the trainer's log misses one of {keys}")
        model = build_model_and_anchors(cfg)[0]
        model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        init, after = model.state_dict(), load_weights(osp.join(work_dir, "checkpoints"))
        frozen = [k for k in init if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
        head = [k for k in init if k.startswith("bbox_head.")]
        kept = all(torch.equal(after[k], init[k]) for k in frozen)
        moved = max(float((after[k] - init[k]).abs().max()) for k in head)
        ms, wait = median_iter(iters, skip=3)
        print(f"  {len(frozen)} frozen tensors equal the seeded init: {kept}; the head's largest move "
              f"{moved:.3g}; {steps} steps in {run_s:.1f} s (model build and eval "
              f"included), {cfg.data.samples_per_gpu * 1000 / ms:.1f} img/s ({ms:.1f} ms/step, median of steps "
              f"4-{steps}), loader wait {wait:.1f} ms/step; {dataset_line} [{gpu}]")
        if not frozen or not kept or moved <= 0:
            fail(f"{name}: the frozen stages moved or the head did not train")
        stdout, stderr, test_s = tool_run(repo, [
            "-m", "radet_tpu_torch.tools.test", train_config, osp.join(work_dir, "checkpoints"), "--device", "cuda",
            "--eval", "bbox", "--cfg-options", *test_opts], f"the test CLI on {name}'s checkpoint")
        metrics = json.loads(stdout[stdout.index("{"):])
        launches = sum(int(n) for n in re.findall(r"batched_nms kernel launches (\d+)", stderr))
        print(f"  python -m radet_tpu_torch.tools.test (strict) on the checkpoint, {test_s:.1f} s: bbox_mAP "
              f"{metrics['bbox_mAP']:.4f}, bbox_mAP_50 {metrics['bbox_mAP_50']:.4f}; batched_nms kernel launches "
              f"{launches}")
        if launches < 1 or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{name}: the test CLI launched no no-vote kernel or gave non-finite metrics")
        dataset = build_dataset(cfg, "train")
        anchor_step_timing(cfg, dataset, gpu)
        if "atss" in name:
            anchor_parity(cfg, dataset, gpu)


def step_ms(cfg, dataset, name: str, gpu: str):
    """The config's train step at batch ``samples_per_gpu`` (its compute
    dtype, AdamW and clip, the batch on the card) by CUDA events; prints
    and returns (ms per step, peak GiB)."""
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.data import collate
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device

    dev = torch.device("cuda")
    model, anchors, ranges, _ = build_model_and_anchors(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
    state = TrainState(model, tx, seed=SEED)
    step = build_train_step(model, anchors, ranges, **step_args(cfg))
    batch_size = int(cfg.data.samples_per_gpu)
    batch = batch_to_device(collate([dataset[i] for i in range(batch_size)]), dev)
    for _ in range(3):
        metrics = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = float(metrics["loss"])
    print(f"timing: {name} train step batch {batch_size} {str(model.dtype)[6:]} (batch on the card): {ms:.2f} "
          f"ms/step, {batch_size * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB; loss {loss:.4f} [{gpu}]")
    if not math.isfinite(loss):
        fail(f"{name}: non-finite loss in the train step")
    del state, model, tx, step, batch
    torch.cuda.empty_cache()
    return ms, peak


def step_args(cfg) -> dict:
    from radet_tpu_torch.apis.common import assignment_cfg_from, loss_cfg_from, normalizer_from_cfg

    return dict(img_norm=cfg.img_norm_cfg.to_dict(), num_classes=int(cfg.model.bbox_head.num_classes),
                assignment_cfg=assignment_cfg_from(cfg), normalizer=normalizer_from_cfg(cfg),
                loss_cfg=loss_cfg_from(cfg))


def running_stats(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if "running_" in k}


def step_parity(cfg, dataset, name: str, gpu: str, flip_rtol: float = FLIP_RTOL,
                scalar_rtol: float = GRAD_RTOL, grad_rtol: float = GRAD_RTOL, loss_rtol: float = LOSS_RTOL) -> None:
    """One float32 step at batch 1 on the card against the CPU, with the same
    weights, batch, assignment noise, side of every ReLU (a ReLU input
    the two put on opposite sides may be at most ``flip_rtol`` of its
    tensor's max |x|) and, for a QAT model, level of every fake-quantized
    element: assignment, losses (``loss_rtol``), gradients (``grad_rtol``,
    a one-element tensor's ``scalar_rtol``) and every BatchNorm running
    statistic after the step."""
    from radet_tpu_torch.apis.common import anchors_from_cfg, build_model_and_anchors
    from radet_tpu_torch.data import collate

    dev = torch.device("cuda")

    def init_model():
        model = build_model_and_anchors(cfg, dtype="float32")[0]
        model.init_weights(torch.Generator().manual_seed(SEED))
        return model

    anchors, ranges, _ = anchors_from_cfg(cfg)
    one = collate([dataset[0]])
    gpu_model, cpu_model = init_model().to(dev), init_model()
    masks, levels = [], []
    with relu_decisions(masks, replay=False), level_decisions(levels, replay=False):
        out = parity_steps(cfg, one, anchors, ranges, step_args(cfg), (("card", gpu_model, dev),))
    with relu_decisions(masks, replay=True) as flips, level_decisions(levels, replay=True) as level_flips:
        out.update(parity_steps(cfg, one, anchors, ranges, step_args(cfg),
                                (("cpu", cpu_model, torch.device("cpu")),)))
    (ac, mc, gc), (ag, mg, gg) = out["cpu"], out["card"]
    same = torch.equal(ag.gt_idx.cpu(), ac.gt_idx)
    w_err = float((ag.weight.cpu() - ac.weight).abs().max())
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    errs = grad_errors({k: v for k, v in gg.items() if v.numel() > 1}, {k: v for k, v in gc.items() if v.numel() > 1})
    scalar_errs = grad_errors({k: v for k, v in gg.items() if v.numel() == 1},
                              {k: v for k, v in gc.items() if v.numel() == 1}) or [(0.0, "none")]
    stat_errs = grad_errors(running_stats(gpu_model), running_stats(cpu_model))
    flip_max = max((r for _, r in flips), default=0.0)
    print(f"  {name} train parity, float32 batch 1, card vs CPU (TF32 off, same noise, ReLU sides"
          f"{' and levels' if levels else ''}): assignment "
          f"gt_idx equal: {same} ({int((ac.gt_idx >= 0).sum())} positives), weight max abs err {w_err:.3g}; losses "
          f"max rel err {loss_err:.3g} (loss {mg['loss']:.6f} vs {mc['loss']:.6f}); gradients max err "
          f"{errs[0][0]:.3g} of the tensor's max abs ({errs[0][1]}), of one-element tensors {scalar_errs[0][0]:.3g} "
          f"({scalar_errs[0][1]}); running statistics max err "
          f"{stat_errs[0][0]:.3g} ({stat_errs[0][1]}, {len(stat_errs)} tensors); ReLU inputs on opposite sides "
          f"of 0: {sum(c for c, _ in flips)} of {sum(m.numel() for m in masks)} in {len(masks)} calls, at most "
          f"{flip_max:.3g} of their tensor's max |x|" + (
              f"; fake-quantized elements the CPU would have put on another level: {sum(level_flips)} of "
              f"{sum(v.numel() for v in levels)} in {len(levels)} calls" if levels else "") + f" [{gpu}]")
    if not same:
        fail(f"{name}: the assignment differs between card and CPU")
    if flip_max > flip_rtol:
        fail(f"{name}: a ReLU input differs in sign by more than rounding ({flip_max:.3g} > {flip_rtol})")
    if len(level_flips) != len(levels):
        fail(f"{name}: {len(levels)} fake quantizations on the card, {len(level_flips)} on the CPU")
    if (w_err > WEIGHT_ATOL or loss_err > loss_rtol or errs[0][0] > grad_rtol or scalar_errs[0][0] > scalar_rtol
            or stat_errs[0][0] > STAT_RTOL):
        fail(f"{name}: card vs CPU train step beyond tolerance (weights {WEIGHT_ATOL}, losses {loss_rtol}, "
             f"gradients {grad_rtol}, one-element gradients {scalar_rtol}, running statistics {STAT_RTOL})")
    del gpu_model, cpu_model, out, masks, levels
    torch.cuda.empty_cache()


def zoo_step_checks(cfg, dataset, name: str, gpu: str) -> None:
    """The zoo config's train step at batch 16 timed with its peak memory
    (:func:`step_ms`), and the float32 step on the card against the CPU
    (:func:`step_parity`)."""
    step_ms(cfg, dataset, name, gpu)
    step_parity(cfg, dataset, name, gpu)


def zoo_phase(gpu: str, repo: Path) -> dict:
    """Each of ZOO_CONFIGS at full width: ``init_detector`` (seeded random
    weights, bf16, cls bias 0) with its parameter count and FPN input
    widths; ``inference_detector`` on 8 random 480x640 images with the
    vote-NMS launches counted; that run's NMS inputs through the kernel and
    the plain version in float64, the float32 forward against the CPU's;
    inference at batch 8 and 128 and the train step at batch 16 timed, and
    the float32 step against the CPU (:func:`zoo_step_checks`).  Returns
    {config name: vote_nms launches of its ``inference_detector`` run}."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.apis.common import assignment_cfg_from
    from radet_tpu_torch.data import InMemoryBOPDataset, train_transforms
    from synthetic_bop import synthetic_bop_records

    dev = torch.device("cuda")
    img_rng = np.random.RandomState(SEED + 10)
    dataset = None
    launches_by = {}
    for config in ZOO_CONFIGS:
        name = osp.splitext(osp.basename(config))[0]
        det = init_detector(str(repo / config), device="cuda", seed=SEED)
        model, cfg = det.model, det.cfg
        widths = list(model.backbone.out_channels)
        lateral = [c.conv.weight.shape[1] for c in model.neck.lateral_convs]
        print(f"zoo: init_detector({config!r}, device='cuda', seed={SEED}): {type(model.backbone).__name__} "
              f"({cfg.model.backbone.type}), {sum(p.numel() for p in model.parameters())} parameters, FPN input "
              f"widths {widths} (its laterals read {lateral}), compute dtype {model.dtype}, input {det.input_size}")
        if widths != ZOO_WIDTHS.get(name, [256, 512, 1024, 2048]) or lateral != widths[1:]:
            fail(f"{name}: the FPN takes {lateral} of a trunk giving {widths}")
        if model.dtype != torch.bfloat16:
            fail(f"{name}: compute dtype is {model.dtype}, the config asks for bfloat16")
        with torch.no_grad():
            model.bbox_head.atss_cls.bias.zero_()
        h, w = det.input_size
        imgs = [img_rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(8)]
        vnc.LAUNCHES = 0
        results = inference_detector(det, imgs)
        torch.cuda.synchronize()
        launches = launches_by[name] = vnc.LAUNCHES
        print(f"  inference_detector on 8 images {h}x{w}: vote_nms kernel launches {launches}, "
              f"detections per image {[len(r['boxes']) for r in results]}")
        if launches < 1:
            fail(f"{name}: the main path did not launch the vote_nms kernel")
        for r in results:
            if not len(r["boxes"]) or r["boxes"].shape[1:] != (4,):
                fail(f"{name}: an image has no detections, or misshapen ones")
            if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
                fail(f"{name}: non-finite detections")
            if (r["labels"] < 0).any() or (r["labels"] >= 21).any():
                fail(f"{name}: labels outside the 21 classes")
        forward_checks(det, str(repo / config), torch.from_numpy(np.stack(imgs)).to(dev), f"{name}: ")

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
            print(f"timing: {name} inference batch {batch} (uint8 on the card): {ms:.2f} ms/batch, "
                  f"{batch * 1000.0 / ms:.1f} img/s, peak memory {peak:.2f} GiB [{gpu}]")
            del u8
        del det, model, results
        torch.cuda.empty_cache()

        if dataset is None:
            max_gt = int(assignment_cfg_from(cfg).get("max_gt", 32))
            records = synthetic_bop_records(np.random.RandomState(SEED + 2), int(cfg.data.samples_per_gpu), (h, w))
            dataset = InMemoryBOPDataset(records, train_transforms((h, w), max_gt=max_gt, seed=SEED),
                                         max_gt=max_gt, classes=cfg.CLASS_NAMES)
        zoo_step_checks(cfg, dataset, name, gpu)
    return launches_by


def zoo_cli_phase(files: str, gpu: str, eval_opts, test_opts, repo: Path) -> None:
    """ZOO_CLI_CONFIG through ``python -m radet_tpu_torch.tools.train`` on the
    JPEG ``train_pbr`` split of ``files`` through its own train_pipeline
    (full width, bf16, batch 16, ZOO_STEPS steps, one eval on the PNG
    set's landscape images): finite losses, the checkpoint, the frozen stem
    and first stage kept and the head moved, the eval's vote-NMS launches;
    ``python -m radet_tpu_torch.tools.test`` (strict, K = 2048) on the
    checkpoint and the PNG set (``test_opts``); ``init_detector`` on the
    work dir and ``inference_detector`` with its weights."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.utils import Config
    from synthetic_bop import write_train_config

    name = osp.splitext(osp.basename(ZOO_CLI_CONFIG))[0]
    train_config = write_train_config(osp.join(files, f"{name}.py"), str(repo / ZOO_CLI_CONFIG),
                                      osp.join(files, "train_pbr.json"), osp.join(files, "train_pbr") + "/",
                                      osp.join(files, "backgrounds"))
    cfg = Config.fromfile(train_config)
    print(f"train zoo: python -m radet_tpu_torch.tools.train {ZOO_CLI_CONFIG} from train_pbr (its own "
          f"train_pipeline, full width, bf16, batch {cfg.data.samples_per_gpu}, {FILES_WORKERS} loader thread "
          f"workers, {ZOO_STEPS} steps, one eval):")
    work_dir = osp.join(files, f"work_dir_{name}")
    iters, dataset_line, _, run_s, _ = train_cli(train_config, work_dir, ZOO_STEPS, "thread", eval_opts)
    model = build_model_and_anchors(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    init, after = model.state_dict(), load_weights(osp.join(work_dir, "checkpoints"))
    frozen = [k for k in init if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
    kept = all(torch.equal(after[k], init[k]) for k in frozen)
    moved = max(float((after[k] - init[k]).abs().max()) for k in init if k.startswith("bbox_head."))
    ms, wait = median_iter(iters, skip=3)
    print(f"  {len(frozen)} frozen tensors equal the seeded init: {kept}; the head's largest move {moved:.3g}; "
          f"{ZOO_STEPS} steps in {run_s:.1f} s (model build and eval included), "
          f"{cfg.data.samples_per_gpu * 1000 / ms:.1f} img/s ({ms:.1f} ms/step, median of steps 4-{ZOO_STEPS}), "
          f"loader wait {wait:.1f} ms/step; {dataset_line} [{gpu}]")
    if not frozen or not kept or moved <= 0:
        fail(f"{name}: the frozen stages moved or the head did not train")

    stdout, stderr, test_s = tool_run(repo, [
        "-m", "radet_tpu_torch.tools.test", train_config, osp.join(work_dir, "checkpoints"), "--device", "cuda",
        "--eval", "bbox", "--cfg-options", *test_opts], f"the test CLI on {name}'s checkpoint")
    metrics = json.loads(stdout[stdout.index("{"):])
    launches = sum(int(n) for n in re.findall(r"vote_nms kernel launches (\d+)", stderr))
    print(f"  python -m radet_tpu_torch.tools.test (strict: vote-NMS at K = 2048) on the checkpoint, "
          f"{test_s:.1f} s: bbox_mAP {metrics['bbox_mAP']:.4f}, bbox_mAP_50 {metrics['bbox_mAP_50']:.4f}; "
          f"vote_nms kernel launches {launches}")
    if launches < 1 or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{name}: the test CLI launched no vote_nms kernel or gave non-finite metrics")

    det = init_detector(train_config, work_dir, device="cuda")
    loaded = det.model.state_dict()
    same = all(torch.equal(loaded[k].cpu(), after[k]) for k in after)
    imgs = [np.random.RandomState(SEED + 11).randint(0, 256, (*det.input_size, 3), dtype=np.uint8)
            for _ in range(8)]
    vnc.LAUNCHES = 0
    results = inference_detector(det, imgs)
    torch.cuda.synchronize()
    print(f"  init_detector on the work dir: {type(det.model.backbone).__name__}, every tensor the checkpoint's: "
          f"{same}; inference_detector on 8 images: vote_nms kernel launches {vnc.LAUNCHES}, detections per image "
          f"{[len(r['boxes']) for r in results]}")
    if not same or vnc.LAUNCHES < 1 or not all(np.isfinite(r["boxes"]).all() for r in results):
        fail(f"{name}: init_detector on the trained work dir did not load or infer")
    del det
    torch.cuda.empty_cache()


def live_bn_phase(config: str, gpu: str) -> None:
    """Phase 11a-b: the flagship with ``norm_eval=False`` at each of
    LIVE_FROZEN, full width, 480x640.  The bf16 train step at batch 16 with
    its peak memory, with and without ``with_cp``, beside the
    ``norm_eval=True`` step of the same call; the float32 step at batch 1
    on the card against the CPU with shared ReLU sides (losses, gradients,
    every running mean and variance); and ``with_cp`` against the plain
    float32 step at batch 2 on the card (cuDNN deterministic): gradients
    and running statistics within CP_RTOL, the statistics moved once."""
    from radet_tpu_torch.apis.common import anchors_from_cfg, assignment_cfg_from, build_model_and_anchors
    from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
    from radet_tpu_torch.utils import Config
    from synthetic_bop import synthetic_bop_records

    dev = torch.device("cuda")
    base = Config.fromfile(config)
    h, w = base.input_size
    max_gt = int(assignment_cfg_from(base).get("max_gt", 32))
    records = synthetic_bop_records(np.random.RandomState(SEED + 2), int(base.data.samples_per_gpu), (h, w))
    dataset = InMemoryBOPDataset(records, train_transforms((h, w), max_gt=max_gt, seed=SEED), max_gt=max_gt,
                                 classes=base.CLASS_NAMES)
    print(f"live BN: {CONFIG} with model.backbone.norm_eval=False (batch statistics in training, running "
          f"statistics updated by 0.1 of the batch's) at frozen_stages {LIVE_FROZEN} (the config's: "
          f"{base.model.backbone.frozen_stages}), full width, {h}x{w}")
    times = {"norm_eval=True": step_ms(base, dataset, "flagship norm_eval=True", gpu)}
    for frozen in LIVE_FROZEN:
        live = [f"model.backbone.frozen_stages={frozen}", "model.backbone.norm_eval=False"]
        for cp in (False, True):
            name = f"norm_eval=False frozen_stages={frozen}" + (" with_cp" if cp else "")
            cfg = Config.fromfile(config, live + [f"model.backbone.with_cp={cp}"])
            times[name] = step_ms(cfg, dataset, f"flagship {name}", gpu)
        step_parity(Config.fromfile(config, live), dataset, f"flagship norm_eval=False frozen_stages={frozen}", gpu,
                    LIVE_FLIP_RTOL, LIVE_SCALAR_RTOL)
    ref_ms, ref_peak = times["norm_eval=True"]
    print("  train step at batch 16, bf16, against norm_eval=True in this call: " + "; ".join(
        f"{k} {ms:.2f} ms ({ms / ref_ms:.3f}x), {peak:.2f} GiB ({peak / ref_peak:.3f}x)"
        for k, (ms, peak) in times.items()) + f" [{gpu}]")

    # with_cp against the plain float32 step on the card
    cfg = Config.fromfile(config, ["model.backbone.frozen_stages=-1", "model.backbone.norm_eval=False"])
    cp_cfg = Config.fromfile(config, ["model.backbone.frozen_stages=-1", "model.backbone.norm_eval=False",
                                      "model.backbone.with_cp=True"])
    anchors, ranges, _ = anchors_from_cfg(cfg)
    models = {}
    for name, c in (("plain", cfg), ("with_cp", cp_cfg)):
        m = build_model_and_anchors(c, dtype="float32")[0]
        m.init_weights(torch.Generator().manual_seed(SEED))
        models[name] = m.to(dev)
    before = running_stats(models["plain"])
    two = collate([dataset[0], dataset[1]])
    torch.backends.cudnn.deterministic = True
    try:
        out = parity_steps(cfg, two, anchors, ranges, step_args(cfg),
                           [(name, m, dev) for name, m in models.items()])
    finally:
        torch.backends.cudnn.deterministic = False
    (_, mp, gp), (_, mc, gc) = out["plain"], out["with_cp"]
    grad_err = grad_errors(gc, gp)[0]
    stats_p, stats_c = running_stats(models["plain"]), running_stats(models["with_cp"])
    stat_err = grad_errors(stats_c, stats_p)[0]
    k = "backbone.layer2.0.bn1.running_var"
    once = float(((stats_c[k] - 0.9 * before[k]) - (stats_p[k] - 0.9 * before[k])).abs().max())
    loss_err = max(abs(mc[k_] - mp[k_]) / max(abs(mp[k_]), 1e-12) for k_ in mp)
    print(f"  with_cp vs plain, float32 batch 2 on the card (frozen_stages=-1, cuDNN deterministic): losses max rel "
          f"err {loss_err:.3g}; gradients max err {grad_err[0]:.3g} of the tensor's max abs ({grad_err[1]}); running "
          f"statistics max err {stat_err[0]:.3g} ({stat_err[1]}); {k} minus 0.9 of its old value differs by "
          f"{once:.3g} (moved once) [{gpu}]")
    if loss_err > CP_RTOL or grad_err[0] > CP_RTOL or stat_err[0] > CP_RTOL:
        fail(f"with_cp changes the step beyond {CP_RTOL}")
    if torch.equal(stats_c[k], before[k]):
        fail("the live BN's running statistics did not move")
    del models, out
    torch.cuda.empty_cache()


def recorded_vote_nms(calls):
    """A stand-in for ``postprocess.vote_nms`` that launches the kernel and
    keeps a copy of each call's inputs, options and outputs in ``calls``."""
    import radet_tpu_torch.models.postprocess as postprocess

    kernel_nms = postprocess.vote_nms

    def run(*args, **kw):
        out = kernel_nms(*args, **kw)
        calls.append(([a.clone() for a in args], kw, [t.clone() for t in out]))
        return out

    return kernel_nms, run


def hold_to_plain(calls, what: str) -> float:
    """The recorded kernel calls against the plain version in float64, those
    of one K and the same options together; returns the max abs box error."""
    groups = {}
    for args, kw, out in calls:
        groups.setdefault((args[0].shape[1], repr(kw)), []).append((args, kw, out))
    err = 0.0
    for (k, _), group in sorted(groups.items()):
        args, kw = [torch.cat(t) for t in zip(*(a for a, _, _ in group))], group[0][1]
        err = max(err, compare([torch.cat(t) for t in zip(*(o for _, _, o in group))], plain_reference(args, **kw),
                               f"{what}: {len(group)} vote-NMS calls (B<={max(a[0].shape[0] for a, _, _ in group)}, "
                               f"K={k}, {int(args[4].sum())} valid candidates), kernel vs plain in float64"))
    return err


def validate_learning_run(argv):
    """``validate_learning.main(argv)`` in this process, with its vote-NMS
    calls recorded and its log kept, and both kernels' launches counted.
    Returns (the metrics, the log's iteration lines, the recorded calls,
    vote-NMS launches, int8 launches, int8 launches by path, the int8
    launches its evals logged, seconds)."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.tools import validate_learning
    from radet_tpu_torch.utils import get_root_logger

    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    logs = LogLines()
    get_root_logger().addHandler(logs)
    vnc.LAUNCHES = icc.LAUNCHES = 0
    icc.PATH_LAUNCHES.update(dict.fromkeys(icc.PATHS, 0))
    t0 = time.perf_counter()
    try:
        metrics = validate_learning.main(argv)
    except SystemExit as e:
        fail(f"validate_learning {' '.join(argv)} exited {e.code}: its mAP50 is below {LEARN_MIN_MAP50}")
    finally:
        postprocess.vote_nms = kernel_nms
        get_root_logger().removeHandler(logs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = [ln for ln in logs.lines if ln.startswith("iter ")]
    eval_int8 = sum(int(v) for ln in logs.lines for v in re.findall(r"int8_conv kernel launches (\d+)", ln))
    if vnc.LAUNCHES < 1 or len(calls) != vnc.LAUNCHES:
        fail(f"validate_learning's eval launched the vote_nms kernel {vnc.LAUNCHES} times ({len(calls)} recorded)")
    if metrics["bbox_mAP_50"] < LEARN_MIN_MAP50:
        fail(f"validate_learning reached mAP50 {metrics['bbox_mAP_50']:.4f} < {LEARN_MIN_MAP50}")
    return metrics, iters, calls, vnc.LAUNCHES, icc.LAUNCHES, dict(icc.PATH_LAUNCHES), eval_int8, wall


def learning_phase(gpu: str):
    """Phase 11c: ``python -m radet_tpu_torch.tools.validate_learning --qat``
    at its defaults (RADet-R18 from scratch, live BN, 400 steps at batch 4,
    128x160, then the strict eval; then the QAT loop: the PTQ eval through
    the int8 deploy config, 200 QAT steps from the float weights, the
    deploy eval, each printing its RESULT line), in this process: mAP50 at
    least LEARN_MIN_MAP50, its eval's first vote-NMS call held to the plain
    version.  Returns (the kernel's launches, its max abs box error there,
    the int8 kernel's launches)."""
    metrics, iters, calls, launches, int8_launches, int8_paths, _, wall = validate_learning_run(["--qat"])
    print(f"learning: python -m radet_tpu_torch.tools.validate_learning --qat (defaults: 400 steps, batch 4, "
          f"128x160, RADet-R18 from scratch, norm_eval=False, float32; then PTQ eval, 200 QAT steps, deploy eval): "
          f"mAP50 {metrics['bbox_mAP_50']:.4f}, mAP {metrics['bbox_mAP']:.4f}; "
          + ", ".join(f"{k} mAP50 {m['bbox_mAP_50']:.4f} mAP {m['bbox_mAP']:.4f}" for k, m in metrics["qat"].items())
          + f"; {wall:.1f} s wall (scenes, both trainings and three evals); vote_nms kernel launches {launches}, "
          f"int8_conv {int8_launches} (by path {int8_paths}) [{gpu}]")
    for ln in iters[-2:]:
        print(f"  {ln}")
    if int8_launches < 1:
        fail("validate_learning --qat's deploy evals launched no int8 kernel")
    err = hold_to_plain(calls[:1], "validate_learning's eval, its first batch")
    del calls
    return launches, err, int8_launches


def sweep_phase(gpu: str, work: str):
    """Phase 11d: ``python -m radet_tpu_torch.tools.run_bop_sweep --mode
    test`` over the seven datasets, in this process, from a directory where
    each config's ``data/<dataset>/`` holds SWEEP_IMAGES synthetic 480x640
    PNG test images annotated with its dataset's class names (random
    weights at full width, bf16; ``test_cfg.score_thr=0`` so that the
    strict eval's candidates reach vote-NMS): every dataset ok, every BOP
    submission's category ids that config's classes', its vote-NMS calls
    held to the plain version.  Returns (the kernel's launches, its max abs
    box error there)."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.tools import run_bop_sweep
    from radet_tpu_torch.utils import Config
    from synthetic_bop import write_bop_test_set

    root = osp.join(work, "sweep")
    rng = np.random.RandomState(SEED + 12)
    named = {}
    for ds in run_bop_sweep.DATASETS:
        path = osp.join(run_bop_sweep.CONFIG_DIR, f"r50_{ds}_pbr.py")
        cfg = Config.fromfile(path)
        data_root = osp.join(root, cfg.data_root)
        ann = write_bop_test_set(data_root, rng, ((SWEEP_IMAGES, (480, 640)),), list(cfg.CLASS_NAMES))
        os.makedirs(osp.join(data_root, "detector_annotations"))
        os.replace(ann, osp.join(data_root, "detector_annotations", "test_bop19.json"))
        with open(osp.join(data_root, "detector_annotations", "test_bop19.json")) as f:
            cats = json.load(f)["categories"]
        targets = {str(c) for c in cfg.data.test.classes}
        named[ds] = {c["id"] for c in cats if c["name"] in targets}
    tested = []
    real_test = run_bop_sweep.test_from_config

    def recording(cfg, model, **kw):
        dataset, results, metrics = real_test(cfg, model, **kw)
        tested.append((dataset, results))
        return dataset, results, metrics

    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    run_bop_sweep.test_from_config = recording
    cwd = os.getcwd()
    os.chdir(root)
    vnc.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        summary = run_bop_sweep.main(["--mode", "test", "--out", osp.join(root, "summary.json"), "--device",
                                      "cuda", "--cfg-options", "test_cfg.score_thr=0.0"])
    finally:
        os.chdir(cwd)
        run_bop_sweep.test_from_config = real_test
        postprocess.vote_nms = kernel_nms
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vnc.LAUNCHES
    print(f"sweep: python -m radet_tpu_torch.tools.run_bop_sweep --mode test, seven datasets, {SWEEP_IMAGES} PNG "
          f"images 480x640 each, random weights, full width, bf16: {wall:.1f} s wall; vote_nms kernel launches "
          f"{launches} [{gpu}]")
    for (ds, entry), (dataset, results) in zip(summary.items(), tested):
        ids = {d["category_id"] for d in dataset.bop_det2json(results)}
        print(f"  {ds}: {entry['status']}, {len(dataset.CLASSES)} classes, {sum(len(r['boxes']) for r in results)} "
              f"detections, BOP category ids {sorted(ids)} (the config's: {sorted(named[ds])}), "
              f"{entry['seconds']} s")
        if entry["status"] != "ok" or not ids or not ids <= named[ds]:
            fail(f"sweep: {ds} {entry.get('error', '')}: category ids {sorted(ids)} outside {sorted(named[ds])}")
    if len(tested) != len(run_bop_sweep.DATASETS) or launches < len(tested) or len(calls) != launches:
        fail(f"sweep: {len(tested)} datasets tested, {launches} kernel launches ({len(calls)} recorded)")
    err = hold_to_plain(calls, "the sweep's evals")
    del calls, tested
    torch.cuda.empty_cache()
    return launches, err


# phase 12: the measuring and deploy tools
TOOL_TIMEOUT = 600  # s, each tool's process
EXPORT_BATCH = 8
EXPORT_CALLS = 3  # calls of the loaded program, each counted
EXPORT_SCORE_ATOL = 1e-5  # exported vs eager step on the card, float32 scores (boxes: BOX_ATOL, BOX_TAIL)
DISPATCH_SHAPES = ((8, 512), (8, 1024), (8, 2048), (16, 2048))
PIPELINE_BATCH = 4  # the loader runs 6 batches per worker count and mode
# a fresh process: load the exported program (importing the package registers
# its NMS operators), run it on the saved images, count the kernel's launches
# per call, time it by CUDA events and save its outputs
EXPORT_RUN = r"""
import json, sys
import numpy as np, torch
import radet_tpu_torch.ops.int8_conv_cuda as icc
import radet_tpu_torch.ops.vote_nms_cuda as vnc
from radet_tpu_torch.tools.export_model import load
program = load(sys.argv[1])
images = torch.from_numpy(np.load(sys.argv[2])).cuda()
b, h, w, _ = images.shape
shapes = torch.tensor([[h, w]] * b, dtype=torch.float32, device="cuda")
scales = torch.ones((b, 4), dtype=torch.float32, device="cuda")
launches, int8_launches = [], []
with torch.inference_mode():
    for _ in range(int(sys.argv[4])):
        before, before8 = vnc.LAUNCHES, icc.LAUNCHES
        outs = program(images, shapes, scales)
        torch.cuda.synchronize()
        launches.append(vnc.LAUNCHES - before)
        int8_launches.append(icc.LAUNCHES - before8)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        program(images, shapes, scales)
    end.record()
    torch.cuda.synchronize()
np.savez(sys.argv[3], *[t.cpu().numpy() for t in outs])
print(json.dumps(dict(launches=launches, int8_launches=int8_launches, ms=start.elapsed_time(end) / 20)))
"""


def tool_run(repo: Path, args, what: str, fresh: bool = False):
    """``python`` with ``args`` from the repository root: ``-m MODULE ...``
    as that entry point's ``main(argv)`` in this process (its stdout and the
    package's log captured: a process of its own would add ~8 s of start-up
    and CUDA set-up to each of the smoke's ~20 CLI runs), or with ``fresh``
    as ``python -m`` in a process of its own (the log's messages read from
    its stderr); anything else in its own process (stderr captured).
    Returns (stdout, the log or stderr, wall s) or fails."""
    args = [str(a) for a in args]
    t0 = time.perf_counter()
    if args[0] != "-m" or fresh:
        proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=str(repo),
                              timeout=TOOL_TIMEOUT)
        if proc.returncode != 0:
            fail(f"{what} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        err = proc.stderr
        if args[0] == "-m":
            err = "\n".join(ln.split(" - ")[-1] for ln in err.splitlines())
        return proc.stdout, err, time.perf_counter() - t0
    import gc
    import importlib
    import traceback

    from radet_tpu_torch.utils import get_root_logger

    out, logs = io.StringIO(), LogLines()
    get_root_logger().addHandler(logs)
    try:
        with contextlib.redirect_stdout(out):
            importlib.import_module(args[1]).main(args[2:])
    except Exception:  # the phase fails with the traceback
        fail(f"{what} raised:\n{traceback.format_exc()[-3000:]}")
    finally:
        get_root_logger().removeHandler(logs)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out.getvalue(), "\n".join(logs.lines), time.perf_counter() - t0


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def flops_tool(config: str, gpu: str, repo: Path) -> None:
    """``get_flops`` on the card at batch 1 against the same tool's count on
    the CPU (in this process)."""
    from radet_tpu_torch.tools import get_flops

    out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.get_flops", config], "get_flops")
    m = re.search(r"count: (\d+) parameters, (\d+) FLOPs", out)
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = get_flops.main([config, "--device", "cpu"])
    print(f"tools: python -m radet_tpu_torch.tools.get_flops {CONFIG} (card, {wall:.1f} s):")
    for ln in out.strip().splitlines():
        print(f"  {ln}")
    print(f"  the same tool on the CPU: {cpu['params']} parameters, {cpu['flops']} FLOPs")
    if not m or (int(m.group(1)), int(m.group(2))) != (cpu["params"], cpu["flops"]) or cpu["params"] != 32159327:
        fail("get_flops: the card's counts differ from the CPU's, or the parameters from 32159327")


def infer_profile(config: str, gpu: str, repo: Path) -> dict:
    """``profile_infer`` at batch 128 and 8: the by-module table, the top
    kernels (vote-NMS's three under postprocess), the roofline and the busy
    share.  Returns the batch-128 summary."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc

    summaries = {}
    for batch in (128, 8):
        out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.profile_infer", "--config", config, "--batch",
                                       batch, "--iters", 3, "--top", 1000], f"profile_infer --batch {batch}")
        s = last_json(out)
        summaries[batch] = s
        print(f"tools: python -m radet_tpu_torch.tools.profile_infer --batch {batch} ({wall:.1f} s):")
        lines = out.strip().splitlines()
        start = next(i for i, ln in enumerate(lines) if ln.startswith("== inference step"))
        stop = next(i for i, ln in enumerate(lines) if ln.startswith("-- top"))
        for ln in lines[start:stop + 2] + lines[stop + 2:stop + 14]:
            if ln.strip():
                print(f"  {ln}")
        nms = {k["name"]: k for k in s["top"] if any(n in k["name"] for n in vnc.CUDA_KERNELS)}
        for k in nms.values():
            print(f"  vote-NMS kernel {k['name'][:60]}: {k['ms']:.4f} ms per step under {k['module']}")
        if {n for n in vnc.CUDA_KERNELS if any(n in name and k["module"] == "postprocess"
                                               for name, k in nms.items())} != set(vnc.CUDA_KERNELS):
            fail(f"profile_infer --batch {batch}: vote-NMS's CUDA kernels are not all under postprocess")
        if abs(sum(m["share"] for m in s["by_module"].values()) - 1) > 1e-6 or not 0 < s["busy_share"] <= 1.05:
            fail(f"profile_infer --batch {batch}: module shares or busy share out of range")
        top = max(s["by_module"].items(), key=lambda kv: kv[1]["ms"])
        print(f"  batch {batch}: {s['ms_per_iter']:.3f} ms per step wall, device {s['measured_ms']:.3f} ms, "
              f"busy {s['busy_share']:.4f}, roofline bound {s['bound_ms']:.3f} ms "
              f"({s['bound_ms'] / s['measured_ms']:.2%} of the device time), most time in {top[0]} "
              f"({top[1]['share']:.1%}) [{gpu}]")
    return summaries[128]


def train_profile(gpu: str, repo: Path) -> dict:
    out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.profile_train", "--batch", 16, "--iters", 10],
                            "profile_train")
    s = json.loads(out[out.index("{"):])
    print(f"tools: python -m radet_tpu_torch.tools.profile_train --batch 16 --iters 10 ({wall:.1f} s): step "
          f"{s['step_ms']:.3f} ms ({s['img_per_s']:.1f} img/s), forward {s['fwd_ms']:.3f}, forward + loss "
          f"{s['fwd_loss_ms']:.3f}, backward + update {s['bwd_opt_ms']:.3f}, assignment {s['assign_ms']:.3f} ms "
          f"({s['assign_frac']:.2%}); {s['step_tflops']:.4f} TFLOP per step, MFU {s['mfu']:.4f} of "
          f"{s['peak_tflops']} TFLOP/s [{s['device']}]")
    if not 0 < s["mfu"] < 1 or abs(s["mfu"] - s["step_tflops"] / (s["step_ms"] / 1e3) / s["peak_tflops"]) > 1e-9:
        fail("profile_train: MFU out of range or not step FLOPs / step time / peak")
    return s


def pipeline_profile(gpu: str, repo: Path) -> None:
    for pipeline in ("train", "test"):
        out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.profile_pipeline", "--pipeline", pipeline,
                                       "--samples", 8, "--workers", 4, "--mode", "thread", "process",
                                       "--batch", PIPELINE_BATCH],
                                f"profile_pipeline --pipeline {pipeline}")
        s = last_json(out)
        print(f"tools: python -m radet_tpu_torch.tools.profile_pipeline --pipeline {pipeline} ({wall:.1f} s): "
              f"{s['per_sample_ms']:.2f} ms per sample, {s['single_core_img_s']:.1f} img/s on one core, "
              f"{s['cores_needed']:.2f} cores for {s['target_img_s']} img/s; loader img/s "
              + ", ".join(f"{k} {v:.1f}" for k, v in s["loader_scaling"].items())
              + f"; {s['host_cores']} host cores [host of {gpu}]")
        print("  transforms, ms per sample: " + ", ".join(f"{k} {v:.2f}" for k, v in s["transforms"].items()))
        if set(s["loader_scaling"]) != {"threadx4", "processx4"}:
            fail(f"profile_pipeline --pipeline {pipeline}: loader runs missing")


def export_phase(config: str, gpu: str, repo: Path, work: str, images, name: str = "export") -> dict:
    """``export_model --verify`` of ``config`` at batch EXPORT_BATCH in bf16
    (the eval phase's weights), the program loaded in a fresh process and
    run on the main path's images, against the eager step in this process;
    returns the loaded program's run (its kernels' launches per call)."""
    from radet_tpu_torch import init_detector

    ckpt = osp.join(work, "random_cls0.pth")
    pt2, npy, npz = (osp.join(work, f"{name}.{ext}") for ext in ("pt2", "npy", "npz"))
    _, err, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.export_model", config, pt2, "--checkpoint", ckpt,
                                   "--batch-size", EXPORT_BATCH, "--verify"], "export_model")
    print(f"tools: python -m radet_tpu_torch.tools.export_model --batch-size {EXPORT_BATCH} --verify "
          f"({wall:.1f} s):")
    for ln in err.splitlines():
        if "exported" in ln or "roundtrip" in ln:
            print(f"  {ln.split(' - ')[-1]}")
    np.save(npy, images)
    out, _, wall = tool_run(repo, ["-c", EXPORT_RUN, pt2, npy, npz, EXPORT_CALLS], "the exported program's run")
    run = last_json(out)
    with np.load(npz) as f:
        got = [f[f"arr_{i}"] for i in range(4)]
    det = init_detector(config, ckpt, device="cuda")
    dev = torch.device("cuda")
    u8 = torch.from_numpy(images).to(dev)
    b, h, w, _ = images.shape
    shapes = torch.tensor([[h, w]] * b, dtype=torch.float32, device=dev)
    scales = torch.ones((b, 4), dtype=torch.float32, device=dev)
    eager = det._infer(det.model, u8, shapes, scales)
    want = [t.cpu().numpy() for t in (eager.boxes, eager.scores, eager.labels, eager.valid)]
    eager_ms = cuda_ms(lambda: det._infer(det.model, u8, shapes, scales), 20)
    valid = want[3]
    box_err = np.abs(got[0] - want[0])[valid]
    score_err = float(np.abs(got[1] - want[1]).max(initial=0.0))
    tail = float((box_err > BOX_ATOL).mean()) if box_err.size else 0.0
    bits = all(np.array_equal(g, w_) for g, w_ in zip(got, want))
    print(f"  loaded in a fresh process ({wall:.1f} s) and run on the main path's {b} images: "
          f"{int(valid.sum())} detections, vote_nms kernel launches per call {run['launches']}, int8_conv "
          f"{run['int8_launches']}; against the eager "
          f"step: valid and labels equal {np.array_equal(got[3], valid) and np.array_equal(got[2], want[2])}, "
          f"box max abs diff {box_err.max(initial=0.0):.3g} px, score max abs diff {score_err:.3g}, bit for bit "
          f"equal {bits}")
    print(f"timing: exported program batch {b} {run['ms']:.3f} ms/batch (fresh process), eager step "
          f"{eager_ms:.3f} ms/batch (this process), uint8 on the card [{gpu}]")
    if not np.array_equal(got[3], valid) or not np.array_equal(got[2], want[2]) or not valid.any():
        fail("the exported program's valid or labels differ from the eager step's, or nothing was detected")
    if score_err > EXPORT_SCORE_ATOL or tail > BOX_TAIL:
        fail(f"the exported program's scores ({score_err:.3g}) or boxes ({tail:.4%} past {BOX_ATOL} px) differ")
    if run["launches"] != [1] * EXPORT_CALLS:
        fail(f"the exported program launched the vote_nms kernel {run['launches']} times in {EXPORT_CALLS} calls")
    del det, eager
    torch.cuda.empty_cache()
    return run


def eval_metric_phase(config: str, repo: Path, work: str, test_opts) -> None:
    """``eval_metric`` on the eval phase's test CLI pickle: its metrics."""
    out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.eval_metric", config, osp.join(work, "eval.pkl"),
                                   "--cfg-options", *test_opts], "eval_metric")
    got = json.loads(out[out.index("{"):])
    with open(osp.join(work, "eval.metrics.json")) as f:
        want = json.load(f)
    print(f"tools: python -m radet_tpu_torch.tools.eval_metric on the test CLI's --out pickle ({wall:.1f} s): "
          f"bbox_mAP {got['bbox_mAP']:.4f}, bbox_mAP_50 {got['bbox_mAP_50']:.4f}; equal to the test CLI's "
          f"{len(want)} metrics: {got == want}")
    if got != want:
        fail("eval_metric's metrics differ from the test CLI's")


def dispatch_timing(gpu: str) -> dict:
    """vote-NMS through its operator (``ops.vote_nms.vote_nms``, the path's
    route) against the kernel's wrapper called directly, in turns, at
    DISPATCH_SHAPES, under ``torch.inference_mode`` as the inference step
    calls it: what the operator's dispatch costs per call."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import vote_nms

    rng = np.random.RandomState(SEED + 13)
    dev = torch.device("cuda")
    kw = dict(iou_threshold=0.65, max_out=100, iou_enable=False, sigma=0.025, global_mode=False)
    out = {}
    for b, k in DISPATCH_SHAPES:
        arrays = [torch.from_numpy(a).to(dev) for a in clustered_candidates(rng, b, k)]
        if not all(torch.equal(x, y) for x, y in zip(vote_nms(*arrays, **kw), vnc.vote_nms_cuda(*arrays, **kw))):
            fail(f"B={b} K={k}: the operator and the wrapper differ")
        with torch.inference_mode():
            op_ms, wrapper_ms, op_runs, wrapper_runs = alternate_ms(
                lambda: vote_nms(*arrays, **kw), lambda: vnc.vote_nms_cuda(*arrays, **kw), 50, 50)
        out[f"{b}x{k}"] = dict(op_ms=op_ms, wrapper_ms=wrapper_ms)
        print(f"timing: vote_nms B={b} K={k}: through the operator {op_ms:.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in op_runs)}), the wrapper alone {wrapper_ms:.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in wrapper_runs)}) [{gpu}]")
    return out


def tools_phase(config: str, gpu: str, repo: Path, work: str, test_opts, images) -> tuple:
    """Phase 12: each tool's CLI (its ``main``) at full width on the
    card (get_flops, profile_infer, profile_train, profile_pipeline,
    export_model and its program in a fresh process, eval_metric), and the
    operator's dispatch cost.  Returns (the exported program's launches per
    call, the dispatch timings)."""
    dispatch = dispatch_timing(gpu)
    flops_tool(config, gpu, repo)
    infer_profile(config, gpu, repo)
    train_profile(gpu, repo)
    export_launches = export_phase(config, gpu, repo, work, images)["launches"]
    eval_metric_phase(config, repo, work, test_opts)
    pipeline_profile(gpu, repo)
    return export_launches, dispatch



# 13. the int8 deploy family (configs/bop/*int8*): the hand-written int8
# convolution (csrc/int8_conv.cu) under the head's towers and the trunk
INT8_CONFIGS = ("r50_ycbv_pbr_int8", "r50_ycbv_pbr_int8_conv2", "r50_ycbv_pbr_int8_full",
                "r50_ycbv_pbr_int8_stream", "r50_ycbv_pbr_int8_qat")
# int8 convolutions per forward: the towers' 2 x 4 convs at 5 levels; + the
# 16 blocks' conv2; + their conv3; + their conv1 and the 4 downsamples
INT8_LAUNCHES = {"r50_ycbv_pbr_int8": 40, "r50_ycbv_pbr_int8_conv2": 56, "r50_ycbv_pbr_int8_full": 72,
                 "r50_ycbv_pbr_int8_stream": 92, "r50_ycbv_pbr_int8_qat": 92}
INT8_MAIN = "r50_ycbv_pbr_int8_stream"  # the kernels line's launches and shapes
INT8_TIMED = ("r50_ycbv_pbr_int8", "r50_ycbv_pbr_int8_full", "r50_ycbv_pbr_int8_stream")
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core rate
# the int8 forward in float32, card vs CPU.  The float convs' and norms'
# rounding differs, so the first int8 conv's input (before any int8
# arithmetic) flips an occasional element by one level: at most
# INT8_FIRST_FLIPS of them.  The following blocks carry each flip on and
# the seeded random weights (unit BatchNorms, far from calibrated) amplify
# it: on the card, 1.7% (int8) and 13.5% (int8_conv2) of all int8 conv
# inputs' elements, by at most 3 and 8 levels, 0.096 and 0.153 of a head
# map's max (tests/test_torch_quant.py against the JAX package on the CPU:
# 2.8% by 2 levels in the stream at 64x64).  The bounds on the whole
# forward catch a gross error (a wrong scale or layout moves most elements
# by many levels).
INT8_FIRST_FLIPS = 1e-3
INT8_FLIPS, INT8_LEVELS, INT8_MAP_RTOL = 0.3, 16, 0.5
# a grouped conv with 4 channels a group (ResNeXt-50 32x4d's layer1 3x3),
# batch 8 at 480x640: (N, C, H, W, Cout, k, stride, groups)
INT8_GROUPED = (8, 128, 120, 160, 128, 3, 1, 32)
INT8_BIG = 128  # the deploy batch of the by-shape timings
SPIN_CYCLES = 10_000_000  # device_ms's lead: ~5 ms at the H100's clocks, above 20 calls of ~90 host us
SERVE_INT8 = 16  # one full batch: the head's dynamic absmax spans the batch


def int8_bound(x_shape, w_shape, out_shape, stride, padding):
    """(ms, 'bytes' or 'operations'): the int8 input the conv reads (the rows
    and columns some tap touches: a quarter of it for a 1x1 stride-2 conv),
    int8 weights and bf16 out over 3.35 TB/s against 2 N Ho Wo Cout Cin/g
    kh kw int8 operations at 1979 TOPS."""
    n, _, h, w = x_shape
    cout, cin_g, kh, kw = w_shape
    ho, wo = out_shape[2:]

    def touched(size, out, k, s, p):
        return len({o * s - p + t for o in range(out) for t in range(k)} & set(range(size)))

    ops = 2.0 * n * ho * wo * cout * cin_g * kh * kw
    nbytes = (n * x_shape[1] * touched(h, ho, kh, stride[0], padding[0]) * touched(w, wo, kw, stride[1], padding[1])
              + cout * cin_g * kh * kw + 2.0 * n * cout * ho * wo)
    t_ops, t_bytes = ops / INT8_TOPS, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def int_mm_ms(x, wt, stride, groups, iters: int):
    """ms of ``torch._int_mm`` on the same int8 inputs for a 1x1 stride-1
    ungrouped conv (the int32 sums only: the one PyTorch call that computes
    them), else None."""
    if wt.shape[2:] != (1, 1) or stride[0] != 1 or groups != 1:
        return None
    a = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    b = wt.reshape(wt.shape[0], -1).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f"  _int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {str(e).splitlines()[0]}")
        return None
    return device_ms(lambda: torch._int_mm(a, b), iters)


@contextlib.contextmanager
def int8_conv_calls(keep_out: bool = False):
    """Within the block, the arguments (copies) of every int8 convolution,
    in call order (the list yielded); with ``keep_out``, (the arguments, a
    copy of the output) pairs."""
    from radet_tpu_torch.ops import quant

    seen = []
    op = quant._int8_conv_op

    def record(*args):
        copies = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        out = op(*args)
        seen.append((copies, out.clone()) if keep_out else copies)
        return out

    quant._int8_conv_op = record
    try:
        yield seen
    finally:
        quant._int8_conv_op = op


def int8_calls(det, images) -> dict:
    """The int8 convolutions of one forward of ``det`` on ``images``: the
    operator's arguments of the first call of each distinct (input shape,
    weight shape, stride, padding, groups), by that key."""
    n, h, w = images.shape[:3]
    dev = images.device
    with torch.inference_mode(), int8_conv_calls() as seen:
        det._infer(det.model, images, torch.tensor([[h, w]] * n, dtype=torch.float32, device=dev),
                   torch.ones((n, 4), dtype=torch.float32, device=dev))
    calls = {}
    for args in seen:
        calls.setdefault((tuple(args[0].shape), tuple(args[1].shape), tuple(args[4]), tuple(args[5]), args[6]), args)
    return calls


def int8_kernel_by_shape(gpu: str, calls: dict) -> dict:
    """Both kernels against the plain version (float64 on the card, without
    cuDNN: an exact sum) bit for bit, int32 sums and bf16 output, at every
    recorded shape and the grouped one, at batch 8 (the recorded inputs) and
    128 (them and 120 seeded random images): the wgmma kernel where
    ``plan`` takes the shape, the mma.sync kernel everywhere.  Each timed
    at both batches beside the bound, the wgmma kernel also with one block
    per tile, ``torch._int_mm`` (1x1 stride-1 shapes) and the bf16 cuDNN conv
    (a different function), each by its device time (``device_ms``: at
    batch 8 a call's host time exceeds most kernels'; ``int8_host_us``
    reads it).  Returns {shape label: numbers}."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch.ops.quant import int8_conv_plain

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 21)
    g_dev = torch.Generator(device=dev).manual_seed(SEED + 23)
    n, c, h, w, cout, k, st, groups = INT8_GROUPED
    grouped = (torch.randint(-127, 128, (n, c, h, w), generator=g, dtype=torch.int8).to(dev).contiguous(
        memory_format=torch.channels_last),
        torch.randint(-127, 128, (cout, c // groups, k, k), generator=g, dtype=torch.int8).to(dev),
        (torch.rand(cout, generator=g) * 1e-3).to(dev), None, [st, st], [k // 2, k // 2], groups, torch.bfloat16)
    cases = [(c, True) for c in calls.values()] + [(grouped, False)]
    out = {}
    print(f"int8: both kernels against the plain version at the {len(calls)} distinct int8 conv shapes of "
          f"{', '.join(INT8_TIMED[1:])} at 480x640 (batch 8: the main path's inputs; batch 128: them and 120 random "
          f"images) and a grouped one (4 channels a group, random int8); device times by CUDA events, the host kept "
          f"ahead [{gpu}]:")
    print("  N C H W -> Cout k/s g path | batch 8: kernel ms, plain ms, bound ms (by), share | batch 128: "
          "kernel ms, one block per tile ms, mma ms, bound ms, share, _int_mm ms, cuDNN bf16 conv ms (not the same "
          "function)")

    def check(x, wt, args, paths, batch):
        for dtype in (torch.int32, torch.bfloat16):
            with torch.backends.cudnn.flags(enabled=False):
                want = int8_conv_plain(x, wt, *args, dtype)
            for path in paths:
                got = icc.int8_conv_cuda(x, wt, *args, dtype, path=path)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"int8_conv {path} x {tuple(x.shape)} w {tuple(wt.shape)} {dtype} (batch {batch}): the "
                         f"kernel differs from the plain version in {int((got != want).sum())} elements")
            del want

    for (x, wt, mult, bias, stride, padding, groups, _), on_path in cases:
        args = (mult, bias, stride, padding, groups)
        cfg = icc.plan(x.shape, wt.shape, tuple(stride), tuple(padding), groups, 256)
        paths = ("wgmma", "mma") if cfg["path"] == "wgmma" else ("mma",)
        if on_path and cfg["path"] != "wgmma":
            fail(f"int8_conv x {tuple(x.shape)} w {tuple(wt.shape)}: a main-path shape outside the wgmma kernel")
        check(x, wt, args, paths, 8)
        label = (f"{x.shape[0]} {x.shape[1]} {x.shape[2]} {x.shape[3]} -> {wt.shape[0]} {wt.shape[2]}/{stride[0]} "
                 f"{groups}")
        row = dict(x=list(x.shape), w=list(wt.shape), stride=stride[0], groups=groups, on_main_path=on_path,
                   path=cfg["path"], plan={k: cfg[k] for k in ("patch_w", "patch_h", "patch_n", "bk", "bn", "stages",
                                                              "tiles", "grid")} if cfg["path"] == "wgmma" else None)

        def kern(xx, **kw):
            return lambda: icc.int8_conv_cuda(xx, wt, *args, torch.bfloat16, **kw)

        row["ms"] = device_ms(kern(x), 20)
        with torch.backends.cudnn.flags(enabled=False):
            row["plain_ms"] = cuda_ms(lambda: int8_conv_plain(x, wt, *args, torch.bfloat16), 2)
        ho, wo = icc.conv_output_hw(x.shape[2], x.shape[3], wt.shape[2:], stride, padding)
        row["bound_ms"], row["bound_by"] = int8_bound(x.shape, wt.shape, (x.shape[0], wt.shape[0], ho, wo), stride,
                                                      padding)
        row["int_mm_ms"] = int_mm_ms(x, wt, stride, groups, 20)
        rand = torch.randint(-127, 128, (INT8_BIG - x.shape[0],) + tuple(x.shape[1:]), generator=g_dev,
                             dtype=torch.int8, device=dev)
        big = torch.cat([x, rand]).contiguous(memory_format=torch.channels_last)
        del rand
        check(big, wt, args, paths, INT8_BIG)
        for key, kw, iters in (("ms_128", {}, 10), ("ms_128_per_tile", dict(path="wgmma", persistent=False), 10),
                               ("mma_ms_128", dict(path="mma"), 5)):
            if kw.get("path", "mma") == "wgmma" and cfg["path"] != "wgmma":
                row[key] = None
                continue
            row[key] = device_ms(kern(big, **kw), iters)
        row["bound_ms_128"], row["bound_by_128"] = int8_bound(big.shape, wt.shape, (INT8_BIG, wt.shape[0], ho, wo),
                                                              stride, padding)
        row["int_mm_ms_128"] = int_mm_ms(big, wt, stride, groups, 10)
        xb, wb = big.to(torch.bfloat16), wt.to(torch.bfloat16)
        row["cudnn_bf16_ms_128"] = device_ms(lambda: F.conv2d(xb, wb, None, stride, padding, 1, groups), 10)
        del big, xb, wb
        out[label] = row
        opt = lambda v: "-" if v is None else f"{v:.4f}"  # noqa: E731
        print(f"  {label} {cfg['path']} | {row['ms']:.4f}, {row['plain_ms']:.3f}, "
              f"{row['bound_ms']:.4f} ({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} | {row['ms_128']:.4f}, "
              f"{opt(row['ms_128_per_tile'])}, {row['mma_ms_128']:.4f}, {row['bound_ms_128']:.4f} "
              f"({row['bound_by_128']}), {row['bound_ms_128'] / row['ms_128']:.1%}, {opt(row['int_mm_ms_128'])}, "
              f"{row['cudnn_bf16_ms_128']:.4f}")
    torch.cuda.empty_cache()
    print(f"  every shape, both batches: int32 sums and bf16 outputs of {' and '.join(icc.PATHS)} equal the plain "
          f"version bit for bit ({time.perf_counter() - t0:.1f} s) [{gpu}]")
    main = [r for r in out.values() if r["on_main_path"]]
    half = sum(r["bound_ms_128"] / r["ms_128"] >= 0.5 for r in main)
    beats = [r for r in main if r["int_mm_ms_128"] is not None]
    print(f"  batch 128, the {len(main)} main-path shapes: wgmma faster than mma at "
          f"{sum(r['ms_128'] < r['mma_ms_128'] for r in main)}, at half its bound or more at {half}, no slower than "
          f"_int_mm at {sum(r['ms_128'] <= r['int_mm_ms_128'] for r in beats)} of {len(beats)}; persistent faster "
          f"than one block per tile at {sum(r['ms_128'] < r['ms_128_per_tile'] for r in main)}")
    return out


def int8_host_us(calls: dict) -> dict:
    """Host microseconds per call of each path (the wrapper, the cached plan
    and, for wgmma, the three tensor maps' encoding included; the launches
    queue without a synchronisation) on the smallest recorded shape."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc

    x, wt, mult, bias, stride, padding, groups, _ = min(calls.values(), key=lambda a: a[0].numel())
    out = {}
    for path in icc.PATHS:
        fn = lambda: icc.int8_conv_cuda(x, wt, mult, bias, stride, padding, groups, torch.bfloat16,  # noqa: E731
                                        path=path)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[path] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print(f"  host us per call at x {tuple(x.shape)} w {tuple(wt.shape)}: wgmma {out['wgmma']:.1f} (three "
          f"cuTensorMapEncodeTiled included), mma {out['mma']:.1f}")
    return out


def int8_detector(name: str, repo: Path, checkpoint=None):
    from radet_tpu_torch import init_detector

    det = init_detector(str(repo / "configs" / "bop" / f"{name}.py"), checkpoint, device="cuda", seed=SEED)
    if checkpoint is None:
        with torch.no_grad():
            det.model.bbox_head.atss_cls.bias.zero_()
    return det


def int8_inference(name: str, gpu: str, repo: Path, imgs) -> tuple:
    """``init_detector`` and ``inference_detector`` on 8 images at full width,
    the int8 and vote-NMS launches of that run counted; the float32 forward
    of the first image on the card against the CPU's.  Returns (int8
    launches, the detector)."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.models.detector import preprocess_images

    det = int8_detector(name, repo)
    model = det.model
    icc.LAUNCHES = vnc.LAUNCHES = 0
    icc.PATH_LAUNCHES.update(dict.fromkeys(icc.PATHS, 0))
    results = inference_detector(det, imgs)
    torch.cuda.synchronize()
    launches, nms, paths = icc.LAUNCHES, vnc.LAUNCHES, dict(icc.PATH_LAUNCHES)
    print(f"  {name}: backbone.quant {model.backbone.quant!r}, bbox_head.quant {model.bbox_head.quant!r}; "
          f"inference_detector on {len(imgs)} images: int8_conv kernel launches {launches} (expected "
          f"{INT8_LAUNCHES[name]}; by path {paths}), vote_nms {nms}, detections per image "
          f"{[len(r['boxes']) for r in results]}")
    if launches != INT8_LAUNCHES[name] or nms != 1 or paths["wgmma"] != launches:
        fail(f"{name}: int8_conv launched {launches} times (by path {paths}), vote_nms {nms}, in one forward")
    for r in results:
        if not len(r["boxes"]) or not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
            fail(f"{name}: an image without detections, or non-finite ones")
    dev = torch.device("cuda")
    norm = det.cfg.img_norm_cfg
    with torch.inference_mode():
        x = preprocess_images(torch.from_numpy(imgs[0][None]).to(dev), norm.mean, norm.std, torch.float32)
        model.dtype = torch.float32
        with int8_conv_calls() as gpu_q:
            gpu_maps = [m.cpu() for maps in model(x) for m in maps]
        model.dtype = torch.bfloat16
        cpu_model = init_detector(str(repo / "configs" / "bop" / f"{name}.py"), device="cpu", seed=SEED).model
        cpu_model.load_state_dict(model.state_dict())
        with int8_conv_calls() as cpu_q:
            cpu_maps = [m for maps in cpu_model(x.cpu()) for m in maps]
    rel = max(float((g - c).abs().max() / c.abs().max().clamp(min=1e-6)) for g, c in zip(gpu_maps, cpu_maps))
    if len(gpu_q) != len(cpu_q):
        fail(f"{name}: {len(gpu_q)} int8 convs on the card, {len(cpu_q)} on the CPU")
    gpu_q, cpu_q = [a[0].cpu() for a in gpu_q], [a[0] for a in cpu_q]
    shares = [(g != c).float().mean().item() for g, c in zip(gpu_q, cpu_q)]
    flips = float(np.mean(shares))
    levels = max(int((g.int() - c.int()).abs().max()) for g, c in zip(gpu_q, cpu_q))
    first = int((gpu_q[0].int() - cpu_q[0].int()).abs().max())
    print(f"  {name}: float32 forward of one image, card vs CPU: the first int8 conv's input {shares[0]:.4%} of "
          f"elements differ (limit {INT8_FIRST_FLIPS:.1%}) by at most {first} level; all {len(gpu_q)} int8 convs' "
          f"inputs {flips:.4%} (limit {INT8_FLIPS:.0%}), by at most {levels} levels (limit {INT8_LEVELS}); head "
          f"maps' max error relative to each map's max {rel:.3g} (limit {INT8_MAP_RTOL})")
    if not (shares[0] <= INT8_FIRST_FLIPS and first <= 1 and flips <= INT8_FLIPS and levels <= INT8_LEVELS
            and rel <= INT8_MAP_RTOL):
        fail(f"{name}: the card's float32 int8 forward disagrees with the CPU's")
    return launches, paths, det


def int8_timing(gpu: str, repo: Path) -> dict:
    """ms per batch at 8 and 128 of the flagship (bf16) and INT8_TIMED, in
    this order, with the int8 launches per batch."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch import init_detector

    dev = torch.device("cuda")
    out = {}
    for name in ("r50_ycbv_pbr",) + INT8_TIMED:
        det = (init_detector(str(repo / CONFIG), device="cuda", seed=SEED) if name == "r50_ycbv_pbr"
               else int8_detector(name, repo))
        h, w = det.input_size
        for batch, iters in ((8, 20), (128, 5)):
            u8 = torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(SEED))
            shp = torch.tensor([[h, w]] * batch, dtype=torch.float32, device=dev)
            scl = torch.ones((batch, 4), dtype=torch.float32, device=dev)

            def step():
                det._infer(det.model, u8, shp, scl)

            step()
            before = icc.LAUNCHES
            step()
            per_batch = icc.LAUNCHES - before
            ms = cuda_ms(step, iters)
            out[f"{name}@{batch}"] = ms
            print(f"timing: {name} batch {batch}: {ms:.2f} ms/batch, {batch * 1000.0 / ms:.1f} img/s, int8_conv "
                  f"launches per batch {per_batch} [{gpu}]")
            del u8
        del det
        torch.cuda.empty_cache()
    return out


def int8_phase(gpu: str, repo: Path, work: str, test_opts, imgs) -> dict:
    """Phase 13: the int8 deploy family at full width.  Returns the kernels
    line's numbers."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch import BatchingDetector, inference_detector

    dev = torch.device("cuda")
    images = torch.from_numpy(np.stack(imgs)).to(dev)
    calls = {}
    for name in INT8_TIMED[1:]:
        calls.update(int8_calls(int8_detector(name, repo), images))
    by_shape = int8_kernel_by_shape(gpu, calls)
    host_us = int8_host_us(calls)
    del calls
    torch.cuda.empty_cache()

    print(f"int8: init_detector and inference_detector at full width, 480x640, bf16 (seeded random weights, cls "
          f"bias 0) [{gpu}]:")
    launches, paths = {}, {}
    for name in INT8_CONFIGS:
        launches[name], paths[name], det = int8_inference(name, gpu, repo, imgs)
        if name != INT8_MAIN:
            del det
            torch.cuda.empty_cache()
            continue
        # serve it: one full batch through BatchingDetector against inference_detector
        # on the same images (the head's dynamic absmax spans the batch, so only
        # equal batches compare)
        rng = np.random.RandomState(SEED + 22)
        batch = list(imgs) + [rng.randint(0, 256, imgs[0].shape, dtype=np.uint8) for _ in range(SERVE_INT8 - 8)]
        want = inference_detector(det, batch)
        before = icc.LAUNCHES
        with BatchingDetector(det, batch_size=SERVE_INT8, max_latency_ms=60000.0) as srv:
            futures = [srv.submit(im) for im in batch]
            got = [f.result(timeout=300) for f in futures]
        served = icc.LAUNCHES - before
        print(f"  {name} served: BatchingDetector(batch {SERVE_INT8}) on one full batch: int8_conv kernel "
              f"launches {served} (the warm-up's and the batch's)")
        compare_results(got, want, f"{name}: served against inference_detector, same batch")
        if served < INT8_LAUNCHES[name]:
            fail(f"{name}: the served batch launched int8_conv {served} times")
        del det
        torch.cuda.empty_cache()

    # the test CLI on the eval phase's PNG set and weights
    ckpt = osp.join(work, "random_cls0.pth")
    config = str(repo / "configs" / "bop" / f"{INT8_MAIN}.py")
    out = osp.join(work, "eval_int8")
    t0 = time.perf_counter()
    _, err, _ = tool_run(repo, ["-m", "radet_tpu_torch.tools.test", config, ckpt, "--eval", "bbox", "--format-only",
                                "--json-prefix", out, "--cfg-options", *test_opts], "the test CLI on an int8 config")
    cli = sum(int(n) for n in re.findall(r"int8_conv kernel launches (\d+)", err))
    with open(out + ".bbox.json") as f:
        bbox_json = json.load(f)
    print(f"int8: python -m radet_tpu_torch.tools.test {INT8_MAIN}.py --eval bbox --format-only (strict) on the "
          f"eval phase's PNG set: {time.perf_counter() - t0:.1f} s, int8_conv kernel launches {cli}, "
          f"{len(bbox_json)} COCO results")
    if cli < INT8_LAUNCHES[INT8_MAIN] or not bbox_json:
        fail("the test CLI on the int8 config launched no int8 kernel or wrote no results")

    # profile_infer --quant int8_stream at batch 128
    out_text, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.profile_infer", "--quant", "int8_stream",
                                        "--batch", 128, "--iters", 3, "--top", 1000], "profile_infer --quant")
    s = last_json(out_text)
    top = sorted(s["by_module"].items(), key=lambda kv: -kv[1]["ms"])
    int8_ms = sum(k["ms"] for k in s["top"] if any(name in k["name"] for name in icc.CUDA_KERNELS))
    print(f"tools: python -m radet_tpu_torch.tools.profile_infer --quant int8_stream --batch 128 ({wall:.1f} s): "
          f"{s['ms_per_iter']:.3f} ms per step wall, device {s['measured_ms']:.3f} ms, busy {s['busy_share']:.4f}, "
          f"int8_conv launches per step {s['int8_conv_launches_per_step']}, int8 conv kernels {int8_ms:.3f} ms per "
          f"step; by module: " + ", ".join(f"{k} {v['ms']:.3f}" for k, v in top) + f" [{gpu}]")
    if s["int8_conv_launches_per_step"] != INT8_LAUNCHES[INT8_MAIN] or not int8_ms > 0:
        fail("profile_infer --quant int8_stream: the int8 kernel's launches per step or time are off")

    # export the int8 config; its program, loaded in a fresh process, launches the kernel
    run = export_phase(config, gpu, repo, work, np.stack(imgs), name="export_int8")
    if run["int8_launches"] != [INT8_LAUNCHES[INT8_MAIN]] * EXPORT_CALLS:
        fail(f"the exported int8 program launched int8_conv {run['int8_launches']} times in {EXPORT_CALLS} calls")

    times = int8_timing(gpu, repo)
    # the kernels line: the slowest of the main path's shapes at batch 8
    main = max((r for r in by_shape.values() if r["on_main_path"]), key=lambda r: r["ms"])
    return dict(launches=launches, paths=paths[INT8_MAIN], by_shape=by_shape, host_us=host_us, main=main,
                times=times, export=run["int8_launches"])


# 14. drawing: the test CLI's --show-dir, show_bop_detbbox and browse_dataset
DRAW_GROUPS = ((4, (480, 640)),)  # the PNG test images drawn, (n, (h, w))
BROWSE_SAMPLES = 2


def draw_phase(config: str, gpu: str, work: str, train_config: str) -> int:
    """Phase 14: drawing at full width, each tool through its CLI's
    ``main``.  ``tools.test --show-dir --show-score-thr 0`` (strict eval,
    the eval phase's weights with the cls bias at 0) on a synthetic PNG
    test set, its vote-NMS launches counted: each PNG equal, decoded by
    the port, to ``imshow_det_bboxes`` of its image and the run's ``--out``
    detections and unlike the image itself, with the host ms to draw and
    to encode PNG and JPEG per image; then ``tools.show_bop_detbbox`` on
    that run's BOP json (every JPEG decodes to 480x640); then
    ``tools.browse_dataset --show-dist --show-assignment`` on the train_pbr
    split through the flagship's own pipeline, the assignment on the card,
    against this script's rebuild of each JPEG (the same seeds: the
    dataset sample, ``assign_labels`` on the card, ``draw_sample``, the
    JPEG writer), byte for byte.  Returns the test CLI's vote-NMS
    launches."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.apis.common import anchor_cfg_from_model, build_dataset
    from radet_tpu_torch.core.anchors import anchor_centers, generate_anchors
    from radet_tpu_torch.data import image_io
    from radet_tpu_torch.tools import browse_dataset, show_bop_detbbox
    from radet_tpu_torch.tools import test as test_cli
    from radet_tpu_torch.utils import Config
    from radet_tpu_torch.utils.image_write import encode_jpeg, imwrite
    from radet_tpu_torch.utils.visualization import imshow_det_bboxes
    from synthetic_bop import write_bop_test_set

    root = osp.join(work, "draw")
    cfg = Config.fromfile(config)
    ann = write_bop_test_set(root, np.random.RandomState(SEED + 14), DRAW_GROUPS, cfg.CLASS_NAMES)
    prefix = osp.join(root, "test") + "/"
    opts = [f"data.test.ann_file={ann!r}", f"data.test.img_prefix={prefix!r}"]
    shown, out = osp.join(root, "shown"), osp.join(root, "draw")
    vnc.LAUNCHES = 0
    t0 = time.perf_counter()
    test_cli.main([config, osp.join(work, "random_cls0.pth"), "--show-dir", shown, "--show-score-thr", "0",
                   "--out", out + ".pkl", "--format-only", "--json-prefix", out, "--cfg-options", *opts])
    torch.cuda.synchronize()
    launches, wall = vnc.LAUNCHES, time.perf_counter() - t0
    torch.cuda.empty_cache()
    if launches < 1:
        fail("tools.test --show-dir launched no vote_nms kernel")
    with open(out + ".pkl", "rb") as f:
        results = pickle.load(f)
    dataset = build_dataset(Config.fromfile(config, opts), "test")
    infos = {i["id"]: i for i in dataset.data_infos}
    names = sorted(i["filename"].replace("/", "_") for i in dataset.data_infos)
    if sorted(os.listdir(shown)) != names or len(results) != len(names):
        fail(f"--show-dir wrote {sorted(os.listdir(shown))}, expected {names}")
    times = {"draw": [], "PNG encode": [], "JPEG encode": []}
    n_boxes = []
    for r in results:
        name = infos[r["img_id"]]["filename"]
        img = image_io.imread_rgb(osp.join(prefix, name))
        t0 = time.perf_counter()
        want = imshow_det_bboxes(img, r["boxes"], r["labels"], r["scores"], class_names=dataset.CLASSES,
                                 score_thr=0.0)
        times["draw"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        imwrite(osp.join(root, "redraw.png"), want)
        times["PNG encode"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        encode_jpeg(want)
        times["JPEG encode"].append(time.perf_counter() - t0)
        got = image_io.imread(osp.join(shown, name.replace("/", "_")), image_io.IMREAD_UNCHANGED)
        if not np.array_equal(got, want):
            fail(f"--show-dir's {name} differs from imshow_det_bboxes in {int((got != want).any(-1).sum())} pixels")
        if np.array_equal(got, img[..., ::-1]):
            fail(f"--show-dir's {name} is the image undrawn")
        n_boxes.append(len(r["boxes"]))
    print(f"draw: tools.test --show-dir --show-score-thr 0 on {len(results)} PNG images "
          f"{DRAW_GROUPS[0][1][0]}x{DRAW_GROUPS[0][1][1]} (boxes drawn per image {n_boxes}): vote_nms kernel "
          f"launches {launches}, every PNG equal to imshow_det_bboxes of the --out detections bit for bit "
          f"(the CLI's main {wall:.1f} s wall)")
    print("timing: drawing on the host, ms per image (mean of "
          f"{len(results)}, {np.mean(n_boxes):.0f} boxes with labels): "
          + ", ".join(f"{k} {np.mean(v) * 1e3:.2f}" for k, v in times.items()) + f" [host of {gpu}]")

    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        show_bop_detbbox.main([out + ".bop.json", "--images-dir", osp.join(root, "test"), "--score-thr", "0",
                               "--output-dir", osp.join(root, "show_det")])
    wall = time.perf_counter() - t0
    written = stdout.getvalue().split()
    if len(written) != len(results):
        fail(f"show_bop_detbbox wrote {len(written)} images, expected {len(results)}")
    for path in written:
        shape = image_io.imread(path).shape
        if shape != DRAW_GROUPS[0][1] + (3,):
            fail(f"show_bop_detbbox's {path} decodes to {shape}")
    print(f"draw: tools.show_bop_detbbox --score-thr 0 wrote {len(written)} JPEGs, each decoding to "
          f"{DRAW_GROUPS[0][1]} (its main {wall:.1f} s wall)")

    browse = osp.join(root, "browse")
    random.seed(SEED)
    np.random.seed(SEED)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        browse_dataset.main([train_config, "--num", str(BROWSE_SAMPLES), "--show-dist", "--show-assignment",
                             "--output-dir", browse, "--device", "cuda"])
    wall = time.perf_counter() - t0
    random.seed(SEED)
    np.random.seed(SEED)
    tcfg = Config.fromfile(train_config)
    ds = build_dataset(tcfg, "train")
    la = tcfg.label_assignment.to_dict()
    anchors, ranges, _, _ = generate_anchors(tuple(tcfg.get("input_size", (480, 640))),
                                             anchor_cfg_from_model(tcfg.model.to_dict(), la))
    centers = anchor_centers(anchors)
    kw = {k: la[k] for k in browse_dataset.ASSIGN_KEYS if k in la}
    dev = torch.device("cuda")
    positives = []
    for i in range(BROWSE_SAMPLES):
        s = ds[i]
        gt_idx, weight = browse_dataset.assign_sample(s, torch.as_tensor(anchors, device=dev),
                                                      torch.as_tensor(ranges, device=dev), kw, seed=i)
        positives.append(int((gt_idx >= 0).sum()))
        want = encode_jpeg(browse_dataset.draw_sample(s, centers, show_dist=True, assignment=(gt_idx, weight)))
        with open(osp.join(browse, f"sample_{i:04d}.jpg"), "rb") as f:
            if f.read() != want:
                fail(f"browse_dataset's sample_{i:04d}.jpg differs from its rebuild")
    if not all(positives):
        fail(f"browse_dataset's assignment has no positive anchor: {positives}")
    print(f"draw: tools.browse_dataset --show-dist --show-assignment --device cuda on the flagship's train "
          f"pipeline: {BROWSE_SAMPLES} JPEGs, each equal byte for byte to the rebuild from the dataset sample, "
          f"assign_labels on the card (positives {positives}) and draw_sample ({wall:.1f} s wall)")
    return launches


# 15. quantization-aware training: configs/bop/r50_ycbv_pbr_int8_qat.py
QAT_CONFIG = "configs/bop/r50_ycbv_pbr_int8_qat.py"
QAT_DEPLOY = "configs/bop/r50_ycbv_pbr_int8_stream.py"
QAT_CLI_STEPS = 4
QAT_LAUNCHES = 92  # int8 convs per forward of the deploy arithmetic (int8_stream)
# The QAT float32 step, card vs CPU, is checked twice.  With the QAT convs' outputs kept in float32 (the only
# change), at the flagship's tolerances: the QAT arithmetic itself.  As it runs, with those outputs stored in
# bfloat16 (as the JAX package's): an element whose float32 sum lands on the other side of a bfloat16 rounding
# moves by up to 2^-8 of itself, so a ReLU input on the other side of 0 may be that far from it, and the
# losses and gradients move by what such steps add up to (measured on the card in four runs, at worst: ReLU
# inputs 0.000387 of their tensor's max, losses 7.2e-4, gradients 0.0179 of a tensor's max).
QAT_FLIP_RTOL = QAT_LOSS_RTOL = 2.0 ** -8
QAT_GRAD_RTOL = 0.05


def qat_step_checks(gpu: str, repo: Path) -> dict:
    """Phase 15a-b: the QAT config's float32 step at batch 1, full width, on
    the card against the CPU (``step_parity``: same weights, batch, noise,
    ReLU sides and levels; TF32 off), with the QAT convs' outputs in float32
    and then as they run (see QAT_GRAD_RTOL); its bf16 step at batch 16
    timed with its peak memory beside the flagship's in this call,
    launching no int8 kernel.  Returns the times."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch.apis.common import assignment_cfg_from
    from radet_tpu_torch.data import InMemoryBOPDataset, train_transforms
    from radet_tpu_torch.utils import Config
    from synthetic_bop import synthetic_bop_records

    cfg = Config.fromfile(str(repo / QAT_CONFIG))
    h, w = cfg.input_size
    max_gt = int(assignment_cfg_from(cfg).get("max_gt", 32))
    records = synthetic_bop_records(np.random.RandomState(SEED + 2), int(cfg.data.samples_per_gpu), (h, w))
    dataset = InMemoryBOPDataset(records, train_transforms((h, w), max_gt=max_gt, seed=SEED), max_gt=max_gt,
                                 classes=cfg.CLASS_NAMES)
    print(f"QAT: {QAT_CONFIG} (backbone {cfg.model.backbone.quant!r}, bbox_head {cfg.model.bbox_head.quant!r}, "
          f"qat), full width, {h}x{w}: straight-through fake quantization at the deploy scales, float32 convs "
          f"with TF32 off, outputs in bfloat16")
    from radet_tpu_torch.ops import quant

    quant.QAT_OUT_DTYPE = torch.float32
    try:
        step_parity(cfg, dataset, "QAT (its convs' outputs kept in float32)", gpu)
    finally:
        quant.QAT_OUT_DTYPE = torch.bfloat16
    step_parity(cfg, dataset, "QAT", gpu, QAT_FLIP_RTOL, grad_rtol=QAT_GRAD_RTOL, loss_rtol=QAT_LOSS_RTOL)
    # the flagship's step before and after the QAT step: its host-paced time moves with the host
    flagship = Config.fromfile(str(repo / CONFIG))
    flagship_ms, flagship_peak = step_ms(flagship, dataset, "flagship", gpu)
    before = icc.LAUNCHES
    qat_ms, qat_peak = step_ms(cfg, dataset, "QAT", gpu)
    step_launches = icc.LAUNCHES - before
    flagship_after_ms, _ = step_ms(flagship, dataset, "flagship, again", gpu)
    print(f"  QAT train step at batch 16, bf16: {qat_ms:.2f} ms ({qat_ms / flagship_ms:.3f}x and "
          f"{qat_ms / flagship_after_ms:.3f}x the flagship's {flagship_ms:.2f} and {flagship_after_ms:.2f} ms before "
          f"and after it), peak {qat_peak:.2f} GiB ({qat_peak / flagship_peak:.3f}x {flagship_peak:.2f}); "
          f"int8_conv launches in its 13 steps: {step_launches} [{gpu}]")
    if step_launches:
        fail(f"the QAT train step launched the int8 kernel {step_launches} times")
    return dict(qat_ms=qat_ms, qat_peak_gib=qat_peak, flagship_ms=[flagship_ms, flagship_after_ms],
                flagship_peak_gib=flagship_peak, train_step_launches=step_launches)


def counted_run(what: str, fn, per_forward: int = QAT_LAUNCHES, extra: int = 0):
    """``fn()`` with vote-NMS recorded and the trainer's log kept; the int8
    launches by kernel and the vote-NMS launches counted: ``per_forward``
    int8 launches for each vote-NMS launch and ``extra`` more, all on the
    wgmma kernel.  Returns (the log, the recorded vote-NMS calls, int8
    launches, int8 launches by path, vote-NMS launches, seconds)."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.utils import get_root_logger

    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    logs = LogLines()
    get_root_logger().addHandler(logs)
    icc.LAUNCHES = vnc.LAUNCHES = 0
    icc.PATH_LAUNCHES.update(dict.fromkeys(icc.PATHS, 0))
    t0 = time.perf_counter()
    try:
        fn()
    finally:
        postprocess.vote_nms = kernel_nms
        get_root_logger().removeHandler(logs)
    torch.cuda.synchronize()
    launches, paths, nms = icc.LAUNCHES, dict(icc.PATH_LAUNCHES), vnc.LAUNCHES
    if nms < 1 or len(calls) != nms or launches != per_forward * nms + extra or paths["wgmma"] != launches:
        fail(f"{what}: int8_conv launched {launches} times (by path {paths}) for {nms} vote_nms launches "
             f"({len(calls)} recorded); expected {per_forward} on the wgmma kernel for each and {extra} more")
    return logs.lines, calls, launches, paths, nms, time.perf_counter() - t0


@contextlib.contextmanager
def tf32_probe():
    """Within the block cuDNN's TF32 is on, as PyTorch starts (this script
    turns it off), and every QAT conv of the trunk and the head records
    the setting at its forward and, through a hook on its output, at its
    backward.  Yields the (forward, backward) lists."""
    import radet_tpu_torch.models.radet_head as head
    import radet_tpu_torch.models.resnet as resnet
    from radet_tpu_torch.ops import quant

    seen = ([], [])

    def probed(conv, x, x_scale=None):
        out = quant.qat_conv_forward(conv, x, x_scale)
        seen[0].append(torch.backends.cudnn.allow_tf32)
        if out.requires_grad:
            out.register_hook(lambda g: seen[1].append(torch.backends.cudnn.allow_tf32))
        return out

    head.qat_conv_forward = resnet.qat_conv_forward = probed
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield seen
    finally:
        torch.backends.cudnn.allow_tf32 = False
        head.qat_conv_forward = resnet.qat_conv_forward = quant.qat_conv_forward


def qat_cli_phase(files: str, gpu: str, eval_opts, test_opts, repo: Path, pbr_checkpoints: str) -> dict:
    """Phase 15c: ``tools.train`` (its ``main``, in this process, with
    cuDNN's TF32 on as PyTorch starts: ``tf32_probe``, which checks that
    the trainer turns it off for every QAT conv's forward and backward) on
    the QAT config from the JPEG ``train_pbr`` split through its own
    pipeline, full width, bf16, batch 16, QAT_CLI_STEPS steps, ``load_from``
    the flagship's from-files checkpoints (every tensor loaded), one
    periodic eval at ``score_thr`` 0 on the deploy arithmetic; then
    ``tools.test`` with QAT_DEPLOY on its checkpoint (strict).  Each run's
    int8 launches: QAT_LAUNCHES per forward, all on the wgmma kernel; its
    vote-NMS calls held to the plain version.  Returns the launches."""
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.tools import test as test_tool
    from radet_tpu_torch.tools import train as train_tool
    from synthetic_bop import write_train_config

    config = write_train_config(osp.join(files, "qat_config.py"), str(repo / QAT_CONFIG),
                                osp.join(files, "train_pbr.json"), osp.join(files, "train_pbr") + "/",
                                osp.join(files, "backgrounds"))
    work_dir = osp.join(files, "work_dir_qat")
    print(f"QAT train CLI: radet_tpu_torch.tools.train.main on {QAT_CONFIG} from train_pbr (full width, bf16, batch "
          f"16, {FILES_WORKERS} loader threads), {QAT_CLI_STEPS} steps, load_from {pbr_checkpoints}, one eval:")
    with tf32_probe() as (tf32_fwd, tf32_bwd):
        log, calls, launches, paths, nms, run_s = counted_run("the QAT train CLI's eval", lambda: train_tool.main([
            config, "--work-dir", work_dir, "--max-iters", str(QAT_CLI_STEPS), "--cfg-options",
            "log_config.interval=1", f"checkpoint_config.interval={QAT_CLI_STEPS}",
            f"evaluation.interval={QAT_CLI_STEPS}", f"data.workers_per_gpu={FILES_WORKERS}", "test_cfg.score_thr=0.0",
            *eval_opts, f"load_from={pbr_checkpoints!r}"]))
        tf32_after = torch.backends.cudnn.allow_tf32
    print(f"  cuDNN TF32 on before the run; in its QAT convs: on at {sum(tf32_fwd)} of {len(tf32_fwd)} forwards and "
          f"{sum(tf32_bwd)} of {len(tf32_bwd)} backwards; on again after it: {tf32_after}")
    if not tf32_fwd or not tf32_bwd or any(tf32_fwd) or any(tf32_bwd) or not tf32_after:
        fail("the QAT trainer did not run every QAT conv's forward and backward with cuDNN's TF32 off")
    iters = [ln for ln in log if ln.startswith("iter ")]
    evals = [ln for ln in log if ln.startswith("eval: ")]
    for ln in iters[:1] + iters[-1:] + evals:
        print(f"  {ln}")
    loaded = load_weights(pbr_checkpoints)
    after = load_weights(osp.join(work_dir, "checkpoints"))
    note = f"loaded {len(loaded)}/{len(loaded)} tensors from pretrained weights"
    history = [float(v) for ln in iters for v in re.findall(r" loss (\S+)", ln)]
    frozen = [k for k in loaded if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
    moved = max(float((after[k].float() - loaded[k].float()).abs().max()) for k in loaded
                if k.startswith(("backbone.layer4.", "bbox_head.")) and loaded[k].is_floating_point())
    if (note not in log or len(iters) != QAT_CLI_STEPS or len(history) != QAT_CLI_STEPS
            or not all(math.isfinite(v) for v in history) or len(evals) != 1
            or not all(torch.equal(after[k], loaded[k]) for k in frozen) or not moved > 0):
        fail(f"the QAT train CLI: {len(iters)} steps, losses {history}, {len(evals)} evals, every tensor loaded: "
             f"{note in log}, frozen kept, trained ones moved {moved:.3g}")
    ms = float(np.median([float(m) for ln in iters[1:] for m in re.findall(r"\| (\S+) ms/iter", ln)]))
    print(f"  {note}; frozen stem and layer1 kept, layer4 and head moved by up to {moved:.3g}; {ms:.1f} ms/step "
          f"(median of steps 2-{QAT_CLI_STEPS}), {run_s:.1f} s in all; eval: int8_conv launches {launches} (by path "
          f"{paths}), vote_nms {nms} [{gpu}]")
    train_err = hold_to_plain(calls, "the QAT train CLI's eval")

    print(f"QAT deploy: radet_tpu_torch.tools.test.main {QAT_DEPLOY} on the QAT checkpoint (strict, score_thr 0), "
          f"the eval phase's PNG set:")
    out = osp.join(files, "qat_deploy")
    _, calls, test_launches, test_paths, test_nms, test_s = counted_run("the deploy test of the QAT checkpoint",
                                                                       lambda: test_tool.main([
        str(repo / QAT_DEPLOY), osp.join(work_dir, "checkpoints"), "--eval", "bbox", "--format-only",
        "--json-prefix", out, "--cfg-options", "test_cfg.score_thr=0.0", *test_opts]))
    with open(out + ".bbox.json") as f:
        results = json.load(f)
    print(f"  {test_s:.1f} s, {len(results)} COCO results; int8_conv launches {test_launches} (by path "
          f"{test_paths}: {QAT_LAUNCHES} per forward), vote_nms {test_nms} [{gpu}]")
    if not results:
        fail("the deploy test of the QAT checkpoint wrote no results")
    test_err = hold_to_plain(calls, "the deploy test of the QAT checkpoint")
    return dict(int8=dict(train_cli_eval=launches, deploy_test=test_launches),
                nms=dict(train_cli_eval=nms, deploy_test=test_nms), max_abs_err=max(train_err, test_err), ms=ms)


def qat_phase(gpu: str, repo: Path, files: str, eval_opts, test_opts, pbr_checkpoints: str) -> dict:
    """Phase 15: quantization-aware training (``qat_step_checks``,
    ``qat_cli_phase``).  Returns the kernels line's numbers."""
    out = qat_step_checks(gpu, repo)
    out.update(qat_cli_phase(files, gpu, eval_opts, test_opts, repo, pbr_checkpoints))
    return out


# 16. frozen-stage int8 training: configs/bop/r50_ycbv_pbr_frozen_int8.py
FI8_CONFIG = "configs/bop/r50_ycbv_pbr_frozen_int8.py"
FI8_CLI_STEPS = 4
# int8 convs per train step at frozen_stages 1: conv1, conv2 and conv3 of layer1's three blocks, and its downsample
FI8_LAUNCHES = 10
FI8_TIMED_STEPS = 13  # step_ms: 3 warm-up steps, 10 timed
FI8_FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
# --frozen-int8 needs a Bottleneck trunk; 100 steps a side keep the A/B near half a minute
FI8_LEARN_ARGS = ["--depth", "50", "--frozen-int8", "--frozen-int8-iters", "100"]


def fi8_launch_checks(cfg, dataset, gpu: str) -> dict:
    """Phase 16c: one bf16 train step of the ``frozen_int8`` config at batch
    16 with its int8 convolutions recorded: exactly FI8_LAUNCHES, all on the
    wgmma kernel, each output equal bit for bit to the plain version on the
    same inputs (float64 on the card, without cuDNN); then each distinct
    shape among them timed at that batch (the step's own inputs) beside its
    bound, ``torch._int_mm`` (1x1 shapes) and the bf16 cuDNN conv.  Returns
    {"launches", "paths", "by_shape"}."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.data import collate
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
    from radet_tpu_torch.ops.quant import int8_conv_plain

    dev = torch.device("cuda")
    model, anchors, ranges, _ = build_model_and_anchors(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
    step = build_train_step(model, anchors, ranges, **step_args(cfg))
    batch = batch_to_device(collate([dataset[i] for i in range(int(cfg.data.samples_per_gpu))]), dev)
    icc.LAUNCHES = 0
    icc.PATH_LAUNCHES.update(dict.fromkeys(icc.PATHS, 0))
    with int8_conv_calls(keep_out=True) as seen:
        metrics = step(TrainState(model, tx, seed=SEED), batch)
    torch.cuda.synchronize()
    launches, paths = icc.LAUNCHES, dict(icc.PATH_LAUNCHES)
    print(f"  one bf16 train step at batch {batch['image'].shape[0]}: int8_conv launches {launches} (by path {paths}),"
          f" loss {float(metrics['loss']):.4f} [{gpu}]")
    if launches != FI8_LAUNCHES or paths["wgmma"] != launches or len(seen) != launches:
        fail(f"the frozen-int8 train step launched int8_conv {launches} times (by path {paths}, {len(seen)} "
             f"recorded); expected {FI8_LAUNCHES}, all on the wgmma kernel")
    for i, (args, out) in enumerate(seen):
        with torch.backends.cudnn.flags(enabled=False):
            want = int8_conv_plain(*args)
        if not torch.equal(out, want):
            fail(f"the frozen-int8 step's int8 conv {i} (x {tuple(args[0].shape)} w {tuple(args[1].shape)}): the "
                 f"kernel differs from the plain version in {int((out != want).sum())} elements")
    print(f"  each of the step's {launches} int8_conv outputs equals the plain version's bit for bit [{gpu}]")
    del model, tx, step, batch, metrics
    shapes = {}
    for args, _ in seen:
        shapes.setdefault((tuple(args[0].shape), tuple(args[1].shape), tuple(args[4])), args)
    del seen
    print("  N C H W -> Cout k/s | kernel ms, plain ms, bound ms (by), share, _int_mm ms, cuDNN bf16 conv ms (not "
          "the same function)")
    by_shape = {}
    for (x, wt, mult, bias, stride, padding, groups, dtype) in shapes.values():
        rest = (mult, bias, stride, padding, groups, dtype)
        label = f"{x.shape[0]} {x.shape[1]} {x.shape[2]} {x.shape[3]} -> {wt.shape[0]} {wt.shape[2]}/{stride[0]}"
        row = dict(x=list(x.shape), w=list(wt.shape), stride=stride[0],
                   path=icc.plan(x.shape, wt.shape, tuple(stride), tuple(padding), groups, 256)["path"])
        row["ms"] = device_ms(lambda: icc.int8_conv_cuda(x, wt, *rest), 20)
        with torch.backends.cudnn.flags(enabled=False):
            row["plain_ms"] = cuda_ms(lambda: int8_conv_plain(x, wt, *rest), 2)
        ho, wo = icc.conv_output_hw(x.shape[2], x.shape[3], wt.shape[2:], stride, padding)
        row["bound_ms"], row["bound_by"] = int8_bound(x.shape, wt.shape, (x.shape[0], wt.shape[0], ho, wo), stride,
                                                      padding)
        row["int_mm_ms"] = int_mm_ms(x, wt, stride, groups, 20)
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        row["cudnn_bf16_ms"] = device_ms(lambda: F.conv2d(xb, wb, None, stride, padding, 1, groups), 20)
        del xb, wb
        by_shape[label] = row
        print(f"  {label} {row['path']} | {row['ms']:.4f}, {row['plain_ms']:.3f}, {row['bound_ms']:.4f} "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%}, "
              f"{'-' if row['int_mm_ms'] is None else format(row['int_mm_ms'], '.4f')}, "
              f"{row['cudnn_bf16_ms']:.4f} [{gpu}]")
    torch.cuda.empty_cache()
    return dict(launches=launches, paths=paths, by_shape=by_shape)


def fi8_trunk_equality(cfg, gpu: str) -> None:
    """Phase 16d: the ``frozen_int8`` trunk with every stage frozen, in
    training mode, against the ``int8_stream`` trunk at eval on the same
    weights, bf16 at batch 2, 480x640, on the card: every tap bit for bit."""
    from radet_tpu_torch.models import build_backbone

    dev = torch.device("cuda")
    bb = {k: v for k, v in cfg.model.backbone.to_dict().items() if k not in ("frozen_int8", "frozen_stages")}
    train = build_backbone(dict(bb, frozen_int8=True, frozen_stages=4))
    train.init_weights(torch.Generator().manual_seed(SEED))
    deploy = build_backbone(dict(bb, quant="int8_stream", frozen_stages=4))
    deploy.load_state_dict(train.state_dict(), strict=True)
    h, w = cfg.input_size
    x = torch.randn((2, 3, h, w), generator=torch.Generator().manual_seed(SEED + 31)).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = train.to(dev).train()(x)
        want = deploy.to(dev).eval()(x)
    same = [torch.equal(g, v) for g, v in zip(got, want)]
    print(f"  the frozen_int8 trunk, every stage frozen, training mode, against the int8_stream trunk at eval "
          f"(bf16, batch 2, {h}x{w}): taps C2..C5 equal bit for bit: {same} [{gpu}]")
    if len(got) != 4 or not all(same):
        fail("the frozen_int8 training trunk differs from the int8_stream eval trunk on the card")
    del train, deploy, got, want
    torch.cuda.empty_cache()


def fi8_step_checks(gpu: str, repo: Path) -> dict:
    """Phase 16a-d: the ``frozen_int8`` config's float32 step at batch 1,
    full width, on the card against the CPU (``step_parity``: same weights,
    batch, noise, ReLU sides and int8 levels); its bf16 step at batch 16
    timed with its peak memory beside the flagship's before and after it,
    FI8_LAUNCHES int8 launches a step; ``fi8_launch_checks``;
    ``fi8_trunk_equality``.  Returns the numbers."""
    import radet_tpu_torch.ops.int8_conv_cuda as icc
    from radet_tpu_torch.apis.common import assignment_cfg_from
    from radet_tpu_torch.data import InMemoryBOPDataset, train_transforms
    from radet_tpu_torch.utils import Config
    from synthetic_bop import synthetic_bop_records

    cfg = Config.fromfile(str(repo / FI8_CONFIG))
    h, w = cfg.input_size
    max_gt = int(assignment_cfg_from(cfg).get("max_gt", 32))
    records = synthetic_bop_records(np.random.RandomState(SEED + 2), int(cfg.data.samples_per_gpu), (h, w))
    dataset = InMemoryBOPDataset(records, train_transforms((h, w), max_gt=max_gt, seed=SEED), max_gt=max_gt,
                                 classes=cfg.CLASS_NAMES)
    print(f"frozen-int8: {FI8_CONFIG} (frozen_stages {cfg.model.backbone.frozen_stages}), full width, {h}x{w}: the "
          f"frozen stem and layer1 on the int8_stream arithmetic in training, layer2 onwards in "
          f"{cfg.compute_dtype}")
    step_parity(cfg, dataset, "frozen-int8", gpu)
    flagship = Config.fromfile(str(repo / CONFIG))
    flagship_ms, flagship_peak = step_ms(flagship, dataset, "flagship", gpu)
    icc.LAUNCHES = 0
    icc.PATH_LAUNCHES.update(dict.fromkeys(icc.PATHS, 0))
    fi8_ms, fi8_peak = step_ms(cfg, dataset, "frozen-int8", gpu)
    torch.cuda.synchronize()
    timed_launches, timed_paths = icc.LAUNCHES, dict(icc.PATH_LAUNCHES)
    flagship_after_ms, _ = step_ms(flagship, dataset, "flagship, again", gpu)
    print(f"  frozen-int8 train step at batch {cfg.data.samples_per_gpu}, {cfg.compute_dtype}: {fi8_ms:.2f} ms "
          f"({fi8_ms / flagship_ms:.3f}x and "
          f"{fi8_ms / flagship_after_ms:.3f}x the flagship's {flagship_ms:.2f} and {flagship_after_ms:.2f} ms before "
          f"and after it), peak {fi8_peak:.2f} GiB ({fi8_peak / flagship_peak:.3f}x {flagship_peak:.2f}); "
          f"int8_conv launches in its {FI8_TIMED_STEPS} steps: {timed_launches} (by path {timed_paths}) [{gpu}]")
    if timed_launches != FI8_LAUNCHES * FI8_TIMED_STEPS or timed_paths["wgmma"] != timed_launches:
        fail(f"the timed frozen-int8 steps launched int8_conv {timed_launches} times (by path {timed_paths}); "
             f"expected {FI8_LAUNCHES} a step on the wgmma kernel")
    out = dict(fi8_ms=fi8_ms, fi8_peak_gib=fi8_peak, flagship_ms=[flagship_ms, flagship_after_ms],
               flagship_peak_gib=flagship_peak, timed_launches=timed_launches)
    out.update(fi8_launch_checks(cfg, dataset, gpu))
    fi8_trunk_equality(cfg, gpu)
    return out


def fi8_cli_phase(files: str, gpu: str, eval_opts, repo: Path, pbr_checkpoints: str) -> dict:
    """Phase 16e: ``tools.train`` (its ``main``, in this process) on the
    ``frozen_int8`` config from the JPEG ``train_pbr`` split through its own
    pipeline, full width, bf16, batch 16, FI8_CLI_STEPS steps, ``load_from``
    the flagship's from-files checkpoints (every tensor loaded), one
    periodic eval at ``score_thr`` 0: FI8_LAUNCHES int8 launches a step, all
    wgmma, none in the eval (its log line); the frozen tensors kept, the
    trained ones moved; the eval's vote-NMS calls held to the plain
    version.  Returns the launches."""
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.tools import train as train_tool
    from synthetic_bop import write_train_config

    config = write_train_config(osp.join(files, "fi8_config.py"), str(repo / FI8_CONFIG),
                                osp.join(files, "train_pbr.json"), osp.join(files, "train_pbr") + "/",
                                osp.join(files, "backgrounds"))
    work_dir = osp.join(files, "work_dir_fi8")
    print(f"frozen-int8 train CLI: radet_tpu_torch.tools.train.main on {FI8_CONFIG} from train_pbr (full width, bf16, "
          f"batch 16, {FILES_WORKERS} loader threads), {FI8_CLI_STEPS} steps, load_from {pbr_checkpoints}, one eval:")
    log, calls, launches, paths, nms, run_s = counted_run("the frozen-int8 train CLI", lambda: train_tool.main([
        config, "--work-dir", work_dir, "--max-iters", str(FI8_CLI_STEPS), "--cfg-options", "log_config.interval=1",
        f"checkpoint_config.interval={FI8_CLI_STEPS}", f"evaluation.interval={FI8_CLI_STEPS}",
        f"data.workers_per_gpu={FILES_WORKERS}", "test_cfg.score_thr=0.0", *eval_opts,
        f"load_from={pbr_checkpoints!r}"]), per_forward=0, extra=FI8_LAUNCHES * FI8_CLI_STEPS)
    iters = [ln for ln in log if ln.startswith("iter ")]
    evals = [ln for ln in log if ln.startswith("eval: ")]
    eval_int8 = [int(v) for ln in log for v in re.findall(r"int8_conv kernel launches (\d+)", ln)]
    for ln in iters[:1] + iters[-1:] + evals:
        print(f"  {ln}")
    loaded = load_weights(pbr_checkpoints)
    after = load_weights(osp.join(work_dir, "checkpoints"))
    note = f"loaded {len(loaded)}/{len(loaded)} tensors from pretrained weights"
    history = [float(v) for ln in iters for v in re.findall(r" loss (\S+)", ln)]
    frozen = [k for k in loaded if k.startswith(FI8_FROZEN)]
    moved = {part: max(float((after[k].float() - loaded[k].float()).abs().max()) for k in loaded
                       if k.startswith(part) and loaded[k].is_floating_point())
             for part in ("backbone.layer2.", "backbone.layer4.", "bbox_head.")}
    if (note not in log or len(iters) != FI8_CLI_STEPS or len(history) != FI8_CLI_STEPS
            or not all(math.isfinite(v) for v in history) or len(evals) != 1 or eval_int8 != [0]
            or after.keys() != loaded.keys() or not all(torch.equal(after[k], loaded[k]) for k in frozen)
            or not all(v > 0 for v in moved.values())):
        fail(f"the frozen-int8 train CLI: {len(iters)} steps, losses {history}, {len(evals)} evals with int8 "
             f"launches {eval_int8}, every tensor loaded: {note in log}, frozen kept, trained ones moved {moved}")
    ms = float(np.median([float(m) for ln in iters[1:] for m in re.findall(r"\| (\S+) ms/iter", ln)]))
    print(f"  {note}; frozen stem and layer1 kept ({len(frozen)} tensors), moved by up to "
          + ", ".join(f"{k[:-1]} {v:.3g}" for k, v in moved.items())
          + f"; {ms:.1f} ms/step (median of steps 2-{FI8_CLI_STEPS}), {run_s:.1f} s in all; int8_conv launches "
          f"{launches} (by path {paths}: {FI8_LAUNCHES} per step, {eval_int8[0]} in the eval), vote_nms {nms} [{gpu}]")
    err = hold_to_plain(calls, "the frozen-int8 train CLI's eval")
    return dict(int8=dict(train_cli=launches, train_cli_eval=eval_int8[0]), nms=dict(train_cli_eval=nms),
                max_abs_err=err, cli_ms=ms)


def fi8_profile(gpu: str, repo: Path) -> dict:
    """Phase 16f: ``tools.profile_train --frozen-int8 --step-only`` at batch
    16: FI8_LAUNCHES int8 launches in a step, all on the wgmma kernel."""
    out, _, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.profile_train", "--frozen-int8", "--step-only",
                                   "--batch", 16, "--iters", 10], "profile_train --frozen-int8")
    s = json.loads(out[out.index("{"):])
    print(f"  python -m radet_tpu_torch.tools.profile_train --frozen-int8 --step-only --batch 16 --iters 10 "
          f"({wall:.1f} s): step {s['step_ms']:.3f} ms ({s['img_per_s']:.1f} img/s), {s['step_tflops']:.4f} TFLOP "
          f"per step, MFU {s['mfu']:.4f}; int8_conv launches per step {s['int8_launches_per_step']} (by path "
          f"{s['int8_launches_by_path']}) [{s['device']}]")
    if (not s["frozen_int8"] or s["int8_launches_per_step"] != FI8_LAUNCHES
            or s["int8_launches_by_path"]["wgmma"] != FI8_LAUNCHES):
        fail(f"profile_train --frozen-int8: {s['int8_launches_per_step']} int8 launches a step (by path "
             f"{s['int8_launches_by_path']}); expected {FI8_LAUNCHES} on the wgmma kernel")
    return s


def fi8_learning(gpu: str) -> dict:
    """Phase 16g: ``python -m radet_tpu_torch.tools.validate_learning`` with
    FI8_LEARN_ARGS, in this process: RADet-R50 from scratch (400 steps at
    batch 4, 128x160, live BN) and its strict eval, mAP50 at least
    LEARN_MIN_MAP50; then the A/B, two fine-tunes of the float weights with
    the stem and layer1 frozen, one with ``frozen_int8``, each evaluated on
    the float path: FI8_LAUNCHES int8 launches in each ``frozen_int8`` step,
    all on the wgmma kernel, none in the evals; the first vote-NMS call held
    to the plain version.  Returns the launches and the A/B."""
    from radet_tpu_torch.tools import validate_learning

    args = validate_learning.parse_args(FI8_LEARN_ARGS)
    metrics, iters, calls, launches, int8_launches, int8_paths, eval_int8, wall = validate_learning_run(
        FI8_LEARN_ARGS)
    ab = metrics["frozen_int8"]
    delta = {k: ab["frozen-int8"][f"bbox_{k}"] - ab["frozen-float"][f"bbox_{k}"] for k in ("mAP_50", "mAP")}
    print(f"  python -m radet_tpu_torch.tools.validate_learning {' '.join(FI8_LEARN_ARGS)} ({args.iters} steps, "
          f"batch {args.batch}, {args.img_size[0]}x{args.img_size[1]}, RADet-R{args.depth} from scratch, "
          f"norm_eval=False, {args.dtype}; then two {args.frozen_int8_iters}-step frozen fine-tunes, float and "
          f"frozen_int8): mAP50 {metrics['bbox_mAP_50']:.4f}, mAP {metrics['bbox_mAP']:.4f}; "
          + ", ".join(f"{k} mAP50 {m['bbox_mAP_50']:.4f} mAP {m['bbox_mAP']:.4f}" for k, m in ab.items())
          + f" (frozen-int8 - frozen-float: mAP50 {delta['mAP_50']:+.4f}, mAP {delta['mAP']:+.4f}); {wall:.1f} s "
          f"wall (scenes, three trainings and three evals); vote_nms kernel launches {launches}, int8_conv "
          f"{int8_launches} (by path {int8_paths}, {eval_int8} in the evals) [{gpu}]")
    for ln in iters[-1:]:
        print(f"    {ln}")
    if (eval_int8 or int8_launches != FI8_LAUNCHES * args.frozen_int8_iters
            or int8_paths["wgmma"] != int8_launches):
        fail(f"validate_learning --frozen-int8 launched int8_conv {int8_launches} times (by path {int8_paths}, "
             f"{eval_int8} in the evals); expected {FI8_LAUNCHES} a frozen_int8 step on the wgmma kernel, none in "
             f"the evals")
    err = hold_to_plain(calls[:1], "validate_learning --frozen-int8's eval, its first batch")
    del calls
    return dict(nms=launches, int8=int8_launches, max_abs_err=err, delta=delta,
                arms={k: {m: v[f"bbox_{m}"] for m in ("mAP_50", "mAP")} for k, v in ab.items()}, wall_s=wall)


def fi8_phase(gpu: str, repo: Path, files: str, eval_opts, pbr_checkpoints: str) -> dict:
    """Phase 16: frozen-stage int8 training (``fi8_step_checks``,
    ``fi8_cli_phase``, ``fi8_profile``, ``fi8_learning``).  Returns the
    kernels line's numbers."""
    out = fi8_step_checks(gpu, repo)
    out.update(fi8_cli_phase(files, gpu, eval_opts, repo, pbr_checkpoints))
    out["profile_train"] = fi8_profile(gpu, repo)
    out["learning"] = fi8_learning(gpu)
    return out


# 17. the eval path's test-time variants: flip and multi-scale TTA, --fuse-conv-bn, nms_impl='scan'
TTA_GROUPS = ((16, (480, 640)), (16, (540, 720)))  # landscape images of the eval phase's set, 2 batches of 16
TTA_BATCH = 16
TTA_SCALES = [(640, 480), (800, 600)]  # (w, h): the flagship's scale and a larger one (padded to 608x800)
TTA_FUSE_RTOL = 1e-4  # fused vs unfused float32 head maps on the card, TF32 off, of each map's max
# the vote-NMS calls a batch of each run makes, by K: the views' at the strict eval's K and the fusion's;
# the strict eval runs first and last, the first a warm-up of the loader and the convolutions' shapes
TTA_RUNS = {
    "strict": ([], [], {2048: 1}),
    "flip_tta": ([], ["test_cfg.flip_tta=True"], {2048: 2, 200: 1}),
    "multiscale_flip_tta": ([], [f"test_cfg.tta.scales={TTA_SCALES}", "test_cfg.tta.flip=True"],
                            {2048: 2 * len(TTA_SCALES), 200 * len(TTA_SCALES): 1}),
    "fuse_conv_bn": (["--fuse-conv-bn"], [], {2048: 1}),
    "nms_impl_scan": ([], ["test_cfg.nms_impl='scan'"], {4420: 1}),  # every candidate: 4 x 1000 + 420
}


def tta_test_set(work: str):
    """The config options reading TTA_GROUPS's images of the eval phase's
    PNG set (its landscape images: TTA's views have no orientation views)
    as data.test, in batches of TTA_BATCH."""
    with open(osp.join(work, "test.json")) as f:
        coco = json.load(f)
    keep = []
    for n, hw in TTA_GROUPS:
        keep += [i for i in coco["images"] if (i["height"], i["width"]) == hw][:n]
    ids = {i["id"] for i in keep}
    subset = dict(coco, images=keep, annotations=[a for a in coco["annotations"] if a["image_id"] in ids])
    path = osp.join(work, "tta.json")
    with open(path, "w") as f:
        json.dump(subset, f)
    return [f"data.test.ann_file={path!r}", f"data.test.img_prefix={osp.join(work, 'test') + '/'!r}",
            f"data.samples_per_gpu={TTA_BATCH}"]


def tta_cli(repo: Path, config: str, ckpt: str, work: str, name: str, opts) -> dict:
    """``tools.test --eval bbox`` (its ``main``, in this process) for one of
    TTA_RUNS, its vote-NMS calls recorded and counted by K against the
    run's expected calls, each held to the plain version in float64, its
    detections and metrics checked.  Returns its numbers and its calls."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc

    flags, extra, per_batch = TTA_RUNS[name]
    n = sum(n for n, _ in TTA_GROUPS)
    want_k = {k: c * -(-n // TTA_BATCH) for k, c in per_batch.items()}
    out = osp.join(work, f"tta_{name}.pkl")
    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    vnc.LAUNCHES = 0
    try:
        stdout, log, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.test", config, ckpt, "--eval", "bbox",
                                            "--out", out, *flags, "--cfg-options", *opts, *extra], f"tools.test {name}")
    finally:
        postprocess.vote_nms = kernel_nms
    torch.cuda.synchronize()
    launches = vnc.LAUNCHES
    metrics = json.loads(stdout[stdout.index("{"):])
    with open(out, "rb") as f:
        results = pickle.load(f)
    done = [ln for ln in log.splitlines() if ln.startswith("inference done")]
    by_k = {}
    for args, _, _ in calls:
        by_k[int(args[0].shape[1])] = by_k.get(int(args[0].shape[1]), 0) + 1
    ok = (len(results) == n and all(len(r["boxes"]) and np.isfinite(r["boxes"]).all() for r in results)
          and all(math.isfinite(v) for v in metrics.values()))
    if launches < 1 or launches != len(calls) or by_k != want_k or len(done) != 1 or not ok:
        fail(f"tools.test {name}: vote_nms launches {launches} ({len(calls)} recorded, by K {by_k}, expected "
             f"{want_k}), {len(results)} results for {n} images, finite detections and metrics: {ok}")
    ips = float(re.findall(r"\(([\d.]+) img/s\)", done[0])[0])
    fused = [int(v) for v in re.findall(r"folded (\d+) frozen BNs", log)]
    print(f"  {name} ({' '.join(flags + extra) or 'strict'}): {done[0]}; {wall:.1f} s in all (model build and "
          f"COCO evaluation included); vote_nms launches by K {by_k}; bbox_mAP {metrics['bbox_mAP']:.4f}"
          + (f"; folded {fused[0]} BNs" if fused else ""))
    err = hold_to_plain(calls, f"tools.test {name}")
    return dict(launches=launches, by_k=by_k, max_abs_err=err, img_s=ips, wall_s=wall, fused=fused,
                metrics=metrics, calls=calls)


def fused_forward_check(config: str, ckpt: str, gpu: str) -> tuple:
    """The flagship's float32 forward on the card, TF32 off, with the
    checkpoint's weights and with them folded (``models/fuse.py``), on two
    random normalized 480x640 images: every head map within TTA_FUSE_RTOL
    of its max.  Returns (the largest error, the folded BNs)."""
    import copy

    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.engine import load_weights
    from radet_tpu_torch.models.fuse import fuse_conv_bn
    from radet_tpu_torch.utils import Config

    dev = torch.device("cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the fused and unfused float32 forwards would differ by its rounding")
    cfg = Config.fromfile(config)
    model = build_model_and_anchors(cfg, dtype="float32")[0]
    model.load_state_dict(load_weights(ckpt), strict=True)
    model.to(dev).eval()
    fused = copy.deepcopy(model)
    weights, report = fuse_conv_bn(model.state_dict())
    fused.load_state_dict(weights, strict=True)
    x = torch.randn((2, 3) + tuple(cfg.input_size), device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        want = [m for maps in model(x) for m in maps]
        got = [m for maps in fused(x) for m in maps]
    err = max(float((g - w).abs().max() / max(float(w.abs().max()), 1e-30)) for g, w in zip(got, want))
    print(f"  --fuse-conv-bn: {report['fused']} BNs folded ({report['skipped']} left), float32 forward on the card "
          f"with TF32 off, fused vs unfused head maps: max error {err:.3g} of each map's max (limit "
          f"{TTA_FUSE_RTOL}) [{gpu}]")
    if err > TTA_FUSE_RTOL or report["fused"] != 53 or report["skipped"]:
        fail(f"--fuse-conv-bn: fused forward off by {err:.3g}, or {report} is not the ResNet-50's 53 BNs")
    del model, fused
    torch.cuda.empty_cache()
    return err, report["fused"]


def tta_phase(config: str, gpu: str, repo: Path, work: str) -> dict:
    """Phase 17: the eval path's test-time variants on the eval phase's PNG
    set (TTA_GROUPS) and weights (random, cls bias 0), each through the
    test CLI's ``main``, full width, bf16, strict: the plain strict eval,
    flip TTA, multi-scale (TTA_SCALES) + flip TTA, ``--fuse-conv-bn`` and
    ``nms_impl='scan'`` (TTA_RUNS: every vote-NMS call counted by K and
    held to the plain version), then the strict eval again (its img/s the
    others' yardstick); the fused float32 forward against the
    unfused one; the fusion's kernel timed at its (B, K) beside the plain
    version and the bound.  Returns the kernels line's numbers."""
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    opts = tta_test_set(work)
    ckpt = osp.join(work, "random_cls0.pth")
    n = sum(n for n, _ in TTA_GROUPS)
    print(f"tta: radet_tpu_torch.tools.test.main on {n} PNG images of the eval set "
          f"({', '.join(f'{k} at {h}x{w}' for k, (h, w) in TTA_GROUPS)}), batch {TTA_BATCH}, strict, full width, "
          f"bf16:")
    runs = {name: tta_cli(repo, config, ckpt, work, name, opts) for name in TTA_RUNS}
    runs["strict_last"] = tta_cli(repo, config, ckpt, work, "strict", opts)
    fuse_err, folded = fused_forward_check(config, ckpt, gpu)
    base = runs["strict_last"]["img_s"]
    print(f"timing: eval img/s over {n} images (inference, files to detections, batch {TTA_BATCH}): strict "
          f"{base:.1f} (run last; {runs['strict']['img_s']:.1f} run first); "
          + "; ".join(f"{k} {r['img_s']:.1f} ({r['img_s'] / base:.2f}x)" for k, r in runs.items()
                      if not k.startswith("strict"))
          + f" [{gpu}]")
    # the fusion's and the scan's kernel calls timed against the plain version, beside the bound
    timing = {}
    for name, k in (("flip_tta", 200), ("multiscale_flip_tta", 200 * len(TTA_SCALES)), ("nms_impl_scan", 4420)):
        args, kw, _ = next(c for c in runs[name]["calls"] if int(c[0][0].shape[1]) == k)
        kernel_ms, plain_ms, _, _ = alternate_ms(lambda: vnc.vote_nms_cuda(*args, **kw),
                                                 lambda: vote_nms_plain(*args, **kw), 50, 3)
        bound_ms, bound_by, _, _ = nms_bound(args, kw["max_out"])
        key = f"B={args[0].shape[0]},K={k}"
        timing[name] = dict(shape=key, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing: vote_nms {'fusion' if k < 2048 else 'scan'} of {name} at {key} "
              f"({int(args[4].sum())} valid candidates): kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by} ({bound_ms / kernel_ms:.2%}) [{gpu}]")
    for r in runs.values():
        del r["calls"]
    torch.cuda.empty_cache()
    return dict(runs=runs, fuse_err=fuse_err, folded=folded, timing=timing)


MF_STEPS = 12  # the mask-free train CLI's steps (full width, batch 16), one periodic eval at the last
MF_LOADER_BATCHES = 4  # batches timed from the mask-free loader alone, after its first
MF_TWIN_IMAGES = 2  # training images whose large boxes' crops hold the C++ transforms to their numpy twins
MF_SAMPLES = 16  # samples timed per pipeline, one thread
ITODD_CONFIG = "configs/bop/r50_itodd_pbr.py"
ITODD_IMAGES = 32  # 1280x960 8-bit gray TIFFs (BOP ITODD's test images), batches of 16
ITODD_HW = (960, 1280)
ITODD_BATCH = 16


def mf_twin(job):
    """One crop's transform, the C++ function against its numpy twin (run in
    a process of its own): (method, crop shape, max abs difference, equal)."""
    from radet_tpu_torch.ops import distance_transform as dt

    method, small = job
    sx, sy = dt.border_seeds(*small.shape[:2])
    if method == "mbd":
        a, b = dt.mbd(small, sx, sy), dt.mbd_plain(small, sx, sy)
    else:
        cost = dt.sobel_edges(small)
        a, b = dt.gdt(cost, sx, sy), dt.gdt_plain(cost, sx, sy)
    return method, small.shape[:2], float(np.abs(a - b).max()), bool(np.array_equal(a, b))


def mf_twin_checks(files: str, gpu: str) -> dict:
    """Phase 18a: the crops of the first MF_TWIN_IMAGES training images'
    large boxes (padded, resized to a short edge of 150, blurred: the
    transforms' input), each through the C++ MBD and GDT and their numpy
    twins (spawned processes, one crop each), bit for bit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from radet_tpu_torch.data import image_io
    from radet_tpu_torch.ops import distance_transform as dt

    with open(osp.join(files, "train_pbr.json")) as f:
        coco = json.load(f)
    jobs = []
    for info in coco["images"][:MF_TWIN_IMAGES]:
        img = image_io.imread_rgb(osp.join(files, "train_pbr", info["file_name"]))
        for ann in (a for a in coco["annotations"] if a["image_id"] == info["id"]):
            x, y, w, h = (int(v) for v in ann["bbox"])
            if (w + 1) * (h + 1) > 32 ** 2:
                small = dt.shrink(dt.padded_crop(img, (x, y, x + w, y + h), 0.05, (128, 128, 128))[0])
                jobs += [("mbd", small), ("gdt", small)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(8, len(jobs)), mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(mf_twin, jobs))
    out = {m: dict(crops=sum(r[0] == m for r in results), max_abs_diff=max(r[2] for r in results if r[0] == m))
           for m in ("mbd", "gdt")}
    shapes = sorted({r[1] for r in results})
    print(f"mask-free: C++ MBD and GDT against their numpy twins on {len(jobs) // 2} crops of {MF_TWIN_IMAGES} "
          f"training images (padded boxes at a short edge of 150: {shapes[0]} to {shapes[-1]}): "
          + ", ".join(f"{m} {v['crops']} crops, max |C++ - twin| {v['max_abs_diff']:.3g}" for m, v in out.items())
          + f"; {time.perf_counter() - t0:.1f} s on {min(8, len(jobs))} processes [host of {gpu}]")
    if not jobs or not all(r[3] for r in results):
        fail(f"the C++ distance transforms differ from their numpy twins: {[r[:3] for r in results if not r[3]]}")
    return out


def mf_pipeline_timing(configs: dict, gpu: str) -> dict:
    """Phase 18b: ms per sample on one thread at 480x640 of the flagship's
    train pipeline (masks) and of its mask-free GDT and MBD variants, and of
    their GenerateDistanceMap alone, over the same MF_SAMPLES samples."""
    from radet_tpu_torch.apis.common import build_dataset
    from radet_tpu_torch.utils import Config

    out = {}
    for name, path in configs.items():
        dataset = build_dataset(Config.fromfile(path), "train")
        gdm = next(i for i, t in enumerate(dataset.pipeline.transforms)
                   if type(t).__name__ == "GenerateDistanceMap")
        inner, spent = dataset.pipeline.transforms[gdm], [0.0]

        def timed(results, inner=inner, spent=spent):
            t0 = time.perf_counter()
            out = inner(results)
            spent[0] += time.perf_counter() - t0
            return out

        dataset.pipeline.transforms[gdm] = timed
        random.seed(SEED)
        np.random.seed(SEED)
        dataset[0]  # first call: libraries loaded, backgrounds cached
        spent[0] = 0.0
        t0 = time.perf_counter()
        for i in range(MF_SAMPLES):
            dataset[i % len(dataset)]
        out[name] = dict(ms=(time.perf_counter() - t0) * 1000 / MF_SAMPLES, map_ms=spent[0] * 1000 / MF_SAMPLES)
    base = out["masked"]["ms"]
    print(f"timing: train pipeline at 480x640, one thread, ms per sample (mean of {MF_SAMPLES}; GenerateDistanceMap "
          f"alone in brackets): " + "; ".join(f"{k} {v['ms']:.2f} ({v['map_ms']:.2f}, {v['ms'] / base:.2f}x)"
                                              for k, v in out.items()) + f" [host of {gpu}]")
    return out


def mf_cli_phase(config: str, gpu: str, eval_opts) -> dict:
    """Phase 18c: ``tools.train`` (its ``main``, in this process) on the
    mask-free GDT config at full width, bf16, batch 16, FILES_WORKERS
    loader threads, MF_STEPS steps and one periodic eval (K = 512) at
    ``score_thr`` 0: finite losses, a checkpoint, and every vote-NMS call
    of the eval held to the plain version.  Returns its numbers."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.engine import load_weights

    repo = Path(__file__).resolve().parent
    work_dir = osp.join(osp.dirname(config), "work_dir_mask_free")
    print(f"mask-free train CLI: radet_tpu_torch.tools.train.main on {CONFIG} from boxes alone "
          f"(GenerateDistanceMap(with_gt_mask=False, distance_transform='gdt'); full width, bf16, batch 16, "
          f"{FILES_WORKERS} loader threads), {MF_STEPS} steps, one eval:")
    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    vnc.LAUNCHES = 0
    try:
        _, log, wall = tool_run(repo, ["-m", "radet_tpu_torch.tools.train", config, "--work-dir", work_dir,
                                       "--max-iters", MF_STEPS, "--cfg-options", "log_config.interval=1",
                                       f"checkpoint_config.interval={MF_STEPS}", f"evaluation.interval={MF_STEPS}",
                                       f"data.workers_per_gpu={FILES_WORKERS}", "test_cfg.score_thr=0.0",
                                       *eval_opts], "the mask-free train CLI")
    finally:
        postprocess.vote_nms = kernel_nms
    torch.cuda.synchronize()
    launches = vnc.LAUNCHES
    log = log.splitlines()
    iters = [ln for ln in log if ln.startswith("iter ")]
    evals = [ln for ln in log if ln.startswith("eval: ")]
    history = [float(v) for ln in iters for v in re.findall(r" loss (\S+)", ln)]
    ks = sorted({int(a[0].shape[1]) for a, _, _ in calls})
    for ln in iters[:1] + iters[-1:] + evals:
        print(f"  {ln}")
    if (len(iters) != MF_STEPS or len(history) != MF_STEPS or not all(math.isfinite(v) for v in history)
            or len(evals) != 1 or launches < 1 or launches != len(calls) or ks != [512]
            or not load_weights(osp.join(work_dir, "checkpoints"))):
        fail(f"the mask-free train CLI: {len(iters)} steps, losses {history}, {len(evals)} evals, vote_nms "
             f"launches {launches} ({len(calls)} recorded at K {ks}), or no checkpoint")
    per_step = [float(m) for ln in iters for m in re.findall(r"\| (\S+) ms/iter", ln)]
    waits = [float(m) for ln in iters for m in re.findall(r"data wait (\S+) ms/iter", ln)]
    ms = float(np.median(per_step[1:]))
    print(f"  each step, ms (data wait ms): " + ", ".join(f"{a:.1f} ({w:.1f})" for a, w in zip(per_step, waits)))
    print(f"  {MF_STEPS} steps, {ms:.1f} ms/step (median of steps 2-{MF_STEPS}), data wait {sum(waits[1:]):.1f} of "
          f"{sum(per_step[1:]):.1f} ms over steps 2-{MF_STEPS}, {wall:.1f} s in all (model build and eval included); "
          f"vote_nms launches {launches} at K {ks} [{gpu}]")
    err = hold_to_plain(calls, "the mask-free train CLI's eval")
    return dict(launches=launches, max_abs_err=err, step_ms=ms, step_ms_each=per_step, data_wait_ms_each=waits,
                wall_s=wall)


def mf_step_parts(config: str, gpu: str) -> dict:
    """Phase 18d: the two halves of the mask-free train CLI's step, each
    alone: the train step on one batch already on the card (``step_ms``),
    and the loader (FILES_WORKERS threads, batch 16, no step running) in ms
    per batch over MF_LOADER_BATCHES batches after its first."""
    from radet_tpu_torch.apis.common import build_dataset
    from radet_tpu_torch.data.loader import DataLoader
    from radet_tpu_torch.utils import Config

    cfg = Config.fromfile(config)
    dataset = build_dataset(cfg, "train")
    bare_ms, _ = step_ms(cfg, dataset, "mask-free gdt", gpu)
    batch = int(cfg.data.samples_per_gpu)
    it = iter(DataLoader(dataset, batch_size=batch, num_workers=FILES_WORKERS, seed=SEED, infinite=True))
    next(it)
    t0 = time.perf_counter()
    for _ in range(MF_LOADER_BATCHES):
        next(it)
    loader_ms = (time.perf_counter() - t0) * 1000 / MF_LOADER_BATCHES
    it.close()
    print(f"timing: mask-free gdt loader alone, {FILES_WORKERS} threads, batch {batch}: {loader_ms:.1f} ms/batch "
          f"({batch * 1000 / loader_ms:.1f} img/s; mean of {MF_LOADER_BATCHES} after the first) [host of {gpu}]")
    return dict(bare_step_ms=bare_ms, loader_ms=loader_ms)


def mask_free_phase(files: str, gpu: str, eval_opts) -> dict:
    """Phase 18: the mask-free distance maps (ROADMAP item 17)."""
    from synthetic_bop import write_train_config

    twins = mf_twin_checks(files, gpu)
    ann, prefix, bg = osp.join(files, "train_pbr.json"), osp.join(files, "train_pbr") + "/", osp.join(files, "backgrounds")
    repo = Path(__file__).resolve().parent
    configs = {"masked": osp.join(files, "train_config.py")}
    for method in ("gdt", "mbd"):
        configs[f"mask-free {method}"] = write_train_config(osp.join(files, f"mask_free_{method}.py"),
                                                            str(repo / CONFIG), ann, prefix, bg, mask_free=method)
    timing = mf_pipeline_timing(configs, gpu)
    cli = mf_cli_phase(configs["mask-free gdt"], gpu, eval_opts)
    parts = mf_step_parts(configs["mask-free gdt"], gpu)
    return dict(twins=twins, pipeline=timing, **cli, **parts)


def itodd_fixture_checks(gpu: str) -> int:
    """Phase 19a: the committed TIFF fixtures (tests/data/tiff: tiles,
    big-endian files, the predictor) decoded here under the three flags
    against cv2's recorded SHA-256 (this machine has no cv2)."""
    import hashlib

    from radet_tpu_torch.data import image_io

    fixtures = Path(__file__).resolve().parent / "tests" / "data" / "tiff"
    with open(fixtures / "hashes.json") as f:
        recorded = json.load(f)
    n = 0
    for name, reads in sorted(recorded["files"].items()):
        for flag, want in reads.items():
            px = image_io.imread(str(fixtures / name), recorded["flags"][flag])
            px = px[..., ::-1] if flag == "color" else px
            got = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
            if got != want["sha256"] or list(px.shape) != want["shape"] or str(px.dtype) != want["dtype"]:
                fail(f"TIFF fixture {name} read {flag} differs from cv2 {recorded['cv2']}'s recorded pixels")
            n += 1
    print(f"itodd: {len(recorded['files'])} committed TIFF fixtures, {n} reads (IMREAD_UNCHANGED, COLOR, GRAYSCALE) "
          f"equal to cv2 {recorded['cv2']}'s recorded SHA-256")
    return n


def itodd_decode_timing(root: str, ann: str, gpu: str) -> dict:
    """Phase 19b: ms per 1280x960 gray image to read (``imread_rgb``, one
    thread): the split's Deflate TIFF, the same pixels as an uncompressed
    TIFF and as a PNG."""
    from radet_tpu_torch.data import image_io
    from synthetic_bop import tiff_bytes, write_png

    with open(ann) as f:
        first = json.load(f)["images"][0]["file_name"]
    path = osp.join(root, "test", first)
    gray = image_io.imread(path, image_io.IMREAD_GRAYSCALE)
    paths = {"tiff_deflate": path, "tiff_none": osp.join(root, "none.tif"), "png": osp.join(root, "same.png")}
    with open(paths["tiff_none"], "wb") as f:
        f.write(tiff_bytes(gray, compression=1))
    write_png(paths["png"], gray)
    out = {}
    for name, p in paths.items():
        if not np.array_equal(image_io.imread_rgb(p)[..., 1], gray):
            fail(f"{name}: the decoded pixels differ")
        t0 = time.perf_counter()
        for _ in range(10):
            image_io.imread_rgb(p)
        out[name] = (time.perf_counter() - t0) * 100
    print("timing: imread_rgb of a 1280x960 gray image, one thread, mean of 10: "
          + ", ".join(f"{k} ({os.path.getsize(paths[k]) // 1024} KB) {v:.2f} ms" for k, v in out.items())
          + f" [host of {gpu}]")
    return out


def itodd_phase(gpu: str, work: str) -> dict:
    """Phase 19: the ITODD config's strict test CLI on gray TIFFs (ROADMAP
    item 20): the fixtures; ITODD_IMAGES synthetic 1280x960 gray Deflate
    TIFFs of 28 classes in BOP's layout; ``tools.test`` (its ``main``) with
    ``configs/bop/r50_itodd_pbr.py`` at full width, bf16, seeded random
    weights with the cls bias at 0, batch ITODD_BATCH, ``--eval bbox``
    with the BOP json: one vote-NMS launch per batch at K = 2048, each held
    to the plain version; results, metrics and the json checked."""
    import radet_tpu_torch.models.postprocess as postprocess
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.engine import save_weights
    from radet_tpu_torch.utils import Config
    from synthetic_bop import write_bop_test_set

    repo = Path(__file__).resolve().parent
    fixtures = itodd_fixture_checks(gpu)
    root = osp.join(work, "itodd")
    t0 = time.perf_counter()
    ann = write_bop_test_set(root, np.random.RandomState(SEED + 20), [(ITODD_IMAGES, ITODD_HW)],
                             [str(i + 1) for i in range(28)], tiff_gray=True)
    print(f"itodd: {ITODD_IMAGES} gray 8-bit Deflate TIFFs {ITODD_HW[0]}x{ITODD_HW[1]} (BOP ITODD's test layout, "
          f"28 classes) written in {time.perf_counter() - t0:.1f} s")
    decode = itodd_decode_timing(root, ann, gpu)
    config = str(repo / ITODD_CONFIG)
    model = build_model_and_anchors(Config.fromfile(config))[0]
    model.init_weights(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()
    ckpt = osp.join(work, "itodd_cls0.pth")
    save_weights(ckpt, model.state_dict())
    del model
    prefix, out = osp.join(root, "result"), osp.join(root, "result.pkl")
    calls = []
    kernel_nms, postprocess.vote_nms = recorded_vote_nms(calls)
    vnc.LAUNCHES = 0
    try:
        stdout, log, wall = tool_run(repo, [
            "-m", "radet_tpu_torch.tools.test", config, ckpt, "--eval", "bbox", "--json-prefix", prefix,
            "--out", out, "--cfg-options", f"data.test.ann_file={ann!r}",
            f"data.test.img_prefix={osp.join(root, 'test') + '/'!r}", f"data.samples_per_gpu={ITODD_BATCH}"],
            "tools.test on the ITODD config")
    finally:
        postprocess.vote_nms = kernel_nms
    torch.cuda.synchronize()
    launches = vnc.LAUNCHES
    metrics = json.loads(stdout[stdout.index("{"):])
    with open(out, "rb") as f:
        results = pickle.load(f)
    with open(prefix + ".bop.json") as f:
        bop = json.load(f)
    done = [ln for ln in log.splitlines() if ln.startswith("inference done")]
    ks = [int(a[0].shape[1]) for a, _, _ in calls]
    want = -(-ITODD_IMAGES // ITODD_BATCH)
    ok = (len(results) == ITODD_IMAGES and all(len(r["boxes"]) and np.isfinite(r["boxes"]).all() for r in results)
          and all(math.isfinite(v) for v in metrics.values()) and len(bop) == sum(len(r["boxes"]) for r in results)
          and all(1 <= d["category_id"] <= 28 and d["time"] == -1.0 for d in bop))
    if launches != want or len(calls) != want or set(ks) != {2048} or len(done) != 1 or not ok:
        fail(f"tools.test on the ITODD config: vote_nms launches {launches} ({len(calls)} recorded at K {ks}; "
             f"expected {want} at 2048), {len(results)} results, {len(bop)} BOP json entries, finite: {ok}")
    ips = float(re.findall(r"\(([\d.]+) img/s\)", done[0])[0])
    print(f"  {done[0]}; {wall:.1f} s in all (model build, decode and COCO evaluation included); vote_nms launches "
          f"{launches} at K {sorted(set(ks))}; {len(bop)} BOP json entries; bbox_mAP {metrics['bbox_mAP']:.4f} [{gpu}]")
    err = hold_to_plain(calls, "tools.test on the ITODD config")
    return dict(launches=launches, max_abs_err=err, img_s=ips, wall_s=wall, decode_ms=decode, fixture_reads=fixtures)


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

    import radet_tpu_torch.ops.int8_conv_cuda as icc
    import radet_tpu_torch.ops.vote_nms_cuda as vnc
    from radet_tpu_torch import inference_detector, init_detector
    from radet_tpu_torch.data import color_aug, image_io, tiff
    from radet_tpu_torch.ops import distance_transform
    from radet_tpu_torch.utils import image_write, native
    from radet_tpu_torch.ops.vote_nms import vote_nms_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = card()
    start = time.perf_counter()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")

    # 1. build the kernel and the host libraries together
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(8) as pool:
        builds = [(src, flags, pool.submit(timed, fn)) for src, flags, fn in (
            (vnc.SOURCE, f"nvcc {' '.join(vnc.NVCC_FLAGS)}", vnc.build),
            (icc.SOURCE, f"nvcc {' '.join(icc.NVCC_FLAGS)}", icc.build),
            (image_io.SOURCE, f"c++ {' '.join(image_io.CXX_FLAGS)}", image_io.build),
            (image_io.JPEG_SOURCE, f"c++ {' '.join(image_io.CXX_FLAGS)}", image_io.build_jpeg),
            (image_write.JPEG_SOURCE, f"c++ {' '.join(image_write.CXX_FLAGS)}", image_write.build_jpeg_encoder),
            (color_aug.SOURCE, f"c++ {' '.join(color_aug.CXX_FLAGS)}", color_aug.build),
            (distance_transform.SOURCE, f"c++ {' '.join(distance_transform.CXX_FLAGS)}", distance_transform.build),
            (tiff.SOURCE, f"c++ {' '.join(tiff.CXX_FLAGS)}", tiff.build))]
        for src, flags, fut in builds:
            print(f"build: {src.relative_to(repo)} -> {native.BUILD_DIR.relative_to(repo)} "
                  f"with {flags}: {fut.result():.2f} s [{gpu}]")
    for log in (vnc.BUILD_LOG, icc.BUILD_LOG):
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas: {line.strip()}")

    print(f"phase builds: {time.perf_counter() - start:.1f} s wall since the start", flush=True)
    with tempfile.TemporaryDirectory() as work:
        phase("JPEG decode", decode_phase, gpu, work)
    phase("CosyPose ops", color_aug_phase, gpu)
    t_main = time.perf_counter()

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

    # the same NMS inputs, through the kernel and through the plain version
    # on the CPU; the float32 forward against the CPU's
    images = torch.from_numpy(np.stack(imgs)).to(dev)
    shapes = torch.tensor([[h, w]] * len(imgs), dtype=torch.float32, device=dev)
    scales = torch.ones((len(imgs), 4), dtype=torch.float32, device=dev)
    main_err = forward_checks(det, config, images)

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
    bound_ms, bound_by, _, _ = nms_bound(bench_inputs, kw["max_out"])
    print(f"timing: vote_nms B=128 K=512: kernel {kernel_ms:.4f} ms (runs {kernel_runs}), "
          f"plain {plain_ms:.3f} ms (runs {plain_runs}), bound {bound_ms * 1e3:.3f} us by {bound_by} "
          f"[{gpu}]")
    print(f"phase kernel vs plain, main path and its timing: {time.perf_counter() - t_main:.1f} s wall", flush=True)
    with tempfile.TemporaryDirectory() as work:
        phase("serving", serving_phase, det, gpu, work)
    del det, model, bench_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        phase("kernel by (B, K)", kernel_by_k)
        eval_opts = phase("eval", eval_phases, config, gpu, work)
        memory_ms = phase("train in memory", train_phases, config, gpu, eval_opts)
        files = osp.join(work, "files")
        os.makedirs(files)
        train_config, mix_config = write_train_files(config, files)
        phase("loader", loader_phase, train_config, gpu)
        phase("loader contention", contention_phase, train_config, gpu)
        pbr_checkpoints = phase("train from files", files_phase, train_config, gpu, eval_opts, memory_ms)
        phase("mixpbr fine-tune", mix_phase, mix_config, pbr_checkpoints, gpu, eval_opts, memory_ms)

        # 9. the anchor family (configs/atss): the no-vote kernel, inference, training
        nms_times = phase("no-vote kernel by (B, K)", nms_by_k, gpu)
        test_opts = [f"data.test.ann_file={osp.join(work, 'test.json')!r}",
                     f"data.test.img_prefix={osp.join(work, 'test') + '/'!r}"]
        nms_launches, nms_err = phase("anchor inference", anchor_inference_phase, gpu, repo, test_opts)
        phase("anchor training", anchor_train_phase, files, gpu, eval_opts, test_opts, repo)

        # 10. configs/bop's backbone zoo: inference, timing, parity, the CLIs
        zoo_launches = phase("zoo", zoo_phase, gpu, repo)
        phase("zoo CLIs", zoo_cli_phase, files, gpu, eval_opts, test_opts, repo)

        # 11. live BatchNorm and checkpointing, the learning check, the BOP sweep
        phase("live BN and with_cp", live_bn_phase, config, gpu)
        learn_launches, learn_err, learn_int8 = phase("validate_learning", learning_phase, gpu)
        sweep_launches, sweep_err = phase("BOP sweep", sweep_phase, gpu, work)

        # 12. the measuring and deploy tools
        export_launches, dispatch = phase("tools", tools_phase, config, gpu, repo, work, test_opts,
                                          np.stack(imgs))

        # 13. the int8 deploy family
        int8 = phase("int8", int8_phase, gpu, repo, work, test_opts, imgs)

        # 14. drawing
        show_dir_launches = phase("draw", draw_phase, config, gpu, work, train_config)

        # 15. quantization-aware training
        qat = phase("QAT", qat_phase, gpu, repo, files, eval_opts, test_opts, pbr_checkpoints)

        # 16. frozen-stage int8 training
        fi8 = phase("frozen-int8 training", fi8_phase, gpu, repo, files, eval_opts, pbr_checkpoints)

        # 17. the eval path's test-time variants
        tta = phase("test-time variants", tta_phase, config, gpu, repo, work)

        # 18. mask-free distance maps; 19. the ITODD config's test split of gray TIFFs
        mask_free = phase("mask-free distance maps", mask_free_phase, files, gpu, eval_opts)
        itodd = phase("ITODD TIFF test split", itodd_phase, gpu, work)
    nms_ms, nms_plain_ms, nms_bound_ms, nms_bound_by, _ = nms_times[ANCHOR_MAIN_SHAPE]

    print(f"card: {gpu}; smoke {time.perf_counter() - start:.1f} s wall")
    print(json.dumps({"kernels": [{
        "name": "vote_nms",
        "route": "cuda",
        "source": "radet_tpu_torch/csrc/vote_nms.cu",
        "replaces": "radet_tpu/ops/pallas_nms.py:382",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no PyTorch call computes vote-NMS
        "zoo_launches": zoo_launches,  # each zoo config's inference_detector run (phase 10)
        # phase 11: validate_learning's eval and the BOP sweep's, each held to the plain version
        "live_bn_launches": {"validate_learning": learn_launches, "run_bop_sweep": sweep_launches},
        "live_bn_max_abs_err": {"validate_learning": learn_err, "run_bop_sweep": sweep_err},
        # phase 12: per call of the torch.export program loaded in a fresh process (batch 8)
        "export_launches": export_launches,
        # phase 12: ms per call through the operator and through the wrapper alone, by BxK
        "dispatch_ms": dispatch,
        # phase 14: the strict eval of python -m radet_tpu_torch.tools.test --show-dir
        "show_dir_launches": show_dir_launches,
        # phase 15: the QAT train CLI's periodic eval, the int8_stream test of its checkpoint; phase 11:
        # validate_learning --qat's three evals
        "qat_launches": dict(qat["nms"], validate_learning=learn_launches),
        # phase 16: the frozen-int8 train CLI's periodic eval, validate_learning --frozen-int8's three evals
        "frozen_int8_launches": dict(fi8["nms"], validate_learning=fi8["learning"]["nms"]),
        "frozen_int8_max_abs_err": dict(train_cli_eval=fi8["max_abs_err"],
                                        validate_learning=fi8["learning"]["max_abs_err"]),
        # phase 17: the test CLI's vote-NMS launches by K over 32 images, batch 16: flip TTA's and multi-scale +
        # flip TTA's views (K 2048) and their fusion (K 200, 400); --fuse-conv-bn's; nms_impl='scan''s
        "tta_launches": {k: tta["runs"][k]["by_k"] for k in ("flip_tta", "multiscale_flip_tta", "fuse_conv_bn")},
        "scan_launches": tta["runs"]["nms_impl_scan"]["by_k"],
        "tta_max_abs_err": {k: tta["runs"][k]["max_abs_err"]
                            for k in ("flip_tta", "multiscale_flip_tta", "fuse_conv_bn")},
        "scan_max_abs_err": tta["runs"]["nms_impl_scan"]["max_abs_err"],
        # phase 17: the fusion's and the scan's calls timed (ms, plain_ms, bound_ms at their B and K)
        "tta_ms": tta["timing"],
        "tta_img_s": {k: r["img_s"] for k, r in tta["runs"].items()},
        # phase 18: the mask-free GDT train CLI's periodic eval (K 512); phase 19: the ITODD config's strict test
        # CLI over 32 gray TIFFs, batch 16 (K 2048); each call held to the plain version
        "mask_free_launches": {"train_cli_eval": mask_free["launches"]},
        "mask_free_max_abs_err": mask_free["max_abs_err"],
        "itodd_launches": {"test_cli": itodd["launches"]},
        "itodd_max_abs_err": itodd["max_abs_err"],
    }, {
        "name": "batched_nms (vote_nms.cu, no-vote mode)",
        "route": "cuda",
        "source": "radet_tpu_torch/csrc/vote_nms.cu",
        "replaces": "radet_tpu/ops/vote_nms.py:343 (plain XLA)",
        "launches": nms_launches,
        "max_abs_err": nms_err,
        "ms": nms_ms,
        "plain_ms": nms_plain_ms,
        "bound_ms": nms_bound_ms,
        "bound_by": nms_bound_by,
        "library_ms": None,  # no PyTorch call computes class-aware greedy NMS
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "radet_tpu_torch/csrc/int8_conv.cu",
        "replaces": "radet_tpu/ops/quant.py:182 (XLA int8 convolution, not Pallas)",
        "launches": int8["launches"][INT8_MAIN],  # int8_stream's inference_detector run (phase 13)
        "max_abs_err": 0.0,  # int32 sums and bf16 outputs equal to the plain version at every shape
        # the slowest of the main path's shapes at batch 8; "by_shape" has them all
        "ms": int8["main"]["ms"],
        "plain_ms": int8["main"]["plain_ms"],
        "bound_ms": int8["main"]["bound_ms"],
        "bound_by": int8["main"]["bound_by"],
        # torch._int_mm where the shape is a 1x1 stride-1 conv (the sums only), else None: no PyTorch
        # call computes an int8 convolution; by_shape has _int_mm at every 1x1 shape
        "library_ms": int8["main"]["int_mm_ms"],
        "shape": {"x": int8["main"]["x"], "w": int8["main"]["w"], "stride": int8["main"]["stride"]},
        "launches_by_config": int8["launches"],
        "launches_by_path": int8["paths"],  # int8_stream's inference_detector run: every launch the wgmma kernel
        "export_launches": int8["export"],
        # phase 15: the QAT train CLI's periodic eval, the int8_stream test of its checkpoint (92 per forward,
        # all wgmma), the timed bf16 train step's 13 steps (must be 0); phase 11: validate_learning --qat's PTQ
        # and deploy evals
        "qat_launches": dict(qat["int8"], train_step=qat["train_step_launches"], validate_learning=learn_int8),
        # phase 16: one bf16 train step at batch 16 (10, all wgmma, each held to the plain version), the 13
        # timed steps, the train CLI's 4 steps and its periodic eval (must be 0), profile_train's step,
        # validate_learning --frozen-int8's fine-tune with frozen_int8 (10 per step, none in its evals)
        "frozen_int8_launches": dict(fi8["int8"], train_step=fi8["launches"], train_step_paths=fi8["paths"],
                                     timed_steps=fi8["timed_launches"],
                                     profile_train=fi8["profile_train"]["int8_launches_per_step"],
                                     validate_learning=fi8["learning"]["int8"]),
        # phase 16: validate_learning --frozen-int8's A/B on the float path (mAP50 and mAP of each arm)
        "frozen_int8_learning": dict(fi8["learning"]["arms"], delta=fi8["learning"]["delta"]),
        # phase 16: the layer1 shapes at batch 16 (the frozen-int8 train step's inputs)
        "frozen_int8_by_shape": fi8["by_shape"],
        # every shape: the wgmma kernel ("ms", "ms_128"; "ms_128_per_tile" with one block per tile) beside
        # the mma.sync kernel ("mma_ms_128") on the same inputs
        "by_shape": int8["by_shape"],
        "host_us": int8["host_us"],  # host microseconds per call of each path (tensor maps encoded per call)
        "ms_per_batch": int8["times"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
