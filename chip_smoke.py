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
   version at B=128, K=512 with CUDA events.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.  Without a CUDA card, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = "configs/bop/r50_ycbv_pbr.py"
SEED = 0
BOX_ATOL = 1e-2  # px; keep sets, labels and scores must match exactly
BOX_TAIL = 0.005  # share of voted coordinates allowed past BOX_ATOL (1-sigma flips)
MAP_RTOL = 1e-3  # float32 card forward vs CPU forward, relative to each map's max


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
