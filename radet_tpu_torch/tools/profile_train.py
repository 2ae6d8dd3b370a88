"""Training-step time and its share of the card's peak (port of
``tools/profile_train.py``).

    python -m radet_tpu_torch.tools.profile_train [--batch 16] [--iters 30] [--depth 50]
        [--peak-tflops 989.4] [--trace-dir D] [--step-only] [--device cpu]

Times, after warm-up, on one synthetic batch (seeded uint8 images, 32 GT
slots of which 8 are valid, float16 ``dist_vals``) of the flagship
recipe's model (ResNet-``--depth``, FPN and RADet head at 256 channels,
``--num-classes``; bf16 convolutions on the card, float32 on the CPU) and
optimizer (AdamW, OneCycle, clip at 35):

- the full train step of ``engine/train_step.py`` (assignment, forward,
  loss, backward, clip and update),
- the label assignment alone,
- forward + loss without gradients,
- the bare forward,

with CUDA events on the card and the host clock on the CPU.
``step_tflops`` is ``FlopCounterMode``'s count of one whole step (forward,
loss and backward: 2 per multiply-add of every convolution and matrix
product), and ``mfu`` = step FLOPs / step time / ``--peak-tflops`` (default
989.4, one H100 SXM's dense bf16 rate at 700 W).  Prints one JSON object
with the JAX tool's keys, the device it ran on (the card's name and power
limit) and ``time_source``.  ``--trace-dir`` writes a ``torch.profiler``
trace of one step there.  ``--frozen-int8`` builds the trunk with
``frozen_int8`` (the frozen stem and layer1 on the int8 deploy arithmetic,
``configs/bop/r50_ycbv_pbr_frozen_int8.py``).  The JSON also gives the
int8 convolution kernel's launches in one step (``int8_launches_per_step``,
and by kernel path: ``ops/int8_conv_cuda.py``'s ``LAUNCHES`` and
``PATH_LAUNCHES``; 0 on the CPU, whose int8 convolutions run the plain
version).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..core.anchors import generate_anchors
from ..engine.optim import build_optimizer
from ..engine.train_step import TrainState, batch_to_device, build_train_step
from ..models.builder import build_detector
from ..models.detector import preprocess_images
from ..ops import int8_conv_cuda
from ..utils.profiling import device_label, resolve_device, trace

H100_BF16_TFLOPS = 989.4  # H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
IMG_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Time the radet_tpu_torch train step and its components")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--input-size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--num-classes", type=int, default=21)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--peak-tflops", type=float, default=H100_BF16_TFLOPS,
                   help="peak for MFU: H100 SXM dense bf16 989.4")
    p.add_argument("--trace-dir", default=None, help="write a torch.profiler trace of one step here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--frozen-int8", action="store_true",
                   help="backbone.frozen_int8: the frozen stem and layer1 run the int8_stream deploy arithmetic "
                        "in the train forward (configs/bop/r50_ycbv_pbr_frozen_int8.py)")
    p.add_argument("--step-only", action="store_true", help="time only the full train step")
    return p.parse_args(argv)


def steady_ms(fn, iters: int, cuda: bool) -> float:
    """ms per call of ``fn`` over ``iters`` calls after one warm-up call:
    CUDA events around the run on the card, the host clock on the CPU."""
    fn()
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def synthetic_batch(b: int, h: int, w: int, n_anchor: int, num_classes: int, max_gt: int):
    """The JAX tool's batch, drawn with the same numpy calls."""
    rs = np.random.RandomState(0)
    g = max_gt
    return dict(
        image=rs.randint(0, 255, (b, h, w, 3), np.uint8),
        gt_boxes=(np.tile(np.asarray([[40, 40, 200, 200]], np.float32), (b, g, 1))
                  + rs.rand(b, g, 1).astype(np.float32) * 50),
        gt_labels=rs.randint(0, num_classes, (b, g), dtype=np.int32),
        gt_valid=np.tile([True] * 8 + [False] * (g - 8), (b, 1)),
        dist_vals=rs.rand(b, n_anchor, g).astype(np.float16),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device, args.cpu)
    cuda = device.type == "cuda"
    h, w = args.input_size
    b = args.batch
    model_cfg = dict(
        type="RADet",
        backbone=dict(depth=args.depth, out_indices=(0, 1, 2, 3), frozen_stages=1, norm_eval=True,
                      frozen_int8=args.frozen_int8),
        neck=dict(out_channels=256, start_level=1, num_outs=5),
        bbox_head=dict(num_classes=args.num_classes, in_channels=256, stacked_convs=4, feat_channels=256),
    )
    model = build_detector(model_cfg, dtype="bfloat16" if cuda else "float32")
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).train()
    anchors, ranges, _, _ = generate_anchors((h, w))
    tx, _ = build_optimizer(dict(type="adamw", lr=4e-4, weight_decay=0.05),
                            dict(policy="onecycle", max_lr=4e-4, total_steps=100100, pct_start=0.05),
                            dict(max_norm=35.0), model)
    state = TrainState(model, tx, seed=1)
    step = build_train_step(model, anchors, ranges, img_norm=IMG_NORM, num_classes=args.num_classes,
                            assignment_cfg=dict(positive_num=10, neg_threshold=0.2, balance_sample=True))
    batch = batch_to_device(synthetic_batch(b, h, w, anchors.shape[0], args.num_classes, args.max_gt), device)

    # FLOPs and int8 kernel launches of one whole step (it also updates the
    # weights, like a warm-up step)
    int8_conv_cuda.LAUNCHES = 0
    int8_conv_cuda.PATH_LAUNCHES.update(dict.fromkeys(int8_conv_cuda.PATHS, 0))
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    step_flops = counter.get_total_flops()
    int8_launches, int8_paths = int8_conv_cuda.LAUNCHES, dict(int8_conv_cuda.PATH_LAUNCHES)

    if args.step_only:
        t_assign = t_fwd = t_fwdloss = float("nan")
    else:
        t_assign = steady_ms(lambda: step.assign(batch, generator=state.step_generator()), args.iters, cuda)
        assign = step.assign(batch, generator=state.step_generator())

        def fwd():
            with torch.no_grad():
                model(preprocess_images(batch["image"], step.mean, step.std, model.dtype))

        def fwd_loss():
            with torch.no_grad():
                losses = step.loss(model, batch, assign)
                return sum(v for k, v in losses.items() if k.startswith("loss_"))

        t_fwd = steady_ms(fwd, args.iters, cuda)
        t_fwdloss = steady_ms(fwd_loss, args.iters, cuda)
    t_step = steady_ms(lambda: step(state, batch), args.iters, cuda)

    if args.trace_dir:
        with trace(args.trace_dir):
            step(state, batch)
            if cuda:
                torch.cuda.synchronize()
        print(f"trace written to {args.trace_dir}")

    mfu = step_flops / (t_step / 1e3) / (args.peak_tflops * 1e12)
    components = not args.step_only
    out = dict(
        batch=b,
        input_size=[h, w],
        step_ms=t_step,
        img_per_s=b / (t_step / 1e3),
        fwd_ms=t_fwd if components else None,
        fwd_loss_ms=t_fwdloss if components else None,
        bwd_opt_ms=t_step - t_fwdloss - t_assign if components else None,
        assign_ms=t_assign if components else None,
        assign_frac=t_assign / t_step if components else None,
        step_tflops=step_flops / 1e12,
        mfu=mfu,
        peak_tflops=args.peak_tflops,
        dtype=str(model.dtype),
        frozen_int8=args.frozen_int8,
        int8_launches_per_step=int8_launches,
        int8_launches_by_path=int8_paths,
        device=device_label(device),
        time_source="CUDA events" if cuda else "host clock (cpu)",
    )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
