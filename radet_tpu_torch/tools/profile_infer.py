"""Where the inference step's time goes, by module, with a roofline (port of
``tools/profile_infer.py``, which reads an xprof trace of the TPU step).

    python -m radet_tpu_torch.tools.profile_infer [--config CFG] [--batch 128] [--iters 3]
        [--top 25] [--peak-tflops 989.4] [--peak-bw-gbs 3350] [--trace-dir D] [--device cpu]

Builds the config's detector (default ``configs/bop/r50_ycbv_pbr.py``, seeded
random weights, the config's ``compute_dtype`` on the card) and its whole
inference step (``apis.common.build_infer_module``: uint8 normalize,
forward, decode, vote-NMS) on seeded uint8 images, and records ``--iters``
steps with ``torch.profiler`` after two untimed ones.  Forward hooks open
one ``record_function`` range per module: ``backbone/stem``,
``backbone/layer1`` ... ``layer4``, ``neck``, ``bbox_head`` and
``postprocess`` (decode and NMS); what runs outside them is
``preprocess``.  The models are not edited.  Each CUDA kernel's device
time goes to the range of the operator that launched it.  Prints:

- time by module, device ms per step and share (on the CPU: host ms of the
  operators, named as such);
- the top ``--top`` kernels by device ms per step, with their module;
- a roofline by module: FLOPs from ``FlopCounterMode``'s per-module counts
  (convolutions and matrix products), bytes from one untimed pass of a
  ``TorchDispatchMode`` that sums each operator's input and output tensor
  sizes (views excluded), and the bound max(FLOPs / peak, bytes / peak
  bandwidth) against the measured time; the step's measured ms against
  the sum of the bounds, and the device's busy share (the union of the
  device events' intervals over the window's wall time).

The peaks default to one H100 SXM's published dense bf16 rate (989.4
TFLOP/s) and HBM3 bandwidth (3350 GB/s) at a 700 W power limit; the card's
name and power limit (``nvidia-smi``) are printed beside them.  The last
line is one JSON object with every number above.  ``--quant`` profiles an
int8 deploy variant of the config, as the JAX tool's: ``int8`` the head's
towers, ``int8_full`` those and the trunk's 3x3 and 1x1 convs
(``backbone.quant='int8'``), ``int8_stream`` those and the int8 residual
stream; the JSON then counts the int8 kernel's launches per step.  The
int8 convolutions' operations count at the bf16 peak in the roofline.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..apis.common import build_infer_module, build_model_and_anchors
from ..ops import int8_conv_cuda
from ..utils.config import Config
from ..utils.profiling import device_label, profiler_activities, resolve_device

DEFAULT_CONFIG = "configs/bop/r50_ycbv_pbr.py"
H100_BF16_TFLOPS = 989.4  # H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
H100_HBM_GBS = 3350.0  # H100 SXM, HBM3
PREPROCESS = "preprocess"
# --quant -> config overrides
QUANT_OPTIONS = {
    "int8": ["model.bbox_head.quant='int8'"],
    "int8_full": ["model.bbox_head.quant='int8'", "model.backbone.quant='int8'"],
    "int8_stream": ["model.bbox_head.quant='int8'", "model.backbone.quant='int8_stream'"],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Profile the radet_tpu_torch inference step by module")
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--input-size", type=int, nargs=2, default=None, help="H W (default: the config's)")
    p.add_argument("--trace-dir", default=None, help="also write the Chrome trace here")
    p.add_argument("--iters", type=int, default=3, help="traced iterations")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--peak-tflops", type=float, default=H100_BF16_TFLOPS, help="H100 SXM dense bf16")
    p.add_argument("--peak-bw-gbs", type=float, default=H100_HBM_GBS, help="H100 SXM HBM3 GB/s")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--quant", default=None, choices=sorted(QUANT_OPTIONS),
                   help="profile an int8 deploy variant: the head's towers, + the trunk, + the stream")
    return p.parse_args(argv)


class ModuleScopes:
    """Forward hooks that open one ``record_function`` range per module of
    the step (see the module docstring); ``current`` names the open one.
    The stages' blocks are hooked (the trunk calls them, not the stage
    containers); the stem's range runs from the trunk's entry to the first
    block."""

    def __init__(self, module):
        self.current = None
        self._range = None
        self._handles = []
        model = module.model
        bb = model.backbone
        self._hook_pre(bb, "backbone/stem")
        for i in range(1, bb.num_stages + 1):
            blocks = list(getattr(bb, f"layer{i}"))
            self._hook_pre(blocks[0], f"backbone/layer{i}")
            self._handles.append(blocks[-1].register_forward_hook(lambda *_: self.close()))
        for name in ("neck", "bbox_head"):
            sub = getattr(model, name)
            self._hook_pre(sub, name)
            self._handles.append(sub.register_forward_hook(lambda *_: self.close()))
        self.names = (["backbone/stem"] + [f"backbone/layer{i}" for i in range(1, bb.num_stages + 1)]
                      + ["neck", "bbox_head", "postprocess", PREPROCESS])
        inner = module.postprocess

        def postprocess(*args, **kwargs):
            self.open("postprocess")
            try:
                return inner(*args, **kwargs)
            finally:
                self.close()

        self._module, self._inner = module, inner
        module.postprocess = postprocess

    def _hook_pre(self, mod, name):
        self._handles.append(mod.register_forward_pre_hook(lambda *_: self.open(name)))

    def open(self, name):
        self.close()
        self._range = torch.profiler.record_function(name)
        self._range.__enter__()
        self.current = name

    def close(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._range, self.current = None, None

    def remove(self):
        for h in self._handles:
            h.remove()
        self._module.postprocess = self._inner


class ByteCounter(TorchDispatchMode):
    """Sums each operator's input and output tensor bytes by the scope open
    when it runs (views move nothing and are left out)."""

    def __init__(self, scopes: ModuleScopes):
        super().__init__()
        self.scopes = scopes
        self.bytes = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            n = sum(t.numel() * t.element_size() for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            self.bytes[self.scopes.current or PREPROCESS] += n
        return out


def flops_by_scope(counts, total: int, num_stages: int):
    """``FlopCounterMode.get_flop_counts()`` (keyed by module path) onto the
    scope names: each stage's blocks, the rest of the trunk as the stem,
    the neck, the head, and what lies outside the model as postprocess."""
    sums = {k: sum(v.values()) for k, v in counts.items()}

    def at(suffix):
        return sum(v for k, v in sums.items() if k.endswith(suffix))

    out = {f"backbone/layer{i}": sum(v for k, v in sums.items()
                                     if re.search(rf"\.backbone\.layer{i}\.\d+$", k))
           for i in range(1, num_stages + 1)}
    out["backbone/stem"] = at(".model.backbone") - sum(out.values())
    out["neck"] = at(".model.neck")
    out["bbox_head"] = at(".model.bbox_head")
    out["postprocess"] = total - at("InferenceModule.model")
    out[PREPROCESS] = 0
    return out


def time_by_scope(events, names, cuda: bool):
    """(microseconds by scope, microseconds by (kernel name, scope), device
    busy microseconds) over the profiled events.  On the card the profiler
    draws each ``record_function`` range on the device's timeline too (a
    device event named as the range); each other device event (kernel,
    copy, fill) goes to the range it lies in there, else to ``preprocess``,
    and the busy time is the union of their intervals.  On the CPU each
    operator's self time goes to the range it started in, and there is no
    busy time."""
    cpu = torch.autograd.DeviceType.CPU
    on_device = cuda

    def spans(pred):
        return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.name in names and pred(e.device_type != cpu))

    ranges = spans(lambda is_device: is_device == on_device)
    starts = [r[0] for r in ranges]

    def scope_of(t):
        i = np.searchsorted(starts, t, side="right") - 1
        return ranges[i][2] if i >= 0 and ranges[i][0] <= t <= ranges[i][1] else PREPROCESS

    by_scope, by_kernel = defaultdict(float), defaultdict(float)
    if not cuda:
        for e in events:
            if e.device_type == cpu and e.name not in names and e.self_cpu_time_total > 0:
                scope = scope_of(e.time_range.start)
                by_scope[scope] += e.self_cpu_time_total
                by_kernel[e.name, scope] += e.self_cpu_time_total
        return by_scope, by_kernel, None
    if not ranges:
        raise RuntimeError("the profiler recorded no module range on the device's timeline")
    busy, end = 0.0, -np.inf
    for e in sorted((e for e in events if e.device_type != cpu and e.name not in names),
                    key=lambda e: e.time_range.start):
        scope = scope_of(e.time_range.start)
        us = e.time_range.end - e.time_range.start
        by_scope[scope] += us
        by_kernel[e.name, scope] += us
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    return by_scope, by_kernel, busy


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device, args.cpu)
    cuda = device.type == "cuda"
    label = device_label(device)
    options = list(args.cfg_options or []) + QUANT_OPTIONS.get(args.quant, [])
    if args.input_size:
        options.append(f"input_size={tuple(args.input_size)}")
    cfg = Config.fromfile(args.config, options)
    model, anchors, _, counts = build_model_and_anchors(cfg, dtype=None if cuda else "float32")
    model.init_weights(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    model.to(device).eval()
    step = build_infer_module(cfg, model, anchors, counts).eval()
    h, w = tuple(cfg.get("input_size", (480, 640)))
    b = args.batch
    rs = np.random.RandomState(0)
    inputs = (torch.from_numpy(rs.randint(0, 256, (b, h, w, 3), np.uint8)).to(device),
              torch.tensor([[h, w]] * b, dtype=torch.float32, device=device),
              torch.ones((b, 4), dtype=torch.float32, device=device))

    scopes = ModuleScopes(step)
    try:
        with torch.inference_mode():
            with FlopCounterMode(display=False) as flop_counter, ByteCounter(scopes) as byte_counter:
                step(*inputs)
            flops = flops_by_scope(flop_counter.get_flop_counts(), flop_counter.get_total_flops(),
                                   model.backbone.num_stages)
            for _ in range(2):
                step(*inputs)
            if cuda:
                torch.cuda.synchronize(device)
            launches0 = int8_conv_cuda.LAUNCHES
            with torch.profiler.profile(activities=profiler_activities()) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step(*inputs)
                if cuda:
                    torch.cuda.synchronize(device)
                wall_us = (time.perf_counter() - t0) * 1e6 / args.iters
            int8_launches = (int8_conv_cuda.LAUNCHES - launches0) / args.iters
    finally:
        scopes.remove()
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(osp.join(args.trace_dir, "trace.json"))
    by_scope, by_kernel, busy_us = time_by_scope(prof.events(), set(scopes.names), cuda)
    n = args.iters
    total_us = sum(by_scope.values()) / n
    what = "device" if cuda else "host (cpu operators' self time)"

    modules = {}
    bound_us = 0.0
    for name in scopes.names:
        us = by_scope.get(name, 0.0) / n
        f, nbytes = flops.get(name, 0), byte_counter.bytes.get(name, 0)
        bound = max(f / (args.peak_tflops * 1e12), nbytes / (args.peak_bw_gbs * 1e9)) * 1e6
        bound_us += bound
        modules[name] = dict(ms=us / 1e3, share=us / total_us if total_us else 0.0, gflop=f / 1e9,
                             mbytes=nbytes / 1e6, bound_ms=bound / 1e3,
                             bound_by="operations" if f / (args.peak_tflops * 1e12)
                             >= nbytes / (args.peak_bw_gbs * 1e9) else "bytes")
    busy = busy_us / n / wall_us if cuda else None
    print(f"\n== inference step: {wall_us / 1e3:.3f} ms/iter wall, {total_us / 1e3:.3f} ms {what} "
          f"(batch {b}, {h}x{w}, {model.dtype}) on {label} ==")
    print(f"roofline lower bound: {bound_us / 1e3:.3f} ms at {args.peak_tflops} TFLOP/s and "
          f"{args.peak_bw_gbs} GB/s (measured / bound {total_us / max(bound_us, 1e-9):.2f}x); "
          f"device busy share {'not measured (cpu)' if busy is None else f'{busy:.4f}'}\n")
    print(f"-- by module ({what} ms per step) --")
    print("      ms  share   GFLOP   MB moved  bound ms  bound by    module")
    for name, m in sorted(modules.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"{m['ms']:8.3f} {100 * m['share']:5.1f}% {m['gflop']:8.2f} {m['mbytes']:10.1f} "
              f"{m['bound_ms']:9.4f}  {m['bound_by']:<10}  {name}")
    print(f"\n-- top {args.top} {'kernels' if cuda else 'operators'} --")
    print("      ms  share  module         name")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[: args.top]
    for (name, scope), us in top:
        print(f"{us / n / 1e3:8.4f} {100 * us / n / max(total_us, 1e-9):5.1f}%  {scope:<14} {name[:100]}")
    summary = dict(
        batch=b, input_size=[h, w], device=label, dtype=str(model.dtype), iters=n, quant=args.quant,
        int8_conv_launches_per_step=int8_launches if cuda else None,
        ms_per_iter=wall_us / 1e3, measured_ms=total_us / 1e3, time_kind=what,
        bound_ms=bound_us / 1e3, busy_share=busy, device_union_ms=busy_us / n / 1e3 if cuda else None, peak_tflops=args.peak_tflops, peak_bw_gbs=args.peak_bw_gbs,
        by_module=modules,
        top=[dict(name=name, module=scope, ms=us / n / 1e3) for (name, scope), us in top],
    )
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
