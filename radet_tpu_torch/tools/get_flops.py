"""Parameters and FLOPs of a config's detector (port of ``tools/get_flops.py``).

    python -m radet_tpu_torch.tools.get_flops CONFIG [--batch-size 1] [--device cpu]

Parameters are the model's ``nn.Parameter`` elements, frozen ones included:
the same count as the JAX tool's ``variables["params"]`` (32,159,327 for
``configs/bop/r50_ycbv_pbr.py``).  FLOPs are ``torch.utils.flop_counter.
FlopCounterMode``'s count of one eval-mode forward (backbone, neck, head; no
post-processing) at ``--batch-size``: 2 per multiply-add of every
convolution and matrix product, nothing for elementwise passes, and every
tap of a padded window counted.  XLA's cost analysis, which the JAX tool
prints, skips the padded taps and adds the elementwise work: for the
flagship at 480x640 the port counts 120.96 GFLOPs per image against the JAX
tool's 119.88, 0.9% apart.  Prints the JAX tool's three lines (four at a
batch above 1), then the exact counts and the device it ran on.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..apis.common import build_model_and_anchors
from ..models.detector import preprocess_images
from ..utils.config import Config
from ..utils.profiling import device_label, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Parameters and FLOPs of a radet_tpu_torch detector")
    p.add_argument("config")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    return p.parse_args(argv)


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(model: torch.nn.Module, x: torch.Tensor) -> int:
    """FLOPs of ``model(x)`` without autograd (see the module docstring)."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device, args.cpu)
    cfg = Config.fromfile(args.config, args.cfg_options)
    model = build_model_and_anchors(cfg, dtype=None if device.type == "cuda" else "float32")[0]
    model.to(device).eval()
    h, w = tuple(cfg.get("input_size", (480, 640)))
    b = args.batch_size
    images = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=device)
    norm = cfg.img_norm_cfg
    mean = torch.tensor(norm["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(norm["std"], dtype=torch.float32, device=device)
    n_params = count_params(model)
    flops = count_flops(model, preprocess_images(images, mean, std, model.dtype))
    print(f"input: {b}x{h}x{w}x3")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {flops / 1e9:.2f} GFLOPs (batch {b})")
    if b > 1:
        print(f"        {flops / 1e9 / b:.2f} GFLOPs/image")
    print(f"count: {n_params} parameters, {flops} FLOPs")
    print(f"device: {device_label(device)}")
    return dict(params=n_params, flops=flops, batch=b, input=[h, w])


if __name__ == "__main__":
    main()
