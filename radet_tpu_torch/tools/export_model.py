"""Export the whole inference step as a ``torch.export`` program (port of
``tools/export_model.py``, which serialises the same step as StableHLO).

    python -m radet_tpu_torch.tools.export_model CONFIG OUT.pt2 [--checkpoint CKPT]
        [--batch-size 1] [--device cuda|cpu] [--verify]

The step (``engine.infer_step.InferenceModule`` of
``apis.common.build_infer_module``) is uint8 normalize -> backbone, FPN and
head -> decode -> vote-NMS (class-aware NMS for the anchor heads), traced
once at a static batch on ``--device`` and written with
``torch.export.save``.  Its inputs are (images (B, H, W, 3) uint8,
img_shapes (B, 2) float32, scale_factors (B, 4) float32) on that device,
its outputs (boxes, scores, labels, valid), as the JAX tool's.  The NMS is
the operator ``torch.ops.radet_tpu_torch.vote_nms`` (``batched_nms``): a
process that loads the program imports ``radet_tpu_torch.ops.vote_nms``
first, and on the card the loaded program launches the hand-written
kernel.  An int8 config's convolutions are the operator
``torch.ops.radet_tpu_torch.int8_conv`` (``radet_tpu_torch.ops.quant``),
which the loaded program runs as the hand-written int8 kernel on the card.
Convolutions run in the config's ``compute_dtype`` on the card
and in float32 on the CPU.  ``--verify`` loads the file back in this
process, runs it on (zero images, img_shapes = the input size, unit scale
factors) and logs the output shapes, the valid count and the largest
difference from the eager step.  ``--platform`` is ``--device``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from ..apis.common import build_infer_module, build_model_and_anchors
from ..engine.checkpoint import load_weights
from ..utils.config import Config
from ..utils.logging import get_root_logger
from ..utils.profiling import device_label, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export the radet_tpu_torch inference step with torch.export")
    p.add_argument("config")
    p.add_argument("output", help="output .pt2 file")
    p.add_argument("--checkpoint", default=None, help="weights (.pth, checkpoint directory); random without")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", "--platform", dest="device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--verify", action="store_true", help="load the artifact back and run it")
    return p.parse_args(argv)


def example_inputs(batch: int, input_size, device):
    """(zero uint8 images, img_shapes = the input size, unit scale factors)."""
    h, w = input_size
    return (
        torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=device),
        torch.tensor([[h, w]] * batch, dtype=torch.float32, device=device),
        torch.ones((batch, 4), dtype=torch.float32, device=device),
    )


def build_module(cfg, checkpoint, device, seed: int = 0):
    """The config's ``InferenceModule`` on ``device`` in eval mode, with the
    checkpoint's weights (strict) or a random init from ``seed``."""
    model, anchors, _, counts = build_model_and_anchors(cfg, dtype=None if device.type == "cuda" else "float32")
    if checkpoint:
        model.load_state_dict(load_weights(checkpoint), strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return build_infer_module(cfg, model, anchors, counts).eval()


def export(module, example):
    """``torch.export.export`` of the step at the example's static shapes."""
    with torch.no_grad():
        return torch.export.export(module, example)


def load(path: str):
    """The saved program, ready to call: ``load(path)(images, img_shapes,
    scale_factors) -> (boxes, scores, labels, valid)``."""
    import radet_tpu_torch.ops.quant  # noqa: F401  registers the int8 convolution operator
    import radet_tpu_torch.ops.vote_nms  # noqa: F401  registers the NMS operators

    return torch.export.load(path).module()


def main(argv=None):
    """Export; with ``--verify``, returns the loaded program."""
    args = parse_args(argv)
    device = resolve_device(args.device, args.cpu)
    logger = get_root_logger()
    cfg = Config.fromfile(args.config, args.cfg_options)
    h, w = tuple(cfg.get("input_size", (480, 640)))
    b = args.batch_size
    module = build_module(cfg, args.checkpoint, device, seed=int(cfg.get("seed", 0)))
    example = example_inputs(b, (h, w), device)
    program = export(module, example)
    os.makedirs(osp.dirname(osp.abspath(args.output)), exist_ok=True)
    torch.export.save(program, args.output)
    logger.info(f"exported {osp.getsize(args.output) / 1e6:.1f} MB torch.export program to {args.output} "
                f"(batch {b}, input {h}x{w}, {device_label(device)})")
    if not args.verify:
        return None
    program = load(args.output)
    outs = program(*example)
    with torch.no_grad():
        eager = module(*example)
    diff = max((a.double() - e.double()).abs().max().item() if a.numel() else 0.0 for a, e in zip(outs, eager))
    logger.info(f"roundtrip ok: boxes {tuple(outs[0].shape)}, valid count {int(outs[3].sum())}, "
                f"max abs difference from the eager step {diff}")
    return program


if __name__ == "__main__":
    main()
