#!/usr/bin/env python
"""Convert the JAX package's orbax weights into a ``radet_tpu_torch`` checkpoint.

    python tools/convert_jax_weights.py CKPT OUT.pth [--config CONFIG]

``CKPT`` is anything ``radet_tpu.engine.checkpoint.load_weights`` reads: a
``save_weights`` directory, a trainer's step directory, or a
``CheckpointManager`` root (its latest step; a full TrainState is reduced to
its model variables).  The ``{params, batch_stats}`` tree is mapped to the
port's mmdet-named state dict by
``radet_tpu_torch.engine.convert.state_dict_from_flax`` (the exact inverse of
``tools/convert_torch_weights.py::convert_mmdet_detector``) and written with
``radet_tpu_torch.engine.checkpoint.save_weights``: ``OUT.pth`` holds
``{"state_dict", "meta"}``, and the checkpoint's ``meta.json``, when it has
one, is copied beside it, so that ``radet_tpu_torch.init_detector`` finds the
class names.  ``--config`` says whether the trunk's downsample is avg-down
(``ResNetV1d``, ``avg_down=True``), which the variables alone do not show,
and loads the result into the config's port model with ``strict=True``
before it is written.

This script imports jax (to read orbax); ``radet_tpu_torch`` itself never
does.
"""

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np


def avg_down_of(cfg):
    """True for a ``ResNetV1d`` trunk or an explicit ``avg_down``; None
    (read it from the deep stem) without a config."""
    if cfg is None:
        return None
    backbone = cfg.model.get("backbone", {})
    return bool(backbone.get("avg_down", backbone.get("type") == "ResNetV1d"))


def convert(checkpoint: str, output: str, config=None, cfg_options=None):
    """Read ``checkpoint`` (orbax), write ``output`` (.pth); returns the state dict."""
    import jax

    from radet_tpu.engine.checkpoint import load_meta, load_weights
    from radet_tpu_torch.engine.checkpoint import save_weights, write_meta
    from radet_tpu_torch.engine.convert import state_dict_from_flax
    from radet_tpu_torch.utils.config import Config

    cfg = Config.fromfile(config, cfg_options) if config else None
    variables = jax.tree.map(np.asarray, load_weights(checkpoint))
    state_dict = state_dict_from_flax(
        {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})},
        avg_down=avg_down_of(cfg),
    )
    if cfg is not None:
        from radet_tpu_torch.apis.common import build_model_and_anchors

        build_model_and_anchors(cfg, dtype="float32")[0].load_state_dict(state_dict, strict=True)
    meta = load_meta(checkpoint)
    classes = meta.get("classes") or meta.get("CLASSES")
    save_weights(output, state_dict, meta={"CLASSES": list(classes)} if classes else {})
    if meta:
        write_meta(osp.dirname(osp.abspath(output)), meta)
    return state_dict


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX orbax weights -> radet_tpu_torch .pth")
    p.add_argument("checkpoint", help="save_weights dir, trainer step dir or CheckpointManager root")
    p.add_argument("output", help="output .pth file")
    p.add_argument("--config", default=None, help="the model's config (avg-down trunks; strict load check)")
    p.add_argument("--cfg-options", nargs="+", default=None)
    args = p.parse_args(argv)
    os.makedirs(osp.dirname(osp.abspath(args.output)), exist_ok=True)
    state_dict = convert(args.checkpoint, args.output, args.config, args.cfg_options)
    print(f"wrote {len(state_dict)} tensors to {args.output}")


if __name__ == "__main__":
    main()
