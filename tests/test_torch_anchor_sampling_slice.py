"""mmdet's RPN recipe (``synthetic_bop.RPN_RECIPE``: sigmoid CE and L1,
MaxIoU at 0.7 / 0.3 / 0.3, RandomSampler(256, 0.5)) on the RetinaNet config
through the port against the JAX package, float32 on the CPU, narrowed to
ResNet-18, an FPN of width 32, 3 classes and 128x160:

- three train steps (SGD with momentum) of both packages on the same
  batch, each on the JAX package's own draws for its key: losses and every
  parameter after the third step within 1e-4 (of each tensor's max abs;
  ``tests/test_torch_anchor_slice.py``'s bar), the sampled counts within
  the sampler's quota;
- the step on the state's own generator: the draws change with the step;
- ``python -m radet_tpu_torch.tools.train --device cpu`` for 2 steps with
  one eval, then ``tools.test --device cpu --eval bbox`` on its checkpoint:
  finite metrics.
"""

import json
import logging
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import anchor_head_spec as jax_anchor_head_spec
from radet_tpu.engine.optim import build_optimizer as jax_build_optimizer
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step_anchor as jax_build_train_step_anchor
from radet_tpu_torch.apis.common import anchor_head_spec
from radet_tpu_torch.core.anchor_assign import assigned_to_dense_targets
from radet_tpu_torch.core.sampler_cores import generator_draws, injected_draws
from radet_tpu_torch.engine import build_optimizer, state_dict_from_flax
from radet_tpu_torch.engine.train_step import TrainState, build_train_step_anchor
from radet_tpu_torch.models.anchor_loss import random_sample_masks
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.tools import train as train_cli
from radet_tpu_torch.utils import get_root_logger
from synthetic_bop import RPN_RECIPE, write_bop_test_set
from torch_parity import ANCHOR_CONFIGS, ANCHOR_HW, config_pair, jax_sampler_draws
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

RETINA = ANCHOR_CONFIGS["retina"][0]
NARROW_R18 = ["model.backbone.depth=18", "model.neck.in_channels=[64, 128, 256, 512]", "model.neck.out_channels=32",
              "model.bbox_head.in_channels=32", "model.bbox_head.feat_channels=32", "model.bbox_head.num_classes=3",
              f"input_size={ANCHOR_HW}", "compute_dtype='float32'"]
OPTIONS = NARROW_R18 + RPN_RECIPE
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0)
STEPS = 3
NAMES = ["a", "b", "c"]


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _batch(seed=0, g=8):
    rng = np.random.RandomState(seed)
    h, w = ANCHOR_HW
    boxes = np.zeros((2, g, 4), np.float32)
    valid = np.zeros((2, g), bool)
    for i, n in enumerate((5, 3)):
        xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(16, 64, (n, 2))], -1).clip(0, [w, h, w, h])
        valid[i, :n] = True
    images = rng.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    return dict(image=images, gt_boxes=boxes, gt_labels=rng.randint(0, 3, (2, g)).astype(np.int32), gt_valid=valid)


@pytest.fixture(scope="module")
def pair():
    return config_pair(RETINA, OPTIONS)


def test_rpn_recipe_spec_matches_jax(pair):
    jax_cfg, cfg, *_ = pair
    got, ref = anchor_head_spec(cfg), jax_anchor_head_spec(jax_cfg)
    assert got["loss_kwargs"] == ref["loss_kwargs"]
    assert got["loss_kwargs"]["sampler_type"] == "RandomSampler" and got["loss_kwargs"]["sampler_num"] == 256


def test_rpn_recipe_train_steps_match_jax(pair):
    """Three SGD steps of each package on the same batch, the port on JAX's
    draws of each step's key."""
    jax_cfg, cfg, jax_model, variables, port, anchors, _, counts = pair
    port.load_state_dict(state_dict_from_flax(variables))
    batch = _batch()
    img_norm = cfg.img_norm_cfg.to_dict()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jtx, _ = jax_build_optimizer(SGD, dict(policy="fixed"), None, params, frozen_stages=1)
    jstep = jax_build_train_step_anchor(jax_model, jtx, anchors, counts, img_norm=img_norm, num_classes=3,
                                        spec=jax_anchor_head_spec(jax_cfg))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                           opt_state=jtx.init(params))
    step = build_train_step_anchor(port, anchors, counts, img_norm=img_norm, num_classes=3, spec=anchor_head_spec(cfg))
    tx, _ = build_optimizer(SGD, dict(policy="fixed"), None, port)
    state = TrainState(port, tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port.train()
    try:
        for i in range(STEPS):
            key = jax.random.PRNGKey(100 + i)
            jstate, ref = jstep(jstate, jbatch, key)
            got = step(state, tbatch, draws=injected_draws(jax_sampler_draws(key, 2, anchors.shape[0])))
            assert set(got) == set(ref)
            for k in ref:
                assert _rel(float(got[k]), float(ref[k])) <= 1e-4, (i, k, float(got[k]), float(ref[k]))
            assert 0 < float(got["num_pos"]) <= 2 * 128
    finally:
        port.eval()
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                                 "batch_stats": variables["batch_stats"]})
    init = state_dict_from_flax(variables)
    for name, p in port.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 1e-4, name
    assert sum(p.requires_grad and not torch.equal(p.detach(), init[name]) for name, p in port.named_parameters()) > 10


def test_rpn_recipe_step_draws_from_the_state_generator(pair):
    """Without injected draws the step samples from the state's generator,
    seeded by (seed, step): a repeat of a step samples the same anchors,
    the next step others; at most 128 positives and 256 samples an image."""
    _, cfg, _, variables, port, anchors, _, counts = pair
    port.load_state_dict(state_dict_from_flax(variables))
    step = build_train_step_anchor(port, anchors, counts, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=3,
                                   spec=anchor_head_spec(cfg))
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    kw = dict(step.spec["loss_kwargs"])
    n = anchors.shape[0]

    def sampled(at):
        state = TrainState(port, None, step=at)
        assigned = step.assign(tbatch)
        pos = assigned_to_dense_targets(assigned, tbatch["gt_boxes"], tbatch["gt_labels"].long(), 3)[2]
        return random_sample_masks(generator_draws(state.step_generator()), pos, assigned == 0,
                                   num=kw["sampler_num"], pos_fraction=kw["sampler_pos_fraction"])

    a, b, c = sampled(0), sampled(0), sampled(1)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert int(a[0].sum(-1).max()) <= 128 and int((a[0].sum(-1) + a[1].sum(-1)).max()) <= 256
    assert int(a[1].sum()) > 0 and n > 256


@pytest.fixture(scope="module")
def png_opts(tmp_path_factory):
    """A synthetic PNG set at 128x160 (6 images, 3 classes) as data.train,
    data.val and data.test, each pipeline's Resize at the input size."""
    root = str(tmp_path_factory.mktemp("rpn_png"))
    ann = write_bop_test_set(root, np.random.RandomState(0), [(6, ANCHOR_HW)], NAMES)
    opts = ["data.samples_per_gpu=2", "data.workers_per_gpu=1"]
    for split, resize in (("train", 2), ("val", 1), ("test", 1)):
        opts += [f"data.{split}.{k}={v!r}" for k, v in (
            ("ann_file", ann), ("img_prefix", osp.join(root, "test") + "/"), ("classes", NAMES),
            (f"pipeline.{resize}.img_scale", ANCHOR_HW[::-1]))]
    return opts


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_rpn_recipe_train_and_test_clis(png_opts, tmp_path, capsys):
    """``tools.train --device cpu`` for 2 steps (one eval at the last) and
    ``tools.test --device cpu --eval bbox`` on its checkpoint."""
    work = tmp_path / "work"
    logs = _Lines()
    get_root_logger().addHandler(logs)
    try:
        train_cli.main([RETINA, "--work-dir", str(work), "--device", "cpu", "--max-iters", "2", "--cfg-options",
                        *OPTIONS, *png_opts, "log_config.interval=1", "evaluation.interval=2",
                        "checkpoint_config.interval=2"])
    finally:
        get_root_logger().removeHandler(logs)
    iters = [ln for ln in logs.lines if ln.startswith("iter ")]
    assert len(iters) == 2 and all("loss_cls" in ln and "loss_bbox" in ln and "num_pos" in ln for ln in iters)
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in iters]
    assert all(np.isfinite(losses)), iters
    assert any(ln.startswith("eval: bbox_mAP") for ln in logs.lines)
    capsys.readouterr()
    test_cli.main([RETINA, str(work / "checkpoints"), "--device", "cpu", "--eval", "bbox", "--cfg-options",
                   *OPTIONS, *png_opts])
    metrics = json.loads(capsys.readouterr().out)
    assert 0 <= metrics["bbox_mAP"] <= 1 and all(np.isfinite(v) for v in metrics.values())
