"""``configs/bop``'s backbone zoo (ResNeXt-50 32x4d, Res2Net-50, ResNeSt-50,
RegNetX-3.2GF) through the port against the JAX package, float32 on the
CPU: each config read from its file, the neck and head narrowed by
``torch_parity.ZOO_NARROW`` (FPN 64, 2 stacked convs, 4 classes, 64x96),
the trunk at its published widths; one seeded variable tree per config
(``torch_parity.zoo_pair``).

- the trunk the config asks for, the FPN sized by it (RegNet's
  [96, 192, 432, 1008], not the inherited [256, 512, 1024, 2048]);
- the inference step: valid and labels equal, scores within 1e-5, boxes
  within 1e-2 px (``tests/test_torch_slice.py``'s bars);
- one whole train step for ResNeSt and RegNet: losses within 1e-5
  relative, every gradient within 1e-4 of its tensor's max abs, frozen
  stages without one (``tests/test_torch_train.py``'s bars);
- ``python -m radet_tpu_torch.tools.train`` for 2 steps on RegNet from a
  synthetic BOP set, its checkpoint read by ``init_detector``, served by
  ``BatchingDetector`` and evaluated by ``tools.test --eval bbox``, strict
  and ``--fast``.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import make_synthetic_bop
from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_infer_step as jax_build_infer_step
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu_torch import BatchingDetector, inference_detector, init_detector
from radet_tpu_torch.apis.common import assignment_cfg_from, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
from radet_tpu_torch.engine import build_optimizer, load_weights, state_dict_from_flax
from radet_tpu_torch.engine.infer_step import build_infer_step
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device, build_train_step
from radet_tpu_torch.models.resnet import Bottle2neck, RegNet, ResNet, SplitAttentionBottleneck
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import synthetic_bop_records, write_bop_test_set, write_png, write_train_config
from torch_parity import IMG_HW, NARROW, ZOO_CONFIGS, jax_assignment_noise, zoo_pair
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ZOO = sorted(ZOO_CONFIGS)
TRUNKS = {  # backbone class, C2..C5 widths, a module of layer2, its groups or its class
    "x50_32x4d": (ResNet, [256, 512, 1024, 2048], "layer2.0.conv2", 32),
    "r2_50": (ResNet, [256, 512, 1024, 2048], "layer2.0", Bottle2neck),
    "s50": (ResNet, [256, 512, 1024, 2048], "layer2.0", SplitAttentionBottleneck),
    "regnetx32": (RegNet, [96, 192, 432, 1008], "layer2.0.conv2", 4),
}


def _close(port, ref, rtol, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


@pytest.fixture(scope="module")
def pairs():
    """zoo_pair(name), built once per config."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = zoo_pair(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_builds_its_trunk(pairs, name):
    _, cfg, _, _, port, _, _, _ = pairs(name)
    kind, widths, module, detail = TRUNKS[name]
    assert type(port.backbone) is kind and port.backbone.out_channels == widths
    assert [c.conv.weight.shape[1] for c in port.neck.lateral_convs] == widths[1:]
    assert cfg.model.neck.in_channels == [256, 512, 1024, 2048]  # inherited, and unread
    block = port.backbone.get_submodule(module)
    assert block.groups == detail if isinstance(detail, int) else isinstance(block, detail)
    assert hasattr(port.backbone, "stem") == (name in ("r2_50", "s50"))


@pytest.mark.parametrize("name", ZOO)
def test_infer_step_matches_jax(pairs, name):
    jax_cfg, cfg, jax_model, variables, port, anchors, _, counts = pairs(name)
    test_cfg = jax_cfg.test_cfg.to_dict()
    img_norm = jax_cfg.img_norm_cfg.to_dict()
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (2, *IMG_HW, 3), dtype=np.uint8)
    shapes = np.asarray([[60, 90], [64, 80]], np.float32)
    scales = np.asarray([[0.5, 0.6, 0.5, 0.6], [1.25, 1.25, 1.25, 1.25]], np.float32)
    ref = jax_build_infer_step(jax_model, anchors, counts, img_norm=img_norm, test_cfg=test_cfg)(
        variables, jnp.asarray(u8), jnp.asarray(shapes), jnp.asarray(scales))
    det = build_infer_step(port, anchors, counts, img_norm=img_norm, test_cfg=cfg.test_cfg.to_dict())(
        port, u8, shapes, scales)
    rb, rs, rl, rv = (np.asarray(x) for x in ref[:4])
    db, ds, dl, dv = (x.numpy() for x in det[:4])
    assert dv.sum() > 10
    np.testing.assert_array_equal(dv, rv)
    np.testing.assert_array_equal(dl[dv], rl[rv])
    np.testing.assert_allclose(ds[dv], rs[rv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(db[dv], rb[rv], rtol=0, atol=1e-2)


@pytest.mark.parametrize("name", ["s50", "regnetx32"])
def test_train_step_matches_jax(pairs, name):
    """Assignment on JAX's own noise, focal/GIoU/IoU losses, backward
    through the trunk; JAX's gradients read through an optax transform
    that stores them as its state."""
    jax_cfg, cfg, jax_model, variables, port, anchors, ranges, _ = pairs(name)
    port.load_state_dict(state_dict_from_flax(variables))
    ds = InMemoryBOPDataset(synthetic_bop_records(np.random.RandomState(0), 2, IMG_HW, 4),
                            train_transforms(IMG_HW, max_gt=32, seed=0), max_gt=32)
    batch = collate([ds[i] for i in range(2)])
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
    )
    jstep = jax_build_train_step(
        jax_model, capture, anchors, ranges, img_norm=jax_cfg.img_norm_cfg.to_dict(), num_classes=4,
        assignment_cfg=jax_assignment_cfg_from(jax_cfg), loss_cfg=jax_loss_cfg_from(jax_cfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=variables["batch_stats"], opt_state=capture.init(params))
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}
    jstate, ref = jstep(jstate, jbatch, key)
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})

    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    step = build_train_step(port, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    port.train()
    try:
        metrics = step(TrainState(port, sgd0), batch_to_device(batch, "cpu"), noise)
    finally:
        port.eval()
    assert float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        _close(float(metrics[k]), float(ref[k]), 1e-5, k)
    frozen = 0
    for pname, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_grads[pname].numpy(), 1e-4, pname)
        else:
            frozen += 1
            assert pname.startswith(("backbone.conv1", "backbone.bn1", "backbone.stem.", "backbone.layer1."))
            assert p.grad is None and not ref_grads[pname].any(), pname
    assert frozen > 10


HW = (64, 128)
NAMES = ["a", "b", "c", "d"]


def test_train_cli_checkpoint_infers_and_tests(tmp_path, capsys):
    """RegNetX-3.2GF: two steps of the train CLI on the CPU from a JPEG
    BOP split through the config's own pipeline; ``init_detector``,
    ``BatchingDetector`` and ``tools.test --eval bbox`` (strict and
    ``--fast``) on its checkpoint."""
    root = str(tmp_path / "bop")
    ann, prefix = make_synthetic_bop(root, images_per_scene=4, img_hw=HW, num_classes=4, max_objects=3, seed=2)
    backgrounds = osp.join(root, "backgrounds")
    os.makedirs(backgrounds)
    rng = np.random.RandomState(3)
    cv2.imwrite(osp.join(backgrounds, "bg0.jpg"), rng.randint(0, 256, (80, 160, 3), np.uint8))
    write_png(osp.join(backgrounds, "bg1.png"), rng.randint(0, 256, (48, 96, 3), np.uint8))
    config = write_train_config(osp.join(root, "regnet_train.py"), ZOO_CONFIGS["regnetx32"], ann, prefix,
                                backgrounds)
    test_ann = write_bop_test_set(root, np.random.RandomState(4), [(3, HW)], NAMES)
    opts = NARROW + [f"input_size={HW}", "data.samples_per_gpu=2", "data.train.classes=None",
                     f"data.train.pipeline.2.img_scale={HW[::-1]}"]
    test_opts = [f"data.test.ann_file={test_ann!r}", f"data.test.img_prefix={osp.join(root, 'test') + '/'!r}",
                 f"data.test.classes={NAMES!r}", f"data.test.pipeline.1.img_scale={HW[::-1]}"]
    work = tmp_path / "work"
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.train", config, "--work-dir", str(work), "--device", "cpu",
           "--max-iters", "2", "--cfg-options", *opts, "log_config.interval=1", "checkpoint_config.interval=2"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=one_thread_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    iters = [ln for ln in proc.stderr.splitlines() if " - iter " in ln]
    assert len(iters) == 2 and all("loss_cls" in ln and "loss_iou" in ln for ln in iters)

    weights = load_weights(str(work / "checkpoints"))
    assert weights["backbone.layer4.1.conv2.weight"].shape == (1008, 48, 3, 3)  # 21 groups of 48
    det = init_detector(config, str(work), cfg_options=opts, device="cpu")
    assert type(det.model.backbone) is RegNet
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    images = list(np.random.RandomState(5).randint(0, 256, (2, *HW, 3), dtype=np.uint8))
    out = inference_detector(det, images)
    for r in out:
        n = len(r["boxes"])
        assert r["boxes"].shape == (n, 4) and np.isfinite(r["boxes"]).all() and n <= 100
        assert ((r["labels"] >= 0) & (r["labels"] < 4)).all()
    with BatchingDetector(det, batch_size=2, max_latency_ms=50) as srv:  # served, batched as above
        served = [f.result(timeout=60) for f in [srv.submit(im) for im in images]]
    for got, want in zip(served, out):
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-2)

    for mode in ([], ["--fast"]):  # strict, then the deploy path
        test_cli.main([config, str(work / "checkpoints"), "--device", "cpu", "--eval", "bbox", *mode,
                       "--cfg-options", *opts, *test_opts])
        metrics = json.loads(capsys.readouterr().out)
        assert 0 <= metrics["bbox_mAP"] <= 1 and "bbox_mAP_50" in metrics
    model = build_model_and_anchors(Config.fromfile(config, opts))[0]
    model.load_state_dict(weights, strict=True)
