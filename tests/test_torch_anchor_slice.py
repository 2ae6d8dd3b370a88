"""The ATSS and RetinaNet configs (configs/atss) through the port against the
JAX package, float32 on the CPU, narrowed as ``torch_parity.ANCHOR_CONFIGS``
(ResNet-50, FPN 32 with ``add_extra_convs='on_input'``, 3 classes, 128x160):
one seeded flax model per head with randomised weights, loaded by the port
through ``state_dict_from_flax`` with ``strict=True``.

- the FPN's and the head's maps within 1e-4 of each map's max;
- the inference step: valid and labels equal, scores within 1e-5, boxes
  within 1e-3 px;
- one whole train step: losses within 1e-5 relative, every gradient within
  1e-4 of its tensor's max abs (``tests/test_torch_train.py``'s bars);
- strict ``test_from_config`` on a synthetic PNG set (ATSS): the same
  detections and COCO metrics within 1e-3;
- ``python -m radet_tpu_torch.tools.train`` for 2 steps on the CPU, the
  checkpoint read by ``init_detector`` and ``tools.test --eval bbox``.
"""

import json
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import radet_tpu_torch.apis.test as port_test
from radet_tpu.apis.common import anchor_head_spec as jax_anchor_head_spec
from radet_tpu.apis.common import build_infer_for_cfg as jax_build_infer_for_cfg
from radet_tpu.apis.test import test_from_config as jax_test_from_config
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step_anchor as jax_build_train_step_anchor
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch import BatchingDetector, inference_detector, init_detector
from radet_tpu_torch.apis.common import anchor_head_spec, build_infer_for_cfg, build_model_and_anchors
from radet_tpu_torch.engine import build_optimizer, state_dict_from_flax
from radet_tpu_torch.engine.train_step import TrainState, build_train_step_anchor
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import write_bop_test_set
from torch_parity import ANCHOR_CONFIGS, ANCHOR_HW, anchor_pair

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
HEADS = sorted(ANCHOR_CONFIGS)
NAMES = ["a", "b", "c"]


def _close(port, ref, rtol, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


@pytest.fixture(scope="module")
def pairs():
    """anchor_pair(name), built once per head."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = anchor_pair(name)
        return cache[name]

    return get


def _images(n=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *ANCHOR_HW, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", HEADS)
def test_fpn_and_head_match_jax(pairs, name):
    jax_cfg, cfg, jax_model, variables, port, _, _ = pairs(name)
    assert cfg.model.neck.add_extra_convs == "on_input"
    assert port.neck.fpn_convs[3].conv.weight.shape[1] == 2048  # P6 from C5
    x = np.random.RandomState(1).randn(2, *ANCHOR_HW, 3).astype(np.float32)
    outs, inter = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=False, capture_intermediates=lambda m, _: m.name == "neck", mutable=["intermediates"]))(
        variables, jnp.asarray(x))
    ref_neck = inter["intermediates"]["neck"]["__call__"][0]
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        neck = port.neck(port.backbone(xt))
        maps = port.bbox_head(neck)
    for i, (got, ref) in enumerate(zip(neck, ref_neck)):
        _close(got.permute(0, 2, 3, 1).numpy(), ref, 1e-4, f"P{i + 3}")
    assert len(maps) == len(outs) == (3 if name == "atss" else 2)
    for kind, got_maps, ref_maps in zip(("cls", "reg", "centerness"), maps, outs):
        for lvl, (got, ref) in enumerate(zip(got_maps, ref_maps)):
            assert got.shape == ref.shape
            _close(got.numpy(), ref, 1e-4, f"{kind} level {lvl}")


@pytest.mark.parametrize("name", HEADS)
def test_infer_step_matches_jax(pairs, name):
    jax_cfg, cfg, jax_model, variables, port, anchors, counts = pairs(name)
    u8 = _images()
    shapes = np.float32([[100, 150], [128, 160]])
    scales = np.float32([[0.5, 0.6, 0.5, 0.6], [1.25, 1.25, 1.25, 1.25]])
    ref = jax_build_infer_for_cfg(jax_cfg, jax_model, anchors, counts)(
        variables, jnp.asarray(u8), jnp.asarray(shapes), jnp.asarray(scales))
    det = build_infer_for_cfg(cfg, port, anchors, counts)(port, u8, shapes, scales)
    rv, dv = np.asarray(ref.valid), det.valid.numpy()
    np.testing.assert_array_equal(dv, rv)
    assert dv.sum(1).min() > 5
    np.testing.assert_array_equal(det.labels.numpy()[dv], np.asarray(ref.labels)[rv])
    np.testing.assert_allclose(det.scores.numpy()[dv], np.asarray(ref.scores)[rv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(det.boxes.numpy()[dv], np.asarray(ref.boxes)[rv], rtol=0, atol=1e-3)


def _train_batch(seed=0, g=8):
    rng = np.random.RandomState(seed)
    h, w = ANCHOR_HW
    boxes = np.zeros((2, g, 4), np.float32)
    valid = np.zeros((2, g), bool)
    for i, n in enumerate((4, 2)):
        xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(16, 64, (n, 2))], -1).clip(0, [w, h, w, h])
        valid[i, :n] = True
    labels = rng.randint(0, 3, (2, g)).astype(np.int32)
    return dict(image=_images(seed=seed), gt_boxes=boxes, gt_labels=labels, gt_valid=valid)


@pytest.mark.parametrize("name", HEADS)
def test_train_step_matches_jax(pairs, name):
    jax_cfg, cfg, jax_model, variables, port, anchors, counts = pairs(name)
    port.load_state_dict(state_dict_from_flax(variables))
    batch = _train_batch()
    # the JAX step's optimizer stores the gradients as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
    )
    img_norm = cfg.img_norm_cfg.to_dict()
    jstep = jax_build_train_step_anchor(jax_model, capture, anchors, counts, img_norm=img_norm, num_classes=3,
                                        spec=jax_anchor_head_spec(jax_cfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                           opt_state=capture.init(params))
    jstate, ref = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})

    step = build_train_step_anchor(port, anchors, counts, img_norm=img_norm, num_classes=3,
                                   spec=anchor_head_spec(cfg))
    assert step.batch_keys == ("image", "gt_boxes", "gt_labels", "gt_valid")
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    port.train()
    try:
        metrics = step(TrainState(port, sgd0), {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        port.eval()
    assert set(metrics) == set(ref) and float(metrics["num_pos"]) > 5
    for k in ref:
        _close(float(metrics[k]), float(ref[k]), 1e-5, k)
    for pname, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_grads[pname].numpy(), 1e-4, pname)
        else:
            assert p.grad is None and not ref_grads[pname].any(), pname
    # assignment alone: the step's own
    assigned = step.assign({k: torch.from_numpy(batch[k]) for k in ("gt_boxes", "gt_valid")})
    assert assigned.shape == (2, anchors.shape[0]) and int((assigned > 0).sum()) == int(metrics["num_pos"])


@pytest.fixture(scope="module")
def png_opts(tmp_path_factory):
    """Config options reading a synthetic PNG set at 128x160 (6 images, 3
    classes) as data.train, data.val and data.test, with each pipeline's
    Resize at the input size."""
    root = str(tmp_path_factory.mktemp("anchor_png"))
    ann = write_bop_test_set(root, np.random.RandomState(0), [(6, ANCHOR_HW)], NAMES)
    opts = ["data.samples_per_gpu=2", "data.workers_per_gpu=1"]
    for split, resize in (("train", 2), ("val", 1), ("test", 1)):
        opts += [f"data.{split}.{k}={v!r}" for k, v in (
            ("ann_file", ann), ("img_prefix", osp.join(root, "test") + "/"), ("classes", NAMES),
            (f"pipeline.{resize}.img_scale", ANCHOR_HW[::-1]))]
    return opts


def test_atss_test_from_config_matches_jax(pairs, png_opts):
    """Strict ``test_from_config`` (single scale, ``nms_topk`` 2048) of both
    packages on the PNG set with the same weights."""
    _, _, jax_model, variables, port, _, _ = pairs("atss")
    path, options = ANCHOR_CONFIGS["atss"]
    jax_cfg, cfg = JaxConfig.fromfile(path, options + png_opts), Config.fromfile(path, options + png_opts)
    _, ref, ref_metrics = jax_test_from_config(jax_cfg, variables)
    _, got, got_metrics = port_test.test_from_config(cfg, port)
    assert [r["img_id"] for r in got] == [r["img_id"] for r in ref] and len(got) == 6
    assert sum(len(r["labels"]) for r in got) > 50
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-5)
    assert got_metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        assert abs(got_metrics[k] - ref_metrics[k]) <= 1e-3, k
    with pytest.raises(NotImplementedError, match="TTA"):
        port_test.test_from_config(Config.fromfile(path, options + png_opts + ["test_cfg.flip_tta=True"]), port)


@pytest.mark.parametrize("name", HEADS)
def test_train_cli_checkpoint_serves_and_tests(name, png_opts, tmp_path, capsys):
    """Two steps of ``python -m radet_tpu_torch.tools.train`` on the CPU from
    the PNG set through the config's own pipeline (no distance maps), one
    eval at the last step; ``init_detector`` loads the checkpoint,
    ``BatchingDetector`` serves it and ``tools.test --eval bbox`` evaluates
    it."""
    path, options = ANCHOR_CONFIGS[name]
    opts = options + png_opts + ["log_config.interval=1", "evaluation.interval=2", "checkpoint_config.interval=2"]
    work = tmp_path / "work"
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.train", path, "--work-dir", str(work), "--device", "cpu",
           "--max-iters", "2", "--cfg-options", *opts]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    iters = [ln for ln in proc.stderr.splitlines() if " - iter " in ln]
    assert len(iters) == 2 and all("loss_cls" in ln and "num_pos" in ln for ln in iters)
    assert ("loss_centerness" in iters[0]) == (name == "atss")
    assert "eval: bbox_mAP" in proc.stderr and "batched_nms kernel launches 0" in proc.stderr

    det = init_detector(path, str(work), cfg_options=options + png_opts, device="cpu")
    assert det.classes == tuple(NAMES)
    out = inference_detector(det, list(_images(3, seed=2)))
    for r in out:
        n = len(r["boxes"])
        assert r["boxes"].shape == (n, 4) and np.isfinite(r["boxes"]).all() and n <= 100
        assert ((r["labels"] >= 0) & (r["labels"] < 3)).all() and np.all(np.diff(r["scores"]) <= 0)
    single = inference_detector(det, _images(3, seed=2)[1])
    np.testing.assert_array_equal(single["labels"], out[1]["labels"])
    np.testing.assert_allclose(single["boxes"], out[1]["boxes"], rtol=0, atol=1e-2)
    with BatchingDetector(det, batch_size=3, max_latency_ms=50) as srv:  # served, batched as above
        served = [f.result(timeout=60) for f in [srv.submit(im) for im in _images(3, seed=2)]]
    for got, want in zip(served, out):
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-2)

    test_cli.main([path, str(work / "checkpoints"), "--device", "cpu", "--eval", "bbox", "--cfg-options",
                   *options, *png_opts])
    metrics = json.loads(capsys.readouterr().out)
    assert 0 <= metrics["bbox_mAP"] <= 1 and "bbox_mAP_50" in metrics
    model = build_model_and_anchors(Config.fromfile(path, options))[0]
    assert type(model.bbox_head).__name__ == {"atss": "ATSSHead", "retina": "AnchorHead"}[name]
