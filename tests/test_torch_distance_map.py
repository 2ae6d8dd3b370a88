"""Mask-free distance maps in the port (ROADMAP item 17) against cv2 5.0.0 and
the JAX package on the CPU.

- cv2's operations on the path, bit for bit: the uint8 INTER_LINEAR resize
  at any ratio and odd widths, the float32 one (OpenCV's own arithmetic;
  cv2's default build takes Intel IPP for it, within 2e-5 of a [0, 1]
  map), ``GaussianBlur`` at (3, 3) and (9, 9) with sigma 0, the 15-bit
  ``COLOR_RGB2GRAY`` over every colour, and the Sobel cost;
- the C++ MBD and GDT against their numpy twins (bit for bit), against the
  JAX package's numpy versions (GDT bit for bit; MBD, whose JAX twin takes
  alpha in float64 where both C++ libraries take a float, within 1e-9 of
  its maximum) and its native library (built with -march=native, which
  fuses multiply-adds: within 1e-12 and 1e-5 of the maximum);
- ``boxes_to_distance_maps`` against JAX's with the fill colours drawn
  alike, for small, clipped, edge-touching, degenerate and large boxes:
  within 2e-5 (the float32 resize back to the box: IPP's coordinates), and
  the float16 maps one float16 step apart at most;
- a mask-free dataset sample (``GenerateDistanceMap(with_gt_mask=False)``
  after the flagship's own transforms) against JAX's ``build_dataset`` on
  the same files: every key equal but ``dist_vals``, which after their
  float16 cast lie within 2e-5 plus one float16 step (9.8e-4 relative);
- one narrow train step on those samples against JAX's, at
  ``tests/test_torch_train.py``'s bars; and the train CLI on a mask-free
  config with a periodic eval.
"""

import os.path as osp
import random
import re
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.data.loader import collate as jax_collate
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu.ops import distance_transform as jax_dt
from radet_tpu.ops import native as jax_native
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import assignment_cfg_from, build_dataset, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.data import collate, color_aug
from radet_tpu_torch.data.gaussian_taps import GAUSSIAN_KSIZE_TAPS
from radet_tpu_torch.data.pipeline import GenerateDistanceMap, resize_linear, resize_linear_f32
from radet_tpu_torch.engine import build_optimizer, build_train_step, state_dict_from_flax
from radet_tpu_torch.engine.checkpoint import load_weights
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
from radet_tpu_torch.ops import distance_transform as dt
from radet_tpu_torch.utils.config import Config
from fixtures import make_synthetic_bop
from synthetic_bop import write_bop_test_set, write_train_config
from torch_parity import FLAGSHIP, NARROW, flax_and_port_models, jax_assignment_noise
from torch_threads import default_torch_threads, one_thread_env, one_torch_thread  # noqa: F401 (fixtures)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "data", "color_aug"))
import make_fixtures  # noqa: E402 (cv2's taps)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
HW = (128, 160)  # boxes of 16 to 41 px: some gated small, most through the transforms
RESIZE_IPP_ATOL = 2e-5  # cv2's IPP float32 resize against OpenCV's arithmetic, on a [0, 1] map
F16_STEP = 2.0 ** -10  # the float16 spacing relative to a value, at most
OPTS = NARROW + [f"input_size={HW}", "data.samples_per_gpu=2", "data.train.classes=None",
                 f"data.train.pipeline.2.img_scale={HW[::-1]}"]


def _sizes(rng, n):
    """(h, w) pairs: odd and even, from 2 px."""
    return [(int(h), int(w)) for h, w in rng.randint(2, 160, (n, 2))] + [(2, 2), (9, 7), (150, 151)]


# ---------------------------------------------------------------- cv2's ops


@pytest.mark.parametrize("channels", [1, 3])
def test_uint8_resize_equals_cv2(channels):
    """``resize_linear`` at arbitrary ratios up and down, odd widths (rows
    that are no multiple of cv2's vector width), and the exact 2x box."""
    rng = np.random.RandomState(channels)
    for h0, w0 in _sizes(rng, 40):
        for w1, h1 in [tuple(int(v) for v in rng.randint(2, 300, 2)), (max(1, w0 // 2), max(1, h0 // 2)),
                       (150, int(150 * h0 / w0) or 2)]:
            img = rng.randint(0, 256, (h0, w0, channels)).astype(np.uint8)
            want = cv2.resize(img, (w1, h1)).reshape(h1, w1, channels)
            np.testing.assert_array_equal(resize_linear(img, (w1, h1)), want, err_msg=f"{(h0, w0)} -> {(h1, w1)}")


def test_float32_resize_equals_opencv_arithmetic():
    """``resize_linear_f32`` equals ``cv2.resize`` with IPP off bit for bit
    (2x downscales included), and cv2's default (IPP) within
    RESIZE_IPP_ATOL on [0, 1] maps."""
    rng = np.random.RandomState(0)
    worst = 0.0
    try:
        for i, (h0, w0) in enumerate(_sizes(rng, 60)):
            w1, h1 = (w0 // 2 or 1, h0 // 2 or 1) if i % 5 == 0 else tuple(int(v) for v in rng.randint(2, 300, 2))
            x = rng.rand(h0, w0).astype(np.float32)
            got = resize_linear_f32(x, (w1, h1))
            cv2.ipp.setUseIPP(False)
            np.testing.assert_array_equal(got, cv2.resize(x, (w1, h1)), err_msg=f"{(h0, w0)} -> {(h1, w1)}")
            cv2.ipp.setUseIPP(True)
            worst = max(worst, float(np.abs(got - cv2.resize(x, (w1, h1))).max()))
    finally:
        cv2.ipp.setUseIPP(True)
    assert worst <= RESIZE_IPP_ATOL


@pytest.mark.parametrize("ksize", [3, 9])
def test_blur_at_kernel_size_equals_cv2(ksize):
    """``cv2.GaussianBlur(img, (k, k), 0)``: the committed taps are cv2's,
    and the C++ blur and its twin give cv2's pixels at odd and even sizes."""
    assert list(GAUSSIAN_KSIZE_TAPS[ksize]) == make_fixtures.cv2_taps(ksize=ksize)
    rng = np.random.RandomState(ksize)
    for h, w in _sizes(rng, 12):
        if min(h, w) < ksize:
            continue
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.GaussianBlur(img, (ksize, ksize), 0)
        np.testing.assert_array_equal(color_aug.gaussian_blur(img, ksize=ksize), want)
        np.testing.assert_array_equal(color_aug.gaussian_blur_plain(img, ksize=ksize), want)
    with pytest.raises(NotImplementedError, match="item 12"):
        color_aug.gaussian_blur(img, ksize=5)


def test_gray_equals_cv2_on_every_colour():
    """``rgb_to_gray`` (shift 15) and its twin are ``cv2.cvtColor(img,
    COLOR_RGB2GRAY)`` on all 2^24 colours."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(color_aug.rgb_to_gray(rgb), want)
    np.testing.assert_array_equal(color_aug.rgb_to_gray_plain(rgb[::64]), want[::64])


def test_sobel_cost_equals_cv2():
    """|cv2.addWeighted(Sobel_x, 0.5, Sobel_y, 0.5, 0)| in float32, C++ and
    twin, at odd and even sizes; and ``sobel_edges`` as the JAX package's."""
    rng = np.random.RandomState(4)
    for h, w in _sizes(rng, 12):
        gray = rng.randint(0, 256, (h, w)).astype(np.uint8)
        ex, ey = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3), cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3)
        want = np.abs(cv2.addWeighted(ex, 0.5, ey, 0.5, 0))
        np.testing.assert_array_equal(dt.sobel_cost(gray), want)
        np.testing.assert_array_equal(dt.sobel_cost_plain(gray), want)
        if min(h, w) >= 3:
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            np.testing.assert_array_equal(dt.sobel_edges(img), jax_dt.sobel_edges(img))


# ------------------------------------------------------------ the transforms


def _transform_inputs(rng):
    """Small images (the twins loop in Python) with border seeds at
    intervals 3 and 1."""
    for h, w, interval in ((2, 2, 1), (7, 9, 3), (16, 5, 1), (23, 31, 3), (12, 40, 2)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img[h // 3:, w // 4:w // 2] = img[0, 0]  # a flat region: ties in the barriers
        yield img, *dt.border_seeds(h, w, interval)


@pytest.mark.parametrize("method", dt.METHODS)
def test_transforms_equal_their_twins(method):
    """The C++ transform and its numpy twin, bit for bit; at alpha 0.1 and
    0.37, niter 4 and 3 (MBD)."""
    rng = np.random.RandomState(len(method))
    for img, sx, sy in _transform_inputs(rng):
        if method == "mbd":
            for kw in (dict(), dict(alpha=0.37, niter=3, base_size=5)):
                np.testing.assert_array_equal(dt.mbd(img, sx, sy, **kw), dt.mbd_plain(img, sx, sy, **kw))
        else:
            cost = dt.sobel_edges(img) if min(img.shape[:2]) >= 3 else rng.rand(*img.shape[:2]).astype(np.float32)
            np.testing.assert_array_equal(dt.gdt(cost, sx, sy), dt.gdt_plain(cost, sx, sy))


@pytest.mark.parametrize("method", dt.METHODS)
def test_transforms_against_jax(method):
    """Against the JAX package's numpy versions (GDT bit for bit; MBD within
    1e-9 of its maximum, alpha float64 there) and its native library (MBD
    within 1e-12, GDT 1e-5 of the maximum: -march=native fuses
    multiply-adds)."""
    rng = np.random.RandomState(7)
    for img, sx, sy in _transform_inputs(rng):
        if method == "mbd":
            got = dt.mbd(img, sx, sy)
            scale = max(float(got.max()), 1e-30)
            assert np.abs(got - jax_dt.mbd_numpy(img, sx, sy)).max() <= 1e-9 * scale
            assert np.abs(got - jax_native.mbd(img, sx, sy)).max() <= 1e-12 * scale
        else:
            cost = rng.rand(*img.shape[:2]).astype(np.float32)
            got = dt.gdt(cost, sx, sy)
            np.testing.assert_array_equal(got, jax_dt.gdt_numpy(cost, sx, sy))
            assert np.abs(got - jax_native.gdt(cost, sx, sy)).max() <= 1e-5 * float(got.max())


BOXES = np.array([
    [10, 12, 70, 90],  # inside
    [0, 0, 160, 120],  # the whole image
    [120, 30, 190, 80],  # clipped at the right edge
    [-15, 60, 40, 140],  # clipped at the left and bottom
    [5, 5, 20, 20],  # small: uniform
    [30, 40, 31, 90],  # one pixel wide: no map
    [50, 50, 50, 80],  # zero wide
    [90, 90, 80, 100],  # inverted
    [33.7, 20.2, 99.9, 61.5],  # fractional
    [0, 0, 48, 22],  # the corner, large by a little: (48 + 1) (22 + 1) > 1024
], np.float32)


@pytest.mark.parametrize("method", dt.METHODS)
def test_boxes_to_distance_maps_match_jax(method):
    """Per-GT maps of a 120x160 image against JAX's, the fill colours drawn
    alike (JAX from ``random``, the port from a generator of the same
    seed): the small and degenerate boxes' maps equal, every map within
    RESIZE_IPP_ATOL, the float16 maps at most one float16 step apart, and
    both generators at the same state after."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    for x1, y1, x2, y2 in BOXES[:4].astype(int):
        img[max(0, y1) + 5:y2 - 5, max(0, x1) + 5:x2 - 5] = rng.randint(0, 256, 3)
    random.seed(11)
    want = jax_dt.boxes_to_distance_maps(img, BOXES, method=method)
    after = random.random()
    gen = random.Random(11)
    got = dt.boxes_to_distance_maps(img, BOXES, method=method, rng=gen)
    assert gen.random() == after
    assert got.shape == want.shape == (len(BOXES), 120, 160) and got.dtype == np.float32
    for g in (4, 5, 6, 7):
        np.testing.assert_array_equal(got[g], want[g])
    assert [float(m.max()) for m in got] == [float(m.max()) for m in want]
    assert [float(m.max()) for m in got[:8]] == [1.0] * 5 + [0.0] * 3  # large and small boxes; degenerate ones
    assert np.abs(got - want).max() <= RESIZE_IPP_ATOL
    f16 = np.abs(got.astype(np.float16).astype(np.float32) - want.astype(np.float16).astype(np.float32))
    assert (f16 <= F16_STEP * np.maximum(np.abs(want), 2.0 ** -14)).all()
    # a pipeline transform of its own seed draws as the JAX one under random.seed
    results = dict(img=img, gt_bboxes=BOXES)
    mapped = GenerateDistanceMap(with_gt_mask=False, distance_transform=method, seed=11)(dict(results))
    np.testing.assert_array_equal(mapped["distance_maps"], got)


def test_unknown_method_raises():
    """An unknown method raises where a large box reaches the transform, on
    both sides; an image of small and degenerate boxes alone gets its maps."""
    img = np.zeros((64, 64, 3), np.uint8)
    box = np.array([[0, 0, 60, 60]], np.float32)
    small = np.array([[2, 2, 20, 20], [5, 5, 6, 40]], np.float32)
    for fn in (jax_dt.boxes_to_distance_maps, dt.boxes_to_distance_maps):
        with pytest.raises(ValueError, match="unknown distance transform 'sdf'"):
            fn(img, box, method="sdf")
    want = jax_dt.boxes_to_distance_maps(img, small, method="sdf")
    np.testing.assert_array_equal(dt.boxes_to_distance_maps(img, small, method="sdf"), want)
    assert want[0, 2:20, 2:20].min() == 1.0 and not want[1].any()


# ------------------------------------------------------- the dataset and step


@pytest.fixture(scope="module")
def mask_free(tmp_path_factory):
    """{'gdt': config, 'mbd': config}: the flagship training from a
    synthetic BOP split at HW through its own pipeline, with boxes alone
    (``write_train_config(mask_free=...)``), and a PNG test split as
    data.val for the periodic eval."""
    root = str(tmp_path_factory.mktemp("mask_free"))
    ann, prefix = make_synthetic_bop(root, num_scenes=1, images_per_scene=4, img_hw=HW, num_classes=4,
                                     max_objects=4, seed=3)
    val = write_bop_test_set(osp.join(root, "val"), np.random.RandomState(1), [(2, HW)], ["a", "b", "c", "d"])
    background = osp.join(root, "background")
    make_synthetic_bop(background, images_per_scene=1, img_hw=HW, seed=9)
    configs = {m: write_train_config(osp.join(root, f"{m}.py"), FLAGSHIP, ann, prefix,
                                     osp.join(background, "train_pbr", "000000", "rgb"), mask_free=m)
               for m in dt.METHODS}
    val_opts = [f"data.val.ann_file={val!r}", f"data.val.img_prefix={osp.join(root, 'val', 'test') + '/'!r}",
                "data.val.classes=['a', 'b', 'c', 'd']", f"data.val.pipeline.1.img_scale={HW[::-1]}"]
    return configs, val_opts


def _samples(path, n):
    """n samples of both packages' ``build_dataset(cfg, 'train')``, each
    index seeded alike (``np.random``, ``random``) on both sides."""
    ref_ds = jax_build_dataset(JaxConfig.fromfile(path, OPTS), "train", test_mode=False)
    port_ds = build_dataset(Config.fromfile(path, OPTS), "train")
    assert [type(t).__name__ for t in port_ds.pipeline.transforms] == [
        type(t).__name__ for t in ref_ds.pipeline.transforms]
    out = ([], [])
    for idx in range(n):
        for side, ds in enumerate((ref_ds, port_ds)):
            np.random.seed(40 + idx)
            random.seed(40 + idx)
            out[side].append(ds[idx])
    return out


@pytest.mark.parametrize("method", dt.METHODS)
def test_mask_free_samples_match_jax(mask_free, method):
    """Every sample of the mask-free pipeline (CosyPoseAug, RandomBackground
    skipping without masks, the flip, the maps) against JAX's: every key
    equal but ``dist_vals``, and those within RESIZE_IPP_ATOL plus one
    float16 step of each value."""
    ref, got = _samples(mask_free[0][method], 4)
    nonuniform = 0
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            if k != "dist_vals":
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i}: {k}")
        x, y = a["dist_vals"].astype(np.float32), b["dist_vals"].astype(np.float32)
        assert (np.abs(x - y) <= RESIZE_IPP_ATOL + F16_STEP * np.abs(y)).all(), i
        nonuniform += int(((y > 0) & (y < 1)).sum())
    assert nonuniform > 50  # the transforms' maps, not only the small boxes' uniform ones


@pytest.mark.usefixtures("default_torch_threads")  # the trunk's bar holds on torch's default count (ROADMAP Queue 3)
def test_mask_free_train_step_matches_jax(mask_free):
    """One narrow float32 train step of each package on its own mask-free
    batch (two samples, GDT maps) with the same weights and assignment
    noise: losses within 1e-5, gradients within 1e-4 of each tensor's max
    (``tests/test_torch_train.py``'s bars)."""
    ref_samples, samples = _samples(mask_free[0]["gdt"], 2)
    path = mask_free[0]["gdt"]
    jax_cfg, cfg = JaxConfig.fromfile(path, OPTS), Config.fromfile(path, OPTS)
    jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
    port, _, _, _ = build_model_and_anchors(cfg)
    variables = flax_and_port_models(jax_model, port, img_hw=HW)
    jbatch, batch = jax_collate(ref_samples), collate(samples)
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    capture = optax.GradientTransformation(  # the JAX step's optimizer keeps the gradients as its state
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_))
    jstep = jax_build_train_step(jax_model, capture, anchors, ranges, img_norm=jax_cfg.img_norm_cfg.to_dict(),
                                 num_classes=4, assignment_cfg=jax_assignment_cfg_from(jax_cfg),
                                 loss_cfg=jax_loss_cfg_from(jax_cfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                           opt_state=capture.init(params))
    key = jax.random.PRNGKey(3)
    jstate, ref = jstep(jstate, {k: jnp.asarray(jbatch[k]) for k in
                                 ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}, key)
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})
    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    step = build_train_step(port, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    metrics = step(TrainState(port, sgd0), batch_to_device(batch, "cpu"), noise)
    assert float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        assert abs(float(metrics[k]) - float(ref[k])) <= 1e-5 * max(1.0, abs(float(ref[k]))), k
    for name, p in port.named_parameters():
        if p.requires_grad:
            want = ref_grads[name].numpy()
            assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * max(float(np.abs(want).max()), 1e-30), name


def test_mask_free_config_trains_through_the_cli(mask_free, tmp_path):
    """``python -m radet_tpu_torch.tools.train`` on the mask-free MBD config
    at narrow width: two steps with finite losses, the periodic eval at
    step 2, and a checkpoint that loads into the model."""
    configs, val_opts = mask_free
    work = str(tmp_path / "work")
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.train", configs["mbd"], "--work-dir", work, "--device", "cpu",
           "--max-iters", "2", "--cfg-options", *OPTS, *val_opts, "log_config.interval=1",
           "checkpoint_config.interval=2", "evaluation.interval=2", "data.workers_per_gpu=1"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=one_thread_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = [ln.split(" - ")[-1] for ln in proc.stderr.splitlines()]  # the messages of the package's log
    losses = [float(v) for ln in log if ln.startswith("iter ") for v in re.findall(r" loss (\S+)", ln)]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    assert sum(ln.startswith("eval: ") for ln in log) == 1, proc.stderr[-2000:]
    model = build_model_and_anchors(Config.fromfile(configs["mbd"], OPTS))[0]
    model.load_state_dict(load_weights(osp.join(work, "checkpoints")), strict=True)
    assert all(torch.isfinite(p).all() for p in model.parameters())
