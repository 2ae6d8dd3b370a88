"""The eval path's test-time variants against the JAX package, float32 on
the CPU: ``--fuse-conv-bn`` (``models/fuse.py``), flip TTA
(``test_cfg.flip_tta``), multi-scale + flip TTA (``test_cfg.tta``) and
``test_cfg.nms_impl='scan'``.

Both packages get the same seeded numpy weights (``torch_parity.
numpy_variables``, carried by ``state_dict_from_flax``).  Tolerances:

- the fold: the fused state dict equal to ``state_dict_from_flax`` of the
  JAX package's fused variables, bit for bit, per trunk family and for a
  whole detector, with the same report; the port's fused forward within
  1e-5 (of each map's max) of its unfused one;
- the flip merge: flipped images equal, fused keep sets, labels and scores
  equal, boxes within 1e-3 px;
- the test CLI (``radet_tpu_torch.tools.test``) against
  ``radet_tpu.apis.test.test_from_config`` on a synthetic PNG test set
  (3 images at the 64x96 input size, 2 at 81x108, resized): labels equal,
  boxes within 1e-3 px, scores within 1e-5, metrics within 1e-3.
"""

import json
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.test import _flip_batch_images, _merge_flip_aug
from radet_tpu.apis.test import test_from_config as jax_test_from_config
from radet_tpu.apis.test import tta_padded_size as jax_tta_padded_size
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu.models import resnet as jres
from radet_tpu.models.fuse import fuse_conv_bn as jax_fuse_conv_bn
from radet_tpu.models.postprocess import Detections as JaxDetections
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis import test as port_test
from radet_tpu_torch.apis.common import build_model_and_anchors
from radet_tpu_torch.data.pipeline import build_pipeline
from radet_tpu_torch.engine.checkpoint import save_weights
from radet_tpu_torch.engine.convert import state_dict_from_flax
from radet_tpu_torch.models import build_backbone
from radet_tpu_torch.models.fuse import fuse_conv_bn
from radet_tpu_torch.models.postprocess import Detections, vote_fuse
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import write_bop_test_set
from test_torch_backbones import BACKBONE, VARIANTS, _carry, _nchw
from torch_parity import ANCHOR_CONFIGS, FLAGSHIP, IMG_HW, NARROW, numpy_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

NAMES = ["a", "b", "c", "d"]
GROUPS = [(3, IMG_HW), (2, (81, 108))]  # landscape only: one JAX compile per test_from_config
FUSE_RTOL = 1e-5  # fused vs unfused forward, of each map's max
BOX_ATOL, SCORE_ATOL, METRIC_ATOL = 1e-3, 1e-5, 1e-3

# one case per trunk family: the port's backbone config, the JAX module's keywords
FAMILIES = dict(VARIANTS, **{
    "ResNet-18": (dict(type="ResNet", depth=18), dict(depth=18)),
    "ResNet-50": (dict(type="ResNet", depth=50), dict(depth=50)),
})


def _jax_fuse(variables, path=()):
    """The JAX package's fold of a variable tree nested under ``path``, and
    its report."""
    def nest(tree):
        for k in reversed(path):
            tree = {k: tree}
        return tree

    fused, report = jax_fuse_conv_bn({col: nest(tree) for col, tree in variables.items()})
    return jax.tree_util.tree_map(np.asarray, fused), report


def _assert_same_state_dict(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _assert_maps_close(got, want, rtol):
    for g, w in zip(got, want):
        err = float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
        assert err <= rtol, err


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_fuse_conv_bn_matches_jax(name, rng):
    """Each trunk family: the fold equals the JAX package's bit for bit,
    every BatchNorm folded (none skipped, as in JAX), and the fused trunk
    computes what the unfused one does."""
    cfg, jax_kw = FAMILIES[name]
    flax_bb = jres.RegNet(arch=cfg["arch"]) if jax_kw is None else jres.ResNet(**jax_kw)
    port_bb = build_backbone(cfg)
    x = rng.rand(1, 36, 52, 3).astype(np.float32) * 4 - 2
    variables = _carry(flax_bb, port_bb, x, BACKBONE, train=False)
    want, want_report = _jax_fuse(variables, ("backbone",))
    want = {k[len("backbone."):]: v for k, v in state_dict_from_flax(want).items()}
    got, report = fuse_conv_bn(port_bb.state_dict())
    n_bn = sum(k.endswith("running_var") for k in got)
    assert report == want_report and report["fused"] == n_bn > 0 and report["skipped"] == 0
    _assert_same_state_dict(got, want)
    with torch.no_grad():
        before = port_bb(_nchw(x))
        port_bb.load_state_dict(got, strict=True)
        _assert_maps_close(port_bb(_nchw(x)), before, FUSE_RTOL)


@pytest.mark.parametrize("norm_eval", [True, False])
def test_fuse_conv_bn_whole_detector_matches_jax(norm_eval, rng):
    """The narrowed flagship: the fused state dict equals the JAX package's
    fused variables; the fused detector's head maps equal the unfused ones.
    Live BatchNorm (``norm_eval=False``) is folded as in JAX: at eval it
    applies its running statistics too."""
    opts = NARROW + [f"model.backbone.norm_eval={norm_eval}"]
    jax_cfg, cfg = JaxConfig.fromfile(FLAGSHIP, opts), Config.fromfile(FLAGSHIP, opts)
    jax_model = jax_build_model_and_anchors(jax_cfg)[0]
    port = build_model_and_anchors(cfg)[0]
    h, w = IMG_HW
    variables = numpy_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), train=False))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.eval()
    want, want_report = _jax_fuse(variables)
    got, report = fuse_conv_bn(port.state_dict())
    assert report == want_report and report["fused"] == 53
    _assert_same_state_dict(got, state_dict_from_flax(want))
    x = torch.from_numpy(rng.randn(2, 3, h, w).astype(np.float32))
    with torch.no_grad():
        before = [m for maps in port(x) for m in maps]
        port.load_state_dict(got, strict=True)
        _assert_maps_close([m for maps in port(x) for m in maps], before, FUSE_RTOL)


def test_flip_and_fusion_match_jax(rng):
    """``flip_images`` within each image's valid width, and the flip merge
    (``unflip_boxes`` and ``vote_fuse``) against the JAX package's
    ``_merge_flip_aug`` on clustered detections with score ties across the
    two views."""
    b, m, hw = 3, 12, (32, 48)
    images = rng.randint(0, 256, (b, *hw, 3)).astype(np.uint8)
    shapes = np.asarray([[32, 48], [32, 37], [20, 48]], np.float32)
    scales = np.asarray([[1.0] * 4, [0.5] * 4, [1.25] * 4], np.float32)
    got = port_test.flip_images(torch.from_numpy(images), torch.from_numpy(shapes)).numpy()
    np.testing.assert_array_equal(got, _flip_batch_images(images, shapes))
    assert not np.array_equal(got, images)

    centers = rng.uniform(10, 60, (4, 2))  # the objects both views see

    def dets(seed):
        r = np.random.RandomState(seed)
        idx = r.randint(0, 4, (b, m))
        xy = centers[idx] + r.randn(b, m, 2)
        wh = r.uniform(8, 12, (b, m, 2))
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
        scores = -np.sort(-np.round(r.uniform(0.1, 1.0, (b, m)), 1), axis=1).astype(np.float32)  # ties
        valid = np.arange(m)[None] < r.randint(m // 2, m + 1, (b, 1))
        return boxes, scores, (idx % 2).astype(np.int64), valid

    base, flipped = dets(1), dets(2)
    # the flipped view's detections, as its image sees them: mirror them into it
    w_ori = shapes[:, 1] / scales[:, 0]
    fb = flipped[0].copy()
    fb[..., 0], fb[..., 2] = w_ori[:, None] - flipped[0][..., 2], w_ori[:, None] - flipped[0][..., 0]
    flipped = (fb,) + flipped[1:]
    test_cfg = dict(nms=dict(type="vote", iou_threshold=0.5, iou_enable=True, sigma=0.5), max_per_img=m)
    batch = dict(image=images, img_shape=shapes, scale_factor=scales)
    ref = _merge_flip_aug(lambda v, x, s, f: JaxDetections(*flipped), None, batch, test_cfg, *base)

    def port_det(arrays):
        boxes, scores, labels, valid = (torch.from_numpy(a) for a in arrays)
        return Detections(boxes, scores, labels.to(torch.int32), valid)

    det_f = port_det(flipped)
    det_f = det_f._replace(boxes=port_test.unflip_boxes(det_f.boxes, torch.from_numpy(shapes),
                                                         torch.from_numpy(scales)))
    out = vote_fuse([port_det(base), det_f], test_cfg)
    rb, rs, rl, rv = ref
    assert 0 < rv.sum() < base[3].sum() + flipped[3].sum()  # the views' clusters merged
    np.testing.assert_array_equal(out.valid.numpy(), rv)
    np.testing.assert_array_equal(out.labels.numpy()[rv], rl[rv])
    np.testing.assert_array_equal(out.scores.numpy()[rv], rs[rv])
    np.testing.assert_allclose(out.boxes.numpy()[rv], rb[rv], rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("scale", [(640, 480), (600, 450), (160, 128), (200, 150), (1333, 800)])
def test_tta_padded_size_matches_jax(scale):
    for divisor in (16, 32):
        assert port_test.tta_padded_size(scale, divisor) == jax_tta_padded_size(scale, divisor)


# ------------------------------------------------ the test CLI against JAX


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """(config options reading the PNG test set, the JAX variable tree, the
    port's checkpoint holding the same weights)."""
    root = tmp_path_factory.mktemp("tta_png")
    ann = write_bop_test_set(str(root), np.random.RandomState(0), GROUPS, NAMES)
    opts = NARROW + ["data.samples_per_gpu=2"] + [f"data.test.{k}={v!r}" for k, v in (
        ("ann_file", ann), ("img_prefix", osp.join(str(root), "test") + "/"), ("classes", NAMES),
        ("pipeline.1.img_scale", IMG_HW[::-1]))]
    jax_model = jax_build_model_and_anchors(JaxConfig.fromfile(FLAGSHIP, opts))[0]
    h, w = IMG_HW
    variables = numpy_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), train=False))
    ckpt = str(root / "weights.pth")
    save_weights(ckpt, state_dict_from_flax(variables))
    return opts, variables, ckpt


def _cli(opts, ckpt, tmp_path, capsys, *flags):
    out = str(tmp_path / "results.pkl")
    test_cli.main([FLAGSHIP, ckpt, "--device", "cpu", "--eval", "bbox", "--out", out, *flags,
                   "--cfg-options", *opts])
    metrics = json.loads(capsys.readouterr().out)
    with open(out, "rb") as f:
        return pickle.load(f), metrics


def _assert_same_detections(got, want):
    """One image's detections: the same, label for label, scores within
    SCORE_ATOL and boxes within BOX_ATOL.  Both are in score order; among
    scores that close the order is rounding's, so each detection is
    matched to an unmatched counterpart rather than to its slot."""
    assert len(got["labels"]) == len(want["labels"])
    free = list(range(len(want["labels"])))
    for i in range(len(got["labels"])):
        match = [j for j in free if got["labels"][i] == want["labels"][j]
                 and abs(float(got["scores"][i]) - float(want["scores"][j])) <= SCORE_ATOL
                 and np.abs(got["boxes"][i] - want["boxes"][j]).max() <= BOX_ATOL]
        assert match, f"detection {i} ({got['labels'][i]}, {got['scores'][i]}, {got['boxes'][i]}) unmatched"
        free.remove(match[0])


def _assert_same_eval(got, want, min_kept):
    (results, metrics), (ref, ref_metrics) = got, want
    assert [r["img_id"] for r in results] == [r["img_id"] for r in ref] and len(results) == 5
    assert sum(len(r["labels"]) for r in results) >= min_kept
    for a, b in zip(results, ref):
        _assert_same_detections(a, b)
    assert metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        assert abs(metrics[k] - ref_metrics[k]) <= METRIC_ATOL, k


@pytest.mark.parametrize("variant", ["flip_tta", "multiscale_flip_tta", "nms_impl_scan"])
def test_cli_test_time_augmentation_matches_jax(variant, eval_pair, tmp_path, capsys):
    """``python -m radet_tpu_torch.tools.test CONFIG CKPT --eval bbox
    --cfg-options ...`` with flip TTA, with two scales (the input size and
    a larger one) and flip, and with ``nms_impl=scan``, against
    ``radet_tpu.apis.test.test_from_config`` on the same config."""
    opts, variables, ckpt = eval_pair
    extra = {
        "flip_tta": ["test_cfg.flip_tta=True"],
        "multiscale_flip_tta": [f"test_cfg.tta.scales=[{IMG_HW[::-1]}, (128, 96)]", "test_cfg.tta.flip=True"],
        "nms_impl_scan": ["test_cfg.nms_impl='scan'"],
    }[variant]
    want = jax_test_from_config(JaxConfig.fromfile(FLAGSHIP, opts + extra), variables)[1:]
    got = _cli(opts + extra, ckpt, tmp_path, capsys)
    # each fused image keeps at most max_per_img (100) of its views' detections
    _assert_same_eval(got, want, min_kept=100)


def test_cli_fuse_conv_bn_matches_jax(eval_pair, tmp_path, capsys):
    """``tools.test --fuse-conv-bn`` against ``test_from_config`` of the JAX
    package's fused variables, and against the port's unfused run."""
    opts, variables, ckpt = eval_pair
    fused, _ = _jax_fuse(variables)
    want = jax_test_from_config(JaxConfig.fromfile(FLAGSHIP, opts), fused)[1:]
    got = _cli(opts, ckpt, tmp_path, capsys, "--fuse-conv-bn")
    _assert_same_eval(got, want, min_kept=100)
    _assert_same_eval(_cli(opts, ckpt, tmp_path, capsys), got, min_kept=100)


def test_refusals_match_jax():
    """``tta.scales`` on an anchor head, ``MultiScaleFlipAug`` with several
    scales or flip, and ``--fuse-conv-bn`` on an int8 config: the port
    refuses as the JAX package does."""
    path, options = ANCHOR_CONFIGS["atss"]
    options = options + ["test_cfg.tta.scales=[(160, 128)]"]
    with pytest.raises(AssertionError) as ref:
        jax_test_from_config(JaxConfig.fromfile(path, options), None)
    with pytest.raises(AssertionError) as got:
        port_test.test_from_config(Config.fromfile(path, options), None)
    assert got.value.args == ref.value.args and "tta" in got.value.args[0]
    for entry in (dict(type="MultiScaleFlipAug", img_scale=[(96, 64), (128, 96)], transforms=[]),
                  dict(type="MultiScaleFlipAug", img_scale=(96, 64), flip=True, transforms=[])):
        with pytest.raises(ValueError) as ref:
            jax_pipeline.build_pipeline([entry])
        with pytest.raises(ValueError) as got:
            build_pipeline([entry])
        assert got.value.args == ref.value.args and "`tta`" in got.value.args[0]
    with pytest.raises(ValueError, match="--fuse-conv-bn is incompatible with backbone.quant='int8'"):
        test_cli.main([osp.join(osp.dirname(FLAGSHIP), "r50_ycbv_pbr_int8_stream.py"), "--device", "cpu",
                       "--fuse-conv-bn"])
