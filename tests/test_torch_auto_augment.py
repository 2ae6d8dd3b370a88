"""The port's affine warps and AutoAugment family against cv2 5.0.0 and the
JAX package on the CPU.

- ``warp.warp_affine`` (C++ and numpy twin) against ``cv2.warpAffine``:
  rotations at scale 1 and not, shears in both directions, translations,
  bilinear and nearest, 1 and 3 channels, scalar and 3-tuple fills, widths
  whose rows end in cv2's scalar tail and widths below one vector step,
  exact angles (points on half pixels): byte-equal;
- ``warp.rotation_matrix_2d`` against ``cv2.getRotationMatrix2D`` and
  ``warp.dilate3x3`` (and twin) against ``cv2.dilate``: equal;
- ``Shear``, ``Rotate``, ``Translate``, ``ColorTransform``,
  ``EqualizeTransform``, ``BrightnessTransform``, ``ContrastTransform``
  and ``AutoAugment`` against the JAX package's, ``random`` and
  ``np.random`` seeded alike, over 12 seeds (one 480x640 fixture, the rest
  60x80 to 120x160): ``img``, ``gt_bboxes``, ``gt_labels`` and ``gt_masks``
  byte-equal; the same validation errors.
"""

import copy
import pickle
import random

import cv2
import numpy as np
import pytest

from radet_tpu.data import auto_augment as jax_aa
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu_torch.data import auto_augment, warp
from radet_tpu_torch.data.pipeline import build_pipeline
from aug_parity import assert_same, aug_results, fixture_image
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

SEEDS = range(12)
F32, F64 = np.float32, np.float64


def _matrix(kind: str, rng, h: int, w: int) -> np.ndarray:
    if kind == "rotate":
        return cv2.getRotationMatrix2D((rng.uniform(0, w), rng.uniform(0, h)), rng.uniform(-180, 180),
                                       rng.uniform(0.5, 1.5))
    if kind == "exact":  # points on half pixels: the roundings' ties
        return cv2.getRotationMatrix2D((w / 2 - 0.5 * rng.randint(2), h / 2 - 0.5 * rng.randint(2)),
                                       float(rng.choice([90, 45, 30, -60, 180, 15])), float(rng.choice([1, 0.5, 2])))
    if kind == "shear-h":
        return np.array([[1, rng.uniform(-0.3, 0.3), 0], [0, 1, 0]], F32).astype(F64)
    if kind == "shear-v":
        return np.array([[1, 0, 0], [rng.uniform(-0.3, 0.3), 1, 0]], F32).astype(F64)
    return np.array([[1, 0, rng.randint(-50, 50)], [0, 1, rng.randint(-50, 50)]], F32).astype(F64)


KINDS = ["rotate", "exact", "shear-h", "shear-v", "translate"]


@pytest.mark.parametrize("kind", KINDS)
def test_warp_affine_matches_cv2(kind):
    rng = np.random.RandomState(KINDS.index(kind))
    images = [fixture_image(0)] + [rng.randint(0, 256, (rng.randint(1, 130), rng.randint(1, 170)) + c).astype(np.uint8)
                              for c in [(3,), (), (3,), (1,), (3,), ()] * 2]
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        mat = _matrix(kind, rng, h, w)
        fill = tuple(float(v) for v in rng.randint(0, 256, 3)) if i % 2 else float(rng.randint(0, 256))
        for interp, flag in (("bilinear", cv2.INTER_LINEAR), ("nearest", cv2.INTER_NEAREST)):
            want = cv2.warpAffine(img, mat, (w, h), flags=flag, borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=fill).reshape(img.shape)
            what = f"{kind} {interp} {img.shape} fill {fill}"
            np.testing.assert_array_equal(warp.warp_affine(img, mat, fill, interp), want, err_msg=what)
            np.testing.assert_array_equal(warp.warp_affine_plain(img, mat, fill, interp), want, err_msg=what)


def test_rotation_matrix_and_dilate_match_cv2():
    rng = np.random.RandomState(5)
    for _ in range(500):
        args = ((rng.uniform(-10, 700), rng.uniform(-10, 500)), rng.uniform(-360, 360), rng.uniform(0.3, 2))
        np.testing.assert_array_equal(warp.rotation_matrix_2d(*args), cv2.getRotationMatrix2D(*args))
    for hw in [(1, 1), (2, 7), (60, 81), (480, 640)]:
        m = (rng.rand(*hw) < 0.05).astype(np.uint8) * rng.randint(1, 256)
        want = cv2.dilate(m, np.ones((3, 3), np.uint8))
        np.testing.assert_array_equal(warp.dilate3x3(m), want)
        np.testing.assert_array_equal(warp.dilate3x3_plain(m), want)
    with pytest.raises(ValueError):
        warp.warp_affine(np.zeros((4, 4), np.float32), np.eye(3)[:2])
    with pytest.raises(ValueError):
        warp.warp_affine(np.zeros((4, 4), np.uint8), np.eye(3)[:2], interpolation="cubic")


POLICIES = [
    [dict(type="Translate", level=4, prob=0.6), dict(type="EqualizeTransform", prob=0.8)],
    [dict(type="Shear", level=2, prob=1.0, direction="vertical"),
     dict(type="Translate", level=6, prob=0.6, direction="vertical")],
    [dict(type="Rotate", level=10, prob=0.6), dict(type="ColorTransform", level=6, prob=1.0)],
    [dict(type="BrightnessTransform", level=6, prob=0.5), dict(type="ContrastTransform", level=4, prob=0.5)],
    [dict(type="Shear", level=4, prob=0.4)],
]

TRANSFORMS = [
    dict(type="Shear", level=7, prob=0.8),
    dict(type="Shear", level=10, prob=0.8, direction="vertical", img_fill_val=(10, 200, 30), interpolation="nearest"),
    dict(type="Rotate", level=8, prob=0.8),
    dict(type="Rotate", level=5, prob=0.8, scale=1.2, center=40, max_rotate_angle=90),
    dict(type="Translate", level=9, prob=0.8, max_translate_offset=60),
    dict(type="Translate", level=10, prob=0.8, direction="vertical", max_translate_offset=100, min_size=4),
    dict(type="ColorTransform", level=3, prob=0.8),
    dict(type="EqualizeTransform", prob=0.8),
    dict(type="BrightnessTransform", level=9, prob=0.8),
    dict(type="ContrastTransform", level=2, prob=0.8),
    dict(type="AutoAugment", policies=POLICIES),
]


@pytest.mark.parametrize("cfg", TRANSFORMS, ids=[f"{c['type']}-{i}" for i, c in enumerate(TRANSFORMS)])
def test_transforms_match_jax(cfg):
    port, ref = build_pipeline([cfg]), jax_pipeline.build_pipeline([cfg])
    port = pickle.loads(pickle.dumps(port))  # process workers pickle the pipeline
    changed = 0
    for seed in SEEDS:
        results = aug_results(seed)
        random.seed(seed)
        np.random.seed(seed)
        want = ref(copy.deepcopy(results))
        random.seed(seed)
        np.random.seed(seed)
        got = port(copy.deepcopy(results))
        assert_same(got, want, f"{cfg['type']} seed {seed}")
        changed += not np.array_equal(got["img"], results["img"])
    assert changed >= 3  # the transform fired on several seeds


def test_boxes_keep_the_matrix_dtype():
    """Shear's float32 matrix and Rotate's float64 one take the corners
    through numpy's promotion as JAX's; a box that collapses is dropped
    with its label and mask."""
    boxes = np.array([[10.3, 20.7, 30.1, 40.9], [0.0, 5.0, 0.5, 9.0]], np.float32)
    for mat in (np.array([[1, 0.123, 0], [0, 1, 0]], F32), warp.rotation_matrix_2d((31.5, 20.5), 13.7, 1.0)):
        got = auto_augment._warp_bboxes(boxes, mat, 64, 48)
        assert got.dtype == np.float32 and np.array_equal(got, jax_aa._warp_bboxes(boxes, mat, 64, 48))
    results = dict(gt_bboxes=np.array([[1, 1, 5, 5], [3, 3, 3.5, 9]], np.float32), gt_labels=np.array([1, 2]),
                   gt_masks=np.ones((2, 4, 4), np.uint8))
    want = copy.deepcopy(results)
    auto_augment._filter_degenerate(results, 1)
    jax_aa._filter_degenerate(want, 1)
    assert_same(results, want, "filter")
    assert len(results["gt_bboxes"]) == 1


BAD = [
    ("Shear", dict(level=11)), ("Shear", dict(level=3, prob=1.5)), ("Shear", dict(level=3, direction="up")),
    ("Shear", dict(level=3, max_shear_magnitude=2)), ("Rotate", dict(level=3, img_fill_val=(1, 2))),
    ("Rotate", dict(level=3, img_fill_val=(1, 2, 300))), ("Translate", dict(level=-1)),
    ("Translate", dict(level=3, direction="diagonal")), ("ColorTransform", dict(level=12)),
    ("EqualizeTransform", dict(prob=-0.1)), ("BrightnessTransform", dict(level=3, prob=2)),
    ("AutoAugment", dict(policies=[])), ("AutoAugment", dict(policies=[[]])),
    ("AutoAugment", dict(policies=[["Shear"]])), ("AutoAugment", dict(policies=[[dict(type="Nope")]])),
]


@pytest.mark.parametrize("t_type,kw", BAD, ids=[f"{t}-{i}" for i, (t, _) in enumerate(BAD)])
def test_validation_errors_match_jax(t_type, kw):
    with pytest.raises((ValueError, KeyError)) as want:
        jax_pipeline.build_pipeline([dict(type=t_type, **kw)])
    with pytest.raises(want.type) as got:
        build_pipeline([dict(type=t_type, **kw)])
    assert str(got.value) == str(want.value)
