"""The port's SSD-recipe and other extra transforms against the JAX package's
on the CPU, and the VOC training sample through the SSD recipe.

- each transform, with ``random`` and ``np.random`` seeded alike on both
  sides, over several seeds: byte-equal images, boxes, labels, masks and
  shapes, and the same None (resample) decisions;
- ``PhotoMetricDistortion``'s RGB<->HSV conversions (``color_aug``'s
  ``rgb_to_hsv_f32`` and ``hsv_to_rgb_f32`` in host C++, and their numpy
  twins) bit for bit against cv2 5.0.0's float32 ``cvtColor``, its vector
  body and scalar tail (rows of any width), and the twins' single-rounding
  ``_fma32`` on ties;
- a packed VOC training sample through ``SSD_VOC_PIPELINE`` (the flagship
  config with ``voc_options``) against JAX's ``build_dataset``: every key
  equal but ``dist_vals``, which the float32 resize inside the box maps
  puts within 2e-5 plus one float16 step (cv2's IPP path, as in
  ``tests/test_torch_distance_map.py``).
"""

import copy
import os
import random

import cv2
import numpy as np
import pytest

from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_dataset
from radet_tpu_torch.data import pipeline
from radet_tpu_torch.data.color_aug import (_fma32, hsv_to_rgb_f32, hsv_to_rgb_f32_plain, rgb_to_hsv_f32,
                                            rgb_to_hsv_f32_plain)
from radet_tpu_torch.data.pipeline import build_pipeline
from radet_tpu_torch.utils.config import Config
from radet_tpu_torch.utils.image_write import write_png
from synthetic_bop import jpeg_fixtures, synthetic_bop_records, voc_options, write_voc_split
from torch_parity import FLAGSHIP, NARROW
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

HW = (60, 80)
SEEDS = range(12)
RESIZE_IPP_ATOL = 2e-5  # cv2's IPP float32 resize against OpenCV's arithmetic, on a [0, 1] map
F16_STEP = 2.0 ** -10  # the float16 spacing relative to a value, at most


def _results(seed, masks=True, seg=False):
    """A results dict of a 60x80 noise image with rectangles, their boxes,
    labels and (with ``masks``) masks, and (with ``seg``) a semantic map."""
    rec = synthetic_bop_records(np.random.RandomState(100 + seed), 1, HW, num_classes=5, max_objects=5)[0]
    out = dict(img=rec["img"], img_shape=HW, ori_shape=HW, scale_factor=np.ones(4, np.float32),
               gt_bboxes=rec["gt_bboxes"], gt_labels=rec["gt_labels"])
    if masks:
        out["gt_masks"] = rec["gt_masks"]
    if seg:
        out["gt_semantic_seg"] = np.random.RandomState(seed).randint(0, 21, HW).astype(np.uint8)
    return out


def _run(transform, results, seed):
    random.seed(seed)
    np.random.seed(seed)
    return transform(copy.deepcopy(results))


def _assert_same(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, (what, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what}: {k}")
        else:
            assert got[k] == v, (what, k)


CASES = {
    "RandomCrop absolute": ("RandomCrop", dict(crop_size=(40, 50)), {}),
    "RandomCrop absolute_range": ("RandomCrop", dict(crop_size=(20, 70), crop_type="absolute_range"), {}),
    "RandomCrop relative": ("RandomCrop", dict(crop_size=(0.5, 0.6), crop_type="relative"), {}),
    "RandomCrop relative_range, negative, unclipped": (
        "RandomCrop", dict(crop_size=(0.3, 0.5), crop_type="relative_range", allow_negative_crop=True,
                           bbox_clip_border=False), {}),
    "MinIoURandomCrop": ("MinIoURandomCrop", dict(), {}),
    "MinIoURandomCrop 0.5, unclipped": ("MinIoURandomCrop", dict(min_ious=(0.5,), min_crop_size=0.5,
                                                                 bbox_clip_border=False), {}),
    "Expand": ("Expand", dict(mean=[123.675, 116.28, 103.53], ratio_range=(1, 4)), {}),
    "Expand always": ("Expand", dict(mean=(0, 10, 250), ratio_range=(1.5, 2), prob=1.0), {}),
    "PhotoMetricDistortion": ("PhotoMetricDistortion", dict(), {}),
    "PhotoMetricDistortion wide": ("PhotoMetricDistortion", dict(brightness_delta=80, contrast_range=(0.2, 2.0),
                                                                 saturation_range=(0.0, 3.0), hue_delta=170), {}),
    "CutOut shape": ("CutOut", dict(n_holes=(1, 5), cutout_shape=[(4, 4), (10, 6)]), {}),
    "CutOut ratio": ("CutOut", dict(n_holes=3, cutout_ratio=(0.1, 0.2), fill_in=(255, 0, 0)), {}),
    "FilterAnnotations": ("FilterAnnotations", dict(min_gt_bbox_wh=(20, 20)), {}),
    "SegRescale down": ("SegRescale", dict(scale_factor=0.5), dict(seg=True)),
    "SegRescale up": ("SegRescale", dict(scale_factor=1.7), dict(seg=True)),
    "RandomCenterCropPad train": ("RandomCenterCropPad", dict(crop_size=(64, 64), ratios=(0.6, 0.8, 1.0, 1.2),
                                                              border=32, mean=(100, 110, 120), test_pad_mode=None),
                                  dict(masks=False)),
    "RandomCenterCropPad test logical_or": ("RandomCenterCropPad", dict(
        crop_size=None, ratios=None, border=None, test_mode=True, test_pad_mode=("logical_or", 31)), {}),
    "RandomCenterCropPad test size_divisor": ("RandomCenterCropPad", dict(
        crop_size=None, ratios=None, border=None, mean=(1, 2, 3), test_mode=True,
        test_pad_mode=("size_divisor", 32)), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(case):
    """Each seed's output byte-equal to JAX's, both built from the same
    pipeline entry; the None decisions equal too."""
    t_type, kwargs, data = CASES[case]
    entry = [dict(type=t_type, **kwargs)]
    ref, port = jax_pipeline.build_pipeline(entry), build_pipeline(entry)
    assert [type(t).__name__ for t in port.transforms] == [t_type]
    outcomes = set()
    for seed in SEEDS:
        results = _results(seed, **data)
        want, got = _run(ref, results, seed), _run(port, results, seed)
        _assert_same(got, want, f"{case}, seed {seed}")
        outcomes.add(want is None or want["img"].shape != results["img"].shape
                     or not np.array_equal(want["img"], results["img"]))
    if t_type not in ("FilterAnnotations", "SegRescale"):
        assert True in outcomes  # the transform did something in some draw


def test_filter_and_crop_resample_decisions_match_jax():
    """None (the loader draws another sample) where no GT is left: a
    FilterAnnotations that drops every box, a RandomCrop of a patch without
    GT, RandomCenterCropPad whose 50 draws keep none."""
    results = _results(0)
    results["gt_bboxes"] = np.array([[2, 2, 6, 6]], np.float32)
    results["gt_labels"] = results["gt_labels"][:1]
    results["gt_masks"] = results["gt_masks"][:1]
    for entry in (dict(type="FilterAnnotations", min_gt_bbox_wh=(5, 5)),
                  dict(type="RandomCrop", crop_size=(10, 10)),
                  dict(type="RandomCenterCropPad", crop_size=(8, 8), ratios=(1.0,), border=2,
                       test_pad_mode=None)):
        r = {k: v for k, v in results.items() if not (entry["type"] == "RandomCenterCropPad" and k == "gt_masks")}
        nones = 0
        for seed in SEEDS:
            want = _run(jax_pipeline.build_pipeline([entry]), r, seed)
            got = _run(build_pipeline([entry]), r, seed)
            _assert_same(got, want, f"{entry['type']}, seed {seed}")
            nones += want is None
        assert nones > 0, entry


def test_seeded_transforms_take_their_own_generator():
    """``seed=`` gives a transform its own generator: the same output
    whatever the global ``random`` holds, and it pickles."""
    import pickle

    results = _results(3)
    for t in (pipeline.MinIoURandomCrop(seed=4), pipeline.Expand(seed=4), pipeline.PhotoMetricDistortion(seed=4),
              pipeline.RandomCrop((30, 30), seed=4), pipeline.CutOut(2, cutout_shape=(5, 5), seed=4)):
        twin = pickle.loads(pickle.dumps(t))
        a = _run(t, results, 0)
        b = _run(twin, results, 99)
        _assert_same(a, b, type(t).__name__)


def test_load_mask_from_file_matches_jax(tmp_path):
    """Masks at the image path rewritten rgb -> mask_visib, numbered by the
    GTs' original annotation indices (some annotations dropped), 0/255 PNGs
    read as 0/1."""
    rgb = tmp_path / "000000" / "rgb"
    masks = tmp_path / "000000" / "mask_visib"
    os.makedirs(rgb)
    os.makedirs(masks)
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(str(masks / f"000003_{i:06d}.png"), (rng.rand(*HW) > 0.5).astype(np.uint8) * 255)
    info = dict(filename="000000/rgb/000003.png", height=HW[0], width=HW[1])
    for ann_masks, n in ((["a/000003_000001.png", "a/000003_000003.png"], 2), (None, 3)):
        results = dict(img_prefix=str(tmp_path) + "/", img_info=info, gt_bboxes=np.zeros((n, 4), np.float32),
                       ann_info=dict(masks=ann_masks))
        want = jax_pipeline.LoadMaskFromFile()(copy.deepcopy(results))
        got = pipeline.LoadMaskFromFile()(copy.deepcopy(results))
        _assert_same(got, want, f"masks {ann_masks}")
        assert got["gt_masks"].shape == (n,) + HW and got["gt_masks"].max() == 1
    with pytest.raises(FileNotFoundError):
        pipeline.LoadMaskFromFile()(dict(results, gt_bboxes=np.zeros((5, 4), np.float32)))


def test_registry_and_refusals():
    """Every transform of this slice and of the AutoAugment family,
    InstaBoost and RADet's colour transforms is registered in both packages
    (the last seven built by ``build_pipeline``, their libraries' bridges
    raising JAX's ``ImportError`` where the library is absent); an unknown
    type raises ``KeyError`` in both; bad arguments raise."""
    for t_type in ("LoadMaskFromFile", "FilterAnnotations", "RandomCrop", "MinIoURandomCrop", "Expand",
                   "PhotoMetricDistortion", "CutOut", "SegRescale", "RandomCenterCropPad"):
        assert t_type in pipeline._TRANSFORMS and t_type in jax_pipeline._TRANSFORMS
    assert list(pipeline._TRANSFORMS) == list(jax_pipeline._TRANSFORMS)
    built = dict(RandomHSV=dict(h_ratio=0.1, s_ratio=0.1, v_ratio=0.1), RandomNoise=dict(noise_ratio=0.1),
                 RandomSmooth={}, AutoAugment=dict(policies=[[dict(type="Shear", level=1)]]), InstaBoost={})
    for t_type in ("RandomHSV", "RandomNoise", "RandomSmooth", "Albu", "Corrupt", "AutoAugment", "InstaBoost"):
        assert t_type in pipeline._TRANSFORMS and t_type in jax_pipeline._TRANSFORMS
        if t_type in built:
            assert [type(t).__name__ for t in build_pipeline([dict(type=t_type, **built[t_type])]).transforms] == [
                t_type]
    for build in (build_pipeline, jax_pipeline.build_pipeline):
        with pytest.raises(KeyError, match="unknown transform"):
            build([dict(type="NoSuchTransform")])
    for bad in (dict(crop_size=(10, 10), crop_type="middle"), dict(crop_size=(0, 10)),
                dict(crop_size=(2.0, 0.5), crop_type="relative"), dict(crop_size=(50, 20), crop_type="absolute_range")):
        with pytest.raises(ValueError):
            pipeline.RandomCrop(**bad)
    with pytest.raises(ValueError):
        pipeline.CutOut(2)
    with pytest.raises(ValueError):
        pipeline.RandomCenterCropPad(crop_size=(8, 8), to_rgb=True, test_pad_mode=None)
    with pytest.raises(ValueError):
        pipeline.SegRescale(backend="pillow")
    with pytest.raises(AssertionError, match="only supports bbox"):
        pipeline.RandomCenterCropPad(crop_size=(64, 64), border=8, test_pad_mode=None)(_results(0))


# --------------------------------------------------------------- RGB <-> HSV


@pytest.mark.parametrize("width", [1, 5, 8, 61, 640])
def test_hsv_conversions_equal_cv2(width):
    """cv2's float32 RGB2HSV and HSV2RGB bit for bit on rows of any width
    (its 8-pixel vector body and scalar tail), integer and fractional
    values, ties between channels, black and gray pixels, and hues up to
    and at 360."""
    rng = np.random.RandomState(width)
    img = (rng.rand(40, width, 3) * 300 - 20).astype(np.float32).clip(0, 255)
    img[::2] = np.round(img[::2])
    img[1, :, 1] = img[1, :, 0]  # R == G
    img[3] = 0
    img[5, :, :] = img[5, :, :1]  # gray
    img[7, :, 2] = img[7, :, 0]  # R == B
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(rgb_to_hsv_f32(img), hsv)
    np.testing.assert_array_equal(rgb_to_hsv_f32_plain(img), hsv)
    hsv[..., 1] = (hsv[..., 1] * np.float32(1.4)).clip(0, 1)
    hsv[..., 0] = (hsv[..., 0] + np.float32(173.3)) % 360
    hsv[9, :, 0] = np.float32(359.99997)
    hsv[11, :, 0] = np.float32(-1e-6) % np.float32(360)  # 360.0 after the float32 mod
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    np.testing.assert_array_equal(hsv_to_rgb_f32(hsv), want)
    np.testing.assert_array_equal(hsv_to_rgb_f32_plain(hsv), want)


def test_fma32_rounds_once():
    """A float64 sum on a float32 tie goes to the side of the exact value
    (which a plain float64 multiply-add rounds to the even neighbour)."""
    f = np.float32
    a, b, c = f(1 + 2 ** -23), f(2 ** -24 * (1 - 2 ** -23)), f(1 + 2 ** -23)
    got = _fma32(np.array([a, a]), np.array([b, -b]), np.array([c, c]))
    np.testing.assert_array_equal(got, [c, c])
    assert (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32) != c
    # off the ties, rounding the float64 multiply-add once more is the fused result
    rng = np.random.RandomState(0)
    x, y, z = (rng.randn(1000).astype(np.float32) for _ in range(3))
    np.testing.assert_array_equal(_fma32(x, y, z), (x.astype(np.float64) * y + z).astype(np.float32))


# ------------------------------------------------------ the SSD recipe sample


@pytest.fixture(scope="module")
def voc_split(tmp_path_factory):
    jpegs, records = jpeg_fixtures()
    return write_voc_split(str(tmp_path_factory.mktemp("voc")), records, jpegs, [("trainval", 6), ("test", 2)])


def test_voc_ssd_samples_match_jax(voc_split):
    """Packed training samples of the VOC2007 trainval split through the
    SSD recipe at the narrow input (``voc_options``, ``min_size``): every
    key equal to JAX's but ``dist_vals`` (within 2e-5 plus one float16
    step), with the draws seeded alike per index."""
    opts = NARROW + voc_options(voc_split, min_size=7, img_scale=(96, 64))
    ref_ds = jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts), "train", test_mode=False)
    port_ds = build_dataset(Config.fromfile(FLAGSHIP, opts), "train")
    assert type(port_ds).__name__ == "VOCDataset" and len(port_ds) == len(ref_ds) == 6
    assert [type(t).__name__ for t in port_ds.pipeline.transforms] == [
        type(t).__name__ for t in ref_ds.pipeline.transforms]
    expanded = 0
    for idx in range(len(ref_ds)):
        for seed in (40 + idx, 80 + idx):
            out = []
            for ds in (ref_ds, port_ds):
                np.random.seed(seed)
                random.seed(seed)
                out.append(ds[idx])
            want, got = out
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (idx, k)
                if k != "dist_vals":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"sample {idx}, seed {seed}: {k}")
            x, y = got["dist_vals"].astype(np.float32), want["dist_vals"].astype(np.float32)
            assert (np.abs(x - y) <= RESIZE_IPP_ATOL + F16_STEP * np.abs(y)).all(), (idx, seed)
            expanded += int(got["gt_valid"].sum())
    assert expanded > 20
