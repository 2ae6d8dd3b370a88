"""The port's uint8 colour conversions, box blur and colour transforms
against cv2 5.0.0 and the JAX package on the CPU.

- ``color_aug.rgb_to_hsv_u8`` (C++) against ``cv2.cvtColor(COLOR_RGB2HSV)``
  on all 2^24 RGB triples, ``hsv_to_rgb_u8`` against COLOR_HSV2RGB on all
  180 x 256 x 256 HSV triples, each laid out in rows cv2 takes in its
  vector code and in rows that end in its scalar tail; their numpy twins
  on a seeded 256 x 250 sample: byte-equal;
- ``color_aug.box_blur`` (C++ and twin) against ``cv2.blur`` at k = 1, 3,
  5, 7 on the JPEG fixtures and odd sizes: byte-equal;
- ``RandomHSV``, ``RandomNoise`` and ``RandomSmooth`` against the JAX
  package's, ``random`` and ``np.random`` seeded alike on both sides, over
  12 seeds (one 480x640 fixture, the rest 60x80 to 120x160): byte-equal;
- the ``Albu`` and ``Corrupt`` bridges: JAX's ``ImportError`` without
  their libraries, and with stand-in libraries the same outputs as JAX's
  bridges (``idx_mapper`` included);
- ``tests/data/pipeline_aug/hashes.json`` (the hashes the card's smoke
  reads) against cv2 here, and the C++ functions and twins against it.
"""

import copy
import json
import os.path as osp
import pickle
import random
import sys
import types

import cv2
import numpy as np
import pytest

from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu_torch.data import color_aug, image_io, pipeline
from radet_tpu_torch.data.pipeline import build_pipeline
from aug_parity import aug_results, assert_same, fixture_image, fixture_names, fixtures
from synthetic_bop import jpeg_fixtures
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

SEEDS = range(12)


def _rows(pixels: np.ndarray, width: int) -> np.ndarray:
    """``pixels`` (N, 3) laid out in rows of ``width``, the last row padded
    with the first pixels."""
    n = -(-len(pixels) // width) * width
    return np.ascontiguousarray(np.concatenate([pixels, pixels[:n - len(pixels)]]).reshape(-1, width, 3))


def test_hsv_u8_matches_cv2_on_every_triple():
    rgb = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"), -1)
    hsv = hsv.reshape(-1, 3).astype(np.uint8)
    for width in (4096, 31):  # cv2's vector rows, and rows it takes in its scalar tail
        img = _rows(rgb, width)
        np.testing.assert_array_equal(color_aug.rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
        img = _rows(hsv, width)
        np.testing.assert_array_equal(color_aug.hsv_to_rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
    sample = np.random.RandomState(0).randint(0, 256, (256, 250, 3)).astype(np.uint8)
    np.testing.assert_array_equal(color_aug.rgb_to_hsv_u8_plain(sample), cv2.cvtColor(sample, cv2.COLOR_RGB2HSV))
    sample[..., 0] %= 180
    np.testing.assert_array_equal(color_aug.hsv_to_rgb_u8_plain(sample), cv2.cvtColor(sample, cv2.COLOR_HSV2RGB))
    with pytest.raises(ValueError):
        color_aug.rgb_to_hsv_u8(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_box_blur_matches_cv2(k):
    rng = np.random.RandomState(k)
    images = [fixture_image(i) for i in range(3)] + [
        rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in [(1, 1), (2, 3), (5, 2), (37, 53), (61, 83)]]
    images.append(np.ascontiguousarray(images[0][3:478, 5:636]))  # W % 8 = 7
    for img in images:
        want = cv2.blur(img, (k, k))
        np.testing.assert_array_equal(color_aug.box_blur(img, k), want, err_msg=f"{img.shape}")
        np.testing.assert_array_equal(color_aug.box_blur_plain(img, k), want, err_msg=f"{img.shape}")
    with pytest.raises(ValueError):
        color_aug.box_blur(images[0], 4)


TRANSFORMS = [
    ("RandomHSV", dict(h_ratio=0.1, s_ratio=0.3, v_ratio=0.3, prob=0.5)),
    ("RandomHSV", dict(h_ratio=0.5, s_ratio=0.8, v_ratio=0.8)),
    ("RandomNoise", dict(noise_ratio=0.02, prob=0.7)),
    ("RandomSmooth", dict(max_kernel_size=7, prob=0.8)),
    ("RandomSmooth", dict(max_kernel_size=4)),
]


@pytest.mark.parametrize("t_type,kw", TRANSFORMS, ids=[f"{t}-{i}" for i, (t, _) in enumerate(TRANSFORMS)])
def test_colour_transforms_match_jax(t_type, kw):
    port, ref = build_pipeline([dict(type=t_type, **kw)]), jax_pipeline.build_pipeline([dict(type=t_type, **kw)])
    changed = 0
    for seed in SEEDS:
        results = aug_results(seed)
        random.seed(seed)
        np.random.seed(seed)
        want = ref(copy.deepcopy(results))
        random.seed(seed)
        np.random.seed(seed)
        got = port(copy.deepcopy(results))
        assert_same(got, want, f"{t_type} seed {seed}")
        changed += not np.array_equal(got["img"], results["img"])
    assert changed >= 3  # the transform fired on several seeds


def test_seeded_colour_transforms_pickle():
    """A ``seed`` gives a transform generators of its own (the global ones
    are ignored); a pickled copy (a process worker's) draws the same."""
    img = np.random.RandomState(0).randint(0, 256, (24, 40, 3)).astype(np.uint8)
    for t in (pipeline.RandomHSV(0.2, 0.3, 0.3, prob=0.6, seed=4), pipeline.RandomNoise(0.05, prob=0.6, seed=4),
              pipeline.RandomSmooth(7, prob=0.6, seed=4)):
        twin = pickle.loads(pickle.dumps(t))
        for i in range(6):
            random.seed(i)
            np.random.seed(i)
            got = t(dict(img=img))["img"]
            random.seed(100 + i)
            np.random.seed(100 + i)
            np.testing.assert_array_equal(got, twin(dict(img=img))["img"])


class _BboxParams:
    def __init__(self, format, label_fields, min_visibility=0.0):
        self.label_fields, self.min_visibility = label_fields, min_visibility


class _DropFirst:
    """Flips the image and its masks and drops the first box."""

    def __init__(self, p=1.0):
        self.p = p

    def __call__(self, data):
        data["image"] = np.ascontiguousarray(data["image"][:, ::-1])
        data["masks"] = [np.ascontiguousarray(m[:, ::-1]) for m in data.get("masks", [])]
        for key in ("bboxes", "labels", "idx_mapper"):
            if key in data:
                data[key] = data[key][1:]
        return data


class _Nest:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class _Compose(_Nest):
    def __init__(self, transforms, bbox_params=None):
        super().__init__(transforms)
        self.bbox_params = bbox_params

    def __call__(self, **data):
        return super().__call__(dict(data))


def _fake_albumentations():
    """A stand-in for albumentations (module-level classes, so that a built
    bridge pickles): ``Compose``, ``BboxParams``, ``DropFirst``, ``Nest``."""
    A = types.ModuleType("albumentations")
    A.BboxParams, A.DropFirst, A.Nest, A.Compose = _BboxParams, _DropFirst, _Nest, _Compose
    return A


def test_albu_and_corrupt_bridges(monkeypatch):
    for t_type, kw in (("Albu", dict(transforms=[])), ("Corrupt", dict(corruption="gaussian_noise"))):
        for build in (build_pipeline, jax_pipeline.build_pipeline):
            with pytest.raises(ImportError, match=t_type):
                build([dict(type=t_type, **kw)])
    monkeypatch.setitem(sys.modules, "albumentations", _fake_albumentations())
    corruptions = types.ModuleType("imagecorruptions")
    corruptions.corrupt = lambda img, corruption_name, severity: (img // (severity + 1)).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "imagecorruptions", corruptions)
    cfgs = [dict(type="Albu", transforms=[dict(type="Nest", transforms=[dict(type="DropFirst")])],
                 bbox_params=dict(type="BboxParams", min_visibility=0.1)),
            dict(type="Albu", transforms=[dict(type="DropFirst")]),
            dict(type="Corrupt", corruption="gaussian_noise", severity=2)]
    for cfg in cfgs:
        port = build_pipeline([cfg])
        pickle.loads(pickle.dumps(port))  # process workers pickle the pipeline
        for seed in (1, 2):
            results = aug_results(seed)
            assert_same(port(copy.deepcopy(results)), jax_pipeline.build_pipeline([cfg])(copy.deepcopy(results)),
                         f"{cfg['type']} seed {seed}")
    albu = build_pipeline([dict(type="Albu", transforms=[dict(type="DropFirst")], skip_img_without_anno=True,
                                bbox_params=dict(type="BboxParams"))])
    one = aug_results(1)
    one.update(gt_bboxes=one["gt_bboxes"][:1], gt_labels=one["gt_labels"][:1], gt_masks=one["gt_masks"][:1])
    assert albu(one) is None  # no box left: the loader draws another sample


def test_committed_cv2_hashes():
    """hashes.json is cv2's on this machine; the C++ functions and their
    twins give it (the card's smoke repeats the second part)."""
    with open(osp.join(fixtures.HERE, "hashes.json")) as f:
        committed = json.load(f)
    assert committed == fixtures.cv2_hashes()
    jpegs, records = jpeg_fixtures()
    names = fixture_names()
    assert sorted(names) == sorted(committed["images"])
    ops, twins = fixtures.port_ops(), fixtures.port_ops(plain=True)
    for name, jpeg, rec in zip(names, jpegs, records):
        want = committed["images"][name]
        img = image_io.imdecode(jpeg)
        assert fixtures.sha(img) == want["rgb_sha256"]
        for case, op, args, twin in fixtures.cases(img, color_aug.rgb_to_hsv_u8(img), rec["gt_masks"]):
            assert fixtures.sha(ops[op](*args)) == want["ops"][case], f"{name} {case}"
            if twin and (case != "inpaint_telea crop" or name == names[0]):
                assert fixtures.sha(twins[op](*args)) == want["ops"][case], f"{name} {case} twin"
