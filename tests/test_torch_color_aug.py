"""CosyPoseAug and polygon masks of the port against the JAX package on the
CPU: the enhance ops (Brightness, Contrast, Color, Sharpness) and the
Gaussian blur at sigma 1, 2, 3 equal the JAX package's cv2 ops byte for
byte, through ``csrc/color_aug.cpp`` and through its numpy twins; the
committed Gaussian taps are cv2's; ``CosyPoseAug`` at the flagship's
settings takes the JAX package's draws and gives its images; ``fill_poly``
gives ``cv2.fillPoly``'s masks through ``LoadAnnotations``; and the port
reproduces the committed cv2 hashes that hold it on a machine without
cv2."""

import hashlib
import importlib.util
import json
import os.path as osp
import random

import cv2
import numpy as np
import pytest

from radet_tpu_torch.data import color_aug
from radet_tpu_torch.data.gaussian_taps import GAUSSIAN_TAPS
from radet_tpu_torch.data.image_io import imread_rgb
from radet_tpu_torch.data.pipeline import LoadAnnotations, build_pipeline
from radet_tpu_torch.data.poly import fill_poly
from radet_tpu_torch.utils.config import Config
from torch_parity import FLAGSHIP

HERE = osp.dirname(osp.abspath(__file__))
FIXTURES = osp.join(HERE, "data", "color_aug")
JPEGS = osp.join(HERE, "data", "jpeg")
_spec = importlib.util.spec_from_file_location("color_aug_fixtures", osp.join(FIXTURES, "make_fixtures.py"))
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)

# each enhance op's factor interval in the flagship's CosyPoseAug
INTERVALS = {"Brightness": (0.1, 6.0), "Contrast": (0.2, 50.0), "Color": (0.0, 20.0), "Sharpness": (0.0, 50.0)}
SHAPES = ((19, 19), (23, 37), (480, 640))
BACKENDS = {"cpp": color_aug.NATIVE, "numpy": color_aug.PLAIN}


def _images(hw):
    """Noise, a blurred (smooth) copy, and the first JPEG fixture cut to
    ``hw``: images whose gray means and blends meet many rounding cases."""
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    noise = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    fixture = imread_rgb(osp.join(JPEGS, "ycbv_420.jpg"))[:hw[0], :hw[1]]
    return [noise, cv2.GaussianBlur(noise, (0, 0), 2.0), np.ascontiguousarray(fixture)]


def _jax_pipeline():
    from radet_tpu.data import pipeline as jax_pipeline

    return jax_pipeline


@pytest.mark.parametrize("sigma", sorted(GAUSSIAN_TAPS))
def test_gaussian_taps_are_cv2s(sigma):
    """The committed table is what the line probe reads off cv2 now, and
    its taps sum to 256 over round(6 sigma + 1) | 1 entries."""
    taps = GAUSSIAN_TAPS[sigma]
    assert list(taps) == make_fixtures.cv2_taps(sigma)
    assert sum(taps) == 256 and len(taps) == int(round(6 * sigma + 1)) | 1 and taps == taps[::-1]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("op", sorted(INTERVALS))
def test_enhance_ops_equal_jax(op, backend):
    """Each op at its interval's ends and at six factors drawn inside it,
    on 19x19, 23x37 and 480x640 images: the JAX package's ``_NpEnhance``
    output, byte for byte."""
    jax_op = _jax_pipeline()._NpEnhance(op, 1.0, INTERVALS[op])
    rng = np.random.RandomState(len(op))
    factors = list(INTERVALS[op]) + list(rng.uniform(*INTERVALS[op], 6))
    for hw in SHAPES:
        for k, img in enumerate(_images(hw)):
            for f in factors:
                got = color_aug.enhance(op, img, f, BACKENDS[backend])
                np.testing.assert_array_equal(got, jax_op._apply(img, f), err_msg=f"{op} {f} {hw} image {k}")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("sigma", [1, 2, 3])
def test_blur_equals_cv2(sigma, backend):
    """The blur of the JAX package's ``PillowBlur`` (``cv2.GaussianBlur``
    at an integer sigma), byte for byte."""
    fn = color_aug.gaussian_blur if backend == "cpp" else color_aug.gaussian_blur_plain
    for hw in SHAPES:
        for k, img in enumerate(_images(hw)):
            want = cv2.GaussianBlur(img, (0, 0), sigmaX=float(sigma))
            np.testing.assert_array_equal(fn(img, sigma), want, err_msg=f"sigma {sigma} {hw} image {k}")


def test_blur_beyond_the_flagship_and_outside_the_table():
    """Sigma 4 to 10 (the rest of the table) also equal cv2 through the
    C++; a sigma outside the table raises naming item 12."""
    img = _images((480, 640))[0]
    for sigma in range(4, 11):
        np.testing.assert_array_equal(color_aug.gaussian_blur(img, sigma),
                                      cv2.GaussianBlur(img, (0, 0), sigmaX=float(sigma)), err_msg=str(sigma))
    for sigma in (0, 11):
        with pytest.raises(NotImplementedError, match="item 12"):
            color_aug.gaussian_blur(img, sigma)


def test_cpp_functions_equal_their_twins():
    """The five C++ functions against their numpy twins on one image,
    including the one-channel blend of Color."""
    img = _images((23, 37))[0]
    gray = color_aug.pil_gray(img)
    np.testing.assert_array_equal(gray, color_aug.pil_gray_plain(img))
    np.testing.assert_array_equal(gray, _jax_pipeline()._pil_gray(img))
    np.testing.assert_array_equal(color_aug.smooth(img), color_aug.smooth_plain(img))
    lut = np.random.RandomState(0).randint(0, 256, 256).astype(np.uint8)
    np.testing.assert_array_equal(color_aug.apply_lut(img, lut), color_aug.apply_lut_plain(img, lut))
    for b in (gray, color_aug.smooth(img)):
        for alpha in (0.0, 0.37, 7.3, 19.9, 50.0):
            np.testing.assert_array_equal(color_aug.add_weighted(img, b, alpha, 1.0 - alpha),
                                          color_aug.add_weighted_plain(img, b, alpha, 1.0 - alpha))
    with pytest.raises(ValueError):
        color_aug.add_weighted(img, gray[:5], 1.0, 0.0)


def _flagship_cosypose_cfg():
    pipe = Config.fromfile(FLAGSHIP).to_dict()["train_pipeline"]
    return next(t for t in pipe if t["type"] == "CosyPoseAug")


def test_cosypose_aug_at_flagship_settings_equals_jax():
    """The flagship's ``CosyPoseAug`` in both packages, Python's ``random``
    seeded alike before each sample: equal images and the generator left
    in the same state (the same draws, in the same order); a seeded chain
    draws as the global generator seeded with the same number."""
    cfg = _flagship_cosypose_cfg()
    jax_pipeline = _jax_pipeline()
    ref = jax_pipeline.build_pipeline([cfg]).transforms[0]
    port = build_pipeline([cfg]).transforms[0]
    assert type(port) is color_aug.CosyPoseAug and [type(op).__name__ for op in port.ops] == [
        "PillowBlur", "_Enhance", "_Enhance", "_Enhance", "_Enhance"]
    applied = 0
    for i in range(48):
        hw = (480, 640) if i < 4 else (64, 96)
        img = _images(hw)[i % 3]
        outs, states = [], []
        for t in (ref, port):
            random.seed(1000 + i)
            outs.append(t(dict(img=img))["img"])
            states.append(random.getstate())
        np.testing.assert_array_equal(outs[1], outs[0], err_msg=f"sample {i}")
        assert states[1] == states[0], f"sample {i}: the draws differ"
        applied += outs[1] is not img
        seeded = color_aug.CosyPoseAug(cfg["p"], cfg["pipelines"], seed=1000 + i)
        random.seed(5)
        np.testing.assert_array_equal(seeded(dict(img=img))["img"], outs[0], err_msg=f"seeded sample {i}")
    assert 30 <= applied < 48  # p = 0.8


def _polygon_objects(rng, h, w, kind):
    """Segmentations (a list of parts, each [x0, y0, x1, y1, ...]) of a
    few objects of one kind."""
    objs = []
    for _ in range(rng.randint(1, 4)):
        parts = []
        for _ in range(rng.randint(1, 4) if kind == "multipart" else 1):
            n = rng.randint(3, 14)
            if kind == "convex":
                ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                r = np.full(n, rng.uniform(3, min(h, w) / 2))
            elif kind == "concave":
                ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                r = rng.uniform(2, min(h, w) / 2, n)
            else:  # self-intersecting, multi-part and outside: unsorted angles
                ang = rng.uniform(0, 4 * np.pi, n)
                r = rng.uniform(2, max(h, w) * (1.2 if kind == "outside" else 0.5), n)
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1)
            if kind == "collinear":
                t = rng.uniform(-40, 40, n)
                pts = np.stack([cx + 3 * t, cy + 2 * t], -1)
            pts = np.round(pts * 2) / 2 if rng.rand() < 0.5 else np.round(pts, 2)  # half-integer ties too
            parts.append(pts.reshape(-1).tolist())
        if rng.rand() < 0.3:
            parts.append(rng.uniform(0, min(h, w), 2 * rng.randint(0, 3)).tolist())  # fewer than 3 points
        objs.append(parts)
    return objs


@pytest.mark.parametrize("kind", ["convex", "concave", "self_intersecting", "collinear", "multipart", "outside"])
def test_polygon_masks_equal_jax(kind):
    """``LoadAnnotations``' polygon path against the JAX package's
    (``cv2.fillPoly`` after rounding half to even), 60 seeded cases of
    each kind at random image sizes: equal masks, byte for byte."""
    jax_load = _jax_pipeline().LoadAnnotations(with_bop_mask=True)
    port_load = LoadAnnotations(with_bop_mask=True)
    rng = np.random.RandomState(sum(map(ord, kind)))
    for case in range(60):
        h, w = (int(v) for v in rng.randint(1, 90, 2))
        objs = _polygon_objects(rng, h, w, kind)
        ann = dict(bboxes=np.zeros((len(objs), 4), np.float32), labels=np.zeros(len(objs), np.int64),
                   segmentations=objs, masks=["unused.png"] * len(objs))
        results = dict(img_info=dict(height=h, width=w), ann_info=ann)
        want = jax_load(dict(results))["gt_masks"]
        got = port_load(dict(results))["gt_masks"]
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (len(objs), h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} case {case}: {objs}")


def test_fill_poly_edges_of_the_image():
    """Polygons reaching past every side, degenerate ones (a point, a
    segment, a zero-area spike) and an empty part list, against cv2."""
    cases = [
        [np.array([[-5, -5], [20, -3], [25, 30], [-8, 12]])],
        [np.array([[14, 26], [12, 28], [12, 28]])],
        [np.array([[8, -4], [0, 7], [4, 17]])],
        [np.array([[3, 3]])],
        [np.array([[2, 2], [9, 5]])],
        [np.array([[51, 74], [65, 41]])],
        [np.array([[0, 0], [12, 0], [12, 30], [0, 30]]), np.array([[3, 3], [9, 3], [9, 9], [3, 9]])],
        [],
    ]
    for parts in cases:
        want = np.zeros((30, 13), np.uint8)
        if parts:
            cv2.fillPoly(want, [p.astype(np.int32) for p in parts], 1)
        np.testing.assert_array_equal(fill_poly(np.zeros((30, 13), np.uint8), parts), want, err_msg=str(parts))


def test_committed_cv2_hashes():
    """What the card's machine checks without cv2: the port's ops on the
    committed JPEG fixtures and ``fill_poly`` on the fixed polygons give
    the SHA-256 that ``make_fixtures.py`` recorded from the JAX package;
    and the recorded polygons are the script's."""
    with open(osp.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, rec in hashes["images"].items():
        img = imread_rgb(osp.join(JPEGS, name))
        assert sha(img) == rec["rgb_sha256"]
        for key, want in rec["ops"].items():
            op, arg = key.split()
            got = color_aug.gaussian_blur(img, int(arg)) if op == "Blur" else color_aug.enhance(op, img, float(arg))
            assert sha(got) == want, f"{name}: {key}"
    polys = hashes["polygons"]
    assert polys["segmentations"] == make_fixtures.polygons()
    h, w = polys["hw"]
    ann = dict(bboxes=np.zeros((len(polys["masks"]), 4), np.float32), labels=np.zeros(len(polys["masks"]), np.int64),
               segmentations=polys["segmentations"])
    masks = LoadAnnotations(with_bop_mask=True)(dict(img_info=dict(height=h, width=w), ann_info=ann))["gt_masks"]
    assert [sha(m) for m in masks] == polys["masks"] and [int(m.sum()) for m in masks] == polys["pixels"]


def test_ops_under_loader_threads():
    """Sixteen threads (the loader's thread workers) run the C++ ops on
    their own images at once, with a short switch interval, the library
    loaded by the first of them: every output equals the serial one."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from radet_tpu_torch.utils import native

    images = [img for hw in ((23, 37), (64, 96)) for img in _images(hw)]
    jobs = [(i, key) for i in range(len(images)) for key in ("Blur 3", "Sharpness 7.9", "Color 0.6", "Contrast 3.3")]

    def run(job):
        i, key = job
        op, arg = key.split()
        img = images[i]
        return color_aug.gaussian_blur(img, int(arg)) if op == "Blur" else color_aug.enhance(op, img, float(arg))

    native._loaded.pop(color_aug.SOURCE, None)  # the threads race to load it
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(run, job) for job in jobs * 4]
            got = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for job, out in zip(jobs * 4, got):
        np.testing.assert_array_equal(out, run(job), err_msg=str(job))
