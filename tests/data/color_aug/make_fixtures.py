"""Write cv2's Gaussian taps into the port, and ``hashes.json``: the SHA-256
of the JAX package's CosyPose ops (cv2) on the committed JPEG fixtures and
of its polygon masks (``cv2.fillPoly``) on fixed polygons.

    python tests/data/color_aug/make_fixtures.py

- ``radet_tpu_torch/data/gaussian_taps.py``: for each integer sigma 1..10,
  the integer taps (summing to 256) of ``cv2.GaussianBlur(img, (0, 0),
  sigma)`` on uint8, and for each kernel size of ``KSIZES`` those of
  ``cv2.GaussianBlur(img, (k, k), 0)`` (sigma derived by cv2), read off a
  blur of a one-pixel vertical line of 255s (each output of the line's row
  is its tap, as every tap is at most 128);
- ``hashes.json``: for each fixture of ``tests/data/jpeg`` decoded RGB by
  cv2, each enhance op at the factors of ``FACTORS`` and the blur at sigma
  1, 2, 3 (``OPS``), and the masks of ``polygons()`` as
  ``radet_tpu.data.pipeline.LoadAnnotations`` fills them.

The card's machine has no cv2: there ``radet_tpu_torch/csrc/color_aug.cpp``
and ``data/poly.py`` are held to these hashes (chip_smoke.py).
"""

import hashlib
import json
import os.path as osp
import sys

import cv2
import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(osp.dirname(osp.dirname(HERE)))
JPEG_DIR = osp.join(osp.dirname(HERE), "jpeg")
TAPS_MODULE = osp.join(REPO, "radet_tpu_torch", "data", "gaussian_taps.py")
SIGMAS = range(1, 11)
KSIZES = (3, 9)  # the mask-free distance maps' blurs (sigma 0)
# enhance op: factors (its interval's ends in the flagship and one inside)
FACTORS = {
    "Brightness": (0.1, 1.7, 6.0),
    "Contrast": (0.2, 3.3, 50.0),
    "Color": (0.0, 0.6, 20.0),
    "Sharpness": (0.0, 7.9, 50.0),
}
BLUR_SIGMAS = (1, 2, 3)
MASK_HW = (480, 640)


def cv2_taps(sigma: int = 0, ksize: int = 0) -> list:
    """cv2's integer taps of the uint8 Gaussian blur at ``sigma`` (kernel
    size from sigma), or at kernel size ``ksize`` with sigma 0."""
    k = ksize or int(round(6 * sigma + 1)) | 1
    n = 4 * k + 1
    img = np.zeros((3, n), np.uint8)
    img[:, n // 2] = 255
    row = cv2.GaussianBlur(img, (ksize, ksize), sigmaX=float(sigma))[1].astype(int)
    return row[n // 2 - k // 2:n // 2 + k // 2 + 1].tolist()


def polygons():
    """Fixed polygon annotations (COCO ``segmentation`` lists of one object
    each) on a 480x640 image: convex, concave, self-intersecting,
    collinear, multi-part, vertices outside the image, a part of fewer than
    3 points, and fractional coordinates."""
    rng = np.random.RandomState(11)
    objs = [
        [[100, 100, 300, 120, 250, 300, 90, 260]],
        [[320, 50, 600, 60, 610, 400, 450, 200, 330, 420]],
        [[50, 400, 400, 470, 60, 470, 420, 380]],  # self-intersecting
        [[10, 10, 200, 10, 400, 10]],  # collinear
        [[500, 300, 700, 250, 690, 520, 480, 500], [520, 320, 560, 330, 540, 380]],  # outside, two parts
        [[-50, -40, 120, 30, 20, 160], [5, 5, 9]],  # a part of fewer than 3 points
        [[200.4, 200.5, 260.5, 201.5, 231.5, 287.49, 199.5, 250.5]],  # fractional, half ties
    ]
    for _ in range(5):
        k = rng.randint(3, 40)
        ang = rng.uniform(0, 6 * np.pi, k)
        rad = rng.uniform(20, 260, k)
        c = rng.uniform((-60, -60), (700, 540))
        objs.append([np.round(np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], -1), 1)
                     .reshape(-1).tolist()])
    return objs


def main():
    sys.path.insert(0, REPO)
    from radet_tpu.data import pipeline as jax_pipeline

    taps = {s: cv2_taps(s) for s in SIGMAS}
    ktaps = {k: cv2_taps(ksize=k) for k in KSIZES}
    assert all(sum(t) == 256 and max(t) <= 128 for t in [*taps.values(), *ktaps.values()])
    with open(TAPS_MODULE, "w") as f:
        f.write('"""Integer taps of cv2\'s uint8 Gaussian blur, ``cv2.GaussianBlur(img, (0, 0),\n'
                'sigma)``, at integer sigma 1 to 10 (kernel size round(6 sigma + 1) | 1), and\n'
                '``cv2.GaussianBlur(img, (k, k), 0)`` at kernel sizes k of ``GAUSSIAN_KSIZE_TAPS``\n'
                '(sigma 0.3 (k / 2 - 1) + 0.8; k 3 takes cv2\'s fixed [1, 2, 1] / 4); the taps sum\n'
                'to 256.  Written by tests/data/color_aug/make_fixtures.py from\n'
                f'cv2 {cv2.__version__}; tests/test_torch_color_aug.py derives them again."""\n\n'
                "GAUSSIAN_TAPS = {\n")
        for s, t in taps.items():
            f.write(f"    {s}: {tuple(t)},\n")
        f.write("}\n\nGAUSSIAN_KSIZE_TAPS = {\n")
        for k, t in ktaps.items():
            f.write(f"    {k}: {tuple(t)},\n")
        f.write("}\n")

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    images = {}
    for name in sorted(n for n in __import__("os").listdir(JPEG_DIR) if n.endswith(".jpg")):
        img = cv2.cvtColor(cv2.imread(osp.join(JPEG_DIR, name), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        ops = {}
        for op, factors in FACTORS.items():
            for f in factors:
                ops[f"{op} {f}"] = sha(jax_pipeline._NpEnhance(op, 1.0, (f, f))._apply(img, f))
        for s in BLUR_SIGMAS:
            # radet_tpu's PillowBlur at sigma s
            ops[f"Blur {s}"] = sha(cv2.GaussianBlur(img, (0, 0), sigmaX=float(s)))
        images[name] = dict(rgb_sha256=sha(img), ops=ops)
    objs = polygons()
    h, w = MASK_HW
    ann = dict(bboxes=np.zeros((len(objs), 4), np.float32), labels=np.zeros(len(objs), np.int64),
               segmentations=objs)
    masks = jax_pipeline.LoadAnnotations(with_bop_mask=True)(
        dict(img_info=dict(height=h, width=w), ann_info=ann))["gt_masks"]
    out = dict(cv2=cv2.__version__, factors=FACTORS, blur_sigmas=list(BLUR_SIGMAS), images=images,
               polygons=dict(hw=list(MASK_HW), segmentations=objs, masks=[sha(m) for m in masks],
                         pixels=[int(m.sum()) for m in masks]))
    with open(osp.join(HERE, "hashes.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
