"""Write ``hashes.json``: the SHA-256 of cv2's output for each case of
:func:`cases` on the committed JPEG fixtures (``tests/data/jpeg``), the
bytes that the port's host C++ functions of the pipeline transforms and
their numpy twins must give: ``color_aug.rgb_to_hsv_u8``, ``hsv_to_rgb_u8``
and ``box_blur``, ``warp.warp_affine``, ``dilate3x3`` and
``rotation_matrix_2d``, and ``inpaint.inpaint_telea``.

    python tests/data/pipeline_aug/make_fixtures.py

Run it where cv2 is installed (the committed file is from cv2 5.0.0) after
changing :func:`cases`; ``tests/test_torch_pipeline_colour.py`` derives the
hashes again from cv2 and holds the committed file to them.  The card's
machine has no cv2: there ``chip_smoke.py`` holds its build of the C++
functions, and the twins, to this file.

:func:`cases` needs numpy only (the card's machine imports it too): each
case is (name, op, args, twin), ``op`` a key of :data:`OPS`, ``args`` its
positional arguments, ``twin`` whether the smoke also runs the numpy twin
on it (the Telea twin is a Python loop: it takes the crops only).
"""

import hashlib
import json
import math
import os.path as osp
import sys

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(osp.dirname(osp.dirname(HERE)))
JPEG_DIR = osp.join(osp.dirname(HERE), "jpeg")
# the port's function of each op, by module and name (its twin: name + "_plain")
OPS = {
    "rgb_to_hsv_u8": ("color_aug", "rgb_to_hsv_u8"),
    "hsv_to_rgb_u8": ("color_aug", "hsv_to_rgb_u8"),
    "box_blur": ("color_aug", "box_blur"),
    "warp_affine": ("warp", "warp_affine"),
    "dilate3x3": ("warp", "dilate3x3"),
    "rotation_matrix_2d": ("warp", "rotation_matrix_2d"),
    "inpaint_telea": ("inpaint", "inpaint_telea"),
}
ODD = (slice(3, 478), slice(5, 636))  # a 475x631 crop: rows of 631 pixels end in every op's scalar tail
CROP = (slice(200, 330), slice(250, 410))  # 130x160 around the middle, for the Telea twin


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _rotation(center, angle: float, scale: float) -> np.ndarray:
    """A float64 rotation matrix, from numpy alone (not cv2's formula)."""
    a = math.radians(angle)
    c, s = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[c, s, (1 - c) * cx - s * cy], [-s, c, s * cx + (1 - c) * cy]])


def _shifted_hsv(hsv: np.ndarray) -> np.ndarray:
    """A changed uint8 HSV image: hue turned by 7 (mod 180), saturation and
    value scaled, as RandomHSV and InstaBoost's jitter change them."""
    out = hsv.astype(np.int32)
    out[..., 0] = (out[..., 0] + 7) % 180
    out[..., 1] = np.clip(out[..., 1] * 1.3, 0, 255)
    out[..., 2] = np.clip(out[..., 2] * 0.8, 0, 255)
    return out.astype(np.uint8)


def _dilate(m: np.ndarray) -> np.ndarray:
    h, w = m.shape
    p = np.pad(m, 1)
    return np.max([p[i:i + h, j:j + w] for i in range(3) for j in range(3)], axis=0)


def cases(img: np.ndarray, hsv: np.ndarray, masks: np.ndarray):
    """The cases of one fixture: ``img`` its RGB decode, ``hsv`` cv2's HSV
    of it (the recorded ``rgb_to_hsv_u8`` output, hashed beside), ``masks``
    its record's (G, H, W) visible masks."""
    odd = np.ascontiguousarray(img[ODD])
    gray = np.ascontiguousarray(img[..., 1])
    union = masks.any(0).astype(np.uint8)
    h, w = img.shape[:2]
    out = [("rgb_to_hsv_u8", "rgb_to_hsv_u8", (img,), True),
           ("rgb_to_hsv_u8 odd", "rgb_to_hsv_u8", (odd,), True),
           ("hsv_to_rgb_u8", "hsv_to_rgb_u8", (_shifted_hsv(hsv),), True),
           ("hsv_to_rgb_u8 odd", "hsv_to_rgb_u8", (np.ascontiguousarray(_shifted_hsv(hsv)[ODD]),), True)]
    for k in (1, 3, 5, 7):
        out += [(f"box_blur {k}", "box_blur", (img, k), True), (f"box_blur {k} odd", "box_blur", (odd, k), True)]
    out += [("dilate3x3", "dilate3x3", (union,), True),
            ("rotation_matrix_2d", "rotation_matrix_2d", ((319.5, 239.5), -17.3, 1.1), True)]
    warps = [
        ("rotate", _rotation((319.5, 239.5), -17.3, 1.1), (128.0, 128.0, 128.0), "bilinear"),
        ("rotate scale 0.8", _rotation((100.25, 371.0), 123.0, 0.8), (7.0, 99.0, 200.0), "bilinear"),
        ("shear horizontal", np.array([[1, 0.27, 0], [0, 1, 0]], np.float32).astype(np.float64), 128.0, "bilinear"),
        ("shear vertical", np.array([[1, 0, 0], [-0.18, 1, 0]], np.float32).astype(np.float64),
         (128.0, 128.0, 128.0), "nearest"),
        ("translate", np.array([[1, 0, -75], [0, 1, 0]], np.float32).astype(np.float64), (0.0, 64.0, 255.0),
         "bilinear"),
        ("paste", _rotation((210.5, 160.0), 0.7, 1.13) + [[0, 0, 4.4], [0, 0, -2.9]], 0.0, "bilinear"),
    ]
    for name, mat, fill, interp in warps:
        out += [(f"warp_affine {name}", "warp_affine", (img, mat, fill, interp), True),
                (f"warp_affine {name} odd", "warp_affine", (odd, mat, fill, interp), True)]
    out += [("warp_affine gray rotate", "warp_affine", (gray, warps[0][1], 50.0, "bilinear"), True),
            ("warp_affine mask nearest", "warp_affine", (union, warps[5][1], 0.0, "nearest"), True)]
    # InstaBoost's hole: the union of the first two instances, dilated 3x3
    hole = _dilate(masks[:2].any(0).astype(np.uint8))
    out.append(("inpaint_telea", "inpaint_telea", (img, hole, 3), False))
    crop_hole = np.zeros((h, w), np.uint8)
    crop_hole[240:275, 290:340] = 1
    crop_hole[300:306, 260:400] = 1
    out.append(("inpaint_telea crop", "inpaint_telea",
                (np.ascontiguousarray(img[CROP]), np.ascontiguousarray(crop_hole[CROP]), 3), True))
    return out


def port_ops(plain: bool = False):
    """The port's function of each op of :data:`OPS`, or with ``plain`` its
    numpy twin (``rotation_matrix_2d`` is plain Python: itself)."""
    import importlib

    out = {}
    for op, (module, name) in OPS.items():
        mod = importlib.import_module(f"radet_tpu_torch.data.{module}")
        out[op] = getattr(mod, name + "_plain") if plain and hasattr(mod, name + "_plain") else getattr(mod, name)
    return out


def cv2_ops():
    """cv2's function of each op of :data:`OPS`."""
    import cv2

    def warp(img, mat, fill, interp):
        flag = {"bilinear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[interp]
        return cv2.warpAffine(img, mat, img.shape[1::-1], flags=flag, borderMode=cv2.BORDER_CONSTANT,
                              borderValue=fill)

    return {
        "rgb_to_hsv_u8": lambda img: cv2.cvtColor(img, cv2.COLOR_RGB2HSV),
        "hsv_to_rgb_u8": lambda hsv: cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
        "box_blur": lambda img, k: cv2.blur(img, (k, k)),
        "warp_affine": warp,
        "dilate3x3": lambda m: cv2.dilate(m, np.ones((3, 3), np.uint8)),
        "rotation_matrix_2d": cv2.getRotationMatrix2D,
        "inpaint_telea": lambda img, hole, r: cv2.inpaint(img, hole, r, cv2.INPAINT_TELEA),
    }


def cv2_hashes() -> dict:
    """{'cv2': version, 'images': {fixture: {'rgb_sha256', 'ops': {case:
    sha}}}} from cv2 on this machine."""
    import cv2

    sys.path.insert(0, REPO)
    sys.path.insert(0, osp.dirname(osp.dirname(HERE)))
    from synthetic_bop import jpeg_fixtures

    ops = cv2_ops()
    jpegs, records = jpeg_fixtures()
    with open(osp.join(JPEG_DIR, "hashes.json")) as f:
        names = [n for n, _ in sorted(json.load(f).items(), key=lambda kv: kv[1]["record"])]
    images = {}
    for name, jpeg, rec in zip(names, jpegs, records):
        img = cv2.cvtColor(cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        images[name] = dict(rgb_sha256=sha(img), ops={
            case: sha(ops[op](*args)) for case, op, args, _ in cases(img, hsv, rec["gt_masks"])})
    return {"cv2": cv2.__version__, "images": images}


def main():
    with open(osp.join(HERE, "hashes.json"), "w") as f:
        json.dump(cv2_hashes(), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
