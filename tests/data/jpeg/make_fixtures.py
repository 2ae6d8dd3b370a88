"""Write this directory's JPEG fixtures with cv2, and ``hashes.json``: the
SHA-256 of cv2's decode of each (RGB for ``IMREAD_COLOR``, and
``IMREAD_GRAYSCALE``).

    python tests/data/jpeg/make_fixtures.py

Each image is record ``k`` of ``synthetic_bop_records(RandomState(
JPEG_FIXTURE_SEED), 3, (480, 640))`` (tests/synthetic_bop.py) with its noise
background replaced by a smooth, lightly textured one (noise would not
compress).  The card's machine has no cv2: there the port's decoder is
held to these hashes (chip_smoke.py), and its training set is made of these
files with that record's boxes and masks.
"""

import hashlib
import json
import os.path as osp
import sys

import cv2
import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.dirname(osp.dirname(HERE)))
from synthetic_bop import JPEG_FIXTURE_SEED, synthetic_bop_records  # noqa: E402

# name: (record, gray, cv2.imwrite parameters)
FIXTURES = {
    "ycbv_420.jpg": (0, False, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "ycbv_444_rst.jpg": (1, False, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 5,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "ycbv_gray.jpg": (2, True, [cv2.IMWRITE_JPEG_QUALITY, 90]),
}


def fixture_image(rec, rng) -> np.ndarray:
    h, w = rec["img"].shape[:2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.stack([40 + 120 * x / w, 60 + 100 * y / h, 90 + 60 * np.sin(x / 50 + y / 70)], -1)
    background = np.clip(smooth + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.where(rec["gt_masks"].any(0)[..., None], rec["img"], background)


def cv2_hashes(path: str) -> dict:
    rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return dict(shape=list(rgb.shape), rgb_sha256=hashlib.sha256(rgb.tobytes()).hexdigest(),
                gray_sha256=hashlib.sha256(gray.tobytes()).hexdigest())


def main():
    records = synthetic_bop_records(np.random.RandomState(JPEG_FIXTURE_SEED), 3, (480, 640))
    rng = np.random.RandomState(JPEG_FIXTURE_SEED)
    out = {}
    for name, (k, gray, params) in FIXTURES.items():
        rgb = fixture_image(records[k], rng)
        img = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if gray else cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        path = osp.join(HERE, name)
        assert cv2.imwrite(path, img, params)
        out[name] = dict(record=k, cv2=cv2.__version__, **cv2_hashes(path))
    with open(osp.join(HERE, "hashes.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
