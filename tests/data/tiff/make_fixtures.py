"""Write the committed TIFF fixtures and ``hashes.json``: the SHA-256 of
``cv2.imread``'s pixels of each under IMREAD_UNCHANGED, IMREAD_COLOR and
IMREAD_GRAYSCALE, with their shape and dtype.

    python tests/data/tiff/make_fixtures.py

The fixtures cover what the test-time writers (cv2, Pillow) do not write:
tiles, big-endian files and the horizontal predictor, by
``tests/synthetic_bop.py::tiff_bytes`` from seeded noise with flat runs.
The card's machine has no cv2: there ``radet_tpu_torch/data/tiff.py`` and
``data/image_io.py`` are held to these hashes (chip_smoke.py), as
``tests/test_torch_tiff.py::test_committed_fixtures_match_cv2`` holds them
here.
"""

import hashlib
import json
import os
import os.path as osp
import sys

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(osp.dirname(osp.dirname(HERE)))
SEED = 20
# name: (shape (h, w, c), bytes a sample, tiff_bytes options)
FIXTURES = {
    "gray8_tiles_lzw_pred.tif": ((61, 83, 1), 1, dict(compression=5, predictor=2, tile=(32, 16))),
    "rgb8_be_lzw_pred.tif": ((45, 70, 3), 1, dict(compression=5, predictor=2, big_endian=True, rows_per_strip=7)),
    "rgb16_be_deflate_pred.tif": ((33, 47, 3), 2, dict(compression=8, predictor=2, big_endian=True)),
    "gray16_be_tiles_deflate.tif": ((40, 64, 1), 2, dict(compression=32946, big_endian=True, tile=(32, 16))),
    "rgba8_tiles_unassoc.tif": ((50, 37, 4), 1, dict(compression=8, tile=(16, 16), extra_samples=2)),
    "gray8_itodd_deflate.tif": ((96, 128, 1), 1, dict(compression=8)),
}
FLAGS = {"unchanged": -1, "color": 1, "grayscale": 0}


def fixture_pixels(shape, nbytes, rng):
    """Noise with flat runs and a ramp (so that LZW and the predictor have
    something to do) of ``shape``, uint8 or uint16."""
    top = 256 ** nbytes
    img = rng.randint(0, top, shape).astype(np.uint8 if nbytes == 1 else np.uint16)
    img[:, : shape[1] // 3] = img[:, :1]
    img[shape[0] // 2:] = (np.arange(shape[1])[None, :, None] * (top // shape[1])).astype(img.dtype)
    return img


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    import cv2

    sys.path[:0] = [REPO, osp.join(REPO, "tests")]
    from synthetic_bop import tiff_bytes

    rng = np.random.RandomState(SEED)
    out = dict(cv2=cv2.__version__, flags=FLAGS, files={})
    for name, (shape, nbytes, kw) in FIXTURES.items():
        img = fixture_pixels(shape, nbytes, rng)
        path = osp.join(HERE, name)
        with open(path, "wb") as f:
            f.write(tiff_bytes(img[..., 0] if shape[2] == 1 else img, **kw))
        reads = {}
        for flag, value in FLAGS.items():
            px = cv2.imread(path, value)
            reads[flag] = dict(sha256=sha(px), shape=list(px.shape), dtype=str(px.dtype))
        out["files"][name] = reads
    with open(osp.join(HERE, "hashes.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {len(FIXTURES)} fixtures: {sum(os.path.getsize(osp.join(HERE, n)) for n in FIXTURES)} bytes")


if __name__ == "__main__":
    main()
