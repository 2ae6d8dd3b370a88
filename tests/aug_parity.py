"""Helpers of the pipeline-transform parity tests
(tests/test_torch_pipeline_colour.py, test_torch_auto_augment.py,
test_torch_instaboost.py): the inputs both packages get, the comparison of
their outputs, and ``tests/data/pipeline_aug/make_fixtures.py`` as a
module, which ``chip_smoke.py``'s phase 23 imports from here too (this
module imports no JAX and no cv2)."""

import importlib.util
import json
import os.path as osp

import numpy as np

from radet_tpu_torch.data import image_io
from synthetic_bop import JPEG_FIXTURES, jpeg_fixtures, synthetic_bop_records

SIZES = [(60, 80), (120, 160), (75, 97), (64, 128)]  # the small cases' (H, W)

_spec = importlib.util.spec_from_file_location(
    "pipeline_aug_fixtures", osp.join(osp.dirname(JPEG_FIXTURES), "pipeline_aug", "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def fixture_names():
    """The JPEG fixtures' names, in the order of their records."""
    with open(osp.join(JPEG_FIXTURES, "hashes.json")) as f:
        return [n for n, _ in sorted(json.load(f).items(), key=lambda kv: kv[1]["record"])]


def fixture_image(i: int = 0) -> np.ndarray:
    """The decode of fixture ``i`` (480x640 RGB)."""
    return image_io.imread_rgb(osp.join(JPEG_FIXTURES, fixture_names()[i]))


def aug_results(seed: int, sizes=SIZES):
    """A results dict: for seed 0 the first 480x640 fixture with its
    record's boxes, labels and masks; else a synthetic record of
    ``sizes[seed % len(sizes)]``."""
    if seed == 0:
        jpegs, records = jpeg_fixtures()
        rec = dict(records[0], img=image_io.imdecode(jpegs[0]))
    else:
        hw = sizes[seed % len(sizes)]
        rec = synthetic_bop_records(np.random.RandomState(300 + seed), 1, hw, num_classes=5, max_objects=4)[0]
    h, w = rec["img"].shape[:2]
    return dict(img=rec["img"], img_shape=(h, w), gt_bboxes=rec["gt_bboxes"], gt_labels=rec["gt_labels"],
                gt_masks=rec["gt_masks"])


def assert_same(got, want, what: str):
    """The same keys, every array of the same dtype and bytes, every other
    value equal."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), f"{what}: {k}"
        else:
            assert got[k] == v, f"{what}: {k}"
