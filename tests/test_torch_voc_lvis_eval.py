"""The port's VOC and LVIS evaluators against the JAX package's, numpy on both
sides (exact, or within 1e-12), and the slice's evaluation as a whole.

- ``eval_map`` in both AP modes, with scale ranges, ignore regions and a
  class without GT, on seeded random scenes; ``tpfp_image``'s argmax-only
  rule; ``eval_recalls`` on scored and unscored proposals;
- every ``LVISEvaluator`` case of ``tests/test_lvis_eval.py``, and
  ``LVISV1Dataset.evaluate`` through ``evaluate_results``;
- the narrowed flagship (``tests/torch_parity.py``) with 20 classes through
  strict ``test_from_config`` on a VOC2007 test split of the JPEG fixtures:
  the same detections and the same VOC AP50 and mAP in both packages.
"""

import json
import os.path as osp

import numpy as np
import pytest

import radet_tpu_torch.apis.test as port_test
from radet_tpu.apis.test import evaluate_results as jax_evaluate_results
from radet_tpu.apis.test import test_from_config as jax_test_from_config
from radet_tpu.data import LVISV1Dataset as JaxLVISV1Dataset
from radet_tpu.data.coco_io import CocoIndex as JaxCocoIndex
from radet_tpu.evaluation import voc_eval as jax_voc
from radet_tpu.evaluation.lvis_eval import LVISEvaluator as JaxLVISEvaluator
from radet_tpu_torch.data.coco_io import CocoIndex
from radet_tpu_torch.data.datasets_extra import LVISV1Dataset
from radet_tpu_torch.evaluation import LVISEvaluator, average_precision, eval_map, eval_recalls
from radet_tpu_torch.evaluation import voc_eval
from synthetic_bop import jpeg_fixtures, write_voc_split
from test_lvis_eval import _det, _perfect, _scene
from torch_parity import FLAGSHIP, NARROW, config_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)


def _voc_scene(rng, n_img=8, n_cls=4, with_ignore=True):
    """Per-image annotations (some with ignore regions) and [img][cls] (M, 5)
    detections near the GTs and away from them; class ``n_cls - 1`` has no
    GT."""
    anns, dets = [], []
    for _ in range(n_img):
        g = rng.randint(0, 6)
        xy = rng.uniform(0, 300, (g, 2))
        wh = rng.uniform(4, 150, (g, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rng.randint(0, n_cls - 1, g)
        ann = dict(bboxes=boxes, labels=labels)
        if with_ignore:
            k = rng.randint(0, 3)
            ixy = rng.uniform(0, 300, (k, 2))
            ann.update(bboxes_ignore=np.concatenate([ixy, ixy + rng.uniform(4, 80, (k, 2))], 1).astype(np.float32),
                       labels_ignore=rng.randint(0, n_cls - 1, k))
        anns.append(ann)
        per_cls = []
        for c in range(n_cls):
            near = boxes[labels == c]
            keep = rng.rand(len(near)) < 0.8
            near = near[keep] + (rng.randn(int(keep.sum()), 4) * 3).astype(np.float32)
            far_xy = rng.uniform(0, 400, (rng.randint(0, 3), 2))
            far = np.concatenate([far_xy, far_xy + rng.uniform(4, 100, far_xy.shape)], 1).astype(np.float32)
            b = np.concatenate([near.reshape(-1, 4), far], 0)
            # ties in score, as a detector's rounding makes them
            scores = np.round(rng.rand(len(b)), 1).astype(np.float32)
            per_cls.append(np.concatenate([b, scores[:, None]], 1).astype(np.float32))
        dets.append(per_cls)
    return dets, anns


def _same(got, want):
    """Nested results (floats, arrays, dicts, lists) equal within 1e-12."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=1e-12)
        assert np.shape(got) == np.shape(want)


@pytest.mark.parametrize("mode", ["area", "11points"])
@pytest.mark.parametrize("scale_ranges", [None, [(0, 32), (32, 96), (96, 1e5)]])
@pytest.mark.parametrize("with_ignore", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_map_matches_jax(mode, scale_ranges, with_ignore, seed):
    dets, anns = _voc_scene(np.random.RandomState(seed), with_ignore=with_ignore)
    for thr in (0.5, 0.75):
        want = jax_voc.eval_map(dets, anns, scale_ranges=scale_ranges, iou_thr=thr, mode=mode)
        got = eval_map(dets, anns, scale_ranges=scale_ranges, iou_thr=thr, mode=mode)
        _same(got, want)
    assert got[1][-1]["num_gts"] is not None and np.all(np.asarray(got[1][-1]["num_gts"]) == 0)  # the empty class


def test_tpfp_and_average_precision_match_jax():
    """The argmax-only rule (a detection whose argmax GT is covered is a
    false positive although another free GT clears the threshold), an
    ignored argmax, area ranges; AP of stacked and single curves."""
    gts = np.asarray([[0, 0, 10, 10], [2, 0, 12, 10]], np.float32)
    dets = np.asarray([[0, 0, 10, 10, 0.9], [1, 0, 11, 10, 0.8], [50, 50, 60, 60, 0.7]], np.float32)
    for ign, ranges in ((None, None), (np.asarray([[50, 50, 60, 60]], np.float32), [(0, 64), (64, 1e4)])):
        want = jax_voc.tpfp_image(dets, gts, ign, 0.5, ranges)
        got = voc_eval.tpfp_image(dets, gts, ign, 0.5, ranges)
        _same(got, want)
    assert voc_eval.tpfp_image(dets, gts)[0][0].tolist() == [1, 0, 0]  # the quirk: det 1 is FP
    rng = np.random.RandomState(0)
    rc = np.sort(rng.rand(3, 20), 1)
    pr = rng.rand(3, 20)
    for mode in ("area", "11points"):
        _same(average_precision(rc, pr, mode), jax_voc.average_precision(rc, pr, mode))
        _same(average_precision(rc[0], pr[0], mode), jax_voc.average_precision(rc[0], pr[0], mode))
    with pytest.raises(ValueError, match="unknown AP mode"):
        average_precision(rc, pr, "points")


@pytest.mark.parametrize("scored", [True, False])
def test_eval_recalls_matches_jax(scored):
    rng = np.random.RandomState(5)
    gts, props = [], []
    for _ in range(6):
        g = rng.randint(0, 5)
        xy = rng.uniform(0, 200, (g, 2))
        gts.append(np.concatenate([xy, xy + rng.uniform(5, 80, (g, 2))], 1).astype(np.float32))
        p = np.concatenate([gts[-1] + rng.randn(g, 4).astype(np.float32) * 4,
                            rng.uniform(0, 250, (rng.randint(0, 30), 4)).astype(np.float32)], 0)
        p[:, 2:] = np.maximum(p[:, 2:], p[:, :2] + 1)
        if scored:
            p = np.concatenate([p, rng.rand(len(p), 1).astype(np.float32)], 1)
        props.append(p)
    for nums, thrs in (((1, 5, 100), (0.5,)), ((3, 10), (0.3, 0.5, 0.7)), (7, 0.6)):
        _same(eval_recalls(gts, props, nums, thrs), jax_voc.eval_recalls(gts, props, nums, thrs))


# ------------------------------------------------------------------- LVIS


def _exhaustive_scene(trial):
    """tests/test_lvis_eval.py::test_exhaustive_lvis_equals_coco_protocol's
    randomized scene and detections of ``trial``."""
    rng = np.random.RandomState(42)
    for t in range(trial + 1):
        cat_ids = [1, 2, 3, 4]
        images, anns = [], []
        for i in range(1, 7):
            present = set(rng.choice(cat_ids, size=rng.randint(1, 5), replace=False))
            images.append(dict(id=i, filename=f"{i}.jpg", width=200, height=200,
                               neg_category_ids=[c for c in cat_ids if c not in present],
                               not_exhaustive_category_ids=[]))
            for c in present:
                for _ in range(rng.randint(1, 3)):
                    x, y = rng.randint(0, 150, 2)
                    w, h = rng.randint(8, 50, 2)
                    anns.append(dict(id=len(anns) + 1, image_id=i, category_id=int(c),
                                     bbox=[float(x), float(y), float(w), float(h)], area=float(w * h), iscrowd=0))
        scene = dict(images=images, annotations=anns, categories=[dict(id=c, name=f"c{c}") for c in cat_ids])
        dets = []
        for ann in anns:
            if rng.rand() < 0.8:
                dets.append(_det(ann["image_id"], ann["category_id"],
                                 [v + float(rng.randn() * 3) for v in ann["bbox"]], float(rng.rand())))
        for _ in range(10):
            x, y = rng.randint(0, 150, 2)
            w, h = rng.randint(8, 50, 2)
            dets.append(_det(int(rng.randint(1, 7)), int(rng.choice(cat_ids)),
                             [float(x), float(y), float(w), float(h)], float(rng.rand())))
    return scene, dets, [1, 2, 3, 4], 300


def _lvis_case(name):
    """(scene, detections, cat_ids, max_dets) of each case of
    tests/test_lvis_eval.py."""
    scene = _scene()
    if name == "perfect":
        return scene, _perfect(), [1, 2], 300
    if name == "unknown_image_dropped":
        return scene, _perfect() + [_det(3, 1, [0, 0, 10, 10], 0.95)], [1, 2], 300
    if name == "negative_image_fp":
        return scene, _perfect() + [_det(1, 2, [0, 0, 10, 10], 0.95)], [1, 2], 300
    if name == "not_exhaustive_unmatched_ignored":
        return scene, _perfect() + [_det(2, 1, [70, 70, 10, 10], 0.95)], [1, 2], 300
    if name == "not_exhaustive_matched_tp":
        return scene, [d for d in _perfect() if d["image_id"] != 2], [1, 2], 300
    if name == "per_image_cap":
        return scene, _perfect() + [_det(1, 1, [j % 50, 40, 5, 5], 0.01 + 1e-6 * j) for j in range(400)], [1, 2], 300
    if name == "no_frequency":
        for c in scene["categories"]:
            del c["frequency"]
        return scene, _perfect(), [1, 2], 300
    return _exhaustive_scene(int(name[-1]))


LVIS_CASES = ["perfect", "unknown_image_dropped", "negative_image_fp", "not_exhaustive_unmatched_ignored",
              "not_exhaustive_matched_tp", "per_image_cap", "no_frequency"] + [f"exhaustive_{t}" for t in range(5)]


@pytest.mark.parametrize("case", LVIS_CASES)
def test_lvis_evaluator_matches_jax(case):
    scene, dets, cat_ids, max_dets = _lvis_case(case)
    ref = JaxLVISEvaluator(JaxCocoIndex(json.loads(json.dumps(scene))), cat_ids=cat_ids, max_dets=max_dets)
    port = LVISEvaluator(CocoIndex(json.loads(json.dumps(scene))), cat_ids=cat_ids, max_dets=max_dets)
    want, got = ref.evaluate(dets), port.evaluate(dets)
    _same(got, want)
    _same(port.classwise_ap(), ref.classwise_ap())
    assert ("mAP_r" in got) == any("frequency" in c for c in scene["categories"])


def test_lvis_dataset_evaluates_through_evaluate_results():
    ref, port = JaxLVISV1Dataset(_scene(), test_mode=True), LVISV1Dataset(_scene(), test_mode=True)
    results = [dict(img_id=i, boxes=np.array([b], np.float32), scores=np.array([0.9], np.float32),
                    labels=np.array([c], np.int64))
               for i, b, c in ((1, [10.0, 10.0, 30.0, 30.0], 0), (2, [30.0, 30.0, 50.0, 50.0], 0),
                               (3, [50.0, 50.0, 70.0, 70.0], 1), (3, [0.0, 0.0, 9.0, 9.0], 0))]
    for classwise in (False, True):
        got = port_test.evaluate_results(port, results, classwise=classwise)
        _same(got, jax_evaluate_results(ref, results, classwise=classwise))
    assert got["bbox_mAP_f"] == pytest.approx(1.0) and got["bbox_AP_cat1"] == pytest.approx(1.0)


# ----------------------------------------------------- the slice, evaluated


def test_voc_test_from_config_matches_jax(tmp_path):
    """The narrowed flagship with VOC's 20 classes and the same seeded
    weights, strict ``test_from_config`` on a VOC2007 test split of the JPEG
    fixtures (one image's XML without ``<size>``): the same keep sets,
    boxes within 1e-3 px and scores within 1e-6, and the same VOC metrics."""
    jpegs, records = jpeg_fixtures()
    root = write_voc_split(str(tmp_path), records, jpegs, [("test", 4)])
    opts = NARROW + ["model.bbox_head.num_classes=20", "data.samples_per_gpu=2", "data.test.type='VOCDataset'",
                     f"data.test.ann_file={osp.join(root, 'ImageSets', 'Main', 'test.txt')!r}",
                     f"data.test.img_prefix={root!r}", "data.test.classes=None", "data.test.bop_submission=False",
                     "data.test.pipeline.1.img_scale=(96, 64)"]
    jax_cfg, cfg, _, variables, port = config_pair(FLAGSHIP, opts)[:5]
    _, ref, ref_metrics = jax_test_from_config(jax_cfg, variables, eval_options={})
    dataset, got, got_metrics = port_test.test_from_config(cfg, port, eval_options={})
    assert type(dataset).__name__ == "VOCDataset" and dataset.year == 2007 and len(got) == 4
    assert sum(len(r["labels"]) for r in got) > 50  # the random head clears score_thr
    for a, b in zip(got, ref):
        assert a["img_id"] == b["img_id"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-6)
    assert got_metrics.keys() == ref_metrics.keys() == {"AP50", "mAP"}
    assert got_metrics == ref_metrics
