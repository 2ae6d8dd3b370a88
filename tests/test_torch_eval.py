"""The port's evaluation path against the JAX package, float32 on the CPU:
COCO metrics, the file-backed BOP test dataset, strict ``test_from_config``
on a synthetic PNG test set, the test CLI, and eval during training.

The PNG test set is written by ``synthetic_bop.write_bop_test_set`` (rows
cycle through all five PNG filters) at the narrow parity widths of
``tests/torch_parity.py``: 3 images at the 64x96 input size, 2 at 81x108
(resized) and 2 portrait ones (the per-orientation views)."""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import radet_tpu_torch.apis.test as port_test
from radet_tpu.apis.common import _build_bop as jax_build_bop
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.test import test_from_config as jax_test_from_config
from radet_tpu.data.coco_io import CocoIndex as JaxCocoIndex
from radet_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import _build_bop, build_dataset, build_model_and_anchors
from radet_tpu_torch.apis.train import train_detector
from radet_tpu_torch.data import InMemoryBOPDataset, train_transforms
from radet_tpu_torch.data.coco_io import CocoIndex
from radet_tpu_torch.data.image_io import IMREAD_UNCHANGED, imread, imread_rgb
from radet_tpu_torch.engine.checkpoint import load_weights, save_weights
from radet_tpu_torch.evaluation.coco_eval import COCOEvaluator
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from radet_tpu_torch.utils.visualization import imshow_det_bboxes
from synthetic_bop import synthetic_bop_records, write_bop_test_set
from torch_parity import FLAGSHIP, IMG_HW, NARROW, flax_and_port_models
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

GOLDEN = osp.join(REPO, "tests", "golden")
NAMES = ["a", "b", "c", "d"]
GROUPS = [(3, IMG_HW), (2, (81, 108)), (2, IMG_HW[::-1])]


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    """Config options reading the PNG test set as data.test and a
    landscape-only one as data.val (periodic eval, as in the JAX package,
    runs one view at the input size)."""
    opts = NARROW + ["data.samples_per_gpu=2"]
    for split, groups in (("test", GROUPS), ("val", GROUPS[:2])):
        root = str(tmp_path_factory.mktemp(f"bop_png_{split}"))
        ann = write_bop_test_set(root, np.random.RandomState(0), groups, NAMES)
        opts += [f"data.{split}.{k}={v!r}" for k, v in (
            ("ann_file", ann), ("img_prefix", osp.join(root, "test") + "/"), ("classes", NAMES),
            ("pipeline.1.img_scale", IMG_HW[::-1]))]
    return opts


# ---------------------------------------------------------------- COCO eval


def _coco(rng, n_img=6, n_cat=3):
    """A COCO dict with crowd and ignored GTs of all area ranges, and
    detections near (and away from) them."""
    images = [dict(id=i + 1, file_name=f"{i:06d}.png", height=480, width=640) for i in range(n_img)]
    anns, dets = [], []
    for img in images:
        for _ in range(rng.randint(1, 7)):
            w, h = rng.uniform(8, 200, 2)
            x, y = rng.uniform(0, 400), rng.uniform(0, 250)
            cat = int(rng.randint(1, n_cat + 1))
            anns.append(dict(id=len(anns) + 1, image_id=img["id"], category_id=cat, bbox=[x, y, w, h],
                             area=float(w * h), iscrowd=int(rng.rand() < 0.1), ignore=int(rng.rand() < 0.1)))
            for _ in range(rng.randint(0, 4)):
                jitter = rng.randn(4) * [4, 4, 6, 6]
                dets.append(dict(image_id=img["id"], category_id=cat if rng.rand() < 0.8 else 1,
                                 bbox=list(np.maximum([x, y, w, h] + jitter, 1.0)), score=float(rng.rand())))
        for _ in range(rng.randint(0, 3)):
            dets.append(dict(image_id=img["id"], category_id=int(rng.randint(1, n_cat + 1)),
                             bbox=list(rng.uniform(1, 300, 4)), score=float(rng.rand())))
    cats = [dict(id=c + 1, name=f"cat{c}") for c in range(n_cat)]
    return dict(images=images, annotations=anns, categories=cats), dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    gt, dets = _coco(np.random.RandomState(seed))
    ref = JaxCOCOEvaluator(JaxCocoIndex(json.loads(json.dumps(gt))), cat_ids=[1, 2, 3])
    port = COCOEvaluator(CocoIndex(json.loads(json.dumps(gt))), cat_ids=[1, 2, 3])
    want, got = ref.evaluate(dets), port.evaluate(dets)
    assert got.keys() == want.keys() and 0 < got["mAP"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert port.classwise_ap() == pytest.approx(ref.classwise_ap(), abs=1e-12)


def test_coco_evaluator_on_the_golden_detections(tmp_path):
    """tests/golden/detections.json evaluated on its synthetic scene gives
    tests/golden/metrics.json.  The goldens round boxes to 1e-3 px and
    scores to 1e-4 (the metrics were taken before rounding), which moves
    the APs by up to 1e-5: the bar is 2e-5."""
    from fixtures import make_synthetic_bop

    ann, _ = make_synthetic_bop(str(tmp_path), num_scenes=1, images_per_scene=4, img_hw=(128, 160),
                                num_classes=4, seed=3)
    index = CocoIndex(ann)
    cat_ids = index.get_cat_ids()
    with open(osp.join(GOLDEN, "detections.json")) as f:
        dets = json.load(f)
    with open(osp.join(GOLDEN, "metrics.json")) as f:
        golden = json.load(f)
    results = [dict(image_id=d["img_id"], bbox=[b[0], b[1], b[2] - b[0], b[3] - b[1]], score=s,
                    category_id=cat_ids[label])
               for d in dets for b, s, label in zip(d["boxes"], d["scores"], d["labels"])]
    got = COCOEvaluator(index, cat_ids).evaluate(results)
    want = JaxCOCOEvaluator(JaxCocoIndex(ann), cat_ids).evaluate(results)
    assert got == want
    assert golden.keys() == {f"bbox_{k}" for k in got}
    for k, v in got.items():
        assert abs(v - golden[f"bbox_{k}"]) <= 2e-5, k


# --------------------------------------------------------------- BOPDataset


def test_bop_dataset_matches_jax(png_set):
    opts = png_set
    jax_cfg, cfg = JaxConfig.fromfile(FLAGSHIP, opts), Config.fromfile(FLAGSHIP, opts)
    base = IMG_HW
    views = 0
    for orient, size in (("landscape", base), ("portrait", base[::-1])):
        ref = jax_build_bop(jax_cfg, dict(jax_cfg.data.test.to_dict(), orientation=orient), True, input_size=size)
        port = _build_bop(cfg, dict(cfg.data.test.to_dict(), orientation=orient), True, input_size=size)
        assert len(port) == len(ref) > 0 and port.CLASSES == ref.CLASSES == NAMES
        assert port.cat2label == ref.cat2label and port.img_ids == ref.img_ids
        for i in range(len(ref)):
            want, got = ref[i], port[i]
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{orient} {i} {k}")
            info = ref.data_infos[i]
            got_ann = port.parse_ann_info(info)
            for k, v in ref.parse_ann_info(info).items():
                if isinstance(v, np.ndarray):
                    assert got_ann[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(got_ann[k], v, err_msg=k)
                else:
                    assert got_ann[k] == v, k
        views += 1
    assert views == 2
    # result formatting
    ref, port = (f(c, c.data.test.to_dict(), True) for f, c in ((jax_build_bop, jax_cfg), (_build_bop, cfg)))
    rng = np.random.RandomState(0)
    dets = [dict(img_id=i, boxes=rng.uniform(0, 60, (3, 4)).astype(np.float32),
                 scores=rng.rand(3).astype(np.float32), labels=rng.randint(0, 4, 3)) for i in port.img_ids]
    assert port.det2json(dets) == ref.det2json(dets)
    assert port.bop_det2json(dets) == ref.bop_det2json(dets)
    assert port.bop_det2json(dets)[0]["scene_id"] == 0 and port.bop_det2json(dets)[-1]["scene_id"] == 2


def test_unported_dataset_paths_raise(png_set):
    opts = png_set
    cfg = Config.fromfile(FLAGSHIP, opts)
    landscape = Config.fromfile(FLAGSHIP, opts + ["data.test.orientation='landscape'"])
    train_view = build_dataset(landscape, "test", test_mode=False)  # the test pipeline loads no GT
    assert not train_view.test_mode
    with pytest.raises(RuntimeError, match="could not draw a valid training sample"):
        train_view[0]
    # a CosyPoseAug left with Resize's arguments, and a RepeatDataset with no dataset or times: the
    # port raises what the JAX package's build_dataset raises on the same config
    from radet_tpu.apis.common import build_dataset as jax_build_dataset

    for opt, test_mode, error in (("data.test.pipeline.1.type='CosyPoseAug'", False, TypeError),
                                  ("data.test.type='RepeatDataset'", None, KeyError)):
        with pytest.raises(error) as ref:
            jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts + [opt]), "test", test_mode=test_mode)
        with pytest.raises(error) as got:
            build_dataset(Config.fromfile(FLAGSHIP, opts + [opt]), "test", test_mode=test_mode)
        assert got.value.args == ref.value.args
    # an unknown dataset type: the JAX package's KeyError (the dataset zoo is ported, item 12f)
    bad = "data.test.type='NoSuchDataset'"
    with pytest.raises(KeyError) as ref:
        jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts + [bad]), "test")
    with pytest.raises(KeyError) as got:
        build_dataset(Config.fromfile(FLAGSHIP, opts + [bad]), "test")
    assert got.value.args == ref.value.args
    # test-time augmentation in the pipeline: the JAX package's ValueError, pointing to test_cfg.tta
    for opt in ("data.test.pipeline.1.flip=True", "data.test.pipeline.1.img_scale=[(96, 64), (128, 96)]"):
        tta = opts + ["data.test.pipeline.1.type='MultiScaleFlipAug'", opt,
                      "data.test.pipeline.1.transforms=[{'type': 'Resize', 'keep_ratio': True}]"]
        with pytest.raises(ValueError) as ref:
            jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, tta), "test")
        with pytest.raises(ValueError) as got:
            build_dataset(Config.fromfile(FLAGSHIP, tta), "test")
        assert got.value.args == ref.value.args and "`tta`" in got.value.args[0]


# ----------------------------------------------------- strict test_from_config


@pytest.fixture(scope="module")
def strict_runs(png_set):
    """Strict ``test_from_config`` of both packages with the same weights
    (one JAX compile per orientation view)."""
    opts = png_set
    jax_cfg, cfg = JaxConfig.fromfile(FLAGSHIP, opts), Config.fromfile(FLAGSHIP, opts)
    port = build_model_and_anchors(cfg)[0]
    variables = flax_and_port_models(jax_build_model_and_anchors(jax_cfg)[0], port)
    ref = jax_test_from_config(jax_cfg, variables)
    got = port_test.test_from_config(cfg, port)
    return ref, got


@pytest.mark.parametrize("part", ["keep_sets", "boxes_and_scores", "metrics"])
def test_strict_test_from_config_matches_jax(strict_runs, part):
    """Keep sets (labels of every kept detection, per image) equal, boxes
    within 1e-3 px and scores within 1e-6, metrics within 1e-6."""
    (_, ref, ref_metrics), (_, got, got_metrics) = strict_runs
    assert [r["img_id"] for r in got] == [r["img_id"] for r in ref] and len(got) == 7
    if part == "keep_sets":
        assert sum(len(r["labels"]) for r in got) > 100  # the random head clears score_thr
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a["labels"], b["labels"])
    elif part == "boxes_and_scores":
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-6)
    else:
        assert got_metrics.keys() == ref_metrics.keys()
        for k in ref_metrics:
            assert abs(got_metrics[k] - ref_metrics[k]) <= 1e-6, k


def test_strict_overrides_reach_the_nms():
    out = port_test.strict_eval_overrides(dict(nms_topk=512, candidate_mode="global"))
    assert out["nms_topk"] == 2048 and out["candidate_mode"] == "per_level"
    assert port_test.strict_eval_overrides(dict(nms_topk=4096))["nms_topk"] == 4096


# ----------------------------------------------------------------- the CLI


def test_cli_writes_bbox_and_bop_json(png_set, tmp_path, capsys):
    opts = png_set
    cfg = Config.fromfile(FLAGSHIP, opts)
    model = build_model_and_anchors(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()  # scores clear score_thr
    ckpt = str(tmp_path / "w.pth")
    save_weights(ckpt, model.state_dict())
    prefix = str(tmp_path / "out")
    show_dir = tmp_path / "shown"
    test_cli.main([FLAGSHIP, ckpt, "--device", "cpu", "--eval", "bbox", "--format-only",
                   "--json-prefix", prefix, "--out", str(tmp_path / "r.pkl"), "--show-dir", str(show_dir),
                   "--eval-options", "classwise=True", "--cfg-options", *opts])
    metrics = json.loads(capsys.readouterr().out)
    assert "bbox_mAP" in metrics and "bbox_AP_a" in metrics
    with open(prefix + ".bbox.json") as f:
        coco = json.load(f)
    with open(prefix + ".bop.json") as f:
        bop = json.load(f)
    with open(tmp_path / "r.pkl", "rb") as f:
        results = pickle.load(f)
    assert len(coco) == len(bop) == sum(len(r["boxes"]) for r in results) > 0
    assert {d["scene_id"] for d in bop} == {0, 1, 2} and all(d["time"] == -1.0 for d in bop)
    # --show-dir: one PNG per image, named after its file, of imshow_det_bboxes at --show-score-thr 0.3
    dataset = build_dataset(cfg, "test")
    infos = {info["id"]: info for info in dataset.data_infos}
    assert len(os.listdir(show_dir)) == len(results) == len(infos)
    for r in results:
        name = infos[r["img_id"]]["filename"]
        want = imshow_det_bboxes(imread_rgb(osp.join(dataset.img_prefix, name)), r["boxes"], r["labels"],
                                 r["scores"], class_names=dataset.CLASSES, score_thr=0.3)
        np.testing.assert_array_equal(imread(str(show_dir / name.replace("/", "_")), IMREAD_UNCHANGED), want)
    # --fuse-conv-bn refuses an int8 trunk, whose activation scales come from the BN affines
    with pytest.raises(ValueError, match="--fuse-conv-bn is incompatible with backbone.quant"):
        test_cli.main([osp.join(osp.dirname(FLAGSHIP), "r50_ycbv_pbr_int8_stream.py"), "--device", "cpu",
                       "--fuse-conv-bn"])


# ---------------------------------------------------- eval during training


def test_train_detector_evaluates_and_saves_best(png_set, tmp_path):
    """Periodic eval on the PNG set writes best_weights.pth and draws no
    random numbers: the run ends on the weights of a run without eval."""
    opts = png_set
    records = synthetic_bop_records(np.random.RandomState(1), 4, IMG_HW, num_classes=4)
    cfg = Config.fromfile(FLAGSHIP, opts + ["runner.max_iters=2", "evaluation.interval=1",
                                            "evaluation.save_best='mAP_50'", "data.workers_per_gpu=1"])

    def run(work_dir, eval_during_train):
        ds = InMemoryBOPDataset(records, train_transforms(IMG_HW, max_gt=32, seed=0), max_gt=32)
        return train_detector(cfg, work_dir=str(tmp_path / work_dir), dataset=ds, device="cpu",
                              eval_during_train=eval_during_train)

    with_eval, without = run("a", True), run("b", False)
    assert with_eval.model.training
    best = tmp_path / "a" / "best_weights.pth"
    assert best.exists() and not (tmp_path / "b" / "best_weights.pth").exists()
    meta = torch.load(best, weights_only=True)["meta"]
    assert meta["step"] in (1, 2) and "bbox_mAP_50" in meta
    assert load_weights(str(best)).keys() == with_eval.model.state_dict().keys()
    for (k, v), w in zip(with_eval.model.state_dict().items(), without.model.state_dict().values()):
        assert torch.equal(v, w), k
