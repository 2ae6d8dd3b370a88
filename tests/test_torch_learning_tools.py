"""The port's learning-validation and BOP-sweep tools, and the test CLI's
reference flags, against the JAX package on the CPU:

- ``python -m radet_tpu_torch.tools.test`` parses every flag of
  ``tools/test.py::parse_args`` to the same values; ``--show`` draws into
  ``work_dir/shown`` and a launcher other than ``none`` raises naming its
  ROADMAP item;
- ``data/synthetic.py::make_synthetic_bop`` (PNG, no cv2) writes the
  annotation json of ``tests/fixtures.py::make_synthetic_bop`` (cv2, JPEG)
  but for the file names, and the same masks;
- ``python -m radet_tpu_torch.tools.validate_learning --cpu`` for 3
  iterations: the RESULT line, then PASS (exit 0) or FAIL (exit 1); its
  ``--frozen-int8`` below depth 50 raises as the JAX tool's (the A/B run
  itself: ``tests/test_torch_frozen_int8.py``);
- every BOP config the sweep runs (the seven ``_pbr`` ones and the three
  ``_mixpbr``): the test dataset in both packages over an annotation file
  of its class names, with the same ``num_classes``, ``cat2label``,
  ``CLASSES`` and category ids in the COCO results and the BOP submission;
- ``python -m radet_tpu_torch.tools.run_bop_sweep --mode test`` on LM-O at
  ResNet-18 through ``--cfg-options``, from a trainer's checkpoint
  directory: the metrics ``test_from_config`` gives for those weights;
- ``tools/compare_ap.py`` on the port's test CLI metrics dump.
"""

import importlib.util
import json
import os
import os.path as osp
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

from fixtures import make_synthetic_bop as fixture_synthetic_bop
from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_dataset, build_model_and_anchors
from radet_tpu_torch.apis.test import test_from_config as port_test_from_config
from radet_tpu_torch.data.synthetic import make_synthetic_bop
from radet_tpu_torch.engine import CheckpointManager, build_optimizer
from radet_tpu_torch.engine.train_step import TrainState
from radet_tpu_torch.tools import run_bop_sweep, validate_learning
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import write_bop_test_set
from torch_parity import FLAGSHIP, NARROW
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _reference_test_cli():
    spec = importlib.util.spec_from_file_location("reference_test_cli", osp.join(REPO, "tools", "test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------- the test CLI's flags

FLAGS = [["--launcher", "none"], ["--local_rank", "0"], ["--gpu-collect"], ["--tmpdir", "d"], ["--shuffle"],
         ["--show-score-thr", "0.5"], ["--show"]]
PARSED = ("launcher", "local_rank", "gpu_collect", "tmpdir", "shuffle", "show_score_thr", "show", "show_dir")


@pytest.mark.parametrize("flags", FLAGS + [sum(FLAGS[:-1], [])], ids=lambda f: " ".join(f))
def test_test_cli_parses_the_reference_flags(flags, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["test.py", "c.py", *flags])
    ref = vars(_reference_test_cli().parse_args())
    got = vars(test_cli.parse_args(["c.py", *flags]))
    assert {k: got[k] for k in PARSED} == {k: ref[k] for k in PARSED}


def test_test_cli_refuses_show_and_launchers(tmp_path):
    """``--show`` draws into ``work_dir/shown`` (a PNG per image); a
    launcher other than ``none`` raises naming item 13."""
    ann = write_bop_test_set(str(tmp_path), np.random.RandomState(0), [(2, (64, 96))], ["a", "b", "c", "d"])
    work_dir = tmp_path / "work"
    test_cli.main([FLAGSHIP, "--device", "cpu", "--show", "--show-score-thr", "0", "--cfg-options", *NARROW,
                   f"work_dir={str(work_dir)!r}", f"data.test.ann_file={ann!r}",
                   f"data.test.img_prefix={str(tmp_path / 'test') + '/'!r}", "data.test.classes=None",
                   "data.test.pipeline.1.img_scale=(96, 64)"])
    assert sorted(os.listdir(work_dir / "shown")) == ["000000_rgb_000000.png", "000000_rgb_000001.png"]
    with pytest.raises(NotImplementedError, match="--launcher pytorch is not ported.*item 13"):
        test_cli.main(["c.py", "--device", "cpu", "--launcher", "pytorch"])


# -------------------------------------------------------------- the scenes


def test_scene_writer_matches_the_fixture(tmp_path):
    kw = dict(num_scenes=2, images_per_scene=3, img_hw=(96, 128), num_classes=3, max_objects=3, seed=4)
    ref_ann, ref_prefix = fixture_synthetic_bop(str(tmp_path / "ref"), **kw)
    ann, prefix = make_synthetic_bop(str(tmp_path / "port"), **kw)
    with open(ref_ann) as f:
        want = json.load(f)
    with open(ann) as f:
        got = json.load(f)
    for img in want["images"]:
        img["filename"] = img["file_name"] = img["file_name"].replace(".jpg", ".png")
    assert got == want and len(got["annotations"]) > 6
    for img in got["images"]:
        png = cv2.imread(osp.join(prefix, img["file_name"]), cv2.IMREAD_COLOR)
        jpeg = cv2.imread(osp.join(ref_prefix, img["file_name"].replace(".png", ".jpg")), cv2.IMREAD_COLOR)
        assert png.shape == jpeg.shape
        # the object drawn last, away from its edges, where JPEG keeps the flat colour: channels in cv2's order
        a = [b for b in got["annotations"] if b["image_id"] == img["id"]][-1]
        x, y, w, h = (int(v) for v in a["bbox"])
        inner = np.s_[y + 4:y + h - 3, x + 4:x + w - 3]
        c = a["category_id"] - 1
        assert (png[inner] == [(60 + 60 * c) % 256, (200 - 50 * c) % 256, 255]).all()
        assert np.abs(png[inner].astype(int) - jpeg[inner]).max() <= 16
    for a in got["annotations"]:
        img = got["images"][a["image_id"] - 1]["file_name"]
        i = sum(1 for b in got["annotations"] if b["image_id"] == a["image_id"] and b["id"] < a["id"])
        name = osp.join(osp.dirname(osp.dirname(img)), "mask_visib", f"{osp.basename(img)[:-4]}_{i:06d}.png")
        assert np.array_equal(cv2.imread(osp.join(prefix, name), cv2.IMREAD_GRAYSCALE),
                              cv2.imread(osp.join(ref_prefix, name), cv2.IMREAD_GRAYSCALE)), name


# --------------------------------------------------------- validate_learning

TINY = ["--cpu", "--iters", "3", "--images", "4", "--img-size", "64", "96", "--workers", "1"]


@pytest.mark.parametrize("min_map50,code", [("0", None), ("1.1", 1)])
def test_validate_learning_gates_on_map50(min_map50, code, capsys):
    if code is None:
        metrics = validate_learning.main(TINY + ["--min-map50", min_map50])
        assert 0 <= metrics["bbox_mAP_50"] <= 1
    else:
        with pytest.raises(SystemExit) as exit_:
            validate_learning.main(TINY + ["--min-map50", min_map50])
        assert exit_.value.code == code
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("RESULT mAP50=") and " mAP=" in lines[-2]
    assert lines[-1] == "PASS" if code is None else lines[-1].startswith("FAIL: mAP50")


def test_validate_learning_refuses_int8_and_a_missing_card():
    with pytest.raises(AssertionError, match="--depth 50"):
        validate_learning.main(["--cpu", "--frozen-int8"])
    args = validate_learning.parse_args(["--cpu"])
    assert (args.iters, args.depth, args.images, args.batch, args.lr, args.min_map50, args.img_size,
            args.feat, args.stacked_convs, args.num_classes, args.dtype, args.workers, args.frozen_int8,
            args.frozen_int8_iters) == (400, 18, 16, 4, 1e-3, 0.5, (128, 160), 64, 2, 3, "float32", 4, False, 200)
    cfg = validate_learning.learning_config(args, "root")
    assert cfg.model.backbone.norm_eval is False and cfg.model.backbone.frozen_stages == -1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            validate_learning.main([])


# ----------------------------------------------------------- the BOP sweep

SWEEP = [f"r50_{d}_pbr.py" for d in run_bop_sweep.DATASETS] + [
    f"r50_{d}_mixpbr.py" for d in ("ycbv", "tless", "tudl")]


@pytest.mark.parametrize("config", SWEEP)
def test_bop_config_class_maps_match_jax(config, tmp_path):
    """The annotation file names every category of the dataset (LM-O's 15
    LineMOD objects, HB's 33); the configs select theirs by name."""
    path = osp.join(REPO, "configs", "bop", config)
    names = list(Config.fromfile(path).CLASS_NAMES)
    ann = write_bop_test_set(str(tmp_path), np.random.RandomState(1), ((3, (48, 64)),), names)
    opts = [f"data.test.ann_file={ann!r}", f"data.test.img_prefix={osp.join(str(tmp_path), 'test') + '/'!r}"]
    cfg, jax_cfg = Config.fromfile(path, opts), JaxConfig.fromfile(path, opts)
    port, ref = build_dataset(cfg, "test"), jax_build_dataset(jax_cfg, "test")
    assert port.CLASSES == ref.CLASSES and len(port.CLASSES) == cfg.model.bbox_head.num_classes
    assert port.cat2label == ref.cat2label and port.cat_ids == ref.cat_ids and port.bop_submission
    assert cfg.model.bbox_head.num_classes == jax_cfg.model.bbox_head.num_classes
    rng = np.random.RandomState(2)
    n = len(port.CLASSES)
    dets = [dict(img_id=i, boxes=rng.uniform(0, 40, (4, 4)).astype(np.float32), scores=rng.rand(4).astype(np.float32),
                 labels=rng.randint(0, n, 4)) for i in port.img_ids]
    assert port.det2json(dets) == ref.det2json(dets)
    assert port.bop_det2json(dets) == ref.bop_det2json(dets)
    with open(ann) as f:
        categories = json.load(f)["categories"]
    named = {c["id"] for c in categories if c["name"] in {str(n) for n in port.CLASSES}}
    assert {d["category_id"] for d in port.bop_det2json(dets)} <= named and len(named) == n


SWEEP_HW = (64, 96)
SWEEP_NARROW = [o for o in NARROW if not o.startswith("input_size")] + [
    f"input_size={SWEEP_HW}", "model.backbone.depth=18", "model.bbox_head.num_classes=8",
    "data.samples_per_gpu=2", "data.workers_per_gpu=1", f"data.test.pipeline.1.img_scale={SWEEP_HW[::-1]}"]


@pytest.fixture(scope="module")
def lmo_run(tmp_path_factory):
    """LM-O narrowed to ResNet-18 over a PNG test set of the LineMOD names,
    and a trainer's checkpoint directory of seeded weights where the sweep
    looks for it; returns (cfg options, checkpoint root, the weights)."""
    root = tmp_path_factory.mktemp("sweep")
    path = osp.join(REPO, "configs", "bop", "r50_lmo_pbr.py")
    ann = write_bop_test_set(str(root), np.random.RandomState(3), ((4, SWEEP_HW),),
                             list(Config.fromfile(path).CLASS_NAMES))
    opts = SWEEP_NARROW + [f"data.test.ann_file={ann!r}", f"data.test.img_prefix={osp.join(str(root), 'test') + '/'!r}"]
    cfg = Config.fromfile(path, opts)
    model = build_model_and_anchors(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()  # scores clear score_thr
    ckpt = str(root / "ckpt" / osp.basename(cfg.work_dir) / "checkpoints")
    tx, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, model)
    CheckpointManager(ckpt).save(1, TrainState(model, tx, step=1), force=True)
    return opts, str(root / "ckpt"), model


def test_bop_sweep_tests_a_trainers_checkpoint(lmo_run, tmp_path, capsys):
    opts, ckpt_root, model = lmo_run
    out = str(tmp_path / "summary.json")
    summary = run_bop_sweep.main(["--datasets", "lmo", "--mode", "test", "--checkpoint-root", ckpt_root,
                                  "--out", out, "--device", "cpu", "--cfg-options", *opts])
    entry = summary["lmo"]
    assert entry["status"] == "ok", entry.get("error")
    assert entry["checkpoint"].endswith("lmo_r50_radet_pbr/checkpoints")
    cfg = Config.fromfile(osp.join(REPO, "configs", "bop", "r50_lmo_pbr.py"), opts)
    dataset, results, metrics = port_test_from_config(cfg, model.eval())
    assert entry["metrics"] == pytest.approx(metrics, abs=1e-12) and sum(len(r["boxes"]) for r in results)
    with open(out) as f:
        assert json.load(f)["lmo"]["metrics"] == entry["metrics"]
    table = capsys.readouterr().out
    assert "lmo      ok" in table and "summary written to" in table
    # a dataset that fails is recorded and the sweep goes on
    failed = run_bop_sweep.main(["--datasets", "tudl", "--mode", "test", "--out", out, "--device", "cpu",
                                 "--cfg-options", *SWEEP_NARROW])
    assert failed["tudl"]["status"] == "failed" and "FileNotFoundError" in failed["tudl"]["error"]


def test_compare_ap_reads_the_test_clis_metrics(lmo_run, tmp_path, capsys):
    opts, ckpt_root, _ = lmo_run
    cfg = osp.join(REPO, "configs", "bop", "r50_lmo_pbr.py")
    test_cli.main([cfg, osp.join(ckpt_root, "lmo_r50_radet_pbr", "checkpoints"), "--device", "cpu", "--eval",
                   "bbox", "--cfg-options", *opts])
    got = str(tmp_path / "got.json")
    metrics = json.loads(capsys.readouterr().out)
    with open(got, "w") as f:
        json.dump(metrics, f)

    def compare_ap(*argv):
        old = sys.argv
        sys.argv = ["compare_ap.py", *argv]
        try:
            runpy.run_path(osp.join(REPO, "tools", "compare_ap.py"), run_name="__main__")
        except SystemExit as e:
            return e.code
        finally:
            sys.argv = old

    assert compare_ap(got, got, "--keys", "bbox_mAP", "bbox_mAP_50", "--tol", "0") == 0
    assert compare_ap(got, "--expect", f"bbox_mAP={metrics['bbox_mAP'] + 0.3}", "--tol", "0.2") == 1
    assert "FAIL bbox_mAP" in capsys.readouterr().out
