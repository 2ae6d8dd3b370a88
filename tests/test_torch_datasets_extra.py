"""The port's dataset zoo (``data/datasets_extra.py``) against the JAX
package's on the CPU, and VOC through the train and test CLIs.

- the COCO dict that ``_xml_to_coco`` builds and every parsed annotation,
  equal to JAX's: VOC2007 and VOC2012 (year from ``img_prefix``),
  ``min_size`` and ``difficult`` routed to the ignore set, an XML without
  ``<size>`` (the size from the JPEG header, where JAX opens the image with
  PIL), ``XMLDataset`` with its own classes, WIDER Face's folder file names;
- ``build_dataset`` of every type of ``DATASET_TYPES`` (the presets'
  ``CLASSES``, LVIS's ``coco_url`` file names), its test samples and its
  evaluation through ``evaluate_results`` (VOC's and LVIS's own protocols,
  KITTI's forced classwise AP) equal to JAX's; a ``ConcatDataset`` of a
  VOC2007 and a VOC2012 split (mmdet's VOC0712); an unknown type's KeyError;
- ``python -m radet_tpu_torch.tools.train --device cpu`` on a VOC split with
  ``evaluation.save_best='mAP'`` writes ``best_weights.pth`` with ``mAP`` in
  its meta, and ``tools.test --eval mAP`` prints VOC's AP50 and mAP.
"""

import json
import os
import os.path as osp
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import radet_tpu_torch.apis.test as port_test
from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.apis.test import evaluate_results as jax_evaluate_results
from radet_tpu.data import datasets_extra as jax_extra
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_dataset
from radet_tpu_torch.data import datasets_extra
from radet_tpu_torch.data.image_io import image_size
from radet_tpu_torch.utils.config import Config
from synthetic_bop import VOC_CLASSES, jpeg_fixtures, voc_options, write_bop_test_set, write_voc_split
from torch_parity import FLAGSHIP, NARROW
from torch_threads import one_thread_env
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TEST_SCALE = "data.{}.pipeline.1.img_scale=(96, 64)"  # the flagship's test Resize at the narrow input


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """VOC2007 (trainval 6, test 3) and VOC2012 (trainval 4) splits of the
    JPEG fixtures; the first image of each without ``<size>``."""
    root = str(tmp_path_factory.mktemp("voc"))
    jpegs, records = jpeg_fixtures()
    return dict(root=root, voc07=write_voc_split(root, records, jpegs, [("trainval", 6), ("test", 3)]),
                voc12=write_voc_split(root, records[::-1], jpegs[::-1], [("trainval", 4)], year=2012))


def _listed(prefix, split):
    return osp.join(prefix, "ImageSets", "Main", f"{split}.txt")


def _same_dataset(port, ref):
    """Both datasets' COCO dicts, ids, classes and every parsed annotation
    equal."""
    assert type(port).__name__ == type(ref).__name__
    assert port.coco.dataset == ref.coco.dataset
    assert port.img_ids == ref.img_ids and list(port.CLASSES) == list(ref.CLASSES) and port.cat_ids == ref.cat_ids
    assert port.data_infos == ref.data_infos
    for info in ref.data_infos:
        got, want = port.parse_ann_info(info), ref.parse_ann_info(info)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


@pytest.mark.parametrize("year", [2007, 2012])
@pytest.mark.parametrize("min_size", [None, 7])
@pytest.mark.parametrize("test_mode", [True, False])
def test_voc_dataset_matches_jax(voc, year, min_size, test_mode):
    prefix = voc["voc07" if year == 2007 else "voc12"]
    kw = dict(ann_file=_listed(prefix, "trainval"), img_prefix=prefix, test_mode=test_mode, min_size=min_size)
    port, ref = datasets_extra.VOCDataset(**kw), jax_extra.VOCDataset(**kw)
    _same_dataset(port, ref)
    assert port.year == ref.year == year and len(port.CLASSES) == 20
    ignored = sum(len(port.parse_ann_info(i)["bboxes_ignore"]) for i in port.data_infos)
    assert ignored >= (3 if min_size else 1)  # difficult objects, and the small ones with min_size
    assert port.data_infos[0]["width"] == 640  # its XML has no <size>


WIDER_FOLDERS = ("0--Parade", "0--Parade", "12--Group")


@pytest.fixture(scope="module")
def wider(tmp_path_factory):
    """A WIDER Face split in VOC layout: images under their XML's folder,
    the last XML without ``<size>``.  Returns (list file, prefix, ids)."""
    root = tmp_path_factory.mktemp("wider") / "WIDER_val"
    os.makedirs(root / "Annotations")
    rng = np.random.RandomState(0)
    ids = []
    for i, folder in enumerate(WIDER_FOLDERS):
        img_id = f"{i}_Parade_marchingband_1_{i}"
        os.makedirs(root / folder, exist_ok=True)
        cv2.imwrite(str(root / folder / f"{img_id}.jpg"), rng.randint(0, 255, (48, 64, 3), np.uint8))
        size = "" if i == 2 else "<size><width>64</width><height>48</height><depth>3</depth></size>"
        with open(root / "Annotations" / f"{img_id}.xml", "w") as f:
            f.write(f"<annotation><folder>{folder}</folder><filename>{img_id}.jpg</filename>{size}"
                    f"<object><name>face</name><difficult>{i % 2}</difficult><bndbox><xmin>{5 + i}</xmin>"
                    f"<ymin>6</ymin><xmax>{30 + i}</xmax><ymax>40</ymax></bndbox></object></annotation>")
        ids.append(img_id)
    with open(root / "val.txt", "w") as f:
        f.write("\n".join(ids) + "\n")
    return str(root / "val.txt"), str(root), ids


def test_xml_and_wider_face_match_jax(voc, wider):
    """``XMLDataset`` with a subset of classes (the others' objects
    skipped), and WIDER Face's ``{folder}/{id}.jpg`` file names."""
    prefix = voc["voc07"]
    kw = dict(ann_file=_listed(prefix, "trainval"), img_prefix=prefix, classes=list(VOC_CLASSES[:8]), min_size=7,
              test_mode=True)
    port = datasets_extra.XMLDataset(**kw)
    _same_dataset(port, jax_extra.XMLDataset(**kw))
    assert port.CLASSES == list(VOC_CLASSES[:8])
    for cls in (datasets_extra.XMLDataset, jax_extra.XMLDataset):
        with pytest.raises(ValueError, match="needs class names"):
            cls(ann_file=kw["ann_file"], img_prefix=prefix)
    ann, root, ids = wider
    kw = dict(ann_file=ann, img_prefix=root, test_mode=True)
    port = datasets_extra.WIDERFaceDataset(**kw)
    _same_dataset(port, jax_extra.WIDERFaceDataset(**kw))
    assert [i["filename"] for i in port.data_infos] == [f"{f}/{n}.jpg" for f, n in zip(WIDER_FOLDERS, ids)]
    assert image_size(osp.join(root, WIDER_FOLDERS[2], f"{ids[2]}.jpg")) == (64, 48)


def test_voc_year_must_be_inferred(voc, tmp_path):
    other = tmp_path / "VOCdevkit_other"
    os.symlink(voc["voc07"], other)
    for cls in (datasets_extra.VOCDataset, jax_extra.VOCDataset):
        with pytest.raises(ValueError, match="Cannot infer dataset year"):
            cls(ann_file=_listed(str(other), "test"), img_prefix=str(other), test_mode=True)


def _png_split(root, class_names, n=3, hw=(48, 64)):
    ann = write_bop_test_set(root, np.random.RandomState(1), [(n, hw)], class_names)
    return ann, osp.join(root, "test") + "/"


def _lvis_split(root):
    """An LVIS v1 json: images named by ``coco_url`` only, negative and
    not-exhaustive category sets, category frequencies."""
    ann, prefix = _png_split(root, ["c1", "c2", "c3"])
    with open(ann) as f:
        data = json.load(f)
    for img, neg, nel in zip(data["images"], ([2], [], [3]), ([], [1], [])):
        url = f"http://images.cocodataset.org/val2017/{img['id']:012d}.png"
        os.makedirs(osp.join(prefix, "val2017"), exist_ok=True)
        os.replace(osp.join(prefix, img.pop("file_name")), osp.join(prefix, "val2017", f"{img['id']:012d}.png"))
        img.update(coco_url=url, neg_category_ids=neg, not_exhaustive_category_ids=nel)
    for cat, freq in zip(data["categories"], "fcr"):
        cat["frequency"] = freq
    with open(ann, "w") as f:
        json.dump(data, f)
    return ann, prefix


def _detections(dataset, seed):
    """Detections near each test image's GT boxes and away from them."""
    rng = np.random.RandomState(seed)
    out = []
    for info in dataset.data_infos:
        ann = dataset.parse_ann_info(info)
        boxes = np.concatenate([ann["bboxes"] + rng.randn(len(ann["bboxes"]), 4).astype(np.float32) * 2,
                                rng.uniform(0, 40, (3, 4)).astype(np.float32)])
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 2)
        labels = np.concatenate([ann["labels"], rng.randint(0, len(dataset.CLASSES), 3)])
        out.append(dict(img_id=info["id"], boxes=boxes, scores=rng.rand(len(boxes)).astype(np.float32),
                        labels=labels.astype(np.int64)))
    return out


def _options(voc, wider, tmp_path, ds_type):
    """cfg-options pointing data.test at a split of ``ds_type``."""
    xml = {"VOCDataset": (_listed(voc["voc07"], "test"), voc["voc07"]),
           "XMLDataset": (_listed(voc["voc07"], "test"), voc["voc07"]), "WIDERFaceDataset": wider[:2]}
    if ds_type in xml:
        ann, prefix = xml[ds_type]
    elif ds_type in ("LVISV1Dataset", "LVISDataset"):
        ann, prefix = _lvis_split(str(tmp_path / "lvis"))
    else:
        names = getattr(datasets_extra.DATASET_TYPES[ds_type], "CLASSES", None) or ["a", "b", "c"]
        ann, prefix = _png_split(str(tmp_path / ds_type), list(names))
    opts = NARROW + [TEST_SCALE.format("test"), f"data.test.type={ds_type!r}", f"data.test.ann_file={ann!r}",
                     f"data.test.img_prefix={prefix!r}", "data.test.bop_submission=False",
                     "data.test.classes=None" if ds_type != "XMLDataset" else
                     f"data.test.classes={list(VOC_CLASSES)!r}"]
    if issubclass(datasets_extra.DATASET_TYPES[ds_type], datasets_extra.XMLDataset):
        opts.append("data.test.min_size=7")
    return opts


@pytest.mark.parametrize("ds_type", sorted(datasets_extra.DATASET_TYPES))
def test_build_dataset_of_every_type_matches_jax(voc, wider, tmp_path, ds_type):
    """``build_dataset`` of each registered type from the flagship config:
    the same class, classes, ids, test samples and evaluation as JAX's
    (``min_size`` reaches only the XML types)."""
    assert sorted(datasets_extra.DATASET_TYPES) == sorted(jax_extra.DATASET_TYPES)
    opts = _options(voc, wider, tmp_path, ds_type)
    ref = jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts), "test")
    port = build_dataset(Config.fromfile(FLAGSHIP, opts), "test")
    assert type(port).__name__ == type(ref).__name__ == datasets_extra.DATASET_TYPES[ds_type].__name__
    _same_dataset(port, ref)
    for i in range(len(ref)):
        want, got = ref[i], port[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ds_type} {i} {k}")
    dets = _detections(port, 0)
    for classwise in (False, True):
        got = port_test.evaluate_results(port, dets, classwise=classwise)
        want = jax_evaluate_results(ref, dets, classwise=classwise)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k
    if ds_type == "KittiDataset":
        assert "bbox_AP_Car" in port_test.evaluate_results(port, dets)  # classwise forced
    if ds_type == "VOCDataset":
        assert got.keys() == {"AP50", "mAP"} and got["mAP"] > 0.2
    if ds_type.startswith("LVIS"):
        assert "bbox_mAP_r" in got and port.data_infos[0]["filename"] == "val2017/000000000001.png"


def test_voc_evaluate_matches_jax(voc):
    """``VOCDataset.evaluate``: mAP at one and two IoU thresholds (11 points
    for VOC2007, the area for VOC2012), and proposal recall."""
    for prefix, split in ((voc["voc07"], "test"), (voc["voc12"], "trainval")):
        kw = dict(ann_file=_listed(prefix, split), img_prefix=prefix, test_mode=True)
        port, ref = datasets_extra.VOCDataset(**kw), jax_extra.VOCDataset(**kw)
        dets = _detections(port, 1)[1:]  # an image without results too
        for options in (dict(), dict(iou_thr=[0.5, 0.75]), dict(metric=["mAP"], iou_thr=0.7),
                        dict(metric="recall", proposal_nums=(1, 10)),
                        dict(metric="recall", proposal_nums=(2, 100), iou_thr=[0.5, 0.7])):
            assert port.evaluate(dets, **options) == ref.evaluate(dets, **options), options
        for ds in (port, ref):
            with pytest.raises(KeyError, match="not supported"):
                ds.evaluate(dets, metric="bbox")


def test_concat_voc0712_matches_jax(voc):
    """mmdet's VOC0712: a ``ConcatDataset`` of the VOC2007 and VOC2012
    trainval splits through the SSD recipe, the sub-datasets inheriting the
    wrapper's pipeline; seeded samples from both halves equal JAX's (the
    box maps' ``dist_vals`` within 2e-5 plus a float16 step)."""
    opts = NARROW + voc_options(voc["voc07"], img_scale=(96, 64)) + [
        "data.train.type='ConcatDataset'",
        "data.train.datasets=[" + ", ".join(
            repr(dict(type="VOCDataset", ann_file=_listed(p, "trainval"), img_prefix=p))
            for p in (voc["voc07"], voc["voc12"])) + "]"]
    ref = jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts), "train", test_mode=False)
    port = build_dataset(Config.fromfile(FLAGSHIP, opts), "train")
    assert type(port).__name__ == "ConcatDataset" and len(port) == len(ref) == 10
    assert [d.year for d in port.datasets] == [2007, 2012]
    for idx in (0, 7):
        out = []
        for ds in (ref, port):
            random.seed(idx)
            np.random.seed(idx)
            out.append(ds[idx])
        want, got = out
        for k in want:
            if k != "dist_vals":
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{idx} {k}")
        np.testing.assert_allclose(got["dist_vals"].astype(np.float32), want["dist_vals"].astype(np.float32),
                                   rtol=2.0 ** -10, atol=2e-5)


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def voc_cli(voc, tmp_path_factory):
    """The narrow flagship with VOC's options trained two steps through the
    train CLI on the CPU, one periodic eval at step 2 with save_best='mAP'."""
    work = str(tmp_path_factory.mktemp("voc_train"))
    opts = NARROW + voc_options(voc["voc07"], min_size=7, img_scale=(96, 64)) + [
        TEST_SCALE.format("val"), TEST_SCALE.format("test"), "data.samples_per_gpu=2", "data.workers_per_gpu=1",
        "log_config.interval=1", "checkpoint_config.interval=2", "evaluation.interval=2", "test_cfg.score_thr=0.0"]
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.train", FLAGSHIP, "--work-dir", work, "--device", "cpu",
           "--max-iters", "2", "--cfg-options", *opts]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=one_thread_env())
    return work, opts, proc


def test_train_cli_saves_best_by_voc_map(voc_cli):
    """VOC's metrics are unprefixed (``mAP``, ``AP50``): ``save_best='mAP'``
    falls back to the bare name, as the JAX trainer does, and writes
    ``best_weights.pth`` with ``mAP`` in its meta."""
    work, _, proc = voc_cli
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = [ln.split(" - ")[-1] for ln in proc.stderr.splitlines()]
    assert any(ln.startswith("train dataset: 6 samples, 20 classes") for ln in log), proc.stderr[-2000:]
    evals = [ln for ln in log if ln.startswith("eval: ")]
    assert len(evals) == 1 and "AP50" in evals[0] and " mAP " in evals[0], evals
    best = torch.load(osp.join(work, "best_weights.pth"), weights_only=True)
    assert best["meta"]["step"] == 2 and "mAP" in best["meta"] and best["meta"]["CLASSES"] == list(VOC_CLASSES)
    assert any(ln.startswith("new best mAP=") for ln in log)


def test_test_cli_prints_voc_metrics(voc_cli, tmp_path):
    """``tools.test --eval mAP`` (a name the JAX CLI accepts, as any) on the
    VOC2007 test split with the trained weights prints VOC's AP50 and mAP."""
    work, opts, proc = voc_cli
    assert proc.returncode == 0, proc.stderr[-3000:]
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.test", FLAGSHIP, osp.join(work, "best_weights.pth"),
           "--device", "cpu", "--eval", "mAP", "--cfg-options", *opts]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=one_thread_env())
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout)
    assert metrics.keys() == {"AP50", "mAP"} and all(0.0 <= v <= 1.0 for v in metrics.values())
    assert "vote_nms kernel launches" in out.stderr
