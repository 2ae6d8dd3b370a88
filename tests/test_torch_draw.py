"""Drawing with the port against cv2 (5.0.0 here) and the JAX package on the
CPU:

- ``utils/raster.py``: text (every printable ASCII character alone and in
  strings, at the (scale, thickness) pairs of ``utils/text_glyphs.py``, at
  origins that clip at each edge, on noise, in colour and gray),
  rectangles, circles and thick fixed-point lines, bit for bit;
- ``utils/visualization.py``'s ``imshow_det_bboxes`` and
  ``imshow_gt_det_bboxes`` and ``apis/inference.py``'s ``show_result`` and
  ``show_result_pyplot`` against the JAX package's, on the same inputs
  (fixed cases and a Hypothesis property test);
- ``utils/image_write.py``: JPEG bytes equal to ``cv2.imencode(".jpg")``,
  PNGs that decode to cv2's pixels, other extensions refused;
- the tools against the JAX tools on the same synthetic BOP files:
  ``tools.test --show-dir`` (the JAX tool drawing the port's detections),
  ``show_bop_detbbox`` and ``browse_dataset --show-dist`` (a train pipeline
  without random transforms) write equal files; ``draw_sample`` equals the
  JAX tool's loop body in cv2, the port's own assignment included; and
  ``browse_dataset --show-assignment`` writes what its parts give.
"""

import importlib.util
import json
import os
import os.path as osp
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fixtures import make_synthetic_bop
from radet_tpu.apis import inference as jax_inference
from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.utils import visualization as jax_vis
from radet_tpu_torch.apis import inference as port_inference
from radet_tpu_torch.apis.common import anchor_cfg_from_model, build_dataset, build_model_and_anchors
from radet_tpu_torch.core.anchors import anchor_centers, generate_anchors
from radet_tpu_torch.engine.checkpoint import save_weights
from radet_tpu_torch.tools import browse_dataset, show_bop_detbbox
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils import raster, visualization
from radet_tpu_torch.utils.config import Config
from radet_tpu_torch.utils.image_write import encode_jpeg, imwrite
from radet_tpu_torch.utils.text_glyphs import GLYPHS
from synthetic_bop import JPEG_FIXTURES, write_bop_test_set
from torch_parity import FLAGSHIP, IMG_HW, NARROW
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CHARS = "".join(chr(c) for c in range(32, 127))
STYLES = sorted(GLYPHS)
NAMES = ["obj_000001", "a much longer class name", "c", "d"]
# origins on a 40 x 120 image: inside, and clipping at the left, right, top (as
# imshow's max(0, y1 - 4) does), and bottom edges
ORIGINS = [(3, 20), (-4, 25), (114, 30), (60, 0), (10, 4), (20, 44)]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", osp.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_tool(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    module.main()


# ------------------------------------------------------------------- text


@pytest.mark.parametrize("style", STYLES, ids=lambda s: f"scale{s[0]}-th{s[1]}")
def test_text_equals_cv2(style):
    """Every printable character alone at every origin of ``ORIGINS``, then
    strings, on noise in colour and in gray."""
    scale, thickness = style
    rng = np.random.RandomState(0)
    texts = list(CHARS) + [CHARS, "obj_000001|0.95", "".join(rng.choice(list(CHARS), 30))]
    for org in ORIGINS:
        for text in texts:
            shape = (40, 120, 3) if len(text) % 2 else (40, 120)
            want = rng.randint(0, 256, shape).astype(np.uint8)
            got = want.copy()
            color = tuple(int(v) for v in rng.randint(0, 256, 3))
            cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness)
            assert raster.put_text(got, text, org, raster.FONT_HERSHEY_SIMPLEX, scale, color, thickness) is got
            np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")


def test_text_refuses_what_it_does_not_draw():
    img = np.zeros((20, 40, 3), np.uint8)
    for kwargs in (dict(font_scale=0.6), dict(font_face=1), dict(text="é"), dict(text="a\nb"),
                   dict(thickness=3)):
        args = dict(text="ab", org=(2, 15), font_face=0, font_scale=0.5, color=(255, 0, 0), thickness=1)
        args.update(kwargs)
        with pytest.raises(NotImplementedError, match="item 15c"):
            raster.put_text(img, **args)
    with pytest.raises(TypeError, match="integer"):
        raster.put_text(img, "a", (2.5, 15), 0, 0.5, (255, 0, 0))
    assert not img.any()


# ------------------------------------------------------------------ shapes


@pytest.mark.parametrize("thickness", [0, 1, 2, 3, -1])
def test_rectangles_equal_cv2(thickness):
    """Boxes inside, across and outside a 23 x 31 image, degenerate ones,
    negative corners; cv2's thickness 0 draws as 1."""
    rng = np.random.RandomState(thickness + 10)
    for i in range(400):
        p = [int(v) for v in rng.randint(-12, 44, 4)]
        if i % 7 == 0:
            p[2] = p[0]
        want = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
        got = want.copy()
        cv2.rectangle(want, (p[0], p[1]), (p[2], p[3]), (10, 200, 90), thickness)
        raster.rectangle(got, (p[0], p[1]), (p[2], p[3]), (10, 200, 90), thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(p))


@pytest.mark.parametrize("thickness", [1, 2, 3, -1])
def test_circles_equal_cv2(thickness):
    """Radius 0-6 (and larger radii, where thicker circles take more
    polygon points), centres inside and outside."""
    rng = np.random.RandomState(5)
    for radius in list(range(7)) + [9, 14, 20]:
        for _ in range(40):
            c = tuple(int(v) for v in rng.randint(-8, 40, 2))
            want = rng.randint(0, 256, (23, 31)).astype(np.uint8)
            got = want.copy()
            cv2.circle(want, c, radius, 255, thickness)
            raster.circle(got, c, radius, 255, thickness)
            np.testing.assert_array_equal(got, want, err_msg=f"{c} r={radius}")


def test_fixed_point_lines_equal_cv2():
    """``cv2.line`` with 16 fraction bits: one pixel wide (the rounded
    8-connected line) and thick (the offset quad and round caps), clipped."""
    rng = np.random.RandomState(6)
    for i in range(600):
        p = [int(v) for v in rng.randint(-10 << 16, 40 << 16, 4)]
        thickness = 1 + i % 5
        want = np.zeros((23, 31, 3), np.uint8)
        got = want.copy()
        cv2.line(want, (p[0], p[1]), (p[2], p[3]), (255, 0, 0), thickness, cv2.LINE_8, 16)
        raster.line(got, (p[0], p[1]), (p[2], p[3]), (255, 0, 0), thickness, shift=16)
        np.testing.assert_array_equal(got, want, err_msg=f"{p} thickness {thickness}")


# ----------------------------------------------------- the JAX package's API

CASES = {
    "names": dict(class_names=NAMES, score_thr=0.0),
    "no-names": dict(class_names=None, score_thr=0.0),
    "no-scores": dict(class_names=NAMES, scores=None),
    "score-thr": dict(class_names=NAMES, score_thr=0.5),
    "labels-past-names": dict(class_names=NAMES[:2], score_thr=0.2),
}


def _detections(rng, n, h, w):
    boxes = np.stack([rng.uniform(-20, w, n), rng.uniform(-20, h, n),
                      rng.uniform(0, w + 20, n), rng.uniform(0, h + 20, n)], -1).astype(np.float32)
    return boxes, rng.randint(0, 8, n), rng.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_imshow_equals_jax(case, tmp_path):
    """``imshow_det_bboxes`` and ``imshow_gt_det_bboxes`` return what the
    JAX package's return, and write the same image."""
    rng = np.random.RandomState(len(case))
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes, labels, scores = _detections(rng, 25, 96, 128)
    kw = dict(CASES[case])
    scores = kw.pop("scores", scores)
    want = jax_vis.imshow_det_bboxes(img, boxes, labels, scores, out_file=str(tmp_path / "want.png"), **kw)
    got = visualization.imshow_det_bboxes(img, boxes, labels, scores, out_file=str(tmp_path / "got.png"), **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "got.png")), cv2.imread(str(tmp_path / "want.png")))
    gt = boxes[:4] - 3.5
    want = jax_vis.imshow_gt_det_bboxes(img, gt, labels[:4], boxes, labels, scores, kw["class_names"],
                                        kw.get("score_thr", 0.0), out_file=str(tmp_path / "want.jpg"))
    got = visualization.imshow_gt_det_bboxes(img, gt, labels[:4], boxes, labels, scores, kw["class_names"],
                                             kw.get("score_thr", 0.0), out_file=str(tmp_path / "got.jpg"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "got.jpg").read_bytes() == (tmp_path / "want.jpg").read_bytes()


@settings(max_examples=30, deadline=None)
@given(
    boxes=st.lists(st.tuples(*[st.floats(-50.0, 200.0, width=32)] * 4), max_size=12),
    labels=st.lists(st.integers(0, 40), min_size=12, max_size=12),
    with_scores=st.booleans(),
    score_thr=st.sampled_from([0.0, 0.3]),
)
def test_imshow_equals_jax_on_any_boxes(boxes, labels, with_scores, score_thr):
    img = np.random.RandomState(len(boxes)).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    labels = np.asarray(labels[:len(boxes)])
    scores = np.linspace(0, 1, len(boxes), dtype=np.float32) if with_scores else None
    want = jax_vis.imshow_det_bboxes(img, boxes, labels, scores, NAMES, score_thr)
    np.testing.assert_array_equal(visualization.imshow_det_bboxes(img, boxes, labels, scores, NAMES, score_thr),
                                  want)


def test_show_result_and_pyplot_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    boxes, labels, scores = _detections(rng, 8, 64, 96)
    result = dict(boxes=boxes, labels=labels, scores=scores)
    np.testing.assert_array_equal(port_inference.show_result(img, result, NAMES),
                                  jax_inference.show_result(img, result, NAMES))

    class Named:
        classes = tuple(NAMES)

    got = port_inference.show_result_pyplot(Named(), img, result, out_file=str(tmp_path / "p.png"))
    want = jax_inference.show_result_pyplot(Named(), img, result, out_file=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == img.shape and osp.getsize(tmp_path / "p.png") > 0


# ---------------------------------------------------------------- writers


def _jpeg_inputs():
    rng = np.random.RandomState(4)
    fixture = cv2.imread(osp.join(JPEG_FIXTURES, "ycbv_420.jpg"))
    return {
        "fixture-480x640": fixture,
        "noise-480x640": rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
        "odd-37x53": fixture[100:137, 200:253],
        "noise-odd-37x53": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
        "gray-480x640": cv2.cvtColor(fixture, cv2.COLOR_BGR2GRAY),
        "gray-odd-37x53": rng.randint(0, 256, (37, 53)).astype(np.uint8),
        "tiny-1x1": rng.randint(0, 256, (1, 1, 3)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", list(_jpeg_inputs()))
def test_jpeg_bytes_equal_cv2(name, tmp_path):
    img = _jpeg_inputs()[name]
    assert encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()
    for ext in (".jpg", ".JPEG"):
        assert imwrite(str(tmp_path / f"port{ext}"), img)
        cv2.imwrite(str(tmp_path / f"cv2{ext}"), img)
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"cv2{ext}").read_bytes()


def test_png_decodes_to_cv2_pixels_and_other_formats_raise(tmp_path):
    rng = np.random.RandomState(8)
    for shape in ((37, 53, 3), (37, 53), (20, 30, 4)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        imwrite(str(tmp_path / "port.png"), img)
        cv2.imwrite(str(tmp_path / "cv2.png"), img)
        for path in ("port.png", "cv2.png"):
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / path), cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(NotImplementedError, match="item 20b, TIFF writing"):
        imwrite(str(tmp_path / "x.tif"), img[..., :3])
    with pytest.raises(NotImplementedError, match="item 15c"):
        imwrite(str(tmp_path / "x.bmp"), img[..., :3])
    with pytest.raises(ValueError, match="uint8"):
        imwrite(str(tmp_path / "x.jpg"), img[..., :3].astype(np.float32))
    assert not osp.exists(tmp_path / "x.bmp") and not osp.exists(tmp_path / "x.jpg")


# ------------------------------------------------------------------ tools


@pytest.fixture(scope="module")
def test_set(tmp_path_factory):
    """A PNG BOP test split (2 images at the narrow input size, one larger)
    and weights whose scores clear the detector's threshold."""
    root = str(tmp_path_factory.mktemp("draw_test_set"))
    ann = write_bop_test_set(root, np.random.RandomState(3), [(2, IMG_HW), (1, (81, 108))], NAMES)
    opts = NARROW + ["data.samples_per_gpu=2"] + [f"data.test.{k}={v!r}" for k, v in (
        ("ann_file", ann), ("img_prefix", osp.join(root, "test") + "/"), ("classes", NAMES),
        ("pipeline.1.img_scale", IMG_HW[::-1]))]
    model = build_model_and_anchors(Config.fromfile(FLAGSHIP, opts))[0]
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()
    ckpt = osp.join(root, "w.pth")
    save_weights(ckpt, model.state_dict())
    return dict(root=root, opts=opts, ckpt=ckpt)


def test_show_dir_equals_the_jax_tool(test_set, tmp_path, monkeypatch):
    """``tools.test --show-dir`` against the JAX tool's ``--show-dir`` on the
    port's detections (the JAX tool's inference is replaced by them): equal
    PNG pixels, one file per image, named as the JAX tool names it."""
    opts, pkl = test_set["opts"], str(tmp_path / "r.pkl")
    test_cli.main([FLAGSHIP, test_set["ckpt"], "--device", "cpu", "--out", pkl, "--show-dir",
                   str(tmp_path / "port"), "--show-score-thr", "0.2", "--cfg-options", *opts])
    with open(pkl, "rb") as f:
        results = pickle.load(f)
    assert sum(int((r["scores"] >= 0.2).sum()) for r in results) > 0
    tool = _load_tool("test")
    monkeypatch.setattr(tool, "build_model_and_anchors", lambda cfg: (None,) * 4)
    monkeypatch.setattr(tool, "init_variables", lambda model, hw: None)
    monkeypatch.setattr(tool, "test_from_config", lambda cfg, variables, **kw: (
        jax_build_dataset(cfg, kw["split"]), results, None))
    _run_tool(monkeypatch, tool, [FLAGSHIP, "--show-dir", tmp_path / "jax", "--show-score-thr", "0.2",
                                  "--cfg-options", *opts])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == len(results) == 3
    assert all(n.startswith("00000") and n.endswith(".png") and "/" not in n for n in names)
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name)), want, err_msg=name)


def test_show_bop_detbbox_equals_the_jax_tool(test_set, tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(9)
    dets = [dict(scene_id=int(s), image_id=int(i), category_id=int(c), score=float(p),
                 bbox=[float(v) for v in rng.uniform(-10, 80, 4)], time=-1.0)
            for s, i, c, p in zip(rng.randint(0, 2, 40), rng.randint(0, 3, 40), rng.randint(1, 5, 40),
                                  rng.uniform(0, 1, 40))]
    results = tmp_path / "dets.bop.json"
    results.write_text(json.dumps(dets))
    args = [results, "--images-dir", osp.join(test_set["root"], "test"), "--score-thr", "0.2"]
    show_bop_detbbox.main([str(a) for a in args] + ["--output-dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    _run_tool(monkeypatch, _load_tool("show_bop_detbbox"), args + ["--output-dir", tmp_path / "jax"])
    jax_out = capsys.readouterr().out
    assert port_out.replace("/port/", "/") == jax_out.replace("/jax/", "/")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3  # scene 1 has one image
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.fixture(scope="module")
def train_config(tmp_path_factory):
    """The flagship at the narrow widths reading a synthetic train split
    through a pipeline without random transforms, so both packages'
    samples of an index are equal without seeding."""
    root = str(tmp_path_factory.mktemp("draw_train_set"))
    ann, prefix = make_synthetic_bop(root, images_per_scene=3, img_hw=IMG_HW, num_classes=4, max_objects=4, seed=2)
    pipeline = [dict(type="LoadImageFromFile"), dict(type="LoadAnnotations", with_bbox=True, with_bop_mask=True),
                dict(type="Resize", img_scale=IMG_HW[::-1], keep_ratio=True), dict(type="GenerateDistanceMap"),
                dict(type="SampleDistanceAtAnchors"), dict(type="Pad", size_divisor=16)]
    path = osp.join(root, "browse_config.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{FLAGSHIP!r}]\n"
                f"data = dict(train=dict(ann_file={ann!r}, img_prefix={prefix!r}, classes=None, "
                f"pipeline={pipeline!r}))\n")
    return path


def test_browse_dataset_equals_the_jax_tool(train_config, tmp_path, monkeypatch, capsys):
    args = [train_config, "--num", "3", "--show-dist", "--cfg-options", *NARROW]
    browse_dataset.main([str(a) for a in args] + ["--device", "cpu", "--output-dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    _run_tool(monkeypatch, _load_tool("browse_dataset"), args + ["--output-dir", tmp_path / "jax"])
    assert port_out.replace("/port/", "/") == capsys.readouterr().out.replace("/jax/", "/")
    for i in range(3):
        name = f"sample_{i:04d}.jpg"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def _jax_loop_body(s, centers, show_dist, assignment):
    """The body of ``tools/browse_dataset.py``'s loop, in cv2, on the port's
    (gt_idx, weight) in place of the JAX assignment's."""
    gt_colors = [(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64),
                 (255, 64, 255), (64, 255, 255), (255, 160, 64), (160, 64, 255)]
    img = cv2.cvtColor(s["image"], cv2.COLOR_RGB2BGR).copy()
    for box, label, valid in zip(s["gt_boxes"], s["gt_labels"], s["gt_valid"]):
        if not valid:
            continue
        x1, y1, x2, y2 = [int(v) for v in box]
        cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        cv2.putText(img, str(int(label)), (x1, max(0, y1 - 4)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    if show_dist and "dist_vals" in s:
        v = s["dist_vals"].max(axis=1)
        for (cx, cy), val in zip(centers, v):
            if val > 0:
                c = int(255 * min(1.0, val))
                cv2.circle(img, (int(cx), int(cy)), 1, (0, 0, c), -1)
    gt_idx, weight = assignment
    for (cx, cy), g, w in zip(centers, gt_idx, weight):
        if g >= 0:
            cv2.circle(img, (int(cx), int(cy)), max(1, int(round(w))), gt_colors[int(g) % len(gt_colors)], -1)
    n_pos, n_ign = int((gt_idx >= 0).sum()), int((gt_idx == -2).sum())
    cv2.putText(img, f"pos {n_pos} ign {n_ign}", (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1)
    return img


def test_show_assignment_draws_the_ports_assignment(train_config, tmp_path, capsys):
    """``draw_sample`` equals the JAX tool's loop body drawn by cv2 on one
    shared sample and the port's (gt_idx, weight); the CLI's JPEGs are that
    drawing of its samples and of ``assign_labels`` seeded by the index."""
    browse_dataset.main([train_config, "--num", "2", "--show-dist", "--show-assignment", "--device", "cpu",
                         "--output-dir", str(tmp_path), "--cfg-options", *NARROW])
    assert capsys.readouterr().out.split() == [str(tmp_path / f"sample_{i:04d}.jpg") for i in range(2)]
    cfg = Config.fromfile(train_config, NARROW)
    dataset = build_dataset(cfg, "train")
    la = cfg.label_assignment.to_dict()
    anchors, ranges, _, _ = generate_anchors(tuple(cfg.input_size), anchor_cfg_from_model(cfg.model.to_dict(), la))
    centers = anchor_centers(anchors)
    kw = {k: la[k] for k in browse_dataset.ASSIGN_KEYS if k in la}
    for i in range(2):
        s = dataset[i]
        assignment = browse_dataset.assign_sample(s, torch.as_tensor(anchors), torch.as_tensor(ranges), kw, seed=i)
        assert (assignment[0] >= 0).sum() > 0
        got = browse_dataset.draw_sample(s, centers, show_dist=True, assignment=assignment)
        np.testing.assert_array_equal(got, _jax_loop_body(s, centers, True, assignment))
        assert (tmp_path / f"sample_{i:04d}.jpg").read_bytes() == encode_jpeg(got)
