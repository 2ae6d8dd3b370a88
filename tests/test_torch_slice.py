"""The port's inference slice against the JAX package, float32 on the CPU.

``build_infer_step`` of both packages on the same uint8 batch and weights
(flagship config narrowed to 64x96, widths 64, 2 stacked convs, 4 classes),
the JAX side at ``approx_topk=False``: valid and labels equal, scores
within 1e-5, boxes within 1e-2 px.  ``nms_topk`` (1024) exceeds the
candidate pairs (129 anchors x 4 classes), so no near-tie at a top-k
boundary decides membership.  Then the user entry points and a run with
JAX made unimportable."""

import os
import os.path as osp
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.engine.train_step import build_infer_step as jax_build_infer_step
from radet_tpu.models.postprocess import get_bboxes as jax_get_bboxes
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch import inference_detector, init_detector
from radet_tpu_torch.apis.common import build_model_and_anchors
from radet_tpu_torch.engine.infer_step import build_infer_step
from radet_tpu_torch.models.postprocess import get_bboxes
from radet_tpu_torch.utils.config import Config
from synthetic_bop import write_png
from torch_parity import FLAGSHIP, IMG_HW, NARROW, flax_and_port_models

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

N_PAIRS = 129 * 4  # anchors at 64x96 (96 + 24 + 6 + 2 + 1) x classes


def _batch(n=2, seed=0):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (n, *IMG_HW, 3), dtype=np.uint8)
    # resized extents below the padded input and non-unit scales exercise
    # the border clamp and the rescale
    shapes = np.asarray([[60, 90], [64, 80]], np.float32)[:n]
    scales = np.asarray([[0.5, 0.6, 0.5, 0.6], [1.25, 1.25, 1.25, 1.25]], np.float32)[:n]
    return u8, shapes, scales


@pytest.fixture(scope="module")
def pair():
    jax_cfg = JaxConfig.fromfile(FLAGSHIP, NARROW)
    cfg = Config.fromfile(FLAGSHIP, NARROW)
    jax_model, anchors, _, counts = jax_build_model_and_anchors(jax_cfg)
    port, p_anchors, _, p_counts = build_model_and_anchors(cfg)
    np.testing.assert_array_equal(p_anchors, anchors)
    assert list(p_counts) == list(counts) and sum(counts) * 4 == N_PAIRS
    variables = flax_and_port_models(jax_model, port)
    return jax_cfg, jax_model, variables, port, anchors, counts


@pytest.mark.parametrize("candidate_mode,min_bbox_size", [("global", 0), ("per_level", 3.0)])
def test_infer_step_matches_jax(pair, candidate_mode, min_bbox_size):
    jax_cfg, jax_model, variables, port, anchors, counts = pair
    test_cfg = dict(
        jax_cfg.test_cfg.to_dict(), candidate_mode=candidate_mode, approx_topk=False,
        nms_topk=1024, min_bbox_size=min_bbox_size,
    )
    assert test_cfg["nms_topk"] > N_PAIRS
    img_norm = jax_cfg.img_norm_cfg.to_dict()
    u8, shapes, scales = _batch()
    ref = jax_build_infer_step(jax_model, anchors, counts, img_norm=img_norm, test_cfg=test_cfg)(
        variables, jnp.asarray(u8), jnp.asarray(shapes), jnp.asarray(scales)
    )
    det = build_infer_step(port, anchors, counts, img_norm=img_norm, test_cfg=test_cfg)(
        port, u8, shapes, scales
    )
    rb, rs, rl, rv = (np.asarray(x) for x in ref[:4])
    db, ds, dl, dv = (x.numpy() for x in det[:4])
    assert dv.sum() > 10  # the random head clears score_thr: NMS sees real clusters
    np.testing.assert_array_equal(dv, rv)
    np.testing.assert_array_equal(dl[dv], rl[rv])
    np.testing.assert_allclose(ds[dv], rs[rv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(db[dv], rb[rv], rtol=0, atol=1e-2)


def test_candidates_without_nms_match_jax(rng):
    """``with_nms=False``: the decoded candidate set and its anchors."""
    levels = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    c = 4
    maps = [[rng.randn(2, h, w, d).astype(np.float32) for h, w in levels] for d in (c, 4, 1)]
    maps[1] = [np.abs(m) for m in maps[1]]
    from radet_tpu_torch.core.anchors import generate_anchors

    anchors, _, _, counts = generate_anchors(IMG_HW)
    level_anchors = np.split(anchors, np.cumsum(counts)[:-1])
    _, shapes, scales = _batch()
    test_cfg = dict(score_thr=0.7, nms_topk=200, candidate_mode="global")
    ref = jax_get_bboxes(*maps, level_anchors, jnp.asarray(shapes), jnp.asarray(scales),
                         test_cfg=dict(test_cfg, approx_topk=False), with_nms=False)
    det = get_bboxes(*[[torch.from_numpy(m) for m in ms] for ms in maps],
                     [torch.from_numpy(a) for a in level_anchors], torch.from_numpy(shapes),
                     torch.from_numpy(scales), test_cfg=test_cfg, with_nms=False)
    rv, dv = np.asarray(ref.valid), det.valid.numpy()
    assert 0 < dv.sum() < dv.size
    np.testing.assert_array_equal(dv, rv)
    for a, b in ((det.boxes, ref.boxes), (det.scores, ref.scores), (det.anchors, ref.anchors)):
        np.testing.assert_allclose(a.numpy()[dv], np.asarray(b)[rv], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(det.labels.numpy()[dv], np.asarray(ref.labels)[rv])


@pytest.mark.parametrize("override", [{"nms_impl": "scan"},
                                      {"nms_impl": "scan", "nms": {"type": "global_vote", "iou_threshold": 0.65}}])
def test_unported_nms_variants_raise(override):
    maps = [[torch.zeros(1, 1, 1, d)] for d in (4, 4, 1)]
    test_cfg = {"nms": {"type": "vote", "iou_threshold": 0.65}, **override}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_bboxes(*maps, [torch.zeros(1, 4)], torch.ones(1, 2), torch.ones(1, 4), test_cfg=test_cfg)


CPU_OPTIONS = [o for o in NARROW if not o.startswith("compute_dtype")]


def test_init_and_inference_detector_on_cpu(tmp_path):
    det = init_detector(FLAGSHIP, cfg_options=CPU_OPTIONS, device="cpu", seed=0)
    assert det.model.dtype == torch.float32  # the config's bf16 applies on the card only
    assert det.classes[0] == "master_chef_can"
    with torch.no_grad():
        det.model.bbox_head.atss_cls.bias.zero_()
    u8, _, _ = _batch()
    out = inference_detector(det, list(u8))
    assert len(out) == 2
    for r in out:
        n = len(r["boxes"])
        assert 0 < n <= 100 and r["boxes"].shape == (n, 4)
        assert np.isfinite(r["boxes"]).all() and np.all(np.diff(r["scores"]) <= 0)
        assert ((r["labels"] >= 0) & (r["labels"] < 4)).all()
    single = inference_detector(det, u8[1])  # batch 1: other conv blocking
    np.testing.assert_array_equal(single["labels"], out[1]["labels"])
    np.testing.assert_allclose(single["scores"], out[1]["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(single["boxes"], out[1]["boxes"], rtol=0, atol=1e-2)
    # a file of another size: read, resized into the input size and padded;
    # boxes come back in the file's coordinates
    big = np.ascontiguousarray(np.repeat(np.repeat(u8[0], 2, axis=0), 2, axis=1))
    path = osp.join(str(tmp_path), "big.png")
    write_png(path, big)
    from_file = inference_detector(det, path)
    from_array = inference_detector(det, big)
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(from_file[k], from_array[k], err_msg=k)
    assert len(from_file["boxes"]) and from_file["boxes"][:, 2:].max() > IMG_HW[1] + 1
    with pytest.raises(FileNotFoundError):
        inference_detector(det, osp.join(str(tmp_path), "missing.png"))
    with pytest.raises(ValueError, match="uint8"):
        inference_detector(det, np.zeros((32, 48, 3), np.float32))


TRAINED_CLASSES = ("obj_a", "obj_b", "obj_c", "obj_d")
CHECKPOINT_FORMS = {  # init_detector's argument, under the fixture's directory
    "manager_root": "work_dir/checkpoints",
    "step_dir": "work_dir/checkpoints/3",
    "work_dir": "work_dir",
    "full_checkpoint_file": "work_dir/checkpoints/3/checkpoint.pth",
    "save_weights_file": "weights.pth",
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """What the port's trainer writes: a work dir whose ``checkpoints`` hold
    full checkpoints of steps 2 and 3 and ``meta.json`` with the class
    names, and a ``save_weights`` file of step 3's weights.  Returns (the
    directory, step 3's state dict)."""
    from radet_tpu_torch.engine import CheckpointManager, TrainState, build_optimizer, save_weights
    from radet_tpu_torch.engine.checkpoint import write_meta

    tmp = tmp_path_factory.mktemp("trained")
    model = build_model_and_anchors(Config.fromfile(FLAGSHIP, CPU_OPTIONS), dtype="float32")[0]
    model.init_weights(torch.Generator().manual_seed(3))
    tx, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, model)
    manager = CheckpointManager(str(tmp / "work_dir" / "checkpoints"))
    write_meta(manager.directory, dict(classes=list(TRAINED_CLASSES)))
    state = TrainState(model, tx, step=2)
    manager.save(2, state, force=True)
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.add_(1.0)  # step 3's weights differ from step 2's
    state.step = 3
    manager.save(3, state, force=True)
    save_weights(str(tmp / "weights.pth"), model.state_dict(), meta=dict(CLASSES=list(TRAINED_CLASSES)))
    return tmp, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("form", sorted(CHECKPOINT_FORMS))
def test_init_detector_loads_what_the_trainer_writes(trained, form):
    """Each form the trainer leaves loads step 3's weights (the latest) with
    the trained class names when the config names none; the config's
    ``data.test.classes`` come first.  ``init_detector`` used to
    ``torch.load`` the path as a file of ``{"state_dict"}`` or a bare state
    dict: a directory raised IsADirectoryError, a full checkpoint failed
    the strict load, and ``meta.json`` was never read."""
    tmp, want = trained
    path = str(tmp / CHECKPOINT_FORMS[form])
    det = init_detector(FLAGSHIP, path, cfg_options=CPU_OPTIONS + ["data.test.classes=None"], device="cpu")
    assert det.classes == TRAINED_CLASSES
    got = det.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert init_detector(FLAGSHIP, path, cfg_options=CPU_OPTIONS, device="cpu").classes[0] == "master_chef_can"


def test_init_detector_never_swaps_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_detector(FLAGSHIP, cfg_options=CPU_OPTIONS)


def test_port_runs_with_jax_unimportable():
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "radet_tpu"):
    sys.modules[name] = None
import numpy as np
import radet_tpu_torch
for mod in pkgutil.walk_packages(radet_tpu_torch.__path__, "radet_tpu_torch."):
    importlib.import_module(mod.name)
from radet_tpu_torch.apis.serving import BatchingDetector
from radet_tpu_torch.tools.serve import make_handler
det = radet_tpu_torch.init_detector({FLAGSHIP!r}, cfg_options={CPU_OPTIONS!r}, device="cpu")
out = radet_tpu_torch.inference_detector(det, np.zeros(({IMG_HW[0]}, {IMG_HW[1]}, 3), np.uint8))
with BatchingDetector(det, batch_size=2) as srv:
    served = srv.detect(np.zeros(({IMG_HW[0]}, {IMG_HW[1]}, 3), np.uint8), timeout=60)
assert sorted(served) == sorted(out) and make_handler(srv)
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "flax", "radet_tpu")]
assert not loaded, loaded
print("ran", sorted(out))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ran ['boxes', 'labels', 'scores']" in proc.stdout
