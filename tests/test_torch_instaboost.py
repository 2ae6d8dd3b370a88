"""The port's Telea inpainting, InstaBoost and the whole augmented train
pipeline against cv2 5.0.0 and the JAX package on the CPU.

- ``inpaint.inpaint_telea`` (C++) against ``cv2.inpaint(..., 3,
  INPAINT_TELEA)`` on the JPEG fixtures with the holes InstaBoost makes
  (the union of instances' masks, dilated 3x3), and on smaller images with
  holes at the borders and radii 1 to 5; its numpy twin on the small ones:
  byte-equal, inside the hole too;
- ``InstaBoost`` against the JAX package's, ``random`` and ``np.random``
  seeded alike, over 10 seeds per configuration (one 480x640 fixture, the
  rest 60x80 to 120x160): ``img``, ``gt_bboxes``, ``gt_labels`` and
  ``gt_masks`` byte-equal; the same errors;
- the flagship's train pipeline with the AutoAugment family, InstaBoost,
  ``RandomHSV``, ``RandomNoise`` and ``RandomSmooth``
  (``synthetic_bop.augmented_pipeline``, the card smoke's) through
  ``build_dataset`` against JAX's: every array of the pipeline's results
  (``distance_maps`` and ``dist_vals`` included) and every packed sample
  byte-equal, and the same samples from the loader's process workers;
- a subprocess that imports the new modules and runs each new transform
  with cv2, PIL, jax and radet_tpu unimportable.
"""

import copy
import os
import os.path as osp
import pickle
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest

from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_dataset
from radet_tpu_torch.data import inpaint
from radet_tpu_torch.data.pipeline import build_pipeline
from radet_tpu_torch.utils.config import Config
from aug_parity import assert_same, aug_results, fixture_image
from fixtures import make_synthetic_bop
from synthetic_bop import jpeg_fixtures, write_png, write_train_config
from torch_parity import FLAGSHIP, NARROW
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SEEDS = range(10)
HW = (64, 128)  # the augmented split's images


def _hole(masks: np.ndarray) -> np.ndarray:
    return cv2.dilate(masks.any(0).astype(np.uint8), np.ones((3, 3), np.uint8))


def test_inpaint_telea_matches_cv2():
    jpegs, records = jpeg_fixtures()
    for i, rec in enumerate(records):  # the 480x640 fixtures, InstaBoost's holes
        img = fixture_image(i)
        for hole in (_hole(rec["gt_masks"][:2]), _hole(rec["gt_masks"])):
            want = cv2.inpaint(img, hole, 3, cv2.INPAINT_TELEA)
            np.testing.assert_array_equal(inpaint.inpaint_telea(img, hole, 3), want, err_msg=f"fixture {i}")
    rng = np.random.RandomState(11)
    for t in range(12):
        if t % 3 == 0:
            img = np.ascontiguousarray(fixture_image(t % 3)[rng.randint(0, 380):][:, rng.randint(0, 520):][:60, :80])
        elif t % 3 == 1:
            img = rng.randint(0, 256, (rng.randint(5, 50), rng.randint(5, 70), 3)).astype(np.uint8)
        else:
            img = cv2.GaussianBlur(rng.randint(0, 256, (rng.randint(20, 50), rng.randint(20, 70), 3)).astype(np.uint8),
                                   (0, 0), 2)
        h, w = img.shape[:2]
        hole = cv2.dilate((rng.rand(h, w) < rng.uniform(0.002, 0.03)).astype(np.uint8),
                          np.ones((rng.randint(1, 7), rng.randint(1, 7)), np.uint8))
        if t % 4 == 0:
            hole[:, :3] = 1  # a hole on the border
        radius = [3, 3, 1, 2, 5][t % 5]
        want = cv2.inpaint(img, hole, radius, cv2.INPAINT_TELEA)
        what = f"case {t}, {img.shape}, radius {radius}"
        np.testing.assert_array_equal(inpaint.inpaint_telea(img, hole, radius), want, err_msg=what)
        np.testing.assert_array_equal(inpaint.inpaint_telea_plain(img, hole, radius), want, err_msg=what)
    with pytest.raises(ValueError):
        inpaint.inpaint_telea(img[..., 0], hole)


CONFIGS = [
    dict(aug_ratio=1.0),
    dict(action_prob=(1, 1, 1), aug_ratio=1.0, color_prob=1.0),
    dict(action_prob=(0, 1, 0), aug_ratio=0.7, scale=(0.5, 1.5), theta=(-30, 30), dx=4, dy=4),
    dict(action_candidate=("skip", "normal"), action_prob=(3, 1), aug_ratio=1.0, color_prob=0.0),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_instaboost_matches_jax(kw):
    port = pickle.loads(pickle.dumps(build_pipeline([dict(type="InstaBoost", **kw)])))  # as a process worker's
    ref = jax_pipeline.build_pipeline([dict(type="InstaBoost", **kw)])
    changed = 0
    for seed in SEEDS:
        results = aug_results(seed)
        random.seed(seed)
        np.random.seed(seed)
        want = ref(copy.deepcopy(results))
        random.seed(seed)
        np.random.seed(seed)
        got = port(copy.deepcopy(results))
        assert_same(got, want, f"InstaBoost {kw} seed {seed}")
        changed += not np.array_equal(got["img"], results["img"])
    assert changed >= 3


def test_seeded_transforms_ignore_the_global_generators():
    """With ``seed`` the AutoAugment family and InstaBoost draw from
    generators of their own: the global ones, reseeded, change nothing,
    and a pickled copy (a process worker's) draws the same."""
    policies = [[dict(type="Rotate", level=8, prob=0.7, seed=2)], [dict(type="Shear", level=5, prob=0.7, seed=3)]]
    for cfg in (dict(type="InstaBoost", aug_ratio=0.7, action_prob=(1, 1, 0), seed=4),
                dict(type="AutoAugment", policies=policies, seed=5),
                dict(type="Translate", level=5, prob=0.6, seed=6), dict(type="ContrastTransform", level=3, seed=7),
                dict(type="EqualizeTransform", prob=0.5, seed=8)):
        t = build_pipeline([cfg])
        twin = pickle.loads(pickle.dumps(t))
        outs = []
        for i in range(6):
            random.seed(i)
            np.random.seed(i)
            got = t(aug_results(1 + i % 3))
            random.seed(100 + i)
            np.random.seed(100 + i)
            want = twin(aug_results(1 + i % 3))
            assert_same(got, want, f"{cfg['type']} call {i}")
            outs.append(got["img"])
        assert any(not np.array_equal(o, aug_results(1 + i % 3)["img"]) for i, o in enumerate(outs)), cfg["type"]


BAD = [dict(hflag=True), dict(action_candidate=("normal", "jump"), action_prob=(1, 1)),
       dict(action_prob=(1, 0)), dict(dx=0), dict(action_prob=(0, 0, 0))]


def test_instaboost_errors_match_jax():
    for kw in BAD:
        with pytest.raises(ValueError) as want:
            jax_pipeline.build_pipeline([dict(type="InstaBoost", **kw)])
        with pytest.raises(ValueError) as got:
            build_pipeline([dict(type="InstaBoost", **kw)])
        assert str(got.value) == str(want.value)
    for build in (build_pipeline, jax_pipeline.build_pipeline):
        with pytest.raises(KeyError, match="per-instance masks"):
            build([dict(type="InstaBoost")])(dict(img=np.zeros((4, 4, 3), np.uint8)))


@pytest.fixture(scope="module")
def augmented_config(tmp_path_factory):
    """The flagship training from a small synthetic split through
    ``augmented_pipeline`` (backgrounds in JPEG and PNG)."""
    root = str(tmp_path_factory.mktemp("bop_aug"))
    ann, prefix = make_synthetic_bop(root, num_scenes=1, images_per_scene=6, img_hw=HW, num_classes=4,
                                     max_objects=4, seed=3)
    backgrounds = osp.join(root, "backgrounds")
    os.makedirs(backgrounds)
    rng = np.random.RandomState(2)
    cv2.imwrite(osp.join(backgrounds, "bg0.jpg"), rng.randint(0, 256, (80, 160, 3), np.uint8))
    write_png(osp.join(backgrounds, "bg1.png"), rng.randint(0, 256, HW + (3,), np.uint8))
    return write_train_config(osp.join(root, "aug_config.py"), FLAGSHIP, ann, prefix, backgrounds, augmented=True)


OPTS = NARROW + [f"input_size={HW}", "data.samples_per_gpu=2", "data.train.classes=None",
                 f"data.train.pipeline.3.img_scale={HW[::-1]}"]  # Resize, after InstaBoost


def test_augmented_pipeline_matches_jax(augmented_config):
    """Each index through both packages' ``build_dataset``, both sides
    seeded alike: the pipeline's results and the packed samples."""
    ref_ds = jax_build_dataset(JaxConfig.fromfile(augmented_config, OPTS), "train", test_mode=False)
    port_ds = build_dataset(Config.fromfile(augmented_config, OPTS), "train")
    names = [type(t).__name__ for t in port_ds.pipeline.transforms]
    assert names == [type(t).__name__ for t in ref_ds.pipeline.transforms] == [
        "LoadImageFromFile", "LoadAnnotations", "InstaBoost", "Resize", "AutoAugment", "RandomHSV", "RandomNoise",
        "RandomSmooth", "RandomBackground", "CosyPoseAug", "RandomFlip", "GenerateDistanceMap",
        "SampleDistanceAtAnchors", "Pad"]
    fired = {2: 0, 4: 0}  # InstaBoost's and AutoAugment's changed images

    def spy(i):
        t = port_ds.pipeline.transforms[i]

        def run(results):
            before = results["img"].copy()
            results = t(results)
            fired[i] += not np.array_equal(results["img"], before)
            return results
        return run

    for i in fired:
        port_ds.pipeline.transforms[i] = spy(i)
    for rep in range(3):
        for idx in range(len(port_ds)):
            seed = 1000 + 10 * rep + idx
            outs = []
            for ds, base in ((ref_ds, ref_ds._base_results), (port_ds, None)):
                np.random.seed(seed)
                random.seed(seed)
                if base is not None:
                    outs.append(ds.pipeline(base(idx)))
                else:
                    info = ds.data_infos[idx]
                    outs.append(ds.pipeline(dict(img_info=info, ann_info=ds.parse_ann_info(info),
                                                 img_prefix=ds.img_prefix, seg_prefix=ds.seg_prefix)))
            want, got = outs
            arrays = [k for k, v in want.items() if isinstance(v, np.ndarray) and k not in ("ann_info",)]
            assert {"img", "gt_bboxes", "gt_masks", "distance_maps", "dist_vals"} <= set(arrays)
            assert_same({k: got[k] for k in arrays}, {k: want[k] for k in arrays}, f"index {idx}, pass {rep}")
            samples = []
            for ds in (ref_ds, port_ds):
                np.random.seed(seed)
                random.seed(seed)
                samples.append(ds[idx])
            assert_same(samples[1], samples[0], f"sample {idx}, pass {rep}")
    assert min(fired.values()) >= 3, fired


def test_augmented_samples_from_process_workers(augmented_config):
    """The loader's process workers (the dataset pickled, both generators
    seeded per task) give the samples drawn here under the same task seeds."""
    from radet_tpu_torch.data import DataLoader
    from radet_tpu_torch.data.loader import _task_seed

    ds = build_dataset(Config.fromfile(augmented_config, OPTS), "train")
    loader = DataLoader(ds, batch_size=3, shuffle=False, num_workers=2, seed=5, worker_mode="process")
    it = iter(loader)
    batch = next(it)
    it.close()
    for j in range(3):
        np.random.seed(_task_seed(5, 0, j))
        random.seed(_task_seed(5, 0, j))
        assert_same({k: v[j] for k, v in batch.items()}, ds[j], f"process worker, index {j}")


NO_CV2 = r"""
import sys
for name in ("cv2", "PIL", "jax", "radet_tpu"):
    sys.modules[name] = None
import numpy as np
from radet_tpu_torch.data import auto_augment, color_aug, inpaint, instaboost, pipeline, warp
from synthetic_bop import AFTER_LOAD, AFTER_RESIZE, AUG_POLICIES, synthetic_bop_records
rec = synthetic_bop_records(np.random.RandomState(0), 1, (60, 80), num_classes=5, max_objects=4)[0]
types = set()
steps = [dict(t, **({"aug_ratio": 1.0} if t["type"] == "InstaBoost" else {})) for t in AFTER_LOAD + AFTER_RESIZE]
steps += [dict(a, prob=1.0) for policy in AUG_POLICIES for a in policy]
for t in steps:
    results = dict(img=rec["img"].copy(), img_shape=(60, 80), gt_bboxes=rec["gt_bboxes"].copy(),
                   gt_labels=rec["gt_labels"].copy(), gt_masks=rec["gt_masks"].copy())
    out = pipeline.build_pipeline([t])(results)
    assert out["img"].shape == (60, 80, 3) and out["img"].dtype == np.uint8
    types.add(t["type"])
for name in ("cv2", "PIL", "jax", "radet_tpu"):
    assert sys.modules[name] is None
print(sorted(types))
"""


def test_new_modules_run_without_cv2_pil_or_jax():
    env = one_thread_env(PYTHONPATH=os.pathsep.join([REPO, osp.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", NO_CV2], capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == str(sorted([
        "AutoAugment", "BrightnessTransform", "ColorTransform", "ContrastTransform", "EqualizeTransform", "InstaBoost",
        "RandomHSV", "RandomNoise", "RandomSmooth", "Rotate", "Shear", "Translate"]))
