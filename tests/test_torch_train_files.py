"""Training from files with the port against the JAX package on the CPU: the
default ``BOPDataset`` trains and filters as the reference's does, train
samples read from JPEG files and BOP masks (per-instance ``mask_visib`` PNGs
or ``tools/pack_masks.py``'s packed id maps) through the flagship's own
``train_pipeline`` (``RandomBackground`` and ``CosyPoseAug`` included) equal
the JAX package's key for key, degenerate samples are redrawn alike, and
``python -m radet_tpu_torch.tools.train`` trains the flagship from such a
set, writes a checkpoint that loads, and fine-tunes from it with the mixpbr
config's ``MixDataset`` of ``train_pbr`` and ``train_real``."""

import importlib.util
import json
import os
import os.path as osp
import random
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.data import BOPDataset as JaxBOPDataset
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu.data.loader import collate as jax_collate
from radet_tpu_torch.apis.common import build_dataset
from radet_tpu_torch.data import BOPDataset, collate
from radet_tpu_torch.data.color_aug import CosyPoseAug
from radet_tpu_torch.data.pipeline import LoadAnnotations, RandomBackground, RandomFlip, build_pipeline
from radet_tpu_torch.engine.checkpoint import load_weights
from radet_tpu_torch.tools import train as train_cli
from radet_tpu_torch.utils.config import Config
from fixtures import make_synthetic_bop
from synthetic_bop import write_png, write_train_config
from torch_parity import FLAGSHIP, NARROW
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MIXPBR = osp.join(REPO, "configs", "bop", "r50_ycbv_mixpbr.py")
HW = (64, 128)  # a width whose rows cv2's resize finishes without a scalar tail
_spec = importlib.util.spec_from_file_location("pack_masks", osp.join(REPO, "tools", "pack_masks.py"))
pack_masks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pack_masks)

# the flagship at narrow widths reading HW images unresized, backgrounds at prob 1
OPTS = NARROW + [f"input_size={HW}", "data.samples_per_gpu=2", "data.train.classes=None",
                 f"data.train.pipeline.2.img_scale={HW[::-1]}", "data.train.pipeline.3.prob=1.0"]


def _edit_annotations(ann_file):
    """Image 2's objects all below min_visib_frac (no trainable GT), one
    object of another image an ignore region, and an image without
    annotations."""
    with open(ann_file) as f:
        coco = json.load(f)
    per_image = {}
    for ann in coco["annotations"]:
        per_image.setdefault(ann["image_id"], []).append(ann)
    crowded = next(i for i, anns in per_image.items() if i != 2 and len(anns) > 1)
    for ann in per_image[2] + per_image[crowded][:1]:
        ann["visib_fract"] = 0.05
    last = coco["images"][-1]["id"]
    coco["annotations"] = [a for a in coco["annotations"] if a["image_id"] != last]
    with open(ann_file, "w") as f:
        json.dump(coco, f)


@pytest.fixture(scope="module")
def train_sets(tmp_path_factory):
    """{'mask_visib': config path, 'mask_packed': config path, 'mix':
    config path}: one synthetic BOP train split of JPEG images, the second
    copy with packed id maps, and (for the mixpbr config) a ``train_real``
    split of 3 images beside the first; all read backgrounds from one
    directory (JPEG and PNG, other sizes)."""
    root = str(tmp_path_factory.mktemp("bop_train"))
    ann, prefix = make_synthetic_bop(root, num_scenes=2, images_per_scene=4, img_hw=HW, num_classes=4,
                                     max_objects=4, seed=1)
    _edit_annotations(ann)
    packed = root + "_packed"
    shutil.copytree(root, packed)
    assert pack_masks.pack_split(osp.join(packed, "train_pbr"), verbose=False) >= 0
    backgrounds = osp.join(root, "backgrounds")
    os.makedirs(backgrounds)
    rng = np.random.RandomState(2)
    for i, (h, w) in enumerate([(80, 160), (32, 64)]):
        cv2.imwrite(osp.join(backgrounds, f"bg{i}.jpg"), rng.randint(0, 256, (h, w, 3), np.uint8))
    write_png(osp.join(backgrounds, "bg2.png"), rng.randint(0, 256, (96, 192, 3), np.uint8))
    configs = {}
    for name, base in (("mask_visib", root), ("mask_packed", packed)):
        configs[name] = write_train_config(
            osp.join(base, "train_config.py"), FLAGSHIP, osp.join(base, "detector_annotations", "train_pbr.json"),
            osp.join(base, "train_pbr") + "/", backgrounds)
    real = make_synthetic_bop(root, images_per_scene=3, img_hw=HW, num_classes=4, max_objects=4, seed=5,
                              split="train_real")
    configs["mix"] = write_train_config(
        osp.join(root, "mix_config.py"), MIXPBR, osp.join(root, "detector_annotations", "train_pbr.json"),
        osp.join(root, "train_pbr") + "/", backgrounds, real=real)
    return configs


def test_default_bop_dataset_trains_and_filters_as_the_reference(train_sets):
    """The Queue 3 fault: without ``test_mode`` both packages build a
    training set that drops the images without trainable GT."""
    cfg = Config.fromfile(train_sets["mask_visib"], OPTS)
    kw = dict(ann_file=cfg.data.train.ann_file, img_prefix=cfg.data.train.img_prefix, min_visib_frac=0.1)
    ref, port = JaxBOPDataset(**kw), BOPDataset(**kw)
    with open(kw["ann_file"]) as f:
        coco = json.load(f)
    trainable = {a["image_id"] for a in coco["annotations"] if a["visib_fract"] >= 0.1}
    n_images = len(coco["images"])
    assert not port.test_mode and not ref.test_mode
    assert len(port) == len(ref) == len(trainable) == n_images - 2  # image 2, the one without annotations
    assert port.img_ids == ref.img_ids == sorted(trainable)
    tests = [cls(test_mode=True, **kw) for cls in (JaxBOPDataset, BOPDataset)]
    unfiltered = [cls(filter_empty_gt=False, **kw) for cls in (JaxBOPDataset, BOPDataset)]
    assert len(tests[0]) == len(tests[1]) == len(unfiltered[0]) == len(unfiltered[1]) == n_images


def _assert_samples_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("masks", ["mask_visib", "mask_packed"])
def test_train_samples_from_files_match_jax(train_sets, masks):
    """Every index of ``build_dataset(cfg, 'train')`` in both packages, each
    side seeded alike (``np.random.seed``, ``random.seed``) before it: equal
    samples, key for key, and equal padded batches of them.  The pipeline
    is the flagship's own: ``RandomBackground`` runs at prob 1 and resizes
    backgrounds of other sizes (at this width cv2's resize has no scalar
    tail, so no byte of the image differs), and ``CosyPoseAug`` blurs and
    enhances at the flagship's probabilities and intervals."""
    path = train_sets[masks]
    ref_ds = jax_build_dataset(JaxConfig.fromfile(path, OPTS), "train", test_mode=False)
    port_ds = build_dataset(Config.fromfile(path, OPTS), "train")
    assert [type(t).__name__ for t in port_ds.pipeline.transforms] == [
        type(t).__name__ for t in ref_ds.pipeline.transforms] == [
        "LoadImageFromFile", "LoadAnnotations", "Resize", "RandomBackground", "CosyPoseAug", "RandomFlip",
        "GenerateDistanceMap", "SampleDistanceAtAnchors", "Pad"]
    assert len(port_ds) == len(ref_ds) == 6
    cosy = port_ds.pipeline.transforms[4]
    applied = []

    def spy(results):
        before = results["img"]
        results = cosy(results)
        applied.append(results["img"] is not before)
        return results

    port_ds.pipeline.transforms[4] = spy
    batches = ([], [])
    for rep in range(2):
        for idx in range(len(port_ds)):
            samples = []
            for ds in (ref_ds, port_ds):
                np.random.seed(100 + 10 * rep + idx)
                random.seed(100 + 10 * rep + idx)
                samples.append(ds[idx])
            _assert_samples_equal(samples[1], samples[0], f"{masks} index {idx}, pass {rep}")
            assert samples[1]["dist_vals"].any() and samples[1]["gt_valid"].any()
            batches[0].append(samples[0])
            batches[1].append(samples[1])
    _assert_samples_equal(collate(batches[1]), jax_collate(batches[0]), f"{masks} batch")
    assert any(applied) and not all(applied)
    assert port_ds.pipeline.transforms[3]._cache  # backgrounds (none at HW) were resized and composited


def test_process_workers_draw_as_seeded_in_process(train_sets):
    """The loader's process workers (the dataset pickled, Python's and
    numpy's generators seeded per task): each sample equals the one drawn
    in this process under the same task seed."""
    from radet_tpu_torch.data import DataLoader
    from radet_tpu_torch.data.loader import _task_seed

    ds = build_dataset(Config.fromfile(train_sets["mask_visib"], OPTS), "train")
    loader = DataLoader(ds, batch_size=3, shuffle=False, num_workers=2, seed=5, worker_mode="process")
    it = iter(loader)
    batch = next(it)
    it.close()  # stops the producer, which shuts the worker processes down
    for j in range(3):
        np.random.seed(_task_seed(5, 0, j))
        random.seed(_task_seed(5, 0, j))
        want = ds[j]
        _assert_samples_equal({k: v[j] for k, v in batch.items()}, want, f"process worker, index {j}")


def test_load_annotations_matches_jax_on_packed_and_per_instance_masks(train_sets):
    """The packed id map is read only where its file exists; both sources
    give the JAX package's masks, and so do polygon ``segmentations``,
    which take precedence over both."""
    port_ds = build_dataset(Config.fromfile(train_sets["mask_packed"], OPTS), "train")
    for idx in range(len(port_ds)):
        info = port_ds.data_infos[idx]
        ann = port_ds.parse_ann_info(info)
        base = dict(img_info=info, ann_info=ann, seg_prefix=port_ds.seg_prefix)
        for ann_variant in (ann, dict(ann, mask_packed="missing.png")):
            want = jax_pipeline.LoadAnnotations(with_bop_mask=True)(dict(base, ann_info=ann_variant))
            got = LoadAnnotations(with_bop_mask=True)(dict(base, ann_info=ann_variant))
            for k in ("gt_bboxes", "gt_labels", "gt_masks"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    shapes = [[[0, 0, 5, 0, 5, 5]], [[10, 2, 40, 9.5, 30.5, 60, -4, 33], [1, 1]], [], [[3, 3, 90, 3, 3, 90]]]
    polys = dict(ann, segmentations=[shapes[i % len(shapes)] for i in range(len(ann["masks"]))])
    want = jax_pipeline.LoadAnnotations(with_bop_mask=True)(dict(base, ann_info=polys))["gt_masks"]
    got = LoadAnnotations(with_bop_mask=True)(dict(base, ann_info=polys))["gt_masks"]
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(ann["masks"]),) + HW and got[0].sum() == 21


def test_degenerate_sample_is_redrawn_as_in_jax(train_sets):
    """Without the GT filter, the image without annotations packs to no
    sample; both packages redraw from ``RandomState(idx)`` and give the
    same other image."""
    cfg = Config.fromfile(train_sets["mask_visib"], OPTS)
    kw = dict(ann_file=cfg.data.train.ann_file, img_prefix=cfg.data.train.img_prefix, min_visib_frac=0.1,
              filter_empty_gt=False, input_size=HW,
              pipeline=[t for t in cfg.data.train.to_dict()["pipeline"] if t["type"] != "RandomBackground"])
    ref, port = JaxBOPDataset(**kw), BOPDataset(**kw)
    empty = len(port) - 1
    assert port.prepare_sample(empty) is None and ref.prepare_sample(empty) is None
    samples = []
    for ds in (ref, port):
        np.random.seed(0)
        random.seed(0)
        samples.append(ds[empty])
    _assert_samples_equal(samples[1], samples[0], "redrawn")
    assert samples[1]["img_id"] != port.img_ids[empty]


def test_random_draws_and_pipeline_entries(tmp_path):
    """``RandomFlip`` and ``RandomBackground`` draw as the JAX package's
    (Python's ``random``), a seed gives them their own generator, an empty
    background directory raises, ``CosyPoseAug`` builds (a pickled copy
    draws from its own seeded generator alike) and its ops as pipeline
    entries of their own raise ``KeyError``, as in the JAX package."""
    import pickle

    random.seed(3)
    ref = [random.random() < 0.5 for _ in range(8)]
    img = np.arange(6, dtype=np.uint8).reshape(1, 2, 3)

    def flips(t):
        return [bool(t(dict(img=img.copy()))["img"][0, 0, 0] != img[0, 0, 0]) for _ in range(8)]

    random.seed(3)
    assert flips(pickle.loads(pickle.dumps(RandomFlip(0.5)))) == ref
    random.seed(99)  # a seeded transform ignores the global generator
    assert flips(pickle.loads(pickle.dumps(RandomFlip(0.5, seed=3)))) == ref and any(ref) and not all(ref)
    with pytest.raises(RuntimeError, match="No background images"):
        RandomBackground(str(tmp_path))
    pipe = build_pipeline([dict(type="CosyPoseAug", p=0.8, pipelines=[dict(type="PillowBlur", p=1.0)])])
    assert [type(t) for t in pipe.transforms] == [CosyPoseAug] and len(pipe.transforms[0].ops) == 1
    chain = CosyPoseAug(p=0.5, pipelines=[dict(type="PillowBrightness", p=0.5)], seed=3)
    copy = pickle.loads(pickle.dumps(chain))
    noise = np.random.RandomState(0).randint(0, 256, (8, 8, 3), np.uint8)
    for _ in range(8):
        np.testing.assert_array_equal(copy(dict(img=noise))["img"], chain(dict(img=noise))["img"])
    for t_type in ("PillowBlur", "PillowColor"):
        with pytest.raises(KeyError):
            jax_pipeline.build_pipeline([dict(type=t_type)])
        with pytest.raises(KeyError, match="unknown transform"):
            build_pipeline([dict(type=t_type)])
    hsv = dict(type="RandomHSV", h_ratio=0.1, s_ratio=0.1, v_ratio=0.1)
    results = dict(img=np.random.RandomState(1).randint(0, 256, (8, 40, 3)).astype(np.uint8))
    outs = []
    for build in (build_pipeline, jax_pipeline.build_pipeline):
        random.seed(3)
        outs.append(build([hsv])(dict(results))["img"])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], results["img"])


def test_background_cache_under_loader_threads(tmp_path):
    """Sixteen threads sharing one ``RandomBackground`` (the loader's thread
    workers) with a 2-entry cache over 5 backgrounds and a short switch
    interval: every call gives its file's resized image, the cache never
    exceeds its size, and a pickled copy (a process worker's) starts empty
    and works."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from radet_tpu_torch.data.pipeline import resize_linear

    rng = np.random.RandomState(4)
    images = {}
    for i in range(5):
        images[str(tmp_path / f"{i}.png")] = rng.randint(0, 256, (24 + 8 * i, 40, 3), np.uint8)
        write_png(str(tmp_path / f"{i}.png"), images[str(tmp_path / f"{i}.png")])
    bg = RandomBackground(str(tmp_path), cache_size=2)
    sizes = []

    def work(seed):
        r = random.Random(seed)
        for _ in range(40):
            path = r.choice(sorted(images))
            got = bg._background(path, 32, 48)
            np.testing.assert_array_equal(got, resize_linear(images[path], (48, 32)))
            sizes.append(len(bg._cache))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            for future in [pool.submit(work, s) for s in range(16)]:
                future.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert len(sizes) == 16 * 40 and max(sizes) <= 2
    copy = pickle.loads(pickle.dumps(bg))
    assert not copy._cache and copy.files == bg.files
    assert copy._background(sorted(images)[0], 32, 48).shape == (32, 48, 3)


def _train_cli(config, work, *args):
    cmd = [sys.executable, "-m", "radet_tpu_torch.tools.train", config, "--work-dir", str(work), "--device", "cpu",
           "--max-iters", "2", *args]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=one_thread_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


@pytest.fixture(scope="module")
def flagship_run(train_sets, tmp_path_factory):
    """(work dir, log) of two steps of the train CLI on the flagship config
    from the packed-mask JPEG set."""
    work = tmp_path_factory.mktemp("flagship_run") / "work"
    log = _train_cli(train_sets["mask_packed"], work, "--seed", "3", "--cfg-options", *OPTS,
                     "data.workers_per_gpu=2", "log_config.interval=1", "checkpoint_config.interval=1")
    return work, log


def test_train_cli_trains_from_files(train_sets, flagship_run):
    """``python -m radet_tpu_torch.tools.train`` on the CPU: two steps from
    the JPEG set through the flagship's own pipeline, a checkpoint whose
    weights load into the model; the multi-GPU flags raise, and the
    unchanged flagship config fails where the JAX package's does (its
    ``RandomBackground`` directory, ``data/coco``, is not here)."""
    work, log = flagship_run
    assert "train dataset: 6 samples" in log and "data wait" in log
    assert sorted(os.listdir(work / "checkpoints")) == ["1", "2", "meta.json"]
    from radet_tpu_torch.apis.common import build_model_and_anchors

    model = build_model_and_anchors(Config.fromfile(train_sets["mask_packed"], OPTS))[0]
    model.load_state_dict(load_weights(str(work / "checkpoints")), strict=True)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    for flag in (["--gpus", "2"], ["--gpu-ids", "0", "1"], ["--launcher", "pytorch"]):
        with pytest.raises(NotImplementedError, match="item 13"):
            train_cli.main([train_sets["mask_packed"], *flag])
    ann_file = Config.fromfile(train_sets["mask_visib"]).data.train.ann_file
    opts = NARROW + ["data.train.classes=None", f"data.train.ann_file={ann_file!r}"]
    assert not osp.exists("data/coco")
    with pytest.raises(RuntimeError, match="No background images") as ref:
        jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts), "train", test_mode=False)
    with pytest.raises(RuntimeError) as got:
        build_dataset(Config.fromfile(FLAGSHIP, opts), "train")
    assert str(got.value) == str(ref.value)


def test_train_cli_fine_tunes_mixpbr_from_the_flagship_checkpoint(train_sets, flagship_run, tmp_path):
    """The mixpbr config (``MixDataset`` of ``train_pbr`` and
    ``train_real`` at ratios [2, 1], the flagship's pipeline) through the
    train CLI with ``load_from`` the flagship run's checkpoints: the set is
    2 x 6 + 3 samples, every tensor of the model is loaded, and after two
    steps the frozen stem and first stage still hold the loaded weights
    (the run's own seed would have drawn others) while the trained ones
    moved from them."""
    flagship_work, _ = flagship_run
    work = tmp_path / "mix"
    log = _train_cli(train_sets["mix"], work, "--seed", "4", "--cfg-options", *OPTS, "data.workers_per_gpu=2",
                     "log_config.interval=1", f"load_from={str(flagship_work / 'checkpoints')!r}")
    assert "train dataset: 15 samples" in log
    loaded = load_weights(str(flagship_work / "checkpoints"))
    assert f"loaded {len(loaded)}/{len(loaded)} tensors from pretrained weights" in log
    after = load_weights(str(work / "checkpoints"))
    assert after.keys() == loaded.keys()
    frozen = [k for k in loaded if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
    trained = [k for k in loaded if k.startswith("bbox_head.") and loaded[k].is_floating_point()]
    assert frozen and trained
    for k in frozen:
        assert torch.equal(after[k], loaded[k]), k
    assert any(not torch.equal(after[k], loaded[k]) for k in trained)
    history = [float(v) for v in __import__("re").findall(r" loss (\S+)", log)]
    assert len(history) == 2 and all(np.isfinite(history))


def test_mixpbr_dataset_draws_both_splits_as_jax(train_sets):
    """``build_dataset`` on the mixpbr config in both packages: the 2:1
    repeat layout over the same images, and equal samples (seeded alike)
    from the ``train_pbr`` and ``train_real`` parts."""
    cfgs = (JaxConfig.fromfile(train_sets["mix"], OPTS), Config.fromfile(train_sets["mix"], OPTS))
    ref, port = jax_build_dataset(cfgs[0], "train", test_mode=False), build_dataset(cfgs[1], "train")
    assert type(port).__name__ == type(ref).__name__ == "MixDataset"
    assert port.cumulative_sizes == ref.cumulative_sizes == [12, 15]
    assert [[d.dataset.img_ids for d in w.datasets] for w in (port, ref)] == [[[1, 3, 4, 5, 6, 7], [1, 2, 3]]] * 2
    assert [d.times for d in port.datasets] == [2, 1] and port.CLASSES == ref.CLASSES
    for idx in (0, 7, 13):
        samples = []
        for ds in (ref, port):
            np.random.seed(idx)
            random.seed(idx)
            samples.append(ds[idx])
        _assert_samples_equal(samples[1], samples[0], f"mix index {idx}")
