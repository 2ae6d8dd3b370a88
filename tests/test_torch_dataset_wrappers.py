"""The port's dataset wrappers against the JAX package's on the CPU: on two
small synthetic BOP sets, the lengths and the index map of every index of
``ConcatDataset``, ``RepeatDataset``, ``MixDataset`` and
``ClassBalancedDataset`` (its repeat indices with and without
``filter_empty_gt``), the attributes forwarded to the first dataset, and
``build_dataset`` of each wrapper type (``configs/bop/r50_ycbv_mixpbr.py``
among them) pointed at the sets."""

import json
import os.path as osp

import numpy as np
import pytest

from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.data import BOPDataset as JaxBOPDataset
from radet_tpu.data import dataset_wrappers as jax_wrappers
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_dataset
from radet_tpu_torch.data import BOPDataset
from radet_tpu_torch.data import dataset_wrappers as wrappers
from radet_tpu_torch.utils.config import Config
from fixtures import make_synthetic_bop
from torch_parity import NARROW
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MIXPBR = osp.join(REPO, "configs", "bop", "r50_ycbv_mixpbr.py")
HW = (48, 64)


@pytest.fixture(scope="module")
def bop_sets(tmp_path_factory):
    """{'pbr': (ann_file, img_prefix), 'real': ...}: 6 and 3 images of 4
    classes; in ``pbr`` the classes are skewed (class 0 in every image)
    and the last image has no annotations."""
    root = str(tmp_path_factory.mktemp("wrapper_sets"))
    pbr = make_synthetic_bop(root, num_scenes=2, images_per_scene=3, img_hw=HW, num_classes=4, max_objects=3,
                             seed=1)
    real = make_synthetic_bop(root, images_per_scene=3, img_hw=HW, num_classes=4, max_objects=3, seed=2,
                              split="train_real")
    with open(pbr[0]) as f:
        coco = json.load(f)
    last = coco["images"][-1]["id"]
    coco["annotations"] = [a for a in coco["annotations"] if a["image_id"] != last]
    for a in coco["annotations"]:
        if a["image_id"] % 2:
            a["category_id"] = 1
    with open(pbr[0], "w") as f:
        json.dump(coco, f)
    return dict(pbr=pbr, real=real)


def _both(bop_sets, name, **kw):
    """(JAX, port) ``BOPDataset`` of one set, without a pipeline."""
    ann, prefix = bop_sets[name]
    return [cls(ann_file=ann, img_prefix=prefix, **kw) for cls in (JaxBOPDataset, BOPDataset)]


class Probe:
    """A dataset whose item i is (name, i)."""

    def __init__(self, name, n):
        self.name, self.n, self.CLASSES = name, n, (name,)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        assert 0 <= i < self.n
        return self.name, i


WRAPPED = {
    "ConcatDataset": lambda m, a, b: m.ConcatDataset([a, b]),
    "RepeatDataset": lambda m, a, b: m.RepeatDataset(a, 3),
    "MixDataset": lambda m, a, b: m.MixDataset([a, b], [2, 1]),
    "MixDataset_3_2": lambda m, a, b: m.MixDataset([b, a], [3, 2]),
}


@pytest.mark.parametrize("kind", sorted(WRAPPED))
def test_wrapper_index_maps_equal_jax(kind):
    """Length, the item behind every index, and ``CLASSES`` (the first
    dataset's) of each wrapper over two datasets of 5 and 3 items."""
    a, b = Probe("a", 5), Probe("b", 3)
    ref, port = WRAPPED[kind](jax_wrappers, a, b), WRAPPED[kind](wrappers, a, b)
    assert len(port) == len(ref) > 0
    assert [port[i] for i in range(len(port))] == [ref[i] for i in range(len(ref))]
    assert port.CLASSES == ref.CLASSES


@pytest.mark.parametrize("filter_empty_gt", [True, False])
@pytest.mark.parametrize("thr", [0.1, 0.5, 0.9])
def test_class_balanced_repeat_indices_equal_jax(bop_sets, thr, filter_empty_gt):
    """``ClassBalancedDataset`` over the skewed set (the image without GT
    kept): the same repeat indices, with and without ``filter_empty_gt``,
    and more than one repeat somewhere."""
    ref_ds, port_ds = _both(bop_sets, "pbr", filter_empty_gt=False)
    assert port_ds.img_ids == ref_ds.img_ids and len(port_ds) == 6
    ref = jax_wrappers.ClassBalancedDataset(ref_ds, thr, filter_empty_gt=filter_empty_gt)
    port = wrappers.ClassBalancedDataset(port_ds, thr, filter_empty_gt=filter_empty_gt)
    assert port.repeat_indices == ref.repeat_indices and len(port) == len(ref)
    assert len(port) > len(port_ds) or thr < 0.5


def test_wrappers_forward_attributes(bop_sets):
    """``CLASSES``, ``cat2label``, ``cat_ids``, ``coco`` and ``det2json``
    come from the first underlying dataset, through nested wrappers; a
    private name is not forwarded."""
    pbr, real = _both(bop_sets, "pbr")[1], _both(bop_sets, "real")[1]
    mix = wrappers.MixDataset([pbr, real], [2, 1])
    nested = wrappers.RepeatDataset(wrappers.ConcatDataset([mix, real]), 2)
    for w in (mix, nested, wrappers.ClassBalancedDataset(pbr, 0.5)):
        assert w.CLASSES == pbr.CLASSES and w.cat2label == pbr.cat2label and w.cat_ids == pbr.cat_ids
        assert w.coco is pbr.coco and w.det2json.__self__ is pbr
    assert len(nested) == 2 * (2 * len(pbr) + len(real) + len(real))
    with pytest.raises(AttributeError):
        mix._not_forwarded


def _config(tmp_path, bop_sets, train):
    """A config file: the mixpbr config with ``data.train`` replaced by
    ``train`` (``_delete_``) and the base's pipeline, whose backgrounds come
    from the ``pbr`` set's images."""
    pipeline = Config.fromfile(MIXPBR).to_dict()["train_pipeline"]
    for t in pipeline:
        if t["type"] == "RandomBackground":
            t["background_dir"] = osp.join(bop_sets["pbr"][1], "000000", "rgb")
    path = tmp_path / "cfg.py"
    path.write_text(f"_base_ = [{MIXPBR!r}]\n"
                    f"data = dict(train=dict(_delete_=True, pipeline={pipeline!r}, **{train!r}))\n")
    return str(path)


def _split(bop_sets, name):
    ann, prefix = bop_sets[name]
    return dict(ann_file=ann, img_prefix=prefix)


WRAPPER_CFGS = {
    "ConcatDataset": lambda s: dict(type="ConcatDataset", datasets=[_split(s, "pbr"), _split(s, "real")]),
    "RepeatDataset": lambda s: dict(type="RepeatDataset", times=4, dataset=_split(s, "real")),
    "ClassBalancedDataset": lambda s: dict(type="ClassBalancedDataset", oversample_thr=0.5,
                                           dataset=_split(s, "pbr")),
}


@pytest.mark.parametrize("kind", sorted(WRAPPER_CFGS))
def test_build_dataset_of_each_wrapper_equals_jax(kind, bop_sets, tmp_path):
    """``build_dataset`` of a wrapper section in both packages: the same
    wrapper type, length and image behind every index; the sub-datasets
    inherit ``classes`` and ``min_visib_frac`` from the wrapper's section."""
    train = dict(WRAPPER_CFGS[kind](bop_sets), classes=None, min_visib_frac=0.1)
    path = _config(tmp_path, bop_sets, train)
    ref = jax_build_dataset(JaxConfig.fromfile(path, NARROW), "train", test_mode=False)
    port = build_dataset(Config.fromfile(path, NARROW), "train")
    assert type(port).__name__ == type(ref).__name__ == kind and len(port) == len(ref)

    def image_of(w, i):  # the (dataset, img_id) of index i, without running the pipeline
        if isinstance(w, (wrappers.ConcatDataset, jax_wrappers.ConcatDataset)):
            k = int(np.searchsorted(w.cumulative_sizes, i, side="right"))
            return (k,) + image_of(w.datasets[k], i - (w.cumulative_sizes[k - 1] if k else 0))
        if isinstance(w, (wrappers.RepeatDataset, jax_wrappers.RepeatDataset)):
            return image_of(w.dataset, i % len(w.dataset))
        if isinstance(w, (wrappers.ClassBalancedDataset, jax_wrappers.ClassBalancedDataset)):
            return image_of(w.dataset, w.repeat_indices[i])
        return (w.img_ids[i],)

    assert [image_of(port, i) for i in range(len(port))] == [image_of(ref, i) for i in range(len(ref))]
    assert port.min_visib_frac == 0.1 and port.CLASSES == ref.CLASSES


def test_build_dataset_builds_the_mixpbr_config(bop_sets):
    """``configs/bop/r50_ycbv_mixpbr.py`` as it is, its two splits pointed
    at the sets: a ``MixDataset`` of [train_pbr x 2, train_real x 1] in
    both packages, over the same images, the flagship's pipeline in every
    sub-dataset and its ``load_from`` the PBR run's checkpoints."""
    (pbr_ann, pbr_prefix), (real_ann, real_prefix) = bop_sets["pbr"], bop_sets["real"]
    opts = NARROW + ["data.train.classes=None", f"data.train.datasets.0.ann_file={pbr_ann!r}",
                     f"data.train.datasets.0.img_prefix={pbr_prefix!r}", f"data.train.datasets.1.ann_file={real_ann!r}",
                     f"data.train.datasets.1.img_prefix={real_prefix!r}",
                     f"data.train.pipeline.3.background_dir={osp.join(pbr_prefix, '000000', 'rgb')!r}"]
    cfg = Config.fromfile(MIXPBR, opts)
    assert cfg.load_from == "work_dirs/ycbv_r50_radet_pbr/checkpoints"
    ref = jax_build_dataset(JaxConfig.fromfile(MIXPBR, opts), "train", test_mode=False)
    port = build_dataset(cfg, "train")
    assert type(port) is wrappers.MixDataset and type(ref).__name__ == "MixDataset"
    assert port.cumulative_sizes == ref.cumulative_sizes == [10, 13]  # pbr: the image without GT dropped
    assert [d.times for d in port.datasets] == [2, 1]
    assert [d.dataset.img_ids for d in port.datasets] == [d.dataset.img_ids for d in ref.datasets]
    for d in port.datasets:
        assert [type(t).__name__ for t in d.dataset.pipeline.transforms][3:5] == ["RandomBackground", "CosyPoseAug"]
        assert d.dataset.min_visib_frac == 0.1
