"""Dataset wrappers (port of ``radet_tpu/data/dataset_wrappers.py``):
``ConcatDataset`` (one index space over several datasets),
``RepeatDataset`` (index modulo the length), ``MixDataset`` (the
concatenation of each dataset repeated by its ratio, the PBR + real mix of
the ``*_mixpbr`` configs) and ``ClassBalancedDataset`` (LVIS-style
oversampling by the square root of the inverse category frequency).

Every wrapper forwards the attributes it does not have (``CLASSES``,
``cat2label``, ``coco``, ``det2json``, ...) to its first underlying
dataset.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import List, Sequence


class _ForwardingMixin:
    _primary_attr = "datasets"

    def _primary(self):
        d = getattr(self, self._primary_attr)
        return d[0] if isinstance(d, (list, tuple)) else d

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._primary(), name)


class ConcatDataset(_ForwardingMixin):
    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)
        self.CLASSES = getattr(self.datasets[0], "CLASSES", None)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class RepeatDataset(_ForwardingMixin):
    _primary_attr = "dataset"

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self._ori_len = len(dataset)
        self.CLASSES = getattr(dataset, "CLASSES", None)

    def __len__(self):
        return self.times * self._ori_len

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]


class MixDataset(ConcatDataset):
    """The datasets, each repeated ``ratios[i]`` times, concatenated."""

    def __init__(self, datasets: Sequence, ratios: Sequence[int]):
        assert len(datasets) == len(ratios)
        super().__init__([RepeatDataset(d, r) for d, r in zip(datasets, ratios)])


class ClassBalancedDataset(_ForwardingMixin):
    """Image ``i`` repeated ceil(r_i) times, r_i the largest of its
    categories' max(1, sqrt(oversample_thr / frequency)); with
    ``filter_empty_gt=False`` the images without GT count as a category of
    their own."""

    _primary_attr = "dataset"

    def __init__(self, dataset, oversample_thr: float, filter_empty_gt: bool = True):
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = getattr(dataset, "CLASSES", None)
        self.repeat_indices: List[int] = []
        for idx, rf in enumerate(self._get_repeat_factors(dataset, oversample_thr)):
            self.repeat_indices.extend([idx] * int(math.ceil(rf)))

    @staticmethod
    def _image_cat_ids(dataset, idx):
        info = dataset.data_infos[idx]
        return {a["category_id"] for a in dataset.coco.get_anns(info["id"]) if a["category_id"] in dataset.cat2label}

    def _get_repeat_factors(self, dataset, thr):
        n = len(dataset)
        cat_freq = defaultdict(float)
        img_cats = []
        empty_cat = len(self.CLASSES) if self.CLASSES is not None else -1
        for idx in range(n):
            cats = self._image_cat_ids(dataset, idx)
            if not cats and not self.filter_empty_gt:
                cats = {empty_cat}
            img_cats.append(cats)
            for c in cats:
                cat_freq[c] += 1.0
        for c in cat_freq:
            cat_freq[c] /= n
        cat_repeat = {c: max(1.0, math.sqrt(thr / f)) for c, f in cat_freq.items() if f > 0}
        return [max({cat_repeat[c] for c in cats}, default=1.0) for cats in img_cats]

    def __len__(self):
        return len(self.repeat_indices)

    def __getitem__(self, idx):
        return self.dataset[self.repeat_indices[idx]]


WRAPPERS = {
    "ConcatDataset": ConcatDataset,
    "RepeatDataset": RepeatDataset,
    "MixDataset": MixDataset,
    "ClassBalancedDataset": ClassBalancedDataset,
}
