"""The dataset zoo beyond BOP (port of ``radet_tpu/data/datasets_extra.py``):
mmdet's registered dataset types over the port's :class:`BOPDataset`.

- ``CocoDataset`` (80 classes), ``YcbvDataset`` (21), ``KittiDataset`` (8,
  COCO protocol with classwise AP forced on), ``DeepFashionDataset`` (15),
  ``CityscapesDataset`` (8, the bbox protocol): presets of class names;
- ``LVISV1Dataset``: file names from each image's ``coco_url``
  (``CocoIndex``), class names from the annotation file's category table,
  evaluated by LVIS's federated protocol (``evaluation/lvis_eval.py``);
- ``XMLDataset``: the PASCAL VOC XML layout, converted once into a COCO
  dict in memory; ``difficult`` objects and boxes below ``min_size`` become
  ignore regions;
- ``VOCDataset``: 20 classes, VOC's mean AP (11 points for VOC2007, the
  area for VOC2012; ``evaluation/voc_eval.py``) and proposal recall;
- ``WIDERFaceDataset``: XML layout, files under each XML's ``folder``.

After the conversion the pipeline, the loader and the device path are
BOP's.  An XML without ``<size>`` takes the size from the image file's
header (``data/image_io.py::image_size``).
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..evaluation.lvis_eval import LVISEvaluator
from ..evaluation.voc_eval import eval_map, eval_recalls
from .bop import BOPDataset
from .image_io import image_size


class _PresetClassesDataset(BOPDataset):
    """BOPDataset with a CLASSES name preset used when ``classes`` is not
    given (mmdet's CustomDataset.get_classes fallback)."""

    CLASSES: Optional[Sequence[str]] = None

    def __init__(self, *args, classes: Optional[Sequence[str]] = None, **kwargs):
        super().__init__(*args, classes=classes or type(self).CLASSES, **kwargs)


class CocoDataset(_PresetClassesDataset):
    """COCO 2017 detection (mmdet datasets/coco.py:19-46)."""

    CLASSES = (
        'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
        'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
        'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog',
        'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
        'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
        'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
        'baseball glove', 'skateboard', 'surfboard', 'tennis racket',
        'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl',
        'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
        'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
        'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop',
        'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
        'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock',
        'vase', 'scissors', 'teddy bear', 'hair drier', 'toothbrush',
    )


class YcbvDataset(_PresetClassesDataset):
    """YCB-Video / BOP ycbv (mmdet datasets/ycbv.py)."""

    CLASSES = (
        'master_chef_can', 'cracker_box', 'sugar_box', 'tomato_soup_can',
        'mustard_bottle', 'tuna_fish_can', 'pudding_box', 'gelatin_box',
        'potted_meat_can', 'banana', 'pitcher_base', 'bleach_cleanser',
        'bowl', 'mug', 'power_drill', 'wood_block', 'scissors',
        'large_marker', 'large_clamp', 'extra_large_clamp', 'foam_brick',
    )


class KittiDataset(_PresetClassesDataset):
    """KITTI 2D detection (mmdet datasets/kitti.py — COCO protocol with
    classwise AP forced on, kitti.py:9-26)."""

    CLASSES = ('Car', 'Van', 'Truck', 'Pedestrian', 'Person_sitting',
               'Cyclist', 'Tram', 'Misc')
    # consumed by apis.test.evaluate_results — mirrors mmdet's
    # evaluate() override that pins classwise=True
    EVAL_DEFAULTS = dict(classwise=True)


class DeepFashionDataset(_PresetClassesDataset):
    """DeepFashion landmark/detection (mmdet datasets/deepfashion.py)."""

    CLASSES = ('top', 'skirt', 'leggings', 'dress', 'outer', 'pants', 'bag',
               'neckwear', 'headwear', 'eyeglass', 'belt', 'footwear', 'hair',
               'skin', 'face')


class CityscapesDataset(_PresetClassesDataset):
    """Cityscapes instance detection, bbox protocol (mmdet
    datasets/cityscapes.py:22-24; the mask-AP path needs the cityscapes
    scripts package and is out of detection scope)."""

    CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle')


class LVISV1Dataset(BOPDataset):
    """LVIS v1 (mmdet datasets/lvis.py:473-742).

    Filenames come from each image's ``coco_url`` (handled by CocoIndex,
    coco_io.py).  Class names default to the annotation file's category
    table — identical content to mmdet's hardcoded 1203-name
    CLASSES tuple, without 200 lines of constants.  Evaluation runs the
    LVIS federated protocol (evaluation/lvis_eval.py: per-image 300-det
    cap, neg/not-exhaustive category sets, APr/APc/APf) in numpy —
    mmdet needs the ``lvis`` package for this (lvis.py:238-245)."""

    def evaluate(self, results: List[dict], **eval_options) -> Dict[str, float]:
        evaluator = LVISEvaluator(
            self.coco, cat_ids=self.cat_ids, img_ids=self.img_ids
        )
        metrics = evaluator.evaluate(self.det2json(results))
        out = {f"bbox_{k}": v for k, v in metrics.items()}
        if eval_options.get("classwise"):
            out.update(
                {f"bbox_AP_{n}": ap for n, ap in evaluator.classwise_ap().items()}
            )
        return out


def _xml_to_coco(
    ann_file: str,
    img_prefix: str,
    class_names: Sequence[str],
    min_size: Optional[float],
    filename_of,
) -> Dict:
    """Parse a PASCAL-VOC XML layout into a COCO-format dict.

    ``ann_file`` is a text file of image ids; each id has
    ``{img_prefix}/Annotations/{id}.xml`` (mmdet xml_style.py:36-57).
    Boxes shift by -1 (VOC is 1-based, xml_style.py:132-139); ``difficult``
    objects and boxes smaller than ``min_size`` become ignore regions
    (xml_style.py:105-125) via the ``difficult`` annotation flag that
    ``BOPDataset.parse_ann_info`` routes to bboxes_ignore/labels_ignore."""
    name_to_cat = {n: i + 1 for i, n in enumerate(class_names)}
    images: List[dict] = []
    annotations: List[dict] = []
    with open(ann_file) as f:
        img_ids = [line.strip() for line in f if line.strip()]
    for num_id, img_id in enumerate(img_ids, start=1):
        xml_path = osp.join(img_prefix, 'Annotations', f'{img_id}.xml')
        root = ET.parse(xml_path).getroot()
        size = root.find('size')
        if size is not None:
            width = int(size.find('width').text)
            height = int(size.find('height').text)
        else:  # the image file's own header
            width, height = image_size(osp.join(img_prefix, filename_of(root, img_id)))
        images.append(
            dict(
                id=num_id,
                filename=filename_of(root, img_id),
                width=width,
                height=height,
                voc_id=img_id,
            )
        )
        for obj in root.findall('object'):
            name = obj.find('name').text
            if name not in name_to_cat:
                continue
            bnd = obj.find('bndbox')
            # int(float(...)): VOC coordinates may be float-typed
            # (xml_style.py:108-114)
            x1 = int(float(bnd.find('xmin').text)) - 1
            y1 = int(float(bnd.find('ymin').text)) - 1
            x2 = int(float(bnd.find('xmax').text)) - 1
            y2 = int(float(bnd.find('ymax').text)) - 1
            w, h = x2 - x1, y2 - y1
            diff_node = obj.find('difficult')
            difficult = int(diff_node.text) if diff_node is not None else 0
            if min_size and (w < min_size or h < min_size):
                difficult = 1  # too-small → ignore region (xml_style.py:116-121)
            annotations.append(
                dict(
                    id=len(annotations) + 1,
                    image_id=num_id,
                    category_id=name_to_cat[name],
                    bbox=[float(x1), float(y1), float(w), float(h)],
                    area=float(w * h),
                    iscrowd=0,
                    difficult=difficult,
                )
            )
    categories = [dict(id=i + 1, name=n) for i, n in enumerate(class_names)]
    return dict(images=images, annotations=annotations, categories=categories)


class XMLDataset(BOPDataset):
    """PASCAL-VOC XML layout (mmdet datasets/xml_style.py).

    The XML tree is converted once into an in-memory COCO dict; after that
    the full static-shape pipeline applies unchanged.  ``min_size`` routes
    too-small boxes to the ignore set (xml_style.py:115-121)."""

    CLASSES: Sequence[str] = ()

    def __init__(
        self,
        ann_file: str,
        img_prefix: str = "",
        classes: Optional[Sequence[str]] = None,
        min_size: Optional[float] = None,
        **kwargs,
    ):
        self.min_size = min_size
        names = list(classes or type(self).CLASSES)
        if not names:
            raise ValueError(f"{type(self).__name__} needs class names")
        coco_dict = _xml_to_coco(
            ann_file, img_prefix, names, min_size, self._filename_of
        )
        super().__init__(
            ann_file=coco_dict, img_prefix=img_prefix, classes=names, **kwargs
        )
        self.ann_file = ann_file

    @staticmethod
    def _filename_of(xml_root, img_id: str) -> str:
        return f'JPEGImages/{img_id}.jpg'

    def get_ann_info(self, idx: int) -> Dict:
        return self.parse_ann_info(self.data_infos[idx])


class VOCDataset(XMLDataset):
    """PASCAL VOC (mmdet datasets/voc.py).

    ``evaluate`` runs the VOC protocol — 11-point interpolated AP for
    VOC2007, area-under-PR for VOC2012 (voc.py:62-81) — via
    evaluation/voc_eval.py instead of the COCO protocol."""

    CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
               'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
               'tvmonitor')

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if 'VOC2007' in self.img_prefix:
            self.year = 2007
        elif 'VOC2012' in self.img_prefix:
            self.year = 2012
        else:
            raise ValueError('Cannot infer dataset year from img_prefix')

    def _results_by_class(self, results: List[dict]) -> List[List[np.ndarray]]:
        """Per-image detection dicts → [img][cls] (M,5) arrays in dataset
        order (keyed by img_id — results may arrive gathered out of order)."""
        by_id = {int(r["img_id"]): r for r in results}
        num_classes = len(self.CLASSES)
        out = []
        for img_id in self.img_ids:
            det = by_id.get(int(img_id))
            per_cls = []
            for c in range(num_classes):
                if det is None:
                    per_cls.append(np.zeros((0, 5), np.float32))
                    continue
                sel = np.asarray(det["labels"]) == c
                boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)[sel]
                scores = np.asarray(det["scores"], np.float32).reshape(-1)[sel]
                per_cls.append(
                    np.concatenate([boxes, scores[:, None]], axis=1).astype(
                        np.float32
                    )
                )
            out.append(per_cls)
        return out

    def evaluate(
        self,
        results: List[dict],
        metric: str = 'mAP',
        iou_thr: float | List[float] = 0.5,
        proposal_nums: Sequence[int] = (100, 300, 1000),
        scale_ranges=None,
        **eval_options,
    ) -> Dict[str, float]:
        if not isinstance(metric, str):
            assert len(metric) == 1
            metric = metric[0]
        if metric not in ('mAP', 'recall'):
            raise KeyError(f'metric {metric} is not supported')
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        out: Dict[str, float] = {}
        if metric == 'mAP':
            # VOC2007 uses the 11-point metric (voc.py:66-69 dataset='voc07')
            mode = '11points' if self.year == 2007 else 'area'
            iou_thrs = [iou_thr] if isinstance(iou_thr, float) else list(iou_thr)
            dets = self._results_by_class(results)
            mean_aps = []
            for thr in iou_thrs:
                # mmdet passes scale_ranges=None here regardless of
                # the argument (voc.py:73-76)
                mean_ap, _ = eval_map(
                    dets, annotations, scale_ranges=None, iou_thr=thr, mode=mode,
                )
                mean_aps.append(mean_ap)
                out[f'AP{int(thr * 100):02d}'] = round(float(mean_ap), 3)
            out['mAP'] = float(sum(mean_aps) / len(mean_aps))
        else:
            by_id = {int(r["img_id"]): r for r in results}
            gt_bboxes, proposals = [], []
            for img_id, ann in zip(self.img_ids, annotations):
                gt_bboxes.append(np.asarray(ann["bboxes"], np.float32))
                det = by_id.get(int(img_id))
                if det is None:
                    proposals.append(np.zeros((0, 5), np.float32))
                else:
                    boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
                    scores = np.asarray(det["scores"], np.float32).reshape(-1, 1)
                    proposals.append(np.concatenate([boxes, scores], axis=1))
            iou_thrs = [iou_thr] if isinstance(iou_thr, float) else list(iou_thr)
            recalls = eval_recalls(gt_bboxes, proposals, proposal_nums, iou_thrs)
            for i, num in enumerate(proposal_nums):
                for j, thr in enumerate(iou_thrs):
                    out[f'recall@{num}@{thr}'] = float(recalls[i, j])
            if recalls.shape[1] > 1:
                ar = recalls.mean(axis=1)
                for i, num in enumerate(proposal_nums):
                    out[f'AR@{num}'] = float(ar[i])
        return out


class WIDERFaceDataset(XMLDataset):
    """WIDER Face in PASCAL-VOC layout (mmdet datasets/wider_face.py):
    filenames are ``{folder}/{id}.jpg`` with folder read from each XML."""

    CLASSES = ('face',)

    @staticmethod
    def _filename_of(xml_root, img_id: str) -> str:
        folder = xml_root.find('folder').text
        return f'{folder}/{img_id}.jpg'


# name → class, the config-facing registry (mmdet datasets/builder.py
# DATASETS registry); wrappers are handled separately in apis.common
DATASET_TYPES: Dict[str, type] = {
    "BOPDataset": BOPDataset,
    "CocoDataset": CocoDataset,
    "YcbvDataset": YcbvDataset,
    "KittiDataset": KittiDataset,
    "DeepFashionDataset": DeepFashionDataset,
    "CityscapesDataset": CityscapesDataset,
    "LVISV1Dataset": LVISV1Dataset,
    "LVISDataset": LVISV1Dataset,
    "XMLDataset": XMLDataset,
    "VOCDataset": VOCDataset,
    "WIDERFaceDataset": WIDERFaceDataset,
}
