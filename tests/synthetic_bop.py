"""Synthetic BOP data without cv2 or JAX, shared by the port's tests
(tests/test_torch_*.py) and its card script (chip_smoke.py): in-memory
training records of filled rectangles, the package's 8-bit PNG writer
(rows cycling through all five PNG filters), a small TIFF writer of its own
(``tiff_bytes``), a BOP test split written with either (PNG, or gray TIFF
as BOP ITODD's), a BOP training split of given JPEG files with
``mask_visib`` PNGs, a config that trains the flagship (or its mixpbr
fine-tune, its mask-free variant, or its pipeline with the AutoAugment
family, InstaBoost and RADet's colour transforms) from such splits, and a
PASCAL VOC split of given JPEG files (``write_voc_split``)."""

import json
import os
import os.path as osp
import struct
import zlib

import numpy as np

from radet_tpu_torch.utils.image_write import write_png  # noqa: F401  (the test data's PNG writer)

# tests/data/jpeg: JPEG files written by cv2 (make_fixtures.py) from the
# first records of synthetic_bop_records(RandomState(JPEG_FIXTURE_SEED), ...)
# at 480x640, and the SHA-256 of cv2's decode of each (hashes.json)
JPEG_FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "jpeg")
JPEG_FIXTURE_SEED = 7


def jpeg_fixtures():
    """(the committed 480x640 JPEG fixtures' bytes, their records' boxes and
    labels): fixture ``i`` shows record ``i`` of
    ``synthetic_bop_records(RandomState(JPEG_FIXTURE_SEED), ...)``."""
    with open(osp.join(JPEG_FIXTURES, "hashes.json")) as f:
        names = sorted(json.load(f).items(), key=lambda kv: kv[1]["record"])
    jpegs = []
    for name, _ in names:
        with open(osp.join(JPEG_FIXTURES, name), "rb") as f:
            jpegs.append(f.read())
    return jpegs, synthetic_bop_records(np.random.RandomState(JPEG_FIXTURE_SEED), len(jpegs), (480, 640))


def synthetic_bop_records(rng, n, hw, num_classes=21, max_objects=6):
    """In-memory BOP-style training records: uint8 RGB images with filled
    rectangles (as tests/fixtures.py draws them), their xyxy boxes, labels
    and binary visible masks (a later rectangle hides what it covers)."""
    h, w = hw
    lo, hi = max(16, min(h, w) // 8), max(24, min(h, w) // 3)
    records = []
    for _ in range(n):
        img = rng.randint(0, 80, (h, w, 3), dtype=np.uint8)
        boxes, labels, masks = [], [], []
        for _ in range(rng.randint(1, max_objects + 1)):
            bw, bh = (int(v) for v in rng.randint(lo, hi, 2))
            x1, y1 = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            c = int(rng.randint(num_classes))
            img[y1:y1 + bh, x1:x1 + bw] = [(60 + 60 * c) % 256, (200 - 50 * c) % 256, 255]
            for m in masks:
                m[y1:y1 + bh, x1:x1 + bw] = 0
            m = np.zeros((h, w), np.uint8)
            m[y1:y1 + bh, x1:x1 + bw] = 1
            boxes.append([x1, y1, x1 + bw, y1 + bh])
            labels.append(c)
            masks.append(m)
        records.append(dict(img=img, gt_bboxes=np.asarray(boxes, np.float32),
                            gt_labels=np.asarray(labels, np.int64), gt_masks=np.stack(masks)))
    return records


def _lzw(data: bytes) -> bytes:
    """TIFF's LZW of ``data``: codes MSB first from 9 bits, the width
    growing one code early, a Clear before the table fills."""
    out, acc, nbits = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nbits
        acc, nbits = (acc << width) | code, nbits + width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 255)

    table, nxt = {bytes([i]): i for i in range(256)}, 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:  # full: Clear, and start again
            put(256)
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        put(table[w])
        if nxt + 1 > (1 << width) - 1:
            width += 1
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def tiff_bytes(img: np.ndarray, compression: int = 8, predictor: int = 1, big_endian: bool = False,
               tile=None, rows_per_strip=None, extra_samples=None) -> bytes:
    """A TIFF file of ``img``: (H, W) or (H, W, C) uint8 or uint16, gray for
    C 1 or 2 and RGB for 3 or 4 (the last channel alpha, ``extra_samples``
    its ExtraSamples value: None writes none), in strips of
    ``rows_per_strip`` rows (default: 8 KiB a strip) or tiles of ``tile`` =
    (width, height) (multiples of 16), compressed with ``compression`` 1
    (none), 5 (LZW), 8 or 32946 (Deflate), with the horizontal predictor
    for ``predictor`` 2, in either byte order."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, spp = img.shape
    depth = img.dtype.itemsize
    order = ">" if big_endian else "<"
    samples = img.astype(np.dtype(order + ("u2" if depth == 2 else "u1")))

    def encode(block):
        if predictor == 2:
            diff = block.astype(np.int64)
            diff[:, 1:] -= block[:, :-1].astype(np.int64)
            block = (diff % (1 << (8 * depth))).astype(block.dtype)
        raw = np.ascontiguousarray(block).tobytes()
        if compression == 1:
            return raw
        if compression == 5:
            return _lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        raise ValueError(f"compression {compression} is not written")

    if tile:
        tw, th = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, spp), samples.dtype)
        pad[:h, :w] = samples
        chunks = [encode(pad[y:y + th, x:x + tw]) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or max(1, 8192 // (w * spp * depth))
        chunks = [encode(samples[y:y + rps]) for y in range(0, h, rps)]
    # header, pixel data, then the IFD and its out-of-line values
    data = bytearray(b"MM\x00*" if big_endian else b"II*\x00") + b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8 * depth] * spp), 259: (3, [compression]),
               262: (3, [1 if spp <= 2 else 2]), 277: (3, [spp]), 284: (3, [1])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples is not None:
        entries[338] = (3, [extra_samples])
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, offsets),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rps]), 279: (4, [len(c) for c in chunks])})
    ifd = len(data)
    data[4:8] = struct.pack(order + "I", ifd)
    extra = ifd + 2 + 12 * len(entries) + 4
    body, tail = bytearray(struct.pack(order + "H", len(entries))), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        packed = struct.pack(f"{order}{len(values)}{'H' if typ == 3 else 'I'}", *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", extra + len(tail))
            tail += packed
        body += struct.pack(order + "HHI", tag, typ, len(values)) + field
    return bytes(data + body + b"\0\0\0\0" + tail)


def write_bop_test_set(root: str, rng, groups, class_names, max_objects: int = 6, tiff_gray: bool = False) -> str:
    """A BOP test split of PNG images (filled rectangles of
    ``len(class_names)`` classes on noise), or with ``tiff_gray`` of 8-bit
    gray Deflate TIFFs of their first channel (as BOP ITODD's test images):
    ``groups`` is [(n, (h, w)), ...], one scene each, written as
    ``root/test/{scene:06d}/gray/{img:06d}.tif`` or ``.../rgb/{img:06d}.png``;
    the COCO json goes to ``root/test.json``, whose path is returned."""
    images, annotations = [], []
    sub, ext = ("gray", "tif") if tiff_gray else ("rgb", "png")
    for scene, (n, hw) in enumerate(groups):
        os.makedirs(osp.join(root, "test", f"{scene:06d}", sub), exist_ok=True)
        for i, rec in enumerate(synthetic_bop_records(rng, n, hw, len(class_names), max_objects)):
            name = f"{scene:06d}/{sub}/{i:06d}.{ext}"
            if tiff_gray:
                with open(osp.join(root, "test", name), "wb") as f:
                    f.write(tiff_bytes(rec["img"][..., 0]))
            else:
                write_png(osp.join(root, "test", name), rec["img"])
            img_id = len(images) + 1
            images.append(dict(id=img_id, file_name=name, height=hw[0], width=hw[1]))
            for (x1, y1, x2, y2), c in zip(rec["gt_bboxes"].tolist(), rec["gt_labels"].tolist()):
                annotations.append(dict(id=len(annotations) + 1, image_id=img_id, category_id=c + 1,
                                        bbox=[x1, y1, x2 - x1, y2 - y1], area=(x2 - x1) * (y2 - y1),
                                        iscrowd=0, visib_fract=1.0))
    categories = [dict(id=c + 1, name=str(n)) for c, n in enumerate(class_names)]
    ann_file = osp.join(root, "test.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=categories), f)
    return ann_file


def write_bop_train_set(root: str, records, jpegs, class_names, split: str = "train_pbr") -> str:
    """A BOP training split of one scene: image ``i`` is the JPEG file
    ``jpegs[i % len(jpegs)]`` (its bytes, as they are) annotated with record
    ``i``'s boxes and labels, and its visible masks as ``mask_visib`` PNGs
    (255 on the object); ``visib_fract`` is the mask's share of its box.
    Writes ``root/{split}/000000/...`` and ``root/{split}.json``; returns
    the json's path."""
    scene = osp.join(root, split, "000000")
    for sub in ("rgb", "mask_visib"):
        os.makedirs(osp.join(scene, sub), exist_ok=True)
    images, annotations = [], []
    for i, rec in enumerate(records):
        h, w = rec["img"].shape[:2]
        with open(osp.join(scene, "rgb", f"{i:06d}.jpg"), "wb") as f:
            f.write(jpegs[i % len(jpegs)])
        images.append(dict(id=i + 1, file_name=f"000000/rgb/{i:06d}.jpg", height=h, width=w))
        for a, ((x1, y1, x2, y2), c, m) in enumerate(zip(rec["gt_bboxes"].tolist(), rec["gt_labels"].tolist(),
                                                         rec["gt_masks"])):
            write_png(osp.join(scene, "mask_visib", f"{i:06d}_{a:06d}.png"), m * np.uint8(255))
            area = (x2 - x1) * (y2 - y1)
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1, category_id=c + 1,
                                    bbox=[x1, y1, x2 - x1, y2 - y1], area=area, iscrowd=0,
                                    visib_fract=float(m.sum()) / area))
    categories = [dict(id=c + 1, name=str(n)) for c, n in enumerate(class_names)]
    ann_file = osp.join(root, f"{split}.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=categories), f)
    return ann_file


# the transforms augmented_pipeline adds to a train pipeline: InstaBoost after
# LoadAnnotations, then after Resize an AutoAugment whose five
# policies use all seven of its types, RandomHSV, RandomNoise and RandomSmooth
AUG_POLICIES = [
    [dict(type="Translate", level=4, prob=0.6), dict(type="EqualizeTransform", prob=0.8)],
    [dict(type="Shear", level=2, prob=1.0, direction="vertical"),
     dict(type="Translate", level=6, prob=0.6, direction="vertical")],
    [dict(type="Rotate", level=10, prob=0.6), dict(type="ColorTransform", level=6, prob=1.0)],
    [dict(type="BrightnessTransform", level=6, prob=0.5), dict(type="ContrastTransform", level=4, prob=0.5)],
    [dict(type="Shear", level=4, prob=0.4)],
]
AFTER_LOAD = [dict(type="InstaBoost", aug_ratio=0.5)]
AFTER_RESIZE = [dict(type="AutoAugment", policies=AUG_POLICIES),
                dict(type="RandomHSV", h_ratio=0.1, s_ratio=0.3, v_ratio=0.3, prob=0.5),
                dict(type="RandomNoise", noise_ratio=0.02, prob=0.3),
                dict(type="RandomSmooth", max_kernel_size=7, prob=0.3)]


def augmented_pipeline(pipeline):
    """``pipeline`` (a list of transform configs) with ``AFTER_LOAD`` after
    its ``LoadAnnotations`` and ``AFTER_RESIZE`` after its ``Resize``."""
    out = []
    for t in pipeline:
        out.append(dict(t))
        out += [dict(a) for a in {"LoadAnnotations": AFTER_LOAD, "Resize": AFTER_RESIZE}.get(t["type"], [])]
    return out


def write_train_config(path: str, base: str, ann_file: str, img_prefix: str, background_dir: str,
                       real=None, mask_free=None, augmented: bool = False) -> str:
    """A config file at ``path`` that is ``base`` training from the given
    split through ``base``'s own ``train_pipeline`` (``CosyPoseAug``
    included), its ``RandomBackground`` reading ``background_dir``.
    ``data.train`` reads ``ann_file`` under ``img_prefix``; with ``real``,
    an (ann_file, img_prefix) pair, ``base``'s wrapper (the ``MixDataset``
    of ``configs/bop/*_mixpbr.py``) reads [the given split, ``real``] as
    its ``train_pbr`` and ``train_real``.  With ``mask_free`` ('gdt' or
    'mbd') the pipeline trains from boxes alone: ``LoadAnnotations``
    without ``with_bop_mask`` (so ``RandomBackground`` skips) and
    ``GenerateDistanceMap(with_gt_mask=False, distance_transform=
    mask_free)``.  With ``augmented``, the pipeline is
    ``augmented_pipeline``'s.  Returns ``path``."""
    from radet_tpu_torch.utils.config import Config

    pipeline = [dict(t) for t in Config.fromfile(base).to_dict()["train_pipeline"]]
    for t in pipeline:
        if t["type"] == "RandomBackground":
            t["background_dir"] = background_dir
        elif mask_free and t["type"] == "LoadAnnotations":
            t["with_bop_mask"] = False
        elif mask_free and t["type"] == "GenerateDistanceMap":
            t.update(with_gt_mask=False, distance_transform=mask_free)
    if augmented:
        pipeline = augmented_pipeline(pipeline)
    if real is None:
        train = f"dict(ann_file={ann_file!r}, img_prefix={img_prefix!r}, pipeline=train_pipeline)"
    else:
        splits = [dict(ann_file=a, img_prefix=p, min_visib_frac=0.1) for a, p in ((ann_file, img_prefix), real)]
        train = f"dict(datasets={splits!r}, pipeline=train_pipeline)"
    with open(path, "w") as f:
        f.write(f"_base_ = [{osp.abspath(base)!r}]\n"
                f"train_pipeline = {pipeline!r}\n"
                f"data = dict(train={train})\n")
    return path


VOC_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat', 'chair', 'cow', 'diningtable',
               'dog', 'horse', 'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


def _voc_xml(img_id: str, hw, objects, with_size: bool = True) -> str:
    size = f"<size><width>{hw[1]}</width><height>{hw[0]}</height><depth>3</depth></size>" if with_size else ""
    objs = "".join(
        f"<object><name>{name}</name><pose>Unspecified</pose><truncated>0</truncated><difficult>{diff}</difficult>"
        f"<bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
        for name, diff, b in objects)
    return (f"<annotation><folder>VOC</folder><filename>{img_id}.jpg</filename>{size}{objs}"
            f"<segmented>0</segmented></annotation>\n")


def write_voc_split(root: str, records, jpegs, splits, year: int = 2007, difficult_every: int = 5,
                    small_every: int = 3, small_side: int = 6, no_size=(0,)) -> str:
    """A PASCAL VOC{year} layout under ``root/VOC{year}`` (returned: the
    datasets' ``img_prefix``): image ``i`` is ``JPEGImages/{i + 1:06d}.jpg``,
    the bytes of ``jpegs[i % len(jpegs)]``, annotated in
    ``Annotations/{i + 1:06d}.xml`` with record ``i % len(records)``'s boxes
    (1-based VOC coordinates, class ``VOC_CLASSES[label % 20]``); every
    ``difficult_every``-th object is ``difficult``, every ``small_every``-th
    image gets one more object of ``small_side`` pixels (below a
    ``min_size`` of ``small_side + 1``), and the XMLs of the images in
    ``no_size`` have no ``<size>``.  ``splits`` is [(name, count), ...]:
    consecutive images, listed in ``ImageSets/Main/{name}.txt``."""
    base = osp.join(root, f"VOC{year}")
    for sub in ("Annotations", "JPEGImages", osp.join("ImageSets", "Main")):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    i, n_obj = 0, 0
    for name, count in splits:
        ids = []
        for _ in range(count):
            img_id = f"{i + 1:06d}"
            rec = records[i % len(records)]
            h, w = rec["img"].shape[:2]
            with open(osp.join(base, "JPEGImages", f"{img_id}.jpg"), "wb") as f:
                f.write(jpegs[i % len(jpegs)])
            objects = []
            for (x1, y1, x2, y2), c in zip(rec["gt_bboxes"].astype(int).tolist(), rec["gt_labels"].tolist()):
                objects.append((VOC_CLASSES[c % 20], int(n_obj % difficult_every == difficult_every - 1),
                                (x1 + 1, y1 + 1, x2 + 1, y2 + 1)))
                n_obj += 1
            if small_every and i % small_every == small_every - 1:
                x, y = 2 + (7 * i) % (w - small_side - 4), 2 + (5 * i) % (h - small_side - 4)
                objects.append((VOC_CLASSES[i % 20], 0, (x + 1, y + 1, x + 1 + small_side, y + 1 + small_side)))
            with open(osp.join(base, "Annotations", f"{img_id}.xml"), "w") as f:
                f.write(_voc_xml(img_id, (h, w), objects, with_size=i not in no_size))
            ids.append(img_id)
            i += 1
        with open(osp.join(base, "ImageSets", "Main", f"{name}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return base


# mmdet's SSD recipe for VOC (ssd300_voc0712) on the flagship's static
# 480x640 input: photometric distortion, zoom out, min-IoU crop, a resize
# to the input (keep_ratio=False, as SSD's), the flip, and distance maps
# from the boxes (VOC has no masks)
SSD_VOC_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="PhotoMetricDistortion", brightness_delta=32, contrast_range=(0.5, 1.5),
         saturation_range=(0.5, 1.5), hue_delta=18),
    dict(type="Expand", mean=[123.675, 116.28, 103.53], ratio_range=(1, 4)),
    dict(type="MinIoURandomCrop", min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3),
    dict(type="Resize", img_scale=(640, 480), keep_ratio=False),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="GenerateDistanceMap", with_gt_mask=False),
    dict(type="SampleDistanceAtAnchors"),
    dict(type="Pad", size_divisor=16),
]


def voc_options(img_prefix: str, train: str = "trainval", test: str = "test", min_size=None,
                img_scale=(640, 480)) -> list:
    """``--cfg-options`` that turn the flagship config into RADet on a VOC
    split (``write_voc_split``'s ``img_prefix``): 20 classes, ``data.train``
    the ``VOCDataset`` of the list ``train`` through ``SSD_VOC_PIPELINE``
    (its resize to ``img_scale``, (w, h)), ``data.val`` and ``data.test``
    that of ``test`` through the flagship's test pipeline, and
    ``evaluation.save_best='mAP'`` (VOC's mean AP)."""
    main = osp.join(img_prefix, "ImageSets", "Main")
    pipeline = [dict(t, img_scale=tuple(img_scale)) if t["type"] == "Resize" else t for t in SSD_VOC_PIPELINE]
    opts = ["model.bbox_head.num_classes=20", "evaluation.save_best='mAP'", f"data.train.pipeline={pipeline!r}",
            "data.test.bop_submission=False"]
    for split, name in (("train", train), ("val", test), ("test", test)):
        opts += [f"data.{split}.type='VOCDataset'", f"data.{split}.ann_file={osp.join(main, name + '.txt')!r}",
                 f"data.{split}.img_prefix={img_prefix!r}", f"data.{split}.classes=None"]
    if min_size is not None:
        opts.append(f"data.train.min_size={min_size!r}")
    return opts


# mmdet's RPN recipe on an AnchorHead config (configs/atss/retina_r50_fpn_ycbv_pbr.py): three ratios at
# scale 8, sigmoid CE and L1, MaxIoU at 0.7 / 0.3 / 0.3 and RandomSampler(256, 0.5)
RPN_ANCHORS = dict(type="AnchorGenerator", ratios=[0.5, 1.0, 2.0], scales=[8], strides=[8, 16, 32, 64, 128])
RPN_SAMPLER = dict(type="RandomSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1, add_gt_as_proposals=False)
RPN_RECIPE = [
    f"model.bbox_head.anchor_generator={RPN_ANCHORS!r}",
    "model.bbox_head.bbox_coder={'type': 'DeltaXYWHBBoxCoder'}",
    "model.bbox_head.loss_cls={'type': 'CrossEntropyLoss', 'use_sigmoid': True, 'loss_weight': 1.0}",
    "model.bbox_head.loss_bbox={'type': 'L1Loss', 'loss_weight': 1.0}",
    "train_cfg.assigner={'type': 'MaxIoUAssigner', 'pos_iou_thr': 0.7, 'neg_iou_thr': 0.3, 'min_pos_iou': 0.3, "
    "'ignore_iof_thr': -1}",
    f"train_cfg.sampler={RPN_SAMPLER!r}",
]
# the other samplers of mmdet, each in place of RPN_SAMPLER
SAMPLERS = {
    "OHEMSampler": dict(type="OHEMSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1),
    "IoUBalancedNegSampler": dict(type="IoUBalancedNegSampler", num=256, pos_fraction=0.5, floor_thr=-1,
                                  floor_fraction=0, num_bins=3),
    "InstanceBalancedPosSampler": dict(type="InstanceBalancedPosSampler", num=256, pos_fraction=0.5),
    "CombinedSampler": dict(type="CombinedSampler", num=256, pos_fraction=0.5,
                            pos_sampler=dict(type="InstanceBalancedPosSampler"),
                            neg_sampler=dict(type="IoUBalancedNegSampler", floor_thr=-1, floor_fraction=0,
                                             num_bins=3)),
    "ScoreHLRSampler": dict(type="ScoreHLRSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1, k=0.5, bias=0.0,
                            score_thr=0.05, iou_thr=0.5),
}
# ScoreHLR's grouping is quadratic in the anchor count (at most 8192): one anchor a cell
ONE_ANCHOR = ["model.bbox_head.anchor_generator={'type': 'AnchorGenerator', 'ratios': [1.0], "
              "'octave_base_scale': 8, 'scales_per_octave': 1, 'strides': [8, 16, 32, 64, 128]}"]


def sampler_options(name: str):
    """RPN_RECIPE with the sampler ``name`` (``RandomSampler`` or a key of
    SAMPLERS); ScoreHLR on ONE_ANCHOR's grid."""
    if name == "RandomSampler":
        return list(RPN_RECIPE)
    return RPN_RECIPE[:-1] + [f"train_cfg.sampler={SAMPLERS[name]!r}"] + (ONE_ANCHOR if name == "ScoreHLRSampler"
                                                                          else [])
