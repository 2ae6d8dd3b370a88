"""Synthetic BOP data without cv2 or JAX, shared by the port's tests
(tests/test_torch_*.py) and its card script (chip_smoke.py): in-memory
training records of filled rectangles, an 8-bit PNG writer whose rows cycle
through all five PNG filters, a BOP test split written with it, a BOP
training split of given JPEG files with ``mask_visib`` PNGs, and a config
that trains the flagship (or its mixpbr fine-tune) from such splits."""

import json
import os
import os.path as osp
import struct
import zlib

import numpy as np

# tests/data/jpeg: JPEG files written by cv2 (make_fixtures.py) from the
# first records of synthetic_bop_records(RandomState(JPEG_FIXTURE_SEED), ...)
# at 480x640, and the SHA-256 of cv2's decode of each (hashes.json)
JPEG_FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "jpeg")
JPEG_FIXTURE_SEED = 7


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


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """A uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image as an
    8-bit PNG whose row y uses filter type y % 5 (None, Sub, Up, Average,
    Paeth), so that a decoder of these files meets every filter."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(x)
    left[:, ch:] = x[:, :-ch]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, ch:] = x[:-1, :-ch]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    predictions = (0, left, up, (left + up) >> 1, paeth)
    kind = np.arange(h) % 5
    rows = np.empty((h, w * ch + 1), np.uint8)
    rows[:, 0] = kind
    for f, pred in enumerate(predictions):
        rows[kind == f, 1:] = ((x - pred) & 255)[kind == f]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def write_bop_test_set(root: str, rng, groups, class_names, max_objects: int = 6) -> str:
    """A BOP test split of PNG images (filled rectangles of
    ``len(class_names)`` classes on noise): ``groups`` is [(n, (h, w)), ...],
    one scene each, written as ``root/test/{scene:06d}/rgb/{img:06d}.png``;
    the COCO json goes to ``root/test.json``, whose path is returned."""
    images, annotations = [], []
    for scene, (n, hw) in enumerate(groups):
        os.makedirs(osp.join(root, "test", f"{scene:06d}", "rgb"), exist_ok=True)
        for i, rec in enumerate(synthetic_bop_records(rng, n, hw, len(class_names), max_objects)):
            name = f"{scene:06d}/rgb/{i:06d}.png"
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


def write_train_config(path: str, base: str, ann_file: str, img_prefix: str, background_dir: str,
                       real=None) -> str:
    """A config file at ``path`` that is ``base`` training from the given
    split through ``base``'s own ``train_pipeline`` (``CosyPoseAug``
    included), its ``RandomBackground`` reading ``background_dir``.
    ``data.train`` reads ``ann_file`` under ``img_prefix``; with ``real``,
    an (ann_file, img_prefix) pair, ``base``'s wrapper (the ``MixDataset``
    of ``configs/bop/*_mixpbr.py``) reads [the given split, ``real``] as
    its ``train_pbr`` and ``train_real``.  Returns ``path``."""
    from radet_tpu_torch.utils.config import Config

    pipeline = [dict(t) for t in Config.fromfile(base).to_dict()["train_pipeline"]]
    for t in pipeline:
        if t["type"] == "RandomBackground":
            t["background_dir"] = background_dir
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
