"""Synthetic BOP data without cv2 or JAX, shared by the port's tests
(tests/test_torch_*.py) and its card script (chip_smoke.py): in-memory
training records of filled rectangles, an 8-bit PNG writer whose rows cycle
through all five PNG filters, and a BOP test split written with it."""

import json
import os
import os.path as osp
import struct
import zlib

import numpy as np


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
