"""Draw a BOP submission's detections over its images (port of
``tools/show_bop_detbbox.py``).

    python -m radet_tpu_torch.tools.show_bop_detbbox RESULTS.json --images-dir SPLIT_DIR
        [--output-dir work_dirs/show_det] [--score-thr 0.3] [--num 20] [--ext png]

For each (scene, image) with a detection at or above ``--score-thr``, in
order, up to ``--num`` of them: reads ``SPLIT_DIR/{scene:06d}/rgb/{image:06d}``
with the extension ``--ext``, ``jpg`` or ``png`` (the first that exists;
an image with none is skipped), draws each box and ``category:score``, and
writes ``{scene:06d}_{image:06d}.jpg`` into ``--output-dir``, printing its
path.  Host work only: no card is used.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from collections import defaultdict

from ..data.image_io import imread_rgb
from ..utils.image_write import imwrite
from ..utils.raster import FONT_HERSHEY_SIMPLEX, put_text, rectangle

COLOR = (0, 200, 255)  # BGR


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Overlay detections from a BOP submission json onto images")
    p.add_argument("results", help="BOP-format detection json")
    p.add_argument("--images-dir", required=True, help="split dir with scene subdirs")
    p.add_argument("--output-dir", default="work_dirs/show_det")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--ext", default="png")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.results) as f:
        dets = json.load(f)
    by_img = defaultdict(list)
    for d in dets:
        if d["score"] >= args.score_thr:
            by_img[(d["scene_id"], d["image_id"])].append(d)

    os.makedirs(args.output_dir, exist_ok=True)
    for n, ((scene, imgid), ds) in enumerate(sorted(by_img.items())):
        if n >= args.num:
            break
        path = None
        for ext in (args.ext, "jpg", "png"):
            cand = osp.join(args.images_dir, f"{scene:06d}", "rgb", f"{imgid:06d}.{ext}")
            if osp.exists(cand):
                path = cand
                break
        if path is None:
            continue
        img = imread_rgb(path)[..., ::-1].copy()  # BGR, as cv2.imread gives it
        for d in ds:
            x, y, w, h = [int(v) for v in d["bbox"]]
            rectangle(img, (x, y), (x + w, y + h), COLOR, 2)
            put_text(img, f"{d['category_id']}:{d['score']:.2f}", (x, max(0, y - 4)), FONT_HERSHEY_SIMPLEX,
                     0.5, COLOR, 1)
        out = osp.join(args.output_dir, f"{scene:06d}_{imgid:06d}.jpg")
        imwrite(out, img)
        print(out)


if __name__ == "__main__":
    main()
