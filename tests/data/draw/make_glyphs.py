"""Write cv2's text glyphs into the port: ``radet_tpu_torch/utils/text_glyphs.py``.

    python tests/data/draw/make_glyphs.py

OpenCV 5 draws ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale,
color, thickness)`` with its TrueType renderer, not with Hershey strokes:
each character is an anti-aliased coverage bitmap (0..255) at a fixed
offset from the pen, the pen moves by a whole number of pixels per
character, and the bitmaps are blended into the image one after another,
``dst = (dst * (255 - a) + color * a + 127) // 255`` per channel.  The
bitmap of a character does not depend on where the pen stands.
``tests/test_torch_draw.py`` holds that model to cv2 on every printable
ASCII character, alone and in strings, at each edge of the image.

This script recovers the model's data from cv2 renders, for each
(scale, thickness) of ``STYLES``: a character drawn white on black at a
known origin is its bitmap (the blend of 255 onto 0 is ``a``), and its
advance is the shift of a following ``'|'`` (whose bitmap is the same
wherever it stands) that reproduces the pair.  It needs cv2 (5.0.0 wrote
the committed module); the port never imports cv2.
"""

import base64
import os.path as osp

import cv2
import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(osp.dirname(osp.dirname(HERE)))
MODULE = osp.join(REPO, "radet_tpu_torch", "utils", "text_glyphs.py")
# (font scale, thickness): the JAX package's 0.5 and 0.45 at thickness 1, and 2
STYLES = ((0.5, 1), (0.45, 1), (0.5, 2), (0.45, 2))
CHARS = [chr(c) for c in range(32, 127)]
CANVAS = (120, 200)  # rows, columns; the origin below leaves room on every side
ORG = (60, 70)  # x, y


def render(text, scale, thickness):
    img = np.zeros(CANVAS, np.uint8)
    cv2.putText(img, text, ORG, cv2.FONT_HERSHEY_SIMPLEX, scale, 255, thickness)
    return img


def blend(dst, alpha):
    """White blended onto ``dst`` with coverage ``alpha``."""
    return ((dst.astype(np.int64) * (255 - alpha) + 255 * alpha + 127) // 255).astype(np.uint8)


def glyph(c, scale, thickness):
    """(dx, dy, bitmap) of ``c`` relative to the origin; (0, 0, 0x0) when
    the character draws nothing."""
    img = render(c, scale, thickness)
    ys, xs = np.nonzero(img)
    if not len(xs):
        return 0, 0, np.zeros((0, 0), np.uint8)
    assert 0 < xs.min() and xs.max() < CANVAS[1] - 1 and 0 < ys.min() and ys.max() < CANVAS[0] - 1
    bitmap = img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return int(xs.min()) - ORG[0], int(ys.min()) - ORG[1], bitmap


def advance(c, scale, thickness):
    """The pen's move over ``c``: the shift of ``'|'`` drawn after it."""
    want = render(c + "|", scale, thickness)
    alone = render(c, scale, thickness).astype(np.int64)
    bar = render("|", scale, thickness).astype(np.int64)
    for shift in range(0, 60):
        if np.array_equal(blend(alone, np.roll(bar, shift, axis=1)), want):
            return shift
    raise AssertionError(f"no advance reproduces {c!r}|")


def main():
    lines = [
        '"""cv2\'s text glyphs, as OpenCV 5 draws ``cv2.putText(img, text, org,',
        "FONT_HERSHEY_SIMPLEX, scale, color, thickness)``: per (scale, thickness) and",
        "printable ASCII character, its pen advance in pixels and its coverage bitmap",
        "(0..255, row-major, base64) at offset (dx, dy) from the pen.  Written by",
        "tests/data/draw/make_glyphs.py from cv2 5.0.0's renders;",
        'tests/test_torch_draw.py holds the drawing to cv2."""',
        "",
        "# {(scale, thickness): {char: (advance, dx, dy, height, width, bitmap)}}",
        "GLYPHS = {",
    ]
    for scale, thickness in STYLES:
        lines.append(f"    ({scale!r}, {thickness}): {{")
        for c in CHARS:
            dx, dy, bitmap = glyph(c, scale, thickness)
            adv = advance(c, scale, thickness)
            data = base64.b64encode(bitmap.tobytes()).decode()
            lines.append(f"        {c!r}: ({adv}, {dx}, {dy}, {bitmap.shape[0]}, {bitmap.shape[1]}, {data!r}),")
        lines.append("    },")
    lines.append("}")
    with open(MODULE, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {MODULE}")


if __name__ == "__main__":
    main()
