"""The port's image reading and test transforms against cv2 and the JAX
package on the CPU: PNG decode byte for byte equal to ``cv2.imread`` (files
written by cv2, and by a writer whose rows cycle through all five PNG
filters), the host C++ unfilter equal to its numpy twin, ``Resize`` equal
to ``cv2.resize``, and the test pipeline's construction."""

import struct
import zlib

import cv2
import numpy as np
import pytest

import radet_tpu.data.pipeline as jax_pipeline
from radet_tpu_torch.data import image_io
from radet_tpu_torch.data.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED
from radet_tpu_torch.data.pipeline import (
    LoadImageFromFile,
    Pad,
    Resize,
    build_pipeline,
    resize_linear,
    resize_nearest,
)
from synthetic_bop import write_png

IMREAD = {"color": IMREAD_COLOR, "gray": IMREAD_GRAYSCALE, "unchanged": IMREAD_UNCHANGED}


def _images():
    rng = np.random.RandomState(0)
    mask = np.zeros((41, 67), np.uint8)
    mask[5:30, 10:50] = 255
    smooth = (np.add.outer(np.arange(40), np.arange(56))[..., None] * [1, 2, 3] % 256).astype(np.uint8)
    return {
        "cv2_rgb": ("cv2", rng.randint(0, 256, (37, 53, 3), np.uint8)),
        "cv2_smooth_rgb": ("cv2", smooth),  # libpng picks other filters on smooth content
        "cv2_gray": ("cv2", rng.randint(0, 256, (29, 31), np.uint8)),
        "cv2_rgba": ("cv2", rng.randint(0, 256, (23, 19, 4), np.uint8)),
        "cv2_rgb16": ("cv2", rng.randint(0, 65536, (17, 21, 3)).astype(np.uint16)),
        "cv2_gray16": ("cv2", rng.randint(0, 65536, (17, 21)).astype(np.uint16)),
        "cv2_mask": ("cv2", mask),
        "cycle_rgb": ("cycle", rng.randint(0, 256, (45, 61, 3), np.uint8)),
        "cycle_smooth_rgb": ("cycle", smooth),
        "cycle_gray": ("cycle", rng.randint(0, 256, (25, 33), np.uint8)),
        "cycle_rgba": ("cycle", rng.randint(0, 256, (15, 9, 4), np.uint8)),
    }


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    paths = {}
    for name, (writer, img) in _images().items():
        paths[name] = str(root / f"{name}.png")
        if writer == "cv2":
            assert cv2.imwrite(paths[name], img)
        else:
            write_png(paths[name], img)
    return paths


@pytest.mark.parametrize("flag", sorted(IMREAD))
@pytest.mark.parametrize("name", sorted(_images()))
def test_png_decode_equals_cv2(png_files, name, flag):
    path = png_files[name]
    ref = cv2.imread(path, IMREAD[flag])
    if flag == "gray" and ref.ndim == 2 and _images()[name][1].ndim == 3:
        # cv2 converts color to gray with its own weights; the port raises
        with pytest.raises(NotImplementedError, match="item 19"):
            image_io.imread(path, IMREAD[flag])
        return
    got = image_io.imread(path, IMREAD[flag])
    if flag == "color":
        ref = ref[..., ::-1]  # the port gives RGB, as radet_tpu's imread_rgb
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(_images()))
def test_cpp_unfilter_equals_numpy_twin(png_files, name):
    with open(png_files[name], "rb") as f:
        data = f.read()
    a = image_io.decode_png(data)
    b = image_io.decode_png(data, image_io.unfilter_plain)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_cycling_writer_uses_every_filter(png_files):
    with open(png_files["cycle_rgb"], "rb") as f:
        data = f.read()
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = zlib.decompress(data[41:41 + n])
    stride = 61 * 3 + 1
    assert sorted({raw[y * stride] for y in range(45)}) == [0, 1, 2, 3, 4]


def _png_bytes(img, interlace=0):
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def test_unread_files_raise(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (8, 10, 3), np.uint8)
    with pytest.raises(FileNotFoundError):
        image_io.imread_rgb(str(tmp_path / "missing.png"))
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    with pytest.raises(NotImplementedError, match="item 7"):
        image_io.imread_rgb(str(tmp_path / "a.jpg"))
    cv2.imwrite(str(tmp_path / "a.tif"), img)
    with pytest.raises(NotImplementedError, match="item 20"):
        image_io.imread_rgb(str(tmp_path / "a.tif"))
    (tmp_path / "adam7.png").write_bytes(_png_bytes(img, interlace=1))
    with pytest.raises(NotImplementedError, match="item 19"):
        image_io.imread_rgb(str(tmp_path / "adam7.png"))
    good = _png_bytes(img)
    (tmp_path / "good.png").write_bytes(good)
    np.testing.assert_array_equal(image_io.imread_rgb(str(tmp_path / "good.png")), img)
    corrupt = bytearray(good)
    corrupt[-20] ^= 1  # a byte of the IDAT data: its CRC no longer holds
    (tmp_path / "crc.png").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="CRC"):
        image_io.imread_rgb(str(tmp_path / "crc.png"))
    raw = np.frombuffer(zlib.decompress(good[41:-16]), np.uint8).copy()
    raw[0] = 7  # no such filter type
    for fn in (image_io.unfilter, image_io.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 7"):
            fn(raw, 8, 30, 3)


# ------------------------------------------------------------------- Resize

RESIZES = {  # (source h, w) -> the flagship test Resize's (w, h) scale
    "tless_720x540": (540, 720),
    "downscale_2x": (960, 1280),
    "upscale_2x": (240, 320),
    "identity": (480, 640),
    "odd": (333, 517),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_equals_cv2(case):
    """Resize into (640, 480) against cv2.INTER_LINEAR / INTER_NEAREST and
    the JAX package's cv2-backed Resize.  Differing pixels: 0 in every case
    (the bound this port holds itself to; a float bilinear is off by 1 on a
    large share of them)."""
    h0, w0 = RESIZES[case]
    rng = np.random.RandomState(h0)
    img = rng.randint(0, 256, (h0, w0, 3), np.uint8)
    masks = rng.randint(0, 2, (2, h0, w0)).astype(np.uint8)
    boxes = np.asarray([[3.5, 7.0, w0 - 2.0, h0 - 1.0], [0.0, 0.0, 20.0, 30.0]], np.float32)

    def results():
        return dict(img=img.copy(), img_shape=(h0, w0), gt_bboxes=boxes.copy(), gt_masks=masks.copy(),
                    scale_factor=np.ones(4, np.float32))

    ref = jax_pipeline.Resize(img_scale=(640, 480))(results())
    got = Resize(img_scale=(640, 480))(results())
    new_h, new_w = got["img_shape"]
    want = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    differ = int((got["img"] != want).sum())
    assert differ == 0, f"{differ} of {want.size} values differ, by up to " \
                        f"{int(np.abs(got['img'].astype(int) - want).max())}"
    for k in ("img", "img_shape", "scale_factor", "gt_bboxes", "gt_masks"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(resize_nearest(masks[0], (new_w, new_h)),
                                  cv2.resize(masks[0], (new_w, new_h), interpolation=cv2.INTER_NEAREST))


def test_resize_linear_on_odd_targets_equals_cv2():
    rng = np.random.RandomState(5)
    for (h0, w0), (w1, h1) in [((37, 53), (32, 16)), ((100, 100), (336, 80)), ((64, 96), (48, 32))]:
        img = rng.randint(0, 256, (h0, w0, 3), np.uint8)
        np.testing.assert_array_equal(resize_linear(img, (w1, h1)),
                                      cv2.resize(img, (w1, h1), interpolation=cv2.INTER_LINEAR))


# ------------------------------------------------------ the test pipeline


def test_load_image_from_file_matches_jax(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (30, 40, 3), np.uint8)
    write_png(str(tmp_path / "x.png"), img)
    base = dict(img_prefix=str(tmp_path), img_info=dict(filename="x.png"))
    ref = jax_pipeline.LoadImageFromFile()(dict(base))
    got = LoadImageFromFile()(dict(base))
    for k in ("img", "img_shape", "ori_shape", "scale_factor"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["img"], img)


def test_reference_test_pipeline_is_absorbed(tmp_path):
    """The reference test pipeline (Normalize, MultiScaleFlipAug with one
    scale and flip=False, formatting entries) builds to
    LoadImageFromFile -> Resize -> Pad and gives the JAX package's sample."""
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
    cfg = [
        dict(type="LoadImageFromFile"),
        dict(type="MultiScaleFlipAug", img_scale=(64, 48), flip=False, transforms=[
            dict(type="Resize", keep_ratio=True), dict(type="RandomFlip"),
            dict(type="Normalize", to_rgb=True, **norm), dict(type="Pad", size_divisor=16),
            dict(type="ImageToTensor", keys=["img"]), dict(type="Collect", keys=["img"]),
        ]),
        dict(type="DefaultFormatBundle"), dict(type="ToTensor", keys=[]),
    ]
    pipe = build_pipeline(cfg, input_size=(48, 64), img_norm=norm)
    assert [type(t) for t in pipe.transforms] == [LoadImageFromFile, Resize, Pad]
    ref_pipe = jax_pipeline.build_pipeline(cfg, input_size=(48, 64), img_norm=norm)
    img = np.random.RandomState(3).randint(0, 256, (90, 100, 3), np.uint8)
    write_png(str(tmp_path / "x.png"), img)
    base = dict(img_prefix=str(tmp_path), img_info=dict(filename="x.png"))
    got, ref = pipe(dict(base)), ref_pipe(dict(base))
    for k in ("img", "img_shape", "scale_factor", "pad_shape"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    with pytest.raises(ValueError, match="img_norm_cfg"):
        build_pipeline([dict(type="Normalize", mean=[0, 0, 0], std=[1, 1, 1])], img_norm=norm)
    with pytest.raises(ValueError, match="to_rgb"):
        build_pipeline([dict(type="Normalize", to_rgb=False)])
    with pytest.raises(NotImplementedError, match="item 12"):
        build_pipeline([dict(type="MultiScaleFlipAug", img_scale=[(64, 48), (96, 72)], transforms=[])])
    with pytest.raises(NotImplementedError, match="item 7"):
        build_pipeline([dict(type="LoadAnnotations", with_bbox=True)])
