"""The port's image reading and test transforms against cv2 and the JAX
package on the CPU: PNG decode byte for byte equal to ``cv2.imread`` (files
written by cv2, and by a writer whose rows cycle through all five PNG
filters), the host C++ unfilter equal to its numpy twin, JPEG decode byte
for byte equal to ``cv2.imread`` (files written by cv2 at several
qualities, samplings, sizes and restart intervals, variants of them, and
the committed fixtures against their recorded hashes), ``Resize`` equal to
``cv2.resize``, and the test pipeline's construction."""

import hashlib
import json
import os.path as osp
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
from synthetic_bop import JPEG_FIXTURES, write_png

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
    cv2.imwrite(str(tmp_path / "a.jpg"), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="item 19"):
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


# --------------------------------------------------------------------- JPEG

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "gray": None}
JPEG_SIZES = [(1, 1), (17, 9), (481, 641), (480, 640)]  # (h, w): odd sizes meet every edge case


def _jpeg_image(h, w, seed):
    """A smooth gradient with a noisy rectangle: blocks of few and of many
    nonzero coefficients."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + 2 * y) % 256], -1)
    img[h // 4:h // 4 + h // 2 + 1, w // 3:w // 3 + w // 2 + 1] = rng.randint(0, 256, 3)
    img[: h // 3, : w // 3 + 1] = rng.randint(0, 256, (h // 3, w // 3 + 1, 3))
    return img.astype(np.uint8)


def _assert_decodes_as_cv2(path, flags=(IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED)):
    for flag in flags:
        ref = cv2.imread(path, flag)
        if flag == IMREAD_COLOR:
            ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
        got = image_io.imread(path, flag)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (flag, got.shape, ref.shape)
        differ = int((got != ref).sum())
        assert differ == 0, f"flag {flag}: {differ} of {ref.size} bytes differ"


@pytest.mark.parametrize("hw", JPEG_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_jpeg_decode_equals_cv2(tmp_path, quality, sampling, hw):
    img = _jpeg_image(*hw, seed=quality)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling == "gray":
        img = img[..., 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img, params)
    _assert_decodes_as_cv2(path)


def _segments(data):
    """(marker, offset of its 0xFF, segment length) up to SOS."""
    pos, out = 2, []
    while True:
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, pos, length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def _variant(data, name):
    """The same image written otherwise: as SOF1, with 16-bit DQT, as RGB
    components (no JFIF marker, component ids 'R', 'G', 'B'), with an EXIF
    orientation tag."""
    segs = _segments(data)
    if name == "sof1":
        pos = next(p for m, p, _ in segs if m == 0xC0)
        return data[:pos + 1] + b"\xc1" + data[pos + 2:]
    if name == "dqt16":
        out = bytearray(data[:2])
        for m, p, n in segs:
            if m != 0xDB:
                out += data[p:p + 2 + n]
                continue
            body, tables = data[p + 4:p + 2 + n], bytearray()
            for i in range(0, len(body), 65):
                tables += bytes([0x10 | body[i]]) + b"".join(struct.pack(">H", v) for v in body[i + 1:i + 65])
            out += b"\xff\xdb" + struct.pack(">H", len(tables) + 2) + tables
        return bytes(out) + data[segs[-1][1] + 2 + segs[-1][2]:]
    if name == "rgb_ids":
        _, app0, n = next(s for s in segs if s[0] == 0xE0)
        data = bytearray(data[:app0] + data[app0 + 2 + n:])
        segs = _segments(bytes(data))
        sof = next(p for m, p, _ in segs if m == 0xC0)
        sos = segs[-1][1]
        for c, cid in enumerate(b"RGB"):
            data[sof + 10 + 3 * c] = cid
            data[sos + 5 + 2 * c] = cid
        return bytes(data)
    orientation = int(name[len("exif"):])
    tiff = b"II*\x00" + struct.pack("<IH", 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + bytes(4)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("case", ["rst1_444", "rst2_422", "rst7_420", "rst3_gray", "optimized", "luma30_chroma95",
                                  "sof1", "dqt16", "rgb_ids", "exif1"])
def test_jpeg_variants_decode_equal_to_cv2(tmp_path, case):
    """Restart intervals (DC predictors reset, byte-aligned), optimized
    Huffman tables, differing luma and chroma tables, and the rewritten
    files of :func:`_variant`."""
    img = _jpeg_image(37, 53, seed=4)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if case.startswith("rst"):
        interval, sampling = case[3:].split("_")
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(interval)]
        if sampling == "gray":
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    elif case == "optimized":
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    elif case == "luma30_chroma95":
        params += [cv2.IMWRITE_JPEG_LUMA_QUALITY, 30, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 95]
    ok, buf = cv2.imencode(".jpg", img, params)
    data = buf.tobytes()
    if case in ("sof1", "dqt16", "rgb_ids", "exif1"):
        data = _variant(data, case)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    # cv2 converts an RGB JPEG to gray with its own weights; the port raises
    flags = (IMREAD_COLOR, IMREAD_UNCHANGED) if case == "rgb_ids" else (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                                         IMREAD_UNCHANGED)
    _assert_decodes_as_cv2(str(path), flags)
    if case == "rgb_ids":
        with pytest.raises(NotImplementedError, match="item 19"):
            image_io.imread(str(path), IMREAD_GRAYSCALE)


@pytest.mark.parametrize("case", ["progressive", "exif6", "411", "440"])
def test_unsupported_jpeg_raises(tmp_path, case):
    """Progressive files, an EXIF orientation cv2 would turn the image by,
    and 4:1:1 / 4:4:0 sampling raise naming ROADMAP item 19; the EXIF-turned
    file still reads with ``IMREAD_UNCHANGED``, which cv2 does not turn."""
    img = _jpeg_image(40, 56, seed=5)
    params = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
              "440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]}.get(case, [])
    data = cv2.imencode(".jpg", img, params)[1].tobytes()
    if case == "exif6":
        data = _variant(data, case)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for flag in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        with pytest.raises(NotImplementedError, match="item 19"):
            image_io.imread(path, flag)
    if case == "exif6":
        assert cv2.imread(path).shape[:2] == (56, 40)  # cv2 turned it
        _assert_decodes_as_cv2(path, (IMREAD_UNCHANGED,))


def test_corrupt_jpeg_raises():
    data = cv2.imencode(".jpg", _jpeg_image(40, 56, seed=6))[1].tobytes()
    for bad in (data[:100], data[:2] + b"\xff\xc4\x00\x05\x00", b"\xff\xd8\xff\xd9"):
        with pytest.raises(ValueError, match="corrupt JPEG"):
            image_io.decode_jpeg(bad)


with open(osp.join(JPEG_FIXTURES, "hashes.json")) as _f:
    FIXTURE_HASHES = json.load(_f)


@pytest.mark.parametrize("name", sorted(FIXTURE_HASHES))
def test_committed_jpeg_fixtures_match_their_hashes(name):
    """The files the card's machine (without cv2) holds its build to: cv2's
    decode here gives the recorded hashes, and so does the port's."""
    path, want = osp.join(JPEG_FIXTURES, name), FIXTURE_HASHES[name]
    ref_rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    ref_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    for img, key in ((ref_rgb, "rgb_sha256"), (ref_gray, "gray_sha256"),
                     (image_io.imread(path, IMREAD_COLOR), "rgb_sha256"),
                     (image_io.imread(path, IMREAD_GRAYSCALE), "gray_sha256")):
        assert hashlib.sha256(img.tobytes()).hexdigest() == want[key], key
    assert list(ref_rgb.shape) == want["shape"] == [480, 640, 3]


# ----------------------------------------------------------------- imdecode


def _cv2_imdecode(data, flag):
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    return ref[..., ::-1] if flag == IMREAD_COLOR else ref  # the port gives RGB


@pytest.mark.parametrize("flag", sorted(IMREAD))
@pytest.mark.parametrize("name", sorted(_images()))
def test_imdecode_png_equals_cv2(png_files, name, flag):
    with open(png_files[name], "rb") as f:
        data = f.read()
    ref = _cv2_imdecode(data, IMREAD[flag])
    if flag == "gray" and _images()[name][1].ndim == 3:
        with pytest.raises(NotImplementedError, match="item 19"):
            image_io.imdecode(data, IMREAD[flag])
        return
    for given in (data, bytearray(data), np.frombuffer(data, np.uint8)):
        got = image_io.imdecode(given, IMREAD[flag])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("flag", sorted(IMREAD))
@pytest.mark.parametrize("name", sorted(FIXTURE_HASHES))
def test_imdecode_jpeg_fixtures_equal_cv2(name, flag):
    with open(osp.join(JPEG_FIXTURES, name), "rb") as f:
        data = f.read()
    ref = _cv2_imdecode(data, IMREAD[flag])
    got = image_io.imdecode(data, IMREAD[flag])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_imdecode_raises_where_cv2_gives_none_or_turns():
    """Bytes cv2.imdecode cannot decode raise ValueError, without naming a
    file; a variant the port does not decode raises NotImplementedError."""
    for bad in (b"", b"not-an-image", _PNG_SIGNATURE_ONLY, b"\xff\xd8\xff\xd9"):
        if bad:
            assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="PNG|JPEG"):
            image_io.imdecode(bad)
    img = _jpeg_image(40, 56, seed=7)
    data = _variant(cv2.imencode(".jpg", img)[1].tobytes(), "exif6")
    with pytest.raises(NotImplementedError, match="image bytes: EXIF orientation 6"):
        image_io.imdecode(data)
    progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(NotImplementedError, match="item 19"):
        image_io.imdecode(progressive)


_PNG_SIGNATURE_ONLY = b"\x89PNG\r\n\x1a\n"


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
    entries = [dict(type="LoadAnnotations", with_bbox=True), dict(type="CosyPoseAug")]
    assert [type(t).__name__ for t in build_pipeline(entries).transforms] == [
        type(t).__name__ for t in jax_pipeline.build_pipeline(entries).transforms] == ["LoadAnnotations",
                                                                                      "CosyPoseAug"]
