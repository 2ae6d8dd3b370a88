"""TIFF reading in the port (ROADMAP item 20) against cv2 5.0.0 and the JAX
package on the CPU: ``image_io.imread`` and ``imdecode`` give
``cv2.imread``'s pixels bit for bit under IMREAD_UNCHANGED, IMREAD_COLOR
(RGB here, BGR there) and IMREAD_GRAYSCALE, for files that cv2 and Pillow
write at test time (compression 1, 5, 8, 32773; gray, gray + alpha, RGB,
RGBA; 8 and 16 bits) and that ``synthetic_bop.tiff_bytes`` writes (tiles,
big-endian files, the horizontal predictor, ExtraSamples), and for the
committed fixtures ``tests/data/tiff``; the C++ decompressors equal their
Python twins; other variants raise naming item 19; and the test CLI on
``configs/bop/r50_itodd_pbr.py`` over a gray-TIFF test split gives the JAX
package's detections and BOP json."""

import hashlib
import json
import os.path as osp
import pickle
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.test import test_from_config as jax_test_from_config
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import build_model_and_anchors
from radet_tpu_torch.data import image_io, tiff
from radet_tpu_torch.engine.checkpoint import save_weights
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import _lzw, tiff_bytes, write_bop_test_set
from torch_parity import IMG_HW, NARROW, flax_and_port_models
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)  # libtiff's warnings on cv2's own RGBA files

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURES = osp.join(REPO, "tests", "data", "tiff")
ITODD = osp.join(REPO, "configs", "bop", "r50_itodd_pbr.py")
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)


def _assert_reads_as_cv2(path: str, what: str = "") -> None:
    """imread and imdecode equal cv2.imread under every flag, bit for bit
    (shape and dtype included), COLOR's channels reversed."""
    with open(path, "rb") as f:
        data = f.read()
    for flag in FLAGS:
        want = cv2.imread(path, flag)
        assert want is not None, (what, flag)
        for got in (image_io.imread(path, flag), image_io.imdecode(data, flag)):
            if flag == cv2.IMREAD_COLOR:
                got = got[..., ::-1]
            assert got.dtype == want.dtype and got.shape == want.shape, (what, flag, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=f"{what} flag {flag}")


def _noise(rng, shape, dtype):
    """Noise with a flat run and a ramp: LZW, PackBits and the predictor
    meet repeats and small differences."""
    top = 256 if dtype == np.uint8 else 65536
    img = rng.randint(0, top, shape).astype(dtype)
    img[:, : shape[1] // 3] = img[:, :1]
    img[shape[0] // 2:] = (np.arange(shape[1]) * (top // shape[1])).astype(dtype).reshape(
        (1, shape[1]) + (1,) * (len(shape) - 2))
    return img


LAYOUTS = {  # cv2.imwrite's channel layouts: gray, BGR, BGRA, at 8 and 16 bits
    "gray8": ((37, 53), np.uint8), "bgr8": ((37, 53, 3), np.uint8), "bgra8": ((29, 41, 4), np.uint8),
    "gray16": ((37, 53), np.uint16), "bgr16": ((23, 31, 3), np.uint16), "bgra16": ((23, 31, 4), np.uint16),
}


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_cv2_written_tiffs_read_as_cv2(tmp_path, compression):
    """Every layout cv2 writes, with ``IMWRITE_TIFF_COMPRESSION`` 1 (none),
    5 (LZW), 8 (Deflate) and 32773 (PackBits), and for LZW and Deflate also
    with the horizontal predictor and 5-row strips."""
    rng = np.random.RandomState(compression)
    for name, (shape, dtype) in LAYOUTS.items():
        img = _noise(rng, shape, dtype)
        params = [[cv2.IMWRITE_TIFF_COMPRESSION, compression]]
        if compression in (5, 8):
            params.append(params[0] + [cv2.IMWRITE_TIFF_PREDICTOR, 2, cv2.IMWRITE_TIFF_ROWSPERSTRIP, 5])
        for i, p in enumerate(params):
            path = str(tmp_path / f"{name}_{i}.tif")
            assert cv2.imwrite(path, img, p)
            _assert_reads_as_cv2(path, f"cv2 {name} {p}")
            np.testing.assert_array_equal(image_io.imread(path, cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_pillow_written_tiffs_read_as_cv2(tmp_path, mode):
    """Pillow's files (its RGBA and LA carry ExtraSamples 2, unassociated
    alpha, which libtiff premultiplies for cv2) under each compression
    Pillow writes."""
    rng = np.random.RandomState(len(mode))
    shape = {"L": (31, 45), "LA": (31, 45, 2), "RGB": (31, 45, 3), "RGBA": (31, 45, 4), "I;16": (31, 45)}[mode]
    img = _noise(rng, shape, np.uint16 if mode == "I;16" else np.uint8)
    im = Image.fromarray(img) if mode == "I;16" else Image.fromarray(img, mode)
    for compression in (None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"):
        path = str(tmp_path / f"{compression}.tif")
        im.save(path, compression=compression)
        _assert_reads_as_cv2(path, f"Pillow {mode} {compression}")


def _writer_cases():
    """(shape, dtype, tiff_bytes options) over tiles, byte orders, the
    predictor, compressions and ExtraSamples."""
    rng = np.random.RandomState(3)
    cases = []
    for i in range(48):
        spp, dtype = (1, 2, 3, 4)[i % 4], (np.uint8, np.uint16)[(i // 4) % 2]
        h, w = (int(v) for v in rng.randint(1, 60, 2))
        tile = (16, 32) if i % 3 == 0 else None
        if tile and spp <= 2 and (dtype == np.uint16 or spp == 2):
            w = 48  # whole tiles across (a clipped one raises: test_other_variants_raise)
        cases.append(((h, w, spp), dtype, dict(
            compression=(1, 5, 8, 32946)[(i // 2) % 4], predictor=(1, 2)[(i // 8) % 2], big_endian=i % 5 == 0,
            tile=tile, rows_per_strip=None if i % 7 else 3,
            extra_samples=(None, 0, 1, 2)[(i // 3) % 4] if spp in (2, 4) else None)))
    return cases


@pytest.mark.parametrize("case", range(0, 48, 8))
def test_tiles_byte_orders_and_predictor_read_as_cv2(tmp_path, case):
    """Eight files each of ``tiff_bytes``: strips (3 rows, or 8 KiB) and
    16x32 tiles past either edge, either byte order, the predictor on 8-
    and 16-bit samples, LZW, both Deflate codes, uncompressed, every
    ExtraSamples value."""
    rng = np.random.RandomState(case)
    for shape, dtype, kw in _writer_cases()[case:case + 8]:
        img = _noise(rng, shape, dtype)
        path = str(tmp_path / "w.tif")
        with open(path, "wb") as f:
            f.write(tiff_bytes(img[..., 0] if shape[2] == 1 else img, **kw))
        _assert_reads_as_cv2(path, f"tiff_bytes {shape} {dtype.__name__} {kw}")


def test_committed_fixtures_match_cv2():
    """The committed fixtures (tiles, big-endian, the predictor, an ITODD-like
    gray Deflate file): cv2 here gives the recorded hashes, and so does the
    port (which the card's machine, without cv2, checks against them)."""
    with open(osp.join(FIXTURES, "hashes.json")) as f:
        recorded = json.load(f)
    assert len(recorded["files"]) == 6
    for name, reads in recorded["files"].items():
        path = osp.join(FIXTURES, name)
        _assert_reads_as_cv2(path, name)
        for flag, want in reads.items():
            px = cv2.imread(path, recorded["flags"][flag])
            got = image_io.imread(path, recorded["flags"][flag])
            got = got[..., ::-1] if flag == "color" else got
            for a in (px, got):
                assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() == want["sha256"], (name, flag)
                assert list(a.shape) == want["shape"] and str(a.dtype) == want["dtype"], (name, flag)


def test_decompressors_equal_their_twins():
    """LZW (the code width at its early changes, a Clear when the table
    fills, a KwKwK code) and PackBits, C++ against Python, and against the
    streams' sources."""
    rng = np.random.RandomState(0)
    for n, top in ((1, 256), (700, 2), (5000, 256), (40000, 3), (9000, 256)):
        raw = rng.randint(0, top, n).astype(np.uint8).tobytes()
        enc = _lzw(raw)
        assert tiff.lzw(enc, len(raw)) == tiff.lzw_plain(enc, len(raw)) == raw
        assert tiff.lzw(enc, 10) == raw[:10]
    assert tiff.lzw(_lzw(b"aaaaaaa"), 7) == b"aaaaaaa"  # the KwKwK case
    runs = bytes([2, 1, 2, 3, 0xFE, 9, 0x80, 0, 7, 0x81, 4])  # literal 3, repeat 3, no-op, literal 1, repeat 128
    want = bytes([1, 2, 3, 9, 9, 9, 7]) + bytes([4]) * 128
    assert tiff.packbits(runs, 200) == tiff.packbits_plain(runs, 200) == want
    for bad in (bytes([5, 1, 2]), bytes([0xFE])):
        for fn in (tiff.packbits, tiff.packbits_plain):
            with pytest.raises(ValueError, match="PackBits"):
                fn(bad, 10)
    for fn in (tiff.lzw, tiff.lzw_plain):
        with pytest.raises(ValueError, match="LZW"):
            fn(bytes([0x80, 0x5F, 0xF0]), 10)  # Clear, then a code past the table


def _patch_tag(data: bytes, tag: int, value: int) -> bytes:
    """``data`` (little-endian, from tiff_bytes) with SHORT tag ``tag`` set
    to ``value``."""
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", out[4:8])
    (n,) = struct.unpack("<H", out[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", out[at:at + 2])[0] == tag:
            out[at + 8:at + 10] = struct.pack("<H", value)
            return bytes(out)
    raise KeyError(tag)


def test_other_variants_raise_item_19(tmp_path):
    """What is not decoded raises NotImplementedError naming ROADMAP item
    19: JPEG-in-TIFF, CCITT, float samples, palette, bit depths below 8,
    planar 2, MinIsWhite, CMYK, YCbCr, BigTIFF, another orientation, and gray with 16 bits or alpha in tiles past the right
    edge (cv2 leaves those tiles' rows unread); a corrupt file raises
    ValueError."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    files = {}
    cv2.imwrite(str(tmp_path / "jpeg.tif"), img, [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    cv2.imwrite(str(tmp_path / "float.tif"), img.astype(np.float32))
    Image.fromarray(img).convert("P").save(tmp_path / "palette.tif")
    Image.fromarray(img[..., 0] > 128).save(tmp_path / "bilevel.tif")
    Image.fromarray(img[..., 0] > 128).save(tmp_path / "ccitt.tif", compression="group4")
    Image.fromarray(img).convert("CMYK").save(tmp_path / "cmyk.tif")
    Image.fromarray(img).convert("YCbCr").save(tmp_path / "ycbcr.tif")
    gray = tiff_bytes(img[..., 0], compression=1)
    files["minisWhite"] = _patch_tag(gray, 262, 0)
    files["planar2"] = _patch_tag(tiff_bytes(img, compression=1), 284, 2)
    files["bigtiff"] = b"II+\x00" + gray[4:]
    files["clipped gray16 tiles"] = tiff_bytes(rng.randint(0, 65536, (20, 30)).astype(np.uint16), tile=(16, 16))
    for name in ("jpeg", "float", "palette", "bilevel", "ccitt", "cmyk", "ycbcr"):
        files[name] = (tmp_path / f"{name}.tif").read_bytes()
    # an Orientation tag of 3: the same file with one more entry
    (ifd,) = struct.unpack("<I", gray[4:8])
    (n,) = struct.unpack("<H", gray[ifd:ifd + 2])
    entries = gray[ifd + 2:ifd + 2 + 12 * n] + struct.pack("<HHIHH", 274, 3, 1, 3, 0)
    files["orientation"] = gray[:ifd] + struct.pack("<H", n + 1) + entries + b"\0\0\0\0"
    for name, data in files.items():
        with pytest.raises(NotImplementedError, match="item 19") as err:
            image_io.imdecode(data, cv2.IMREAD_COLOR)
        assert "TIFF" in str(err.value), name
    # a page after the first: cv2.imread and the port read the first
    two = tmp_path / "two.tif"
    Image.fromarray(img).save(two, save_all=True, append_images=[Image.fromarray(img[::-1].copy())])
    _assert_reads_as_cv2(str(two), "two pages")
    corrupt = bytearray(tiff_bytes(img, compression=8))
    corrupt[20:60] = bytes(40)
    with pytest.raises(ValueError, match="TIFF"):
        image_io.imdecode(bytes(corrupt), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="not a TIFF"):
        image_io.imdecode(b"II\x00\x00rest", cv2.IMREAD_COLOR)


def test_imread_rgb_of_a_gray_itodd_image_matches_jax(tmp_path):
    """An ITODD-sized test image (1280x960 8-bit gray): the port's
    ``imread_rgb`` equals the JAX package's (cv2) RGB, gray replicated."""
    import radet_tpu.data.pipeline as jax_pipeline

    img = _noise(np.random.RandomState(5), (960, 1280), np.uint8)
    path = str(tmp_path / "000001.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(img))
    got = image_io.imread_rgb(path)
    np.testing.assert_array_equal(got, jax_pipeline.imread_rgb(path))
    np.testing.assert_array_equal(got, np.repeat(img[..., None], 3, 2))


# ----------------------------------------------------------- the ITODD test CLI


def test_itodd_strict_test_cli_matches_jax(tmp_path, capsys):
    """``tools.test`` on ``configs/bop/r50_itodd_pbr.py`` (28 classes,
    ``bop_submission=True``) over a synthetic ITODD-layout test split of
    gray TIFFs, at the narrow parity widths with the same weights as the
    JAX package's ``test_from_config``: per image the same kept labels,
    boxes within 1e-3 px and scores within 1e-6; the BOP json entry for
    entry (scene, image and category ids equal; bbox and score as the
    detections); metrics within 1e-6."""
    root = str(tmp_path / "itodd")
    ann = write_bop_test_set(root, np.random.RandomState(0), [(3, (96, 128)), (2, IMG_HW)],
                             [str(i + 1) for i in range(28)], tiff_gray=True)
    opts = NARROW + ["model.bbox_head.num_classes=28", "data.samples_per_gpu=2", f"data.test.ann_file={ann!r}",
                     f"data.test.img_prefix={osp.join(root, 'test') + '/'!r}",
                     f"data.test.pipeline.1.img_scale={IMG_HW[::-1]}"]
    jax_cfg, cfg = JaxConfig.fromfile(ITODD, opts), Config.fromfile(ITODD, opts)
    port = build_model_and_anchors(cfg)[0]
    variables = flax_and_port_models(jax_build_model_and_anchors(jax_cfg)[0], port)
    ckpt = str(tmp_path / "w.pth")
    save_weights(ckpt, port.state_dict())
    _, ref, ref_metrics = jax_test_from_config(jax_cfg, variables)
    ref_bop = jax_build_dataset(jax_cfg, "test").bop_det2json(ref)

    prefix = str(tmp_path / "out")
    test_cli.main([ITODD, ckpt, "--device", "cpu", "--eval", "bbox", "--json-prefix", prefix,
                   "--out", str(tmp_path / "r.pkl"), "--cfg-options", *opts])
    with open(tmp_path / "r.pkl", "rb") as f:
        got = pickle.load(f)
    with open(prefix + ".bop.json") as f:
        bop = json.load(f)
    metrics = json.loads(capsys.readouterr().out)
    assert [r["img_id"] for r in got] == [r["img_id"] for r in ref] and len(got) == 5
    assert sum(len(r["labels"]) for r in got) > 50
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0, atol=1e-6)
    assert len(bop) == len(ref_bop) and {d["scene_id"] for d in bop} == {0, 1}
    for d, e in zip(bop, ref_bop):
        assert (d["scene_id"], d["image_id"], d["category_id"], d["time"]) == (
            e["scene_id"], e["image_id"], e["category_id"], e["time"])
        np.testing.assert_allclose(d["bbox"], e["bbox"], rtol=0, atol=2e-3)
        assert abs(d["score"] - e["score"]) <= 1e-6
    assert all(1 <= d["category_id"] <= 28 for d in bop)
    assert metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        assert abs(metrics[k] - ref_metrics[k]) <= 1e-6, k
