"""Module parity between radet_tpu (flax) and radet_tpu_torch, float32:
ResNet-50 trunk, FPN, RADetHead and the whole forward at 64x96 (widths 64,
2 stacked convs, 4 classes), every per-level map within 1e-4; plus the
ported config loader, anchors, TBLR decode and input normalisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.core.anchors import AnchorConfig as JaxAnchorConfig
from radet_tpu.core.anchors import generate_anchors as jax_generate_anchors
from radet_tpu.core.box_coder import tblr_decode as jax_tblr_decode
from radet_tpu.models import build_detector as jax_build_detector
from radet_tpu.models.detector import flatten_head_outputs as jax_flatten
from radet_tpu.models.detector import preprocess_images as jax_preprocess
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.core.anchors import AnchorConfig, generate_anchors
from radet_tpu_torch.core.box_coder import tblr_decode
from radet_tpu_torch.models import build_detector
from radet_tpu_torch.models.detector import flatten_head_outputs, preprocess_images
from radet_tpu_torch.utils.config import Config
from torch_parity import IMG_HW, SMALL_MODEL, TOL, flax_and_port_models
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

FLAGSHIP = "configs/bop/r50_ycbv_pbr.py"


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    jax_model = jax_build_detector(SMALL_MODEL, dtype="float32")
    port = build_detector(SMALL_MODEL, dtype="float32")
    variables = flax_and_port_models(jax_model, port)
    return jax_model, port, variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_maps(port_maps, jax_maps, nchw):
    assert len(port_maps) == len(jax_maps)
    for t, f in zip(port_maps, jax_maps):
        t = t.detach().numpy()
        if nchw:
            t = t.transpose(0, 2, 3, 1)
        f = np.asarray(f)
        assert t.shape == f.shape
        np.testing.assert_allclose(t, f, **TOL)


def test_resnet50_trunk_parity(models):
    jax_model, port, variables = models
    x = np.random.RandomState(1).rand(2, *IMG_HW, 3).astype(np.float32) * 4 - 2
    f = jax_model.apply(variables, jnp.asarray(x), method=lambda m, x: m.backbone(x, train=False))
    with torch.no_grad():
        t = port.backbone(_nchw(x))
    assert [tuple(m.shape[1:3]) for m in f] == [(16, 24), (8, 12), (4, 6), (2, 3)]
    _assert_maps(t, f, nchw=True)


def test_fpn_parity(models):
    jax_model, port, variables = models
    rng = np.random.RandomState(2)
    feats = [
        rng.randn(2, h, w, c).astype(np.float32)
        for (h, w), c in zip([(16, 24), (8, 12), (4, 6), (2, 3)], [256, 512, 1024, 2048])
    ]
    f = jax_model.apply(variables, [jnp.asarray(a) for a in feats], method=lambda m, x: m.neck(x))
    with torch.no_grad():
        t = port.neck([_nchw(a) for a in feats])
    assert [tuple(m.shape[1:3]) for m in f] == [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    _assert_maps(t, f, nchw=True)


def test_fpn_upsample_crops_odd_levels(models):
    """A level that is not twice the one above (5 -> 3): repeat-then-crop,
    as the JAX package, where interpolate(size=...) would pick other rows."""
    jax_model, port, variables = models
    rng = np.random.RandomState(3)
    feats = [
        rng.randn(1, h, w, c).astype(np.float32)
        for (h, w), c in zip([(20, 18), (10, 9), (5, 5), (3, 3)], [256, 512, 1024, 2048])
    ]
    f = jax_model.apply(variables, [jnp.asarray(a) for a in feats], method=lambda m, x: m.neck(x))
    with torch.no_grad():
        t = port.neck([_nchw(a) for a in feats])
    _assert_maps(t, f, nchw=True)


def test_radet_head_parity(models):
    jax_model, port, variables = models
    rng = np.random.RandomState(4)
    pyramid = [rng.randn(2, h, w, 64).astype(np.float32)
               for h, w in [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]]
    f = jax_model.apply(variables, [jnp.asarray(a) for a in pyramid],
                        method=lambda m, x: m.bbox_head(x))
    with torch.no_grad():
        t = port.bbox_head([_nchw(a) for a in pyramid])
    for port_maps, jax_maps in zip(t, f):  # cls, reg, iou: NHWC float32
        assert all(m.dtype == torch.float32 for m in port_maps)
        _assert_maps(port_maps, jax_maps, nchw=False)


def test_detector_forward_and_flatten_parity(models):
    jax_model, port, variables = models
    u8 = np.random.RandomState(5).randint(0, 256, (2, *IMG_HW, 3), dtype=np.uint8)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    x_jax = jax_preprocess(jnp.asarray(u8), mean, std)
    x_port = preprocess_images(torch.from_numpy(u8), mean, std)
    np.testing.assert_allclose(x_port.permute(0, 2, 3, 1).numpy(), np.asarray(x_jax), rtol=1e-6)
    f = jax_model.apply(variables, x_jax, train=False)
    with torch.no_grad():
        t = port(x_port)
    for port_maps, jax_maps in zip(t, f):
        _assert_maps(port_maps, jax_maps, nchw=False)
    for a, b in zip(flatten_head_outputs(*t), jax_flatten(*f)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_config_loader_matches():
    opts = ["model.bbox_head.num_classes=5", "test_cfg.nms.iou_enable=True"]
    assert Config.fromfile(FLAGSHIP, opts).to_dict() == JaxConfig.fromfile(FLAGSHIP, opts).to_dict()


@pytest.mark.parametrize("hw", [(480, 640), (64, 96), (100, 130)])
def test_anchors_match(hw):
    cfg = dict(ratios=[1.0], octave_base_scale=8, scales_per_octave=1, strides=[8, 16, 32, 64, 128])
    ours = generate_anchors(hw, AnchorConfig.from_cfg(cfg))
    ref = jax_generate_anchors(hw, JaxAnchorConfig.from_cfg(cfg))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3]


def test_tblr_decode_matches():
    rng = np.random.RandomState(6)
    anchors = rng.uniform(0, 300, (3, 50, 2)).astype(np.float32)
    anchors = np.concatenate([anchors, anchors + rng.uniform(10, 80, (3, 50, 2))], -1).astype(np.float32)
    tblr = rng.uniform(0, 8, (3, 50, 4)).astype(np.float32)
    hw = np.asarray([[200, 250], [300, 300], [480, 640]], np.float32)
    for max_shape in (None, (hw[:, 0:1], hw[:, 1:2])):
        ref = jax_tblr_decode(
            jnp.asarray(anchors), jnp.asarray(tblr),
            max_shape=None if max_shape is None else tuple(map(jnp.asarray, max_shape)),
        )
        ours = tblr_decode(
            torch.from_numpy(anchors), torch.from_numpy(tblr),
            max_shape=None if max_shape is None else tuple(map(torch.from_numpy, max_shape)),
        )
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
