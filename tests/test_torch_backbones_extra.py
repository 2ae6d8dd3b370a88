"""The port's extra backbone families and necks against the JAX package,
float32 on the CPU (``radet_tpu_torch/models/backbones_extra.py``,
``models/fpn.py``).

Every check gives both packages the same seeded numpy inputs and weights
(``torch_parity.numpy_variables``: BN statistics and affines drawn too),
carried across by ``state_dict_from_flax`` and loaded with
``strict=True``; float32 maps agree within ``MAP_RTOL`` (1e-4) of each
map's max abs value:

- the helpers: ``_maxpool_ceil`` against ``F.max_pool2d(ceil_mode=True)``
  and the JAX helper at SSD300's odd sizes; the reflect pad at every size
  against ``jnp.pad``;
- Darknet-53 at full width; HRNet with a tiny stage dict and with
  ``hrnet_w32``; SSDVGG at 300x300; DetectoRS R50-SAC and
  DetectoRS_ResNeXt 32x4d; DetectoRS's ``rfp_feats`` and ``output_img``;
- the FPN's extra-conv sources with and without ``relu_before_extra_convs``;
  the ChannelMapper at kernel 1 and 3, with and without its ReLU;
- the four detector compositions (Darknet + FPN from C3, HRNet + FPN
  ``on_lateral`` with ReLUs, DetectoRS-SAC + the flagship's FPN, SSD300 +
  ChannelMapper on six levels) with a narrow neck and head: the head maps,
  and the inference step's detections (vote-NMS's plain version on the
  CPU) against the JAX inference step's;
- the builder's errors, as the JAX builder's;
- ``--fuse-conv-bn``'s fold: Darknet every BatchNorm (as JAX's fold, bit
  for bit), DetectoRS with SAC's BatchNorms left in place; the fused trunk
  computes what the unfused one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radet_tpu.engine.train_step import build_infer_step as jax_build_infer_step
from radet_tpu.models import backbones_extra as jbx
from radet_tpu.models import build_detector as jax_build_detector
from radet_tpu.models import fpn as jfpn
from radet_tpu.models.fuse import fuse_conv_bn as jax_fuse_conv_bn
from radet_tpu_torch.engine.convert import state_dict_from_flax
from radet_tpu_torch.engine.infer_step import build_infer_step
from radet_tpu_torch.models import backbones_extra as pbx
from radet_tpu_torch.models import build_backbone, build_detector
from radet_tpu_torch.models.fpn import FPN, ChannelMapper
from radet_tpu_torch.models.fuse import fuse_conv_bn
from torch_parity import FLAGSHIP, NARROW, SERVE_TEST_CFG, config_pair, numpy_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

MAP_RTOL = 1e-4  # of each map's max abs value, float32
FUSE_RTOL = 1e-5  # fused vs unfused trunk, of each map's max

# tests/test_backbones_extra.py's stage dict
TINY_HRNET = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK", num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC", num_blocks=(1, 1), num_channels=(4, 8)),
    stage3=dict(num_modules=2, num_branches=3, block="BASIC", num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC", num_blocks=(1, 1, 1, 1),
                num_channels=(4, 8, 16, 32)),
)


def _nest(tree, path):
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _carry(flax_module, port_module, init_args, where, **init_kw):
    """Seeded numpy variables of ``flax_module`` (initialised on
    ``init_args``); the port module loads them placed ``where`` (a flax
    path and its state dict prefix) in a detector tree, strictly.  Returns
    the variables."""
    path, prefix = where
    variables = numpy_variables(lambda: flax_module.init(jax.random.PRNGKey(0), *init_args, **init_kw))
    sd = state_dict_from_flax({col: _nest(tree, path) for col, tree in variables.items()})
    port_module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    port_module.eval()
    return variables


def _jax_apply(module, variables, *args, jit=True, **kw):
    """``module.apply``, jitted: one XLA compile of a trunk takes a few
    seconds, its eager dispatch op by op several times that (but for
    HRNet-w32, whose many small branches compile slower than they run)."""
    if not jit:
        return module.apply(variables, *args, **kw)
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


BACKBONE = (("backbone",), "backbone.")
NECK = (("neck",), "neck.")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_maps_close(port_maps, jax_maps, rtol=MAP_RTOL):
    """NCHW port maps against NHWC JAX maps, each within ``rtol`` of its max abs."""
    assert len(port_maps) == len(jax_maps)
    for i, (t, f) in enumerate(zip(port_maps, jax_maps)):
        t, f = t.detach().numpy().transpose(0, 2, 3, 1), np.asarray(f)
        assert t.shape == f.shape, (i, t.shape, f.shape)
        err = np.abs(t - f).max() / max(np.abs(f).max(), 1e-30)
        assert err <= rtol, f"map {i}: error {err:.3g} of its max abs (limit {rtol})"


@pytest.mark.parametrize("hw", [(75, 75), (19, 19), (5, 5), (75, 19), (1, 3)])
def test_maxpool_ceil_matches_torch_and_jax(hw, rng):
    """SSD300's odd sizes (75 -> 38, 19 -> 10, 5 -> 3), and a map below the kernel."""
    x = rng.randn(2, 3, *hw).astype(np.float32)
    got = pbx._maxpool_ceil(torch.from_numpy(x), 2, 2)
    ref = np.asarray(jbx._maxpool_ceil(jnp.asarray(x.transpose(0, 2, 3, 1)), 2, 2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    if min(hw) >= 2:
        assert torch.equal(got, F.max_pool2d(torch.from_numpy(x), 2, 2, ceil_mode=True))


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (3, 5), (8, 6)])
def test_reflect_pad_and_upsample_match_jax(hw, rng):
    """SAC's reflect pad by 2 at maps smaller than the pad (numpy reflects
    again), and HRNet's nearest upsample."""
    x = rng.randn(1, 2, *hw).astype(np.float32)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    ref = np.asarray(jnp.pad(nhwc, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect")).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(pbx._reflect_pad(torch.from_numpy(x), 2).numpy(), ref)
    ref = np.asarray(jbx._upsample_nearest(nhwc, 4)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(pbx._upsample_nearest(torch.from_numpy(x), 4).numpy(), ref)


def test_presets_and_layouts_match_jax():
    assert pbx.HRNET_PRESETS == jbx.HRNET_PRESETS and pbx.DARKNET_ARCH == jbx.DARKNET_ARCH
    for depth in (11, 13, 16, 19):
        assert pbx.vgg_feature_layout(depth) == jbx.vgg_feature_layout(depth)
    for size in (300, 512):
        assert pbx.ssd_extra_layout(size) == jbx.ssd_extra_layout(size)


# name -> (the port's backbone config, the JAX module the JAX builder makes of it, input hw)
TRUNKS = {
    "Darknet-53": (dict(type="Darknet", depth=53), jbx.Darknet(), (64, 64)),
    "HRNet-tiny": (dict(type="HRNet", extra=TINY_HRNET), jbx.HRNet(extra=jbx.freeze_cfg(TINY_HRNET)), (68, 84)),
    "HRNet-w32": (dict(type="HRNet", extra="hrnet_w32"), jbx.HRNet(extra="hrnet_w32"), (64, 64)),
    "SSDVGG-300": (dict(type="SSDVGG", input_size=300, depth=16), jbx.SSDVGG(), (300, 300)),
    "DetectoRS-R50-SAC": (dict(type="DetectoRS_ResNet", depth=50, sac=dict(type="SAC"), frozen_stages=1),
                          jbx.DetectoRSResNet(stage_with_sac=(False, True, True, True)), (64, 64)),
    "DetectoRS-X50-32x4d-SAC": (
        dict(type="DetectoRS_ResNeXt", depth=50, groups=32, base_width=4, sac=dict(type="SAC")),
        jbx.DetectoRSResNet(stage_with_sac=(False, True, True, True), groups=32, base_width=4), (64, 64)),
}


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_backbone_matches_jax(name, rng):
    cfg, flax_bb, hw = TRUNKS[name]
    port_bb = build_backbone(cfg)
    x = rng.rand(1, *hw, 3).astype(np.float32) * 4 - 2
    variables = _carry(flax_bb, port_bb, (jnp.asarray(x),), BACKBONE, train=False)
    ref = _jax_apply(flax_bb, variables, jnp.asarray(x), jit=name != "HRNet-w32", train=False)
    with torch.no_grad():
        got = port_bb(_nchw(x))
    assert [t.shape[1] for t in got] == port_bb.out_channels == [r.shape[-1] for r in ref]
    assert all(float(t.abs().max()) > 0 for t in got)
    _assert_maps_close(got, ref)


def test_detectors_rfp_feats_and_output_img_match_jax(rng):
    """The recursive-feature-pyramid feed (``rfp_conv`` in stages 2-4's first
    blocks) and the image as the first output."""
    flax_bb = jbx.DetectoRSResNet(stage_with_sac=(False, True, True, True), rfp_inplanes=16, output_img=True)
    port_bb = build_backbone(dict(type="DetectoRS_ResNet", depth=50, sac=dict(type="SAC"), rfp_inplanes=16,
                                  output_img=True))
    x = rng.rand(1, 64, 96, 3).astype(np.float32) * 4 - 2
    rfp = [rng.randn(1, 64 // s, 96 // s, 16).astype(np.float32) for s in (4, 8, 16, 32)]
    variables = _carry(flax_bb, port_bb, (jnp.asarray(x), [jnp.asarray(r) for r in rfp]), BACKBONE, train=False)
    assert "rfp_conv" in variables["params"]["layer2_0"] and "rfp_conv" not in variables["params"]["layer1_0"]
    ref = _jax_apply(flax_bb, variables, jnp.asarray(x), [jnp.asarray(r) for r in rfp], train=False)
    plain = _jax_apply(flax_bb, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_bb(_nchw(x), [_nchw(r) for r in rfp])
        got_plain = port_bb(_nchw(x))
    assert port_bb.out_channels == [3, 256, 512, 1024, 2048]
    _assert_maps_close(got, ref)
    _assert_maps_close(got_plain, plain)
    assert np.abs(np.asarray(ref[2]) - np.asarray(plain[2])).max() > 1e-3  # the feed changes stage 2 on


@pytest.mark.parametrize("relu", [False, True], ids=["no-relu", "relu"])
@pytest.mark.parametrize("source", ["on_input", "on_output", "on_lateral"])
def test_fpn_extra_convs_match_jax(source, relu, rng):
    """Three extra levels, so that a ReLU sits before two of them."""
    widths, hws = [8, 16, 24, 32], [(17, 23), (9, 12), (5, 6), (3, 3)]
    inputs = [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(hws, widths)]
    flax_fpn = jfpn.FPN(out_channels=16, num_outs=6, start_level=1, add_extra_convs=source,
                        relu_before_extra_convs=relu)
    port_fpn = FPN(widths, 16, 6, 1, source, relu)
    variables = _carry(flax_fpn, port_fpn, ([jnp.asarray(x) for x in inputs],), NECK)
    ref = flax_fpn.apply(variables, [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = port_fpn([_nchw(x) for x in inputs])
    _assert_maps_close(got, ref)


@pytest.mark.parametrize("with_relu", [True, False], ids=["relu", "no-relu"])
@pytest.mark.parametrize("kernel", [1, 3])
def test_channel_mapper_matches_jax(kernel, with_relu, rng):
    widths, hws = [12, 20, 8], [(19, 19), (10, 10), (1, 1)]
    inputs = [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(hws, widths)]
    flax_neck = jfpn.ChannelMapper(out_channels=16, kernel_size=kernel, with_relu=with_relu)
    port_neck = ChannelMapper(widths, 16, kernel, with_relu)
    variables = _carry(flax_neck, port_neck, ([jnp.asarray(x) for x in inputs],), NECK)
    assert sorted(port_neck.state_dict()) == [f"convs.{i}.conv.{p}" for i in range(3) for p in ("bias", "weight")]
    ref = flax_neck.apply(variables, [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = port_neck([_nchw(x) for x in inputs])
    _assert_maps_close(got, ref)
    assert (min(float(t.min()) for t in got) >= 0) == with_relu


SSD_LEVELS = [8, 16, 32, 64, 100, 300]
SSD_RANGES = [(-1, 32), (32, 64), (64, 128), (128, 256), (256, 512), (512, 1e8)]
# the compositions of tests/test_backbones_extra.py's builder test, on the
# flagship config with NARROW's neck and head (64 wide, 2 stacked convs, 4 classes)
COMPOSITIONS = {
    "darknet53": ["model.backbone={'type': 'Darknet', 'depth': 53}", "model.neck.start_level=0"],
    "hrnet_tiny": [f"model.backbone={{'type': 'HRNet', 'extra': {TINY_HRNET!r}}}",
                   "model.neck.add_extra_convs='on_lateral'", "model.neck.relu_before_extra_convs=True"],
    "detectors_r50_sac": ["model.backbone={'type': 'DetectoRS_ResNet', 'depth': 50, 'sac': {'type': 'SAC'}, "
                          "'stage_with_sac': (False, True, True, True), 'frozen_stages': 1}"],
    "ssd300_vgg16": ["input_size=(300, 300)", "model.backbone={'type': 'SSDVGG', 'input_size': 300, 'depth': 16}",
                     "model.neck={'type': 'ChannelMapper', 'out_channels': 64, 'kernel_size': 1}",
                     f"model.bbox_head.strides={SSD_LEVELS}", f"model.bbox_head.anchor_generator.strides={SSD_LEVELS}",
                     f"model.bbox_head.anchor_generator.regress_ranges={SSD_RANGES}"],
}


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_detector_composition_matches_jax(name):
    """The head maps of a normalized batch, then the inference step on uint8
    images (valid and labels equal, scores within 1e-5, boxes within 1e-2
    px: ``tests/test_torch_slice.py``'s bars); SSD300 gives six levels of
    38, 19, 10, 5, 3 and 1, the anchor grid's ceil(300 / stride)."""
    jax_cfg, cfg, jax_model, variables, port, anchors, _, counts = config_pair(
        FLAGSHIP, NARROW + SERVE_TEST_CFG + COMPOSITIONS[name])
    h, w = cfg.input_size
    if name == "ssd300_vgg16":
        assert list(counts) == [38 * 38, 19 * 19, 10 * 10, 5 * 5, 3 * 3, 1]
        assert port.neck.__class__ is ChannelMapper and len(port.bbox_head.scales) == 6
    rng = np.random.RandomState(1)
    x = (rng.rand(1, h, w, 3).astype(np.float32) * 4 - 2)
    ref = _jax_apply(jax_model, variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    for g, r in zip(got, ref):  # per-level NHWC float32 maps of each branch
        _assert_maps_close([t.permute(0, 3, 1, 2) for t in g], r)

    u8 = rng.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    shapes = np.asarray([[h, w], [h - 4, w - 6]], np.float32)
    scales = np.asarray([[1.0] * 4, [1.25] * 4], np.float32)
    test_cfg, img_norm = jax_cfg.test_cfg.to_dict(), jax_cfg.img_norm_cfg.to_dict()
    want = jax_build_infer_step(jax_model, anchors, counts, img_norm=img_norm, test_cfg=test_cfg)(
        variables, jnp.asarray(u8), jnp.asarray(shapes), jnp.asarray(scales))
    det = build_infer_step(port, anchors, counts, img_norm=img_norm, test_cfg=cfg.test_cfg.to_dict())(
        port, u8, shapes, scales)
    rb, rs, rl, rv = (np.asarray(t) for t in want[:4])
    db, ds, dl, dv = (t.numpy() for t in det[:4])
    assert dv.sum() > 10
    np.testing.assert_array_equal(dv, rv)
    np.testing.assert_array_equal(dl[dv], rl[rv])
    np.testing.assert_allclose(ds[dv], rs[rv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(db[dv], rb[rv], rtol=0, atol=1e-2)


def _small_model(backbone, neck=None):
    return dict(type="RADet", backbone=backbone,
                neck=neck or dict(type="FPN", out_channels=32, start_level=1, num_outs=5),
                bbox_head=dict(type="RADetHead", num_classes=3, stacked_convs=1, feat_channels=32))


@pytest.mark.parametrize("change,error,match", [
    (dict(backbone=dict(type="HourglassNet")), AssertionError, "standalone"),
    (dict(backbone=dict(type="TridentResNet")), AssertionError, "standalone"),
    (dict(neck=dict(type="PAFPN", out_channels=32)), AssertionError, "unknown neck type"),
    (dict(neck=dict(type="ChannelMapper", out_channels=32, act_cfg=dict(type="GELU"))), AssertionError, "act_cfg"),
    (dict(neck=dict(type="FPN", out_channels=32, norm_cfg=dict(type="GN"))), AssertionError, "norm_cfg"),
    (dict(backbone=dict(type="Darknet", quant="int8")), AssertionError, "ResNet/ResNeXt"),
    (dict(backbone=dict(type="HRNet", frozen_int8=True)), AssertionError, "frozen_int8"),
    (dict(backbone=dict(type="HRNet", extra="hrnet_w48")), KeyError, "hrnet_w48"),
], ids=["hourglass", "trident", "neck-type", "act_cfg", "norm_cfg", "quant", "frozen_int8", "hrnet-preset"])
def test_builder_errors_match_jax(change, error, match):
    """Each config the JAX builder (or its module's init) refuses, the port
    refuses with the same exception type."""
    model_cfg = {**_small_model(dict(type="ResNet", depth=50)), **change}
    with pytest.raises(error, match=match):
        jax_model = jax_build_detector(model_cfg)
        jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    with pytest.raises(error, match=match):
        build_detector(model_cfg)


def test_module_assertions_match_jax():
    """The JAX modules' asserts on their own arguments, at init."""
    bad_stage1 = dict(TINY_HRNET, stage1=dict(TINY_HRNET["stage1"], block="BASIC"))
    for jax_module, port_cfg, match in (
        (jbx.DetectoRSResNet(depth=18), dict(type="DetectoRS_ResNet", depth=18), "depth >= 50"),
        (jbx.HRNet(extra=jbx.freeze_cfg(bad_stage1)), dict(type="HRNet", extra=bad_stage1), "BOTTLENECK"),
    ):
        with pytest.raises(AssertionError):
            jax_module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
        with pytest.raises(AssertionError, match=match):
            build_backbone(port_cfg)


@pytest.mark.parametrize("backbone,frozen,levels", [
    (dict(type="Darknet"), [], [256, 512, 1024]),
    (dict(type="Darknet", frozen_stages=2), ["conv1", "conv_res_block1"], [256, 512, 1024]),
    (dict(type="DetectoRS_ResNet", depth=50), [], [256, 512, 1024, 2048]),
    (dict(type="DetectoRS_ResNet", depth=50, frozen_stages=1), ["conv1", "bn1", "layer1"], [256, 512, 1024, 2048]),
    (dict(type="HRNet"), [], [18, 36, 72, 144]),
    (dict(type="SSDVGG"), [], [512, 1024, 512, 256, 256, 256]),
], ids=["darknet", "darknet-frozen2", "detectors", "detectors-frozen1", "hrnet-w18", "ssd300"])
def test_builder_defaults_match_jax(backbone, frozen, levels):
    """As the JAX builder: ``frozen_stages`` -1 unless the config sets it
    (then the stem and that many stages take no gradient), the trunk's
    widths, and under a ChannelMapper one head level per backbone output."""
    model_cfg = _small_model(backbone, dict(type="ChannelMapper", out_channels=32))
    port = build_detector(model_cfg)
    assert port.backbone.out_channels == levels and len(port.bbox_head.scales) == len(levels)
    fixed = {k.split(".")[1] for k, p in port.named_parameters() if not p.requires_grad}
    assert sorted(fixed) == sorted(frozen)
    jax_model = jax_build_detector(model_cfg)
    assert jax_model._num_backbone_outputs() == len(levels)
    assert jax_model.frozen_stages == backbone.get("frozen_stages", -1)


def _jax_fuse(variables):
    fused, report = jax_fuse_conv_bn({col: _nest(tree, ("backbone",)) for col, tree in variables.items()})
    return jax.tree_util.tree_map(np.asarray, fused), report


@pytest.mark.parametrize("name", ["Darknet-53", "DetectoRS-R50-SAC"])
def test_fuse_conv_bn_matches_jax(name, rng):
    """Darknet: every BatchNorm folded; DetectoRS: SAC convs standardise
    their weight per call, so their BatchNorms stay (as in the JAX
    package).  The fold equals JAX's bit for bit, and the fused trunk
    computes what the unfused one does."""
    cfg, flax_bb, _ = TRUNKS[name]
    port_bb = build_backbone(cfg)
    x = rng.rand(1, 48, 64, 3).astype(np.float32) * 4 - 2
    variables = _carry(flax_bb, port_bb, (jnp.asarray(x),), BACKBONE, train=False)
    want, want_report = _jax_fuse(variables)
    want = {k[len("backbone."):]: v for k, v in state_dict_from_flax(want).items()}
    got, report = fuse_conv_bn(port_bb.state_dict())
    n_bn = sum(k.endswith("running_var") for k in got)
    assert (report["fused"], report["skipped"]) == (want_report["fused"], want_report["skipped"])
    assert report["fused"] + report["skipped"] == n_bn
    if name.startswith("Darknet"):
        assert report["skipped"] == 0 and report["fused"] == 52
    else:
        # layers 2-4: every block's bn2 follows a SAC conv
        assert report["skipped"] == 4 + 6 + 3 and all(p.endswith(".bn2") for p in report["skipped_paths"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with torch.no_grad():
        before = port_bb(_nchw(x))
        port_bb.load_state_dict(got, strict=True)
        _assert_maps_close(port_bb(_nchw(x)), [t.numpy().transpose(0, 2, 3, 1) for t in before], FUSE_RTOL)
