"""The port's backbone zoo against the JAX package, float32 on the CPU.

Every check gives both packages the same seeded numpy inputs and weights
(``torch_parity.numpy_variables``: BN drawn as ``randomize`` draws it),
carried across by ``state_dict_from_flax`` (``strict=True``).  Within
``TOL`` (1e-4):

- ``regnet_stage_params`` for all eight presets, exactly;
- ``_avg_down`` against ``torch.nn.AvgPool2d(ceil_mode=True,
  count_include_pad=False)`` at odd sizes;
- each block kind at small widths and odd sizes, strided and not: the
  grouped Bottleneck, the BasicBlock with avg-down, Res2Net's stage and
  normal blocks, the split-attention conv at groups 1 and 2 and its
  bottleneck, RegNet's expansion-1 Bottleneck;
- whole backbones (ResNetV1d-18, ResNeXt-50, Res2Net-50, ResNeSt-50,
  RegNetX-400MF) at 68x84, and their trainable parameters equal to
  ``frozen_param_mask``'s;
- ``state_dict_from_flax`` then ``convert_mmdet_detector`` gives back each
  variant's flax tree, and the other way round; every builder type and
  depth maps onto the JAX package's variables;
- what is still unported raises naming its ROADMAP item; ``with_cp``
  builds with the plain build's parameter names.
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from radet_tpu.engine.optim import frozen_param_mask
from radet_tpu.models import build_detector as jax_build_detector
from radet_tpu.models import resnet as jres
from radet_tpu_torch.engine.convert import state_dict_from_flax
from radet_tpu_torch.models import build_backbone, build_detector
from radet_tpu_torch.models import resnet as pres
from torch_parity import TOL, numpy_variables

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools"))
from convert_torch_weights import convert_mmdet_detector  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: E402, F401 (autouse: passed tests' files removed)


def _nest(tree, path):
    for k in reversed(path):
        tree = {k: tree}
    return tree


# where a module's variables sit in a detector tree, and its state dict's prefix there
BACKBONE = (("backbone",), "backbone.")
BLOCK = (("backbone", "layer1_0"), "backbone.layer1.0.")
SPLIT_ATTENTION = (("backbone", "layer1_0", "conv2"), "backbone.layer1.0.conv2.")


def _carry(flax_module, port_module, x, where, avg_down=None, seed=0, **init_kw):
    """Seeded numpy variables of ``flax_module`` on ``x`` (NHWC); the port
    module loads the same weights, placed ``where`` in a detector
    tree, strictly (``avg_down`` as ``state_dict_from_flax`` takes it).
    Returns the variables."""
    path, prefix = where
    variables = numpy_variables(lambda: flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **init_kw), seed)
    sd = state_dict_from_flax({col: _nest(tree, path) for col, tree in variables.items()}, avg_down)
    port_module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    port_module.eval()
    return variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_close(port_maps, jax_maps):
    assert len(port_maps) == len(jax_maps)
    for t, f in zip(port_maps, jax_maps):
        t = t.detach().numpy().transpose(0, 2, 3, 1)
        assert t.shape == np.asarray(f).shape
        np.testing.assert_allclose(t, np.asarray(f), **TOL)


def test_regnet_stage_params_match_jax():
    assert pres.REGNET_ARCH == jres.REGNET_ARCH and len(pres.REGNET_ARCH) == 8
    for name, arch in pres.REGNET_ARCH.items():
        assert pres.regnet_stage_params(arch) == jres.regnet_stage_params(arch), name
    assert pres.regnet_stage_params(pres.REGNET_ARCH["regnetx_3.2gf"])[:2] == ([96, 192, 432, 1008], [2, 6, 15, 2])


@pytest.mark.parametrize("hw,stride", [((17, 23), 2), ((5, 7), 2), ((16, 9), 3), ((7, 8), 3)])
def test_avg_down_matches_torch_avg_pool(hw, stride, rng):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jres._avg_down(jnp.asarray(x), stride))
    pool = torch.nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False)
    got = pool(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, -(-hw[0] // stride), -(-hw[1] // stride), 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    down = pres.Downsample(3, 5, stride, avg_down=True)
    assert isinstance(down[0], torch.nn.AvgPool2d) and down[0].ceil_mode and not down[0].count_include_pad


# name -> (JAX block, the port's block, input channels)
def _blocks():
    D = pres.Downsample
    return {
        "bottleneck_grouped_s2": (jres.Bottleneck(planes=16, stride=2, has_downsample=True, groups=4, width=32),
                                  pres.Bottleneck(24, 16, 2, D(24, 64, 2), groups=4, width=32), 24),
        "bottleneck_grouped_s1": (jres.Bottleneck(planes=16, groups=4, width=32),
                                  pres.Bottleneck(64, 16, 1, None, groups=4, width=32), 64),
        "basic_avg_down_s2": (jres.BasicBlock(planes=16, stride=2, has_downsample=True, avg_down=True),
                              pres.BasicBlock(8, 16, 2, D(8, 16, 2, avg_down=True)), 8),
        "basic_avg_down_s1": (jres.BasicBlock(planes=16, has_downsample=True, avg_down=True),
                              pres.BasicBlock(8, 16, 1, D(8, 16, 1, avg_down=True)), 8),
        "bottle2neck_stage_s2": (jres.Bottle2neck(planes=16, stride=2, has_downsample=True),
                                 pres.Bottle2neck(24, 16, 2, D(24, 64, 2, avg_down=True)), 24),
        "bottle2neck_stage_s1": (jres.Bottle2neck(planes=16, has_downsample=True),
                                 pres.Bottle2neck(24, 16, 1, D(24, 64, 1, avg_down=True)), 24),
        "bottle2neck_normal": (jres.Bottle2neck(planes=16), pres.Bottle2neck(64, 16), 64),
        "split_attention_bottleneck_s2": (
            jres.SplitAttentionBottleneck(planes=16, stride=2, has_downsample=True, groups=2, base_width=16),
            pres.SplitAttentionBottleneck(24, 16, 2, D(24, 64, 2, avg_down=True), groups=2, base_width=16), 24),
        "regnet_bottleneck_s2": (jres.Bottleneck(planes=24, stride=2, has_downsample=True, groups=3, width=24,
                                                 expansion=1),
                                 pres.Bottleneck(16, 24, 2, D(16, 24, 2), groups=3, width=24, expansion=1), 16),
    }


@pytest.mark.parametrize("name", sorted(_blocks()))
def test_block_matches_jax(name, rng):
    flax_block, port_block, cin = _blocks()[name]
    x = rng.randn(2, 17, 23, cin).astype(np.float32)
    variables = _carry(flax_block, port_block, x, BLOCK, avg_down="avg_down" in name, train=False)
    ref = flax_block.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_block(_nchw(x))
    _assert_close([got], [ref])


@pytest.mark.parametrize("groups,stride", [(1, 1), (2, 2)])
def test_split_attention_conv_matches_jax(groups, stride, rng):
    """Radix 2; groups 2 puts fc2's group-major channels under the
    branch-major splits."""
    flax_conv = jres.SplitAttentionConv(channels=16, stride=stride, groups=groups, radix=2)
    port_conv = pres.SplitAttentionConv(16, stride, groups, 2)
    x = rng.randn(2, 17, 23, 16).astype(np.float32)
    variables = _carry(flax_conv, port_conv, x, SPLIT_ATTENTION, train=False)
    ref = flax_conv.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_conv(_nchw(x))
    _assert_close([got], [ref])


# name -> (the port's backbone config, the JAX module the JAX builder makes of it)
VARIANTS = {
    "ResNetV1d-18": (dict(type="ResNetV1d", depth=18), dict(depth=18, deep_stem=True, avg_down=True)),
    "ResNeXt-50": (dict(type="ResNeXt", depth=50, groups=32, base_width=4), dict(groups=32, base_width=4)),
    "Res2Net-50": (dict(type="Res2Net", depth=50),
                   dict(scales=4, base_width=26, deep_stem=True, avg_down=True)),
    "ResNeSt-50": (dict(type="ResNeSt", depth=50), dict(radix=2, deep_stem=True, avg_down=True)),
    "RegNetX-400MF": (dict(type="RegNet", arch="regnetx_400mf"), None),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_backbone_matches_jax(name, rng):
    """The whole trunk at an odd 68x84 (odd maps from stride 4 on); the
    trainable parameters are those ``frozen_param_mask`` leaves trainable."""
    cfg, jax_kw = VARIANTS[name]
    flax_bb = jres.RegNet(arch=cfg["arch"]) if jax_kw is None else jres.ResNet(**jax_kw)
    port_bb = build_backbone(cfg)
    x = rng.rand(1, 68, 84, 3).astype(np.float32) * 4 - 2
    variables = _carry(flax_bb, port_bb, x, BACKBONE, train=False)
    ref = flax_bb.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_bb(_nchw(x))
    assert [t.shape[1] for t in got] == port_bb.out_channels == [r.shape[-1] for r in ref]
    _assert_close(got, ref)

    for frozen in (1, 2, -1):
        port_bb = build_backbone(dict(cfg, frozen_stages=frozen))
        mask = frozen_param_mask({"backbone": variables["params"]}, frozen)
        flags = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), mask,
                                       {"backbone": variables["params"]})
        sd = state_dict_from_flax({"params": flags, "batch_stats": {"backbone": variables["batch_stats"]}})
        want = {k[len("backbone."):] for k, v in sd.items() if v.all() and "running_" not in k}
        assert {k for k, p in port_bb.named_parameters() if p.requires_grad} == want, frozen
        assert len(want) < len(list(port_bb.parameters())) or frozen == -1


def _small_model(backbone):
    return dict(type="RADet", backbone=backbone,
                neck=dict(type="FPN", out_channels=32, start_level=1, add_extra_convs="on_output", num_outs=5),
                bbox_head=dict(type="RADetHead", num_classes=3, in_channels=32, stacked_convs=1, feat_channels=32))


def _flax_shapes(model_cfg, hw=(64, 64)):
    jax_model = jax_build_detector(model_cfg, dtype="float32")
    return jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_inverse_of_convert_mmdet_detector(name):
    """flax tree -> state dict -> ``convert_mmdet_detector`` -> the same
    tree, no entry left over; the port's own state dict the other way
    round, bit for bit; mmdet's avg-down names."""
    model_cfg = _small_model(VARIANTS[name][0])
    shapes = _flax_shapes(model_cfg)
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = state_dict_from_flax(tree)
    flat = {}
    convert_mmdet_detector({k: v.numpy() for k, v in sd.items()}, flat)
    want = traverse_util.flatten_dict(tree)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=str(k))

    port = build_detector(model_cfg)
    port.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in port.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    mine = port.state_dict()
    flat = {}
    convert_mmdet_detector({k: v.numpy() for k, v in mine.items()}, flat)
    back = state_dict_from_flax(traverse_util.unflatten_dict(flat))
    assert set(back) == set(mine)
    for k, v in mine.items():
        assert torch.equal(back[k], v), k
    ds = sorted({k.split(".downsample.")[1].split(".")[0] for k in mine if ".downsample." in k})
    assert ds == (["0", "1"] if name in ("ResNeXt-50", "RegNetX-400MF") else ["1", "2"])
    if name.startswith(("Res2Net", "ResNeSt", "ResNetV1d")):
        assert "backbone.stem.6.weight" in mine and "backbone.conv1.weight" not in mine


def test_stride_one_avg_down_loads_without_its_pool():
    """An avg-down layer at stride 1 saved without the identity pool in
    front (mmcls's ResLayer) loads strictly into the same places."""
    backbone = build_backbone(dict(type="ResNeSt", depth=50))
    sd = {k: torch.rand(v.shape) for k, v in backbone.state_dict().items()}
    moved = {}
    for k, v in sd.items():
        for i in ("1", "2"):
            k = k.replace(f"layer1.0.downsample.{i}.", f"layer1.0.downsample.{int(i) - 1}.")
        moved[k] = v
    assert "layer1.0.downsample.0.weight" in moved and "layer2.0.downsample.2.weight" in moved
    backbone.load_state_dict(moved, strict=True)
    for k, v in backbone.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("backbone", [
    dict(type="ResNet", depth=18), dict(type="ResNet", depth=34), dict(type="ResNet", depth=101),
    dict(type="ResNet", depth=152), dict(type="ResNetV1d", depth=50),
    dict(type="ResNeXt", depth=101, groups=64, base_width=4), dict(type="RegNet", arch="regnetx_3.2gf"),
], ids=lambda b: f"{b['type']}-{b.get('depth', b.get('arch'))}")
def test_builder_types_map_onto_jax_variables(backbone):
    """Each type and depth the builder takes: the JAX package's variables
    (shapes, zeros) convert and load strictly, the FPN sized by the trunk."""
    model_cfg = _small_model(backbone)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), _flax_shapes(model_cfg))
    port = build_detector(model_cfg)
    port.load_state_dict(state_dict_from_flax(zeros), strict=True)
    widths = [port.neck.lateral_convs[i].conv.weight.shape[1] for i in range(3)]
    assert widths == port.backbone.out_channels[1:]


ITEM12 = "item 12"


@pytest.mark.parametrize("change,item", [
    (dict(backbone=dict(type="Darknet", depth=53)), ITEM12),
    (dict(backbone=dict(type="HRNet")), ITEM12),
    (dict(backbone=dict(type="SSDVGG")), ITEM12),
    (dict(backbone=dict(type="DetectoRS_ResNet", depth=50)), ITEM12),
    (dict(backbone=dict(type="DetectoRS_ResNeXt", depth=50)), ITEM12),
    (dict(neck=dict(type="ChannelMapper", out_channels=32)), ITEM12),
    (dict(neck=dict(type="FPN", out_channels=32, add_extra_convs="on_lateral")), ITEM12),
])
def test_unported_variants_raise_naming_their_item(change, item):
    model_cfg = {**_small_model(dict(type="ResNet", depth=50)), **change}
    with pytest.raises(NotImplementedError, match=item):
        build_detector(model_cfg)


@pytest.mark.parametrize("part,options", [
    ("backbone", dict(quant="int8")),
    ("backbone", dict(quant="int8", qat=True)),
    ("backbone", dict(frozen_int8=True)),
    ("bbox_head", dict(quant="int8")),
], ids=["quant", "qat", "frozen_int8", "head_quant"])
def test_int8_variants_build_with_the_plain_parameter_names(part, options):
    """The int8 deploy options (ported: item 14a) change no parameter, as
    the JAX package's ``Int8Conv`` keeps the float conv's variables."""
    base = _small_model(dict(type="ResNet", depth=50))
    int8 = build_detector({**base, part: {**base[part], **options}})
    assert [(k, v.shape) for k, v in int8.state_dict().items()] == [
        (k, v.shape) for k, v in build_detector(base).state_dict().items()]


@pytest.mark.parametrize("backbone", [dict(type="ResNet", depth=50), dict(type="ResNeXt", depth=50, groups=32)],
                         ids=lambda b: b["type"])
def test_with_cp_builds_with_the_plain_parameter_names(backbone):
    """``with_cp`` (ported: checkpointed blocks) changes no parameter, as
    flax's ``nn.remat`` keeps the variable tree."""
    model_cfg = _small_model(backbone)
    plain = build_detector(model_cfg)
    cp = build_detector({**model_cfg, "backbone": dict(backbone, with_cp=True)})
    assert cp.backbone.with_cp and not plain.backbone.with_cp
    assert [k for k, _ in cp.named_parameters()] == [k for k, _ in plain.named_parameters()]


def test_regnet_arch_must_be_a_named_preset():
    arch = dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22, bot_mul=1.0)
    model_cfg = _small_model(dict(type="RegNet", arch=arch))
    with pytest.raises(AssertionError, match="named preset"):
        jax_build_detector(model_cfg)
    with pytest.raises(ValueError, match="named preset"):
        build_detector(model_cfg)
    with pytest.raises(ValueError, match="named preset"):
        build_detector(_small_model(dict(type="RegNet", arch="regnetx_2gf")))
    with pytest.raises(ValueError, match="unknown backbone type"):
        build_detector(_small_model(dict(type="HourglassNet")))
