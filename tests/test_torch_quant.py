"""The int8 deploy family (``radet_tpu_torch/ops/quant.py`` and the int8
branches of the head and the trunk) against the JAX package, on the CPU.

- ``quantize_int8``, ``affine_act_scale``, ``_scale_fold`` and ``Int8Conv``
  bit for bit against the JAX package's jitted functions (its compiled
  arithmetic: a division by the constant 127 is a multiplication by the
  float32 reciprocal there), ``Int8Conv`` in its three input modes at
  kernel 1 and 3, stride 1 and 2, groups 1 and 4, with and without bias;
  the int32 sums bit for bit against XLA's int8 convolution;
- a narrow int8 head (64 channels, GroupNorm 32), the ResNet-18 trunk at
  ``quant='int8'`` and the ResNet-50 trunk at ``int8_conv2`` and
  ``int8_stream`` on a 64x64 input, and ``r50_ycbv_pbr_int8_stream.py`` at
  full width through ``init_detector`` with weights from
  ``state_dict_from_flax``: each within its stated tolerance, with the share
  of int8 elements that flipped a level against JAX measured and bounded
  (two float implementations put an occasional value on the other side of
  a rounding step; the float tensors that are quantized differ by their
  normalizations' rounding);
- that the six ``configs/bop/*int8*`` configs build, and the JAX builder's
  fail-fast cases raise the same way; that a plain quant config refuses to
  train and the ``frozen_int8`` and QAT configs each take a train step
  (``tests/test_torch_frozen_int8.py`` and ``tests/test_torch_qat.py`` hold
  them to JAX's);
- ``profile_infer --quant int8 --cpu`` and ``validate_learning --int8-eval
  --cpu`` at a tiny size;
- ``int8_conv_cuda.plan``, the static rule that picks the wgmma kernel or
  the mma.sync kernel, over the int8 configs' 26 conv shapes at 480x640 and
  batches 8 and 128 and over the kernel cases: which path, and that every
  TMA box, stride and the shared memory respect the H100's limits.

The kernel-vs-plain cases need a CUDA card and skip without one; on the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_quant.py``
(this module imports jax only inside the cases that compare with it).
"""

import glob
import os.path as osp

import numpy as np
import pytest
import torch

import radet_tpu_torch.ops.int8_conv_cuda as cuda_mod
from radet_tpu_torch import init_detector
from radet_tpu_torch.apis.common import build_model_and_anchors
from radet_tpu_torch.apis.train import train_detector
from radet_tpu_torch.engine.convert import state_dict_from_flax
from radet_tpu_torch.engine.train_step import batch_to_device, build_train_step
from radet_tpu_torch.models import build_detector
from radet_tpu_torch.models.builder import build_backbone
from radet_tpu_torch.models.layers import Conv2d
from radet_tpu_torch.models.radet_head import ConvGNBlock, RADetHead
from radet_tpu_torch.models.resnet import Bottleneck
from radet_tpu_torch.ops import quant
from radet_tpu_torch.tools import profile_infer, validate_learning
from radet_tpu_torch.utils.config import Config
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BOP = osp.join(REPO, "configs", "bop")
INT8_CONFIGS = sorted(osp.basename(p)[:-3] for p in glob.glob(osp.join(BOP, "*int8*.py")))
# Against JAX: the largest difference relative to each map's max |x|, and
# the share of the int8 elements handed between blocks that differ (mean over
# those tensors).  Measured on this file's seeds (float32, an x86-64
# CPU): the head tower 1.2e-6 with no flip; the 'int8' and 'int8_conv2'
# trunks 6.3e-7 (float rounding, no flip); the 'int8_stream' trunk 0.032 with
# 2.8% of its int8 elements flipped, by at most 2 levels (a BatchNorm output
# that differs by an ulp flips an element of the stem's quantization, and the
# flips spread through the 16 blocks); the int8_stream detector 0.042 at P3
# and P4 (the head's first conv quantizes its FPN level with the level's
# absmax, which the FPN's float rounding moves).
HEAD_RTOL, HEAD_FLIPS = 1e-4, 1e-3
TRUNK_RTOL = 1e-5
STREAM_RTOL, STREAM_FLIPS, STREAM_LEVELS = 0.06, 0.05, 3
DETECTOR_RTOL, DETECTOR_HEAD_FLIPS = 0.08, 0.05


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, imported here only (the card has no jax)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from radet_tpu.models import builder as jbuilder
    from radet_tpu.models import radet_head as jhead
    from radet_tpu.models import resnet as jresnet
    from radet_tpu.ops import quant as jquant

    class J:
        pass

    j = J()
    j.jax, j.jnp, j.quant, j.head, j.resnet, j.builder = jax, jnp, jquant, jhead, jresnet, jbuilder
    return j


def _conv_module(kernel_hwio, bias, stride, groups):
    kh, _, cin_g, cout = kernel_hwio.shape
    m = Conv2d(cin_g * groups, cout, kh, stride=stride, padding=(kh - 1) // 2, groups=groups, bias=bias is not None)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel_hwio.transpose(3, 2, 0, 1)))
        if bias is not None:
            m.bias.copy_(torch.from_numpy(bias))
    return m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def test_quantize_and_scales_bit_equal(jx):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 7, 9, 24) * 3).astype(np.float32)
    s = (rng.rand(24) * 0.05 + 0.001).astype(np.float32)
    for scale in (s, np.float32(0.0213)):
        want = np.asarray(jx.jax.jit(jx.quant.quantize_int8)(x, scale))
        got = quant.quantize_int8(_nchw(x), torch.from_numpy(np.asarray(scale)))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    gamma, beta = rng.randn(24).astype(np.float32), rng.randn(24).astype(np.float32)
    gamma[0] = beta[0] = 0.0  # the 1e-6 floor
    for k in (8.0, 4.0):
        want = np.asarray(jx.jax.jit(lambda g, b, k=k: jx.quant.affine_act_scale(g, b, k))(gamma, beta))
        got = quant.affine_act_scale(torch.from_numpy(gamma), torch.from_numpy(beta), k).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 4])
def test_scale_fold_bit_equal(jx, groups):
    cin, features = 6, 8
    s = np.random.RandomState(groups).rand(cin * groups).astype(np.float32)
    want = np.asarray(jx.quant._scale_fold(jx.jnp.asarray(s), cin, groups, features))  # (1, 1, cin, features)
    got = quant._scale_fold(torch.from_numpy(s), cin, groups, features)  # OIHW-broadcastable
    got = np.broadcast_to(got.numpy(), (features, cin, 1, 1)).transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(got, np.broadcast_to(want, (1, 1, cin, features)))


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["float", "int8", "per_channel"])
def test_int8_conv_bit_equal(jx, mode, k, stride, groups, bias):
    """Output of ``Int8Conv`` (bfloat16) and the int32 sums, bit for bit."""
    rng = np.random.RandomState(k * 100 + stride * 10 + groups)
    cin, cout = 16, 8
    kernel = (rng.randn(k, k, cin // groups, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    if mode == "float":
        x, s = (rng.randn(2, 9, 11, cin) * 2).astype(np.float32), None
    else:
        x = rng.randint(-127, 128, (2, 9, 11, cin)).astype(np.int8)
        s = np.float32(0.037) if mode == "int8" else (rng.rand(cin) * 0.1 + 0.01).astype(np.float32)
    pad = (k - 1) // 2
    conv = jx.quant.Int8Conv(cout, kernel_size=(k, k), strides=(stride, stride), padding=((pad, pad), (pad, pad)),
                             feature_group_count=groups, use_bias=bias)
    params = {"kernel": kernel, **({"bias": b} if bias else {})}
    want = np.asarray(jx.jax.jit(lambda p, x, s: conv.apply({"params": p}, x, s))(params, x, s)
                      .astype(jx.jnp.float32))
    m = _conv_module(kernel, b, stride, groups)
    got = quant.int8_conv_forward(m, _nchw(x), None if s is None else torch.from_numpy(np.asarray(s)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), want)

    xq = rng.randint(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    acc = jx.jax.lax.conv_general_dilated(xq, wq, (stride, stride), ((pad, pad), (pad, pad)),
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
                                          preferred_element_type=jx.jnp.int32)
    got_acc = quant.int8_conv(_nchw(xq), torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1))),
                              torch.ones(cout), None, (stride, stride), (pad, pad), groups, torch.int32)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.permute(0, 2, 3, 1).numpy(), np.asarray(acc))


def test_int8_conv_operator_and_flops():
    """The operator's CPU, fake and schema paths agree (``opcheck``), and
    FlopCounterMode counts it as a convolution."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 16, 9, 11)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (8, 4, 3, 3)).astype(np.int8))
    mult, b = torch.rand(8), torch.randn(8)
    for bias, dtype in ((None, torch.bfloat16), (b, torch.float32), (None, torch.int32)):
        torch.library.opcheck(torch.ops.radet_tpu_torch.int8_conv.default,
                              (x, w, mult, bias, [2, 2], [1, 1], 4, dtype))
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        y = quant.int8_conv(x, w, mult, None, (1, 1), (1, 1), 4)
    assert counter.get_total_flops() == 2 * 2 * 9 * 11 * 8 * 4 * 9
    assert y.shape == (2, 8, 9, 11) and y.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(AssertionError, match="per-channel scales require int8"):
        quant.int8_conv_forward(Conv2d(16, 8, 3, padding=1), x.float(), torch.ones(16))
    with pytest.raises(AssertionError, match="requires its scale"):
        quant.int8_conv_forward(Conv2d(16, 8, 3, padding=1), x)


def _flips(got_int8, want_int8) -> float:
    return float(np.mean(np.asarray(got_int8) != np.asarray(want_int8)))


def _stream_flips(port_q, jax_q):
    """(mean flip share over the 16 blocks' int8 outputs, largest level
    difference)."""
    assert len(port_q) == len(jax_q) == 16
    levels = max(int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max()) for g, w in zip(port_q, jax_q))
    return float(np.mean([_flips(g, w) for g, w in zip(port_q, jax_q)])), levels


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _record_int8(monkeypatch, cls, method):
    """Record the int8 tensors ``cls.method`` hands on (the first element of
    a tuple it returns), in call order."""
    seen = []
    inner = getattr(cls, method)

    def wrapper(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        if isinstance(out, tuple):
            seen.append(out[0].permute(0, 2, 3, 1).numpy())
        return out

    monkeypatch.setattr(cls, method, wrapper)
    return seen


def _head_order(seen, levels, emitting):
    """The port's int8 tower outputs (level by level, the cls tower's then
    the reg tower's blocks) in flax's order (tower, block, level)."""
    per_level = 2 * emitting
    return [seen[lvl * per_level + tower * emitting + blk]
            for tower in (0, 1) for blk in range(emitting) for lvl in range(levels)]


def _jax_int8(intermediates, name):
    """Int8 outputs of JAX modules named ``name`` (prefix) in a captured
    intermediates tree, as flax records them (module order)."""
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                for o in v:
                    if isinstance(o, tuple) and getattr(o[0], "dtype", None) == np.int8 and path.startswith(name):
                        out.append(np.asarray(o[0]))
            elif isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(intermediates, "")
    return out


def test_int8_head_tower(jx, monkeypatch):
    """A narrow int8 RADetHead (64 channels, 4 stacked convs, GroupNorm 32)
    on five random levels: outputs within ``HEAD_RTOL`` of their max, and
    the int8 tensors between blocks flipped at most ``FLIP_SHARE``."""
    from torch_parity import numpy_variables

    jnp = jx.jnp
    head = jx.head.RADetHead(num_classes=4, in_channels=64, feat_channels=64, stacked_convs=4, quant="int8")
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, s, s + 2, 64).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    variables = numpy_variables(lambda: {"params": {"bbox_head": head.init(
        jx.jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"]}})
    want, inter = jx.jax.jit(lambda v, f: head.apply(v, f, capture_intermediates=True))(
        {"params": variables["params"]["bbox_head"]}, feats)
    port = RADetHead(num_classes=4, in_channels=64, feat_channels=64, stacked_convs=4, quant="int8")
    sd = {k[len("bbox_head."):]: v for k, v in state_dict_from_flax(variables).items()}
    port.load_state_dict(sd, strict=True)
    port.eval()
    seen = _record_int8(monkeypatch, ConvGNBlock, "forward_int8")
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    errs = [_rel_err(g.numpy(), w) for g_maps, w_maps in zip(got, want) for g, w in zip(g_maps, w_maps)]
    jax_q = _jax_int8(inter["intermediates"], "cls_conv") + _jax_int8(inter["intermediates"], "reg_conv")
    port_q = _head_order(seen, 5, 3)
    assert len(jax_q) == len(port_q) == 30
    flips = np.mean([_flips(g, w) for g, w in zip(port_q, jax_q)])
    print(f"head: max error {max(errs):.3g} of a map's max, flip share {flips:.3g}")
    assert max(errs) < HEAD_RTOL and flips <= HEAD_FLIPS


def _trunk_pair(jx, backbone, hw=(64, 64)):
    from torch_parity import numpy_variables

    jmodel = jx.resnet.ResNet(**{k: v for k, v in backbone.items() if k != "type"})
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    variables = numpy_variables(lambda: jmodel.init(jx.jax.random.PRNGKey(0), jx.jnp.zeros((1, *hw, 3))))
    tree = {c: {"backbone": variables[c]} for c in ("params", "batch_stats")}
    port = build_backbone(backbone)
    port.load_state_dict({k[len("backbone."):]: v for k, v in state_dict_from_flax(tree).items()}, strict=True)
    port.eval()
    want, inter = jx.jax.jit(lambda v, x: jmodel.apply(v, x, train=False, capture_intermediates=True))(
        variables, x)
    return port, _nchw(x), want, inter["intermediates"]


@pytest.mark.parametrize("depth,level", [(18, "int8"), (50, "int8_conv2"), (50, "int8_stream")])
def test_int8_trunk(jx, monkeypatch, depth, level):
    """The ResNet-18 trunk at 'int8' and ResNet-50's at 'int8_conv2' and
    'int8_stream' on a 64x64 input: C2..C5 within ``TRUNK_RTOL`` of their
    max; for the stream, the int8 blocks' outputs flipped at most
    ``FLIP_SHARE``."""
    port, x, want, inter = _trunk_pair(jx, dict(type="ResNet", depth=depth, quant=level))
    seen = _record_int8(monkeypatch, Bottleneck, "forward_int8")
    with torch.no_grad():
        got = port(x)
    assert len(got) == len(want) == 4
    errs = [_rel_err(_nhwc(g), w) for g, w in zip(got, want)]
    if level != "int8_stream":
        assert max(errs) < TRUNK_RTOL
        return
    flips, levels = _stream_flips(seen, _jax_int8(inter, "layer"))
    print(f"trunk {level}: max error {max(errs):.3g} of a map's max, flip share {flips:.3g}, levels {levels}")
    assert max(errs) < STREAM_RTOL and flips <= STREAM_FLIPS and levels <= STREAM_LEVELS


def test_int8_stream_detector_full_width(jx, monkeypatch, tmp_path):
    """``configs/bop/r50_ycbv_pbr_int8_stream.py`` at full width (64x96, float32):
    weights drawn for the JAX model, converted by ``state_dict_from_flax``,
    loaded by ``init_detector``; the head's maps within ``DETECTOR_RTOL`` of
    their max, the trunk's int8 stream flipped at most ``FLIP_SHARE``, and
    ``inference_detector``'s detections finite."""
    from radet_tpu.apis.common import build_model_and_anchors as jax_build
    from radet_tpu.utils.config import Config as JaxConfig
    from torch_parity import numpy_variables

    from radet_tpu_torch import inference_detector

    path = osp.join(BOP, "r50_ycbv_pbr_int8_stream.py")
    options = ["input_size=(64, 96)", "compute_dtype='float32'"]
    jmodel = jax_build(JaxConfig.fromfile(path, options))[0]
    variables = numpy_variables(lambda: jmodel.init(jx.jax.random.PRNGKey(0), jx.jnp.zeros((1, 64, 96, 3)),
                                                    train=False))
    ckpt = str(tmp_path / "int8_stream.pth")
    torch.save(state_dict_from_flax(variables), ckpt)
    det = init_detector(path, ckpt, cfg_options=options, device="cpu")
    assert det.model.backbone.quant == "int8_stream" and det.model.bbox_head.quant == "int8"
    x = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    want, inter = jx.jax.jit(lambda v, x: jmodel.apply(v, x, train=False, capture_intermediates=True))(
        variables, x)
    seen = _record_int8(monkeypatch, Bottleneck, "forward_int8")
    seen_head = _record_int8(monkeypatch, ConvGNBlock, "forward_int8")
    with torch.no_grad():
        got = det.model(_nchw(x))
    errs = [_rel_err(g.numpy(), w) for g_maps, w_maps in zip(got, want) for g, w in zip(g_maps, w_maps)]
    flips, levels = _stream_flips(seen, _jax_int8(inter["intermediates"], "backbone"))
    head_flips = np.mean([_flips(g, w) for g, w in zip(
        _head_order(seen_head, 5, 3), _jax_int8(inter["intermediates"], "bbox_head/cls_conv")
        + _jax_int8(inter["intermediates"], "bbox_head/reg_conv"))])
    print(f"detector: max error {max(errs):.3g} of a map's max, stream flip share {flips:.3g} "
          f"(levels {levels}), head flip share {head_flips:.3g}")
    assert max(errs) < DETECTOR_RTOL and flips <= STREAM_FLIPS and levels <= STREAM_LEVELS
    assert head_flips <= DETECTOR_HEAD_FLIPS
    results = inference_detector(det, [np.random.RandomState(3).randint(0, 256, (64, 96, 3), np.uint8)])
    assert np.isfinite(results[0]["boxes"]).all() and np.isfinite(results[0]["scores"]).all()


@pytest.mark.parametrize("name", INT8_CONFIGS)
def test_int8_configs_build(name):
    """Each of ``configs/bop``'s six int8 configs builds with its levels."""
    cfg = Config.fromfile(osp.join(BOP, f"{name}.py"))
    model = build_model_and_anchors(cfg, dtype="float32")[0]
    bb, head = cfg.model.get("backbone", {}), cfg.model.get("bbox_head", {})
    assert model.backbone.quant == bb.get("quant") and model.bbox_head.quant == head.get("quant")
    assert model.backbone.qat == bool(bb.get("qat")) and model.backbone.frozen_int8 == bool(bb.get("frozen_int8"))
    assert len(INT8_CONFIGS) == 6


_HEAD = dict(type="RADetHead", num_classes=3, in_channels=32, stacked_convs=1, feat_channels=32)
_NECK = dict(type="FPN", out_channels=32, start_level=1, add_extra_convs="on_output", num_outs=5)
_ATSS = dict(type="ATSSHead", num_classes=3, in_channels=32, stacked_convs=1, feat_channels=32,
             anchor_generator=dict(type="AnchorGenerator", ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
                                   strides=[8, 16, 32, 64, 128]))
FAIL_FAST = {  # (model config, exception)
    "quant_level": (dict(backbone=dict(type="ResNet", depth=50, quant="int4")), AssertionError),
    "res2net": (dict(backbone=dict(type="Res2Net", depth=50, quant="int8")), AssertionError),
    "resnest": (dict(backbone=dict(type="ResNeSt", depth=50, quant="int8")), AssertionError),
    "regnet": (dict(backbone=dict(type="RegNet", arch="regnetx_3.2gf", quant="int8")), AssertionError),
    "v1d_stream": (dict(backbone=dict(type="ResNetV1d", depth=50, quant="int8_stream")), AssertionError),
    "basic_stream": (dict(backbone=dict(type="ResNet", depth=18, quant="int8_stream")), AssertionError),
    "qat_no_quant": (dict(backbone=dict(type="ResNet", depth=50, qat=True)), AssertionError),
    "qat_live_bn": (dict(backbone=dict(type="ResNet", depth=50, quant="int8", qat=True, norm_eval=False)),
                    AssertionError),
    "frozen_with_quant": (dict(backbone=dict(type="ResNet", depth=50, quant="int8", frozen_int8=True)),
                          AssertionError),
    "frozen_v1d": (dict(backbone=dict(type="ResNetV1d", depth=50, frozen_int8=True)), AssertionError),
    "frozen_stages": (dict(backbone=dict(type="ResNet", depth=50, frozen_int8=True, frozen_stages=-1)),
                      AssertionError),
    "head_qat_no_quant": (dict(bbox_head=dict(_HEAD, qat=True)), AssertionError),
    "atss_qat": (dict(type="SingleStageDetector", bbox_head=dict(_ATSS, quant="int8", qat=True)), AssertionError),
    "head_level": (dict(bbox_head=dict(_HEAD, quant="int4")), ValueError),
}


@pytest.mark.parametrize("case", sorted(FAIL_FAST))
def test_fail_fast_as_the_jax_builder(jx, case):
    """Each refused combination raises the JAX package's exception type, at
    its build (the port) and at its build or first trace (JAX)."""
    change, exc = FAIL_FAST[case]
    model_cfg = {**dict(type="RADet", backbone=dict(type="ResNet", depth=50), neck=_NECK, bbox_head=_HEAD),
                 **change}
    with pytest.raises(exc):
        jmodel = jx.builder.build_detector(model_cfg, dtype="float32")
        jx.jax.eval_shape(lambda: jmodel.init(jx.jax.random.PRNGKey(0), jx.jnp.zeros((1, 64, 64, 3))))
    with pytest.raises(exc):
        build_detector(model_cfg)


def test_int8_training_refused(jx, tmp_path):
    """A plain quant config refuses to train (as the JAX package's
    ``check_trainable_quant``); the ``frozen_int8`` config and the QAT
    config each build a train step and take one (``tests/test_torch_qat.py``
    and ``tests/test_torch_frozen_int8.py`` hold them to JAX's): the
    frozen stem and layer1 take no gradient and keep their weights, the
    others move; at eval both run."""
    from radet_tpu.apis.train import check_trainable_quant as jax_check

    from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
    from radet_tpu_torch.engine import build_optimizer
    from radet_tpu_torch.engine.train_step import TrainState
    from synthetic_bop import synthetic_bop_records

    plain = Config.fromfile(osp.join(BOP, "r50_ycbv_pbr_int8_full.py"))
    with pytest.raises(AssertionError, match="qat=True"):
        jax_check(plain.model.to_dict())
    with pytest.raises(ValueError, match="qat=True"):
        train_detector(plain, work_dir=str(tmp_path / "plain"), device="cpu")
    small = ["model.backbone.depth=18", "model.neck.out_channels=32", "model.bbox_head.in_channels=32",
             "model.bbox_head.feat_channels=64", "model.bbox_head.stacked_convs=1", "input_size=(64, 64)"]
    x = torch.zeros((1, 3, 64, 64))
    ds = InMemoryBOPDataset(synthetic_bop_records(np.random.RandomState(0), 2, (64, 64)),
                            train_transforms((64, 64), max_gt=32, seed=0), max_gt=32)
    frozen = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 64x64 maps: more threads only wait on the other test processes
    try:
        for name, opts in (("r50_ycbv_pbr_frozen_int8.py", ["model.backbone.depth=50"]),
                           ("r50_ycbv_pbr_int8_qat.py", ["model.backbone.quant='int8'"])):
            cfg = Config.fromfile(osp.join(BOP, name), small + opts)
            model, anchors, ranges, _ = build_model_and_anchors(cfg, dtype="float32")
            model.init_weights(torch.Generator().manual_seed(0))
            before = {k: v.clone() for k, v in model.state_dict().items()}
            step = build_train_step(model, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=21)
            tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
            metrics = step(TrainState(model.train(), tx), batch_to_device(collate([ds[0], ds[1]]), "cpu"))
            assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0, name
            for k, p in model.named_parameters():
                assert (p.grad is None) == k.startswith(frozen), (name, k)
            after = model.state_dict()
            assert all(torch.equal(after[k], before[k]) for k in before if k.startswith(frozen)), name
            assert not torch.equal(after["backbone.layer2.0.conv1.weight"], before["backbone.layer2.0.conv1.weight"])
            with torch.no_grad():
                assert len(model.eval()(x)) == 3
    finally:
        torch.set_num_threads(threads)


def test_profile_infer_quant_on_the_cpu(capsys):
    """``profile_infer --quant int8`` on a narrow flagship: the head's
    towers are int8, their operations counted."""
    from torch_parity import NARROW

    narrow = [o for o in NARROW if not o.startswith("compute_dtype")]
    out = profile_infer.main(["--cpu", "--quant", "int8", "--batch", "1", "--iters", "1", "--top", "3",
                              "--cfg-options", *narrow])
    assert out["quant"] == "int8" and out["int8_conv_launches_per_step"] is None
    assert out["by_module"]["bbox_head"]["gflop"] > 0
    assert "== inference step:" in capsys.readouterr().out


def test_validate_learning_int8_eval_on_the_cpu(capsys):
    """``--int8-eval`` evaluates the trained weights through the three int8
    variants, each with its RESULT line and deltas."""
    metrics = validate_learning.main(["--cpu", "--iters", "3", "--images", "4", "--img-size", "64", "96",
                                      "--workers", "1", "--int8-eval", "--min-map50", "0"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT")]
    assert [ln.split()[1] for ln in lines[1:]] == [tag for tag, _ in validate_learning.INT8_EVALS]
    assert all("(delta mAP50 " in ln for ln in lines[1:]) and lines[0].startswith("RESULT mAP50=")
    assert sorted(metrics["int8_eval"]) == sorted(tag for tag, _ in validate_learning.INT8_EVALS)
    assert all(0 <= m["bbox_mAP_50"] <= 1 for m in metrics["int8_eval"].values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (N, Cin, H, W, Cout, k, stride, groups): a 3x3 of the head, the trunk's
# 1x1 and strided 3x3, a ResNeXt layer1 3x3 (4 channels a group), ragged
# sizes past every tile edge; then the wgmma kernel's edges: Ho and Wo not
# multiples of the patch, Cout not a multiple of the tile's 64 / 128 / 256
# channels, Cin 64 (64-byte swizzle), 48 and 16 (32-byte swizzle, a chunk
# half past the channels), stride 2 on odd H and W, more tiles than SMs
# (persistent blocks walk several), and a Cout the TMA store refuses (mma)
KERNEL_CASES = [
    (2, 256, 15, 20, 256, 3, 1, 1), (2, 64, 30, 40, 256, 1, 1, 1), (2, 128, 30, 40, 128, 3, 2, 1),
    (2, 1024, 8, 10, 2048, 1, 2, 1), (2, 128, 30, 40, 128, 3, 1, 32), (3, 48, 7, 9, 72, 3, 2, 4),
    (1, 20, 5, 7, 6, 3, 1, 2),
    (2, 128, 27, 37, 128, 3, 1, 1), (2, 256, 15, 20, 72, 3, 1, 1), (3, 128, 13, 17, 320, 1, 1, 1),
    (2, 64, 30, 40, 64, 3, 1, 1), (2, 48, 9, 11, 64, 3, 1, 1), (1, 16, 7, 9, 24, 3, 1, 1),
    (2, 256, 29, 39, 256, 3, 2, 1), (2, 512, 15, 21, 1024, 1, 2, 1), (16, 64, 120, 160, 64, 1, 1, 1),
    (8, 128, 60, 80, 128, 3, 1, 1), (1, 32, 6, 6, 12, 3, 1, 1),
]


def _wgmma_domain(case, out_bytes: int) -> bool:
    """Whether a KERNEL_CASES entry lies in the wgmma kernel's domain."""
    _, cin, _, _, cout, _, _, groups = case
    return groups == 1 and cin % 16 == 0 and cout * out_bytes % 16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16, torch.float32], ids=["int32", "bf16", "f32"])
def test_kernel_matches_plain(cuda_device, case, out_dtype):
    """Both kernels (the plan's choice through the operator, then each path
    forced, the wgmma one also with one block per tile) equal the plain
    version bit for bit."""
    n, cin, h, w, cout, k, stride, groups = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randint(-127, 128, (n, cin, h, w), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, cin // groups, k, k), generator=g, dtype=torch.int8)
    mult = torch.rand(cout, generator=g) * 1e-3
    bias = torch.randn(cout, generator=g) if out_dtype == torch.float32 else None
    args = (mult, bias, (stride, stride), ((k - 1) // 2,) * 2, groups, out_dtype)
    want = quant.int8_conv_plain(x, wt, *args)
    dev = [t if t is None else t.to(cuda_device) for t in (x, wt, mult, bias)]
    wgmma = _wgmma_domain(case, torch.empty((), dtype=out_dtype).element_size())
    before, paths = cuda_mod.LAUNCHES, dict(cuda_mod.PATH_LAUNCHES)
    got = quant.int8_conv(dev[0].contiguous(memory_format=torch.channels_last), dev[1], dev[2], dev[3], *args[2:])
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    chosen = "wgmma" if wgmma else "mma"
    assert cuda_mod.PATH_LAUNCHES[chosen] == paths[chosen] + 1
    assert got.dtype == out_dtype and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    # an NCHW-contiguous input is converted by the wrapper
    got = cuda_mod.int8_conv_cuda(dev[0], dev[1], dev[2], dev[3], *args[2:])
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    forced = [dict(path="mma")] + ([dict(path="wgmma", persistent=True), dict(path="wgmma", persistent=False)]
                                   if wgmma else [])
    for kw in forced:
        got = cuda_mod.int8_conv_cuda(*dev, *args[2:], **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, msg=lambda m: f"{kw}: {m}")
    if not wgmma:
        with pytest.raises(ValueError, match="does not take"):
            cuda_mod.int8_conv_cuda(*dev, *args[2:], path="wgmma")


# the 26 distinct int8 conv shapes of configs/bop's int8 configs at 480x640
# (int8_full's and int8_stream's; chip_smoke.py::int8_kernel_by_shape records
# them from the forward): (Cin, H, W, Cout, k, stride), padding (k - 1) // 2
INT8_CONFIG_SHAPES = [
    (256, 60, 80, 256, 3, 1), (256, 30, 40, 256, 3, 1), (256, 15, 20, 256, 3, 1), (256, 8, 10, 256, 3, 1),
    (256, 4, 5, 256, 3, 1), (64, 120, 160, 64, 3, 1), (128, 120, 160, 128, 3, 2), (128, 60, 80, 128, 3, 1),
    (256, 60, 80, 256, 3, 2), (512, 30, 40, 512, 3, 2), (512, 15, 20, 512, 3, 1), (64, 120, 160, 256, 1, 1),
    (128, 60, 80, 512, 1, 1), (256, 30, 40, 1024, 1, 1), (512, 15, 20, 2048, 1, 1), (64, 120, 160, 64, 1, 1),
    (256, 120, 160, 64, 1, 1), (256, 120, 160, 128, 1, 1), (256, 120, 160, 512, 1, 2), (512, 60, 80, 128, 1, 1),
    (512, 60, 80, 256, 1, 1), (512, 60, 80, 1024, 1, 2), (1024, 30, 40, 256, 1, 1), (1024, 30, 40, 512, 1, 1),
    (1024, 30, 40, 2048, 1, 2), (2048, 15, 20, 512, 1, 1),
]
PLAN_CASES = ([(n, c, h, w, cout, k, s, 1) for n in (8, 128) for c, h, w, cout, k, s in INT8_CONFIG_SHAPES]
              + KERNEL_CASES)


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_paths_and_tma_limits(case):
    """The wgmma path takes every int8-config shape, the mma.sync path
    the grouped and ragged ones; each wgmma plan respects the TMA's and the
    SM's limits and covers the output with its tiles."""
    n, cin, h, w, cout, k, stride, groups = case
    for out_bytes in (2, 4):
        p = cuda_mod.plan((n, cin, h, w), (cout, cin // groups, k, k), (stride, stride), ((k - 1) // 2,) * 2,
                          groups, alignment=256, out_bytes=out_bytes)
        want = "wgmma" if _wgmma_domain(case, out_bytes) else "mma"
        assert p["path"] == want, (out_bytes, p)
        if case[:5] in [(n, *s[:4]) for s in INT8_CONFIG_SHAPES]:
            assert p["path"] == "wgmma"
        if want == "mma":
            continue
        # a misaligned tensor goes to the mma.sync kernel
        assert cuda_mod.plan((n, cin, h, w), (cout, cin, k, k), (stride, stride), ((k - 1) // 2,) * 2, 1,
                             alignment=8, out_bytes=out_bytes)["path"] == "mma"
        swizzle = {128: 128, 64: 64, 32: 32}[p["bk"]]
        for box, elem, span in ((p["a_box"], 1, swizzle), (p["b_box"], 1, swizzle), (p["o_box"], out_bytes, 128)):
            assert all(1 <= d <= 256 for d in box), box
            assert box[0] * elem % 16 == 0 and box[0] * elem <= span, (box, span)
        for strides in (p["a_strides"], p["b_strides"], p["o_strides"]):
            assert all(s % 16 == 0 and s < 2**40 for s in strides), strides
        assert p["patch_w"] * p["patch_h"] * p["patch_n"] == cuda_mod.WGMMA_BM
        assert np.prod(p["o_box"][1:]) == cuda_mod.WGMMA_BM // 2  # one consumer warpgroup's rows
        assert p["stage_bytes"] == (cuda_mod.WGMMA_BM + p["bn"]) * p["bk"]
        assert 2 <= p["stages"] <= cuda_mod.WGMMA_MAX_STAGES
        assert p["smem"] == 1024 + cuda_mod.EPILOGUE_BYTES + cuda_mod.BARRIER_BYTES + p["stages"] * p["stage_bytes"]
        assert p["smem"] <= cuda_mod.SMEM_LIMIT == 227 * 1024
        assert p["bn"] in (64, 128, 256) and p["tiles_o"] * p["bn"] >= cout
        assert (p["tiles_w"] * p["patch_w"] >= p["o_w"] and p["tiles_h"] * p["patch_h"] >= p["o_h"]
                and p["tiles_n"] * p["patch_n"] >= p["a_n"])
        ho, wo = cuda_mod.conv_output_hw(h, w, (k, k), (stride, stride), ((k - 1) // 2,) * 2)
        assert p["o_w"] * p["o_h"] * p["a_n"] == n * ho * wo
        assert p["grid"] == min(p["tiles"], cuda_mod.H100_SMS)


def test_kernel_refuses_cpu_tensors():
    x = torch.zeros((1, 16, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mod.int8_conv_cuda(x, torch.zeros((8, 16, 1, 1), dtype=torch.int8), torch.ones(8), None,
                                (1, 1), (0, 0), 1, torch.bfloat16)
