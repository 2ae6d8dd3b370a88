"""Quantization-aware training (``qat``) in the port against the JAX
package, float32 on the CPU, on the same seeded numpy inputs and weights.

The JAX side is jitted: its compiled arithmetic (a product feeding an add
is one fused multiply-add, ``/ 127`` a multiplication by its reciprocal)
is the reference, as in ``tests/test_torch_quant.py``.

- ``fake_quant_ste`` (per tensor and per channel) and
  ``fake_quant_weight_ste`` bit for bit, their gradients equal to
  ``jax.grad``'s;
- the QAT branch of ``Int8Conv`` (dynamic absmax, a static scale per tensor
  and per channel, groups 1 and 4, with a bias): forward bit for bit, the
  gradients of the input, kernel, bias and the per-channel scale (the
  fold's term) within ``GRAD_RTOL`` of their max;
- the head's tower, each ``Bottleneck`` level (``int8_stream`` with and
  without a downsample, ``int8``, ``int8_conv2``), ``BasicBlock`` at
  ``int8``, the ResNet-50 ``int8_stream`` trunk with its QAT stem, and (in
  ``tests/test_torch_qat_step.py``) a whole train step (losses, gradients,
  one AdamW update) of the QAT config at full width, with this file's
  helpers.  Where a float tensor is fake-quantized, two
  float32 implementations put an element on another level now and then
  (one level is max/127: far more than rounding), so these cases share the
  levels: the port's are recorded (``ops/quant.py::quant_levels``) and JAX's
  ``fake_quant_ste`` replays them in the same call order; JAX's own
  decisions are counted, and their share is printed and bounded
  (``FLIP_SHARE``).  The QAT conv stores its output in bfloat16, as JAX's,
  so an element whose float32 sum lands on the other side of a bfloat16
  rounding differs by 2^-8 of itself: ``MODULE_RTOL``, ``STEP_RTOL``;
- a QAT model at eval is the deploy model bit for bit; ``with_cp`` under
  QAT equals the same step without it; the train step runs a QAT model's
  convs, forward and backward, with cuDNN's TF32 off;
- ``tools.train`` on ``configs/bop/r50_ycbv_pbr_int8_qat.py`` (narrowed)
  from a float checkpoint, its checkpoint through ``tools.test`` with
  ``r50_ycbv_pbr_int8_stream.py``; ``validate_learning --qat``.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.models import radet_head as jhead
from radet_tpu.models import resnet as jres
from radet_tpu.ops import quant as jquant
from radet_tpu_torch.apis.common import build_model_and_anchors
from radet_tpu_torch.engine import state_dict_from_flax
from radet_tpu_torch.models import build_backbone
from radet_tpu_torch.models import resnet as pres
from radet_tpu_torch.models.layers import Conv2d
from radet_tpu_torch.models.radet_head import RADetHead
from radet_tpu_torch.ops import quant
from radet_tpu_torch.utils.config import Config
from test_torch_backbones import BLOCK, _carry, _nchw
from torch_parity import numpy_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
QAT_CONFIG = osp.join(REPO, "configs", "bop", "r50_ycbv_pbr_int8_qat.py")
STREAM_CONFIG = osp.join(REPO, "configs", "bop", "r50_ycbv_pbr_int8_stream.py")
GRAD_RTOL = 1e-5  # the QAT conv alone: gradients, relative to each tensor's max |ref|
SCALE_RTOL = 1e-4  # its per-channel scale's gradient: a sum of terms of both signs
MODULE_RTOL = 3e-3  # modules with shared levels: outputs and gradients (bfloat16 roundings, see above)
STEP_RTOL = 1e-2  # the whole step with shared levels: losses and gradients
FLIP_SHARE = 2e-3  # JAX's own levels against the port's, share of the fake-quantized elements
UNSHARED_FLIPS, UNSHARED_RTOL = 0.05, 0.1  # two runs with their own levels: activations' levels, taps


def _close(port, ref, rtol, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"
    return err


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


class SharedLevels:
    """The port's fake-quantization levels recorded in call order (its
    ``quant.quant_levels`` replaced), replayed by JAX's ``fake_quant_ste``
    (replaced in the three modules that call it) in the same order, through
    ``jax.pure_callback``; where JAX's own decision differs is counted in
    ``own``; ``jax_calls`` counts JAX's calls."""

    def __init__(self, monkeypatch):
        self.port, self.own, self.jax_calls = [], {}, 0
        levels = quant.quant_levels

        def record(x, scale):
            r = levels(x, scale)
            self.port.append(r.clone())
            return r

        def replay(x, scale):
            i = self.jax_calls
            self.jax_calls += 1
            xf = x.astype(jnp.float32)
            shape = xf.shape
            r = jax.pure_callback(lambda: self._jax_layout(i, shape), jax.ShapeDtypeStruct(shape, jnp.float32))
            sg = jax.lax.stop_gradient
            own = jnp.clip(jnp.round(sg(xf) / sg(scale)), -127.0, 127.0)
            jax.debug.callback(lambda n, i=i: self.own.__setitem__(i, int(n)), jnp.sum(own != r))
            return (xf + sg(r * scale - xf)).astype(x.dtype)

        monkeypatch.setattr(quant, "quant_levels", record)
        for mod in (jquant, jres, jhead):
            monkeypatch.setattr(mod, "fake_quant_ste", replay)

    def _jax_layout(self, i, shape):
        """Level tensor ``i`` of the port (NCHW activations, OIHW kernels)
        in JAX's layout (NHWC, HWIO) of ``shape``."""
        r = self.port[i].numpy()
        fits = [p for p in ((0, 2, 3, 1), (2, 3, 1, 0)) if tuple(r.transpose(p).shape) == tuple(shape)]
        assert fits, (i, r.shape, shape)
        return np.ascontiguousarray(r.transpose(fits[0]))

    def flip_share(self) -> float:
        """Share of the fake-quantized elements on which JAX's own level
        differs from the port's; checks that both made the same calls."""
        jax.effects_barrier()  # the counts arrive through asynchronous callbacks
        assert self.jax_calls == len(self.port) == len(self.own), (self.jax_calls, len(self.port), len(self.own))
        return sum(self.own.values()) / sum(r.numel() for r in self.port)


# -------------------------------------------------------------- primitives


@pytest.mark.parametrize("kind", ["per_tensor", "per_channel", "weight"])
def test_fake_quant_bit_equal(kind):
    """Forward bit for bit against the jitted JAX primitive (also on levels
    that clip at +-127), gradient: the straight-through identity, as
    ``jax.grad``'s, none for the scale."""
    rng = np.random.RandomState(len(kind))
    x = (rng.randn(2, 9, 11, 24) * 3).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    if kind == "weight":
        x, w = x[:, :3, :3].transpose(1, 2, 0, 3) * 0.1, w[:, :3, :3].transpose(1, 2, 0, 3)  # HWIO (3, 3, 2, 24)
        fn = jquant.fake_quant_weight_ste
        port_x = torch.from_numpy(x.transpose(3, 2, 0, 1).copy()).requires_grad_()

        def run(t):
            return quant.fake_quant_weight_ste(t).permute(2, 3, 1, 0)
    else:
        scale = np.float32(0.0213) if kind == "per_tensor" else (rng.rand(24) * 0.05 + 0.001).astype(np.float32)
        fn = lambda a: jquant.fake_quant_ste(a, scale)  # noqa: E731
        port_x = _nchw(x).requires_grad_()
        s = torch.from_numpy(np.asarray(scale))

        def run(t):
            return quant.fake_quant_ste(t, s[:, None, None] if s.dim() else s).permute(0, 2, 3, 1)
    want = np.asarray(jax.jit(fn)(x))
    if kind != "weight":  # some elements clip at +-127 levels
        assert (np.abs(np.round(x / np.asarray(scale))) > 127).any()
    got = run(port_x)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    ref = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(fn(a) * w)))(x))
    (got * torch.from_numpy(w)).sum().backward()
    grad = port_x.grad.numpy().transpose((2, 3, 1, 0) if kind == "weight" else (0, 2, 3, 1))
    np.testing.assert_array_equal(grad, ref)


@pytest.mark.parametrize("mode,groups", [("dynamic", 1), ("per_tensor", 1), ("per_channel", 1), ("dynamic", 4),
                                         ("per_channel", 4)])
def test_qat_conv_matches_jax(mode, groups):
    """``quant.qat_conv_forward`` against ``Int8Conv(qat=True)(x, s,
    train=True)`` with a bias: the bfloat16 output bit for bit; the
    gradients of x, kernel, bias and a per-channel scale."""
    rng = np.random.RandomState(groups * 10 + len(mode))
    cin, cout = 16, 8
    kernel = (rng.randn(3, 3, cin // groups, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    x = (np.maximum(rng.randn(2, 9, 11, cin), 0) * 2).astype(np.float32)
    scale = {"dynamic": None, "per_tensor": np.float32(0.037),
             "per_channel": (rng.rand(cin) * 0.02 + 0.01).astype(np.float32)}[mode]
    w = (rng.randn(2, 9, 11, cout)).astype(np.float32)
    conv = jquant.Int8Conv(cout, feature_group_count=groups, use_bias=True, qat=True)

    def out(p, a, s):
        return conv.apply({"params": p}, a, s, train=True).astype(jnp.float32)

    params = {"kernel": kernel, "bias": bias}
    want = np.asarray(jax.jit(out)(params, x, scale))
    argnums = (0, 1) if mode == "dynamic" else (0, 1, 2)
    grads = jax.jit(jax.grad(lambda p, a, s: jnp.sum(out(p, a, s) * w), argnums=argnums))(params, x, scale)

    m = Conv2d(cin, cout, 3, padding=1, groups=groups, bias=True)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(bias))
    xt = _nchw(x).requires_grad_()
    st = None if scale is None else torch.from_numpy(np.asarray(scale)).requires_grad_()
    got = quant.qat_conv_forward(m, xt, st)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), want)
    (got.float() * _nchw(w)).sum().backward()
    _close(m.weight.grad.numpy().transpose(2, 3, 1, 0), grads[0]["kernel"], GRAD_RTOL, "kernel")
    _close(m.bias.grad.numpy(), grads[0]["bias"], GRAD_RTOL, "bias")
    _close(_nhwc(xt.grad), grads[1], GRAD_RTOL, "x")
    if mode == "per_channel":
        assert np.abs(grads[2]).max() > 0
        _close(st.grad.numpy(), grads[2], SCALE_RTOL, "x_scale")
    elif mode == "per_tensor":
        assert st.grad is None and not np.asarray(grads[2]).any()  # no gradient through the quantization
    with pytest.raises(AssertionError, match="float inputs"):
        quant.qat_conv_forward(m, xt.detach().to(torch.int8), st)


# ----------------------------------------------------------------- modules


def test_qat_head_tower_matches_jax(monkeypatch):
    """A narrow QAT RADetHead (64 channels, 2 stacked convs, GroupNorm 32)
    in training mode on five random levels: every output, and the
    gradients of every parameter (GroupNorm's scale and bias through the
    static scales' folds too), with shared levels."""
    head = jhead.RADetHead(num_classes=3, in_channels=32, feat_channels=64, stacked_convs=2, quant="int8",
                           qat=True)
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, s, s + 2, 32).astype(np.float32) for s in (8, 4, 2, 1, 1)]
    variables = numpy_variables(lambda: {"params": {"bbox_head": head.init(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"]}})
    port = RADetHead(num_classes=3, in_channels=32, feat_channels=64, stacked_convs=2, quant="int8", qat=True)
    sd = {k[len("bbox_head."):]: v for k, v in state_dict_from_flax(variables).items()}
    port.load_state_dict(sd, strict=True)
    weights = [[rng.randn(*f.shape[:3], c).astype(np.float32) for f in feats] for c in (3, 4, 1)]
    levels = SharedLevels(monkeypatch)

    def jloss(p, fs):
        outs = head.apply({"params": p}, fs, train=True)
        return sum(jnp.sum(o * w) for maps, ws in zip(outs, weights) for o, w in zip(maps, ws)), outs

    port.train()
    outs = port([_nchw(f) for f in feats])
    sum((o * torch.from_numpy(w)).sum() for maps, ws in zip(outs, weights) for o, w in zip(maps, ws)).backward()
    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"]["bbox_head"], feats)
    share = levels.flip_share()
    for maps, ref in zip(outs, want):
        for o, r in zip(maps, ref):
            _close(o.detach().numpy(), r, MODULE_RTOL, "head output")
    ref_sd = {k[len("bbox_head."):]: v for k, v in state_dict_from_flax({"params": {"bbox_head": grads}}).items()}
    errs = {k: _close(p.grad.numpy(), ref_sd[k].numpy(), MODULE_RTOL, k) for k, p in port.named_parameters()}
    assert np.abs(ref_sd["cls_convs.0.gn.weight"].numpy()).max() > 0
    print(f"head: gradients max error {max(errs.values()):.3g}, JAX's own levels differ at {share:.3g}")
    assert share <= FLIP_SHARE


def _block_cases():
    D = pres.Downsample
    return {  # name -> (JAX block, port block, input channels, stream)
        "stream_downsample": (jres.Bottleneck(planes=16, stride=2, has_downsample=True, quant="int8_stream", qat=True),
                              pres.Bottleneck(32, 16, 2, D(32, 64, 2), quant="int8_stream", qat=True), 32, True),
        "stream": (jres.Bottleneck(planes=16, quant="int8_stream", qat=True),
                   pres.Bottleneck(64, 16, 1, None, quant="int8_stream", qat=True), 64, True),
        "int8": (jres.Bottleneck(planes=16, stride=2, has_downsample=True, quant="int8", qat=True),
                 pres.Bottleneck(32, 16, 2, D(32, 64, 2), quant="int8", qat=True), 32, False),
        "int8_conv2": (jres.Bottleneck(planes=16, quant="int8_conv2", qat=True),
                       pres.Bottleneck(64, 16, 1, None, quant="int8_conv2", qat=True), 64, False),
        "basic_int8": (jres.BasicBlock(planes=16, stride=2, has_downsample=True, quant="int8", qat=True),
                       pres.BasicBlock(8, 16, 2, D(8, 16, 2), quant="int8", qat=True), 8, False),
    }


@pytest.mark.parametrize("name", sorted(_block_cases()))
def test_qat_block_matches_jax(name, monkeypatch):
    """Each QAT block in training mode (frozen BN) against JAX's: output,
    the stream's statistics, and the gradients of every parameter (the BN
    affines through the scales' folds too), of the input and of the
    incoming statistics, with shared levels."""
    jblock, pblock, cin, stream = _block_cases()[name]
    rng = np.random.RandomState(len(name))
    x = np.maximum(rng.randn(2, 9, 11, cin), 0).astype(np.float32)
    stats = (np.abs(rng.randn(cin)).astype(np.float32) * 0.2, (rng.rand(cin) + 0.5).astype(np.float32))
    if stream:  # the block's input is the stream fake-quantized at its own scale
        s_in = np.maximum(stats[0] + 4 * np.sqrt(stats[1]), 1e-6) / np.float32(127)
        x = (np.clip(np.round(x / s_in), -127, 127) * s_in).astype(np.float32)
    variables = _carry(jblock, pblock, x, BLOCK)
    levels = SharedLevels(monkeypatch)
    pblock.train()
    xt = _nchw(x).requires_grad_()
    st = tuple(torch.from_numpy(a).requires_grad_() for a in stats)
    y, out_stats = pblock(xt, st, torch.float32) if stream else (pblock(xt), None)
    y_w = rng.randn(*_nhwc(y).shape).astype(np.float32)
    loss = (y * _nchw(y_w)).sum()
    if stream:
        loss = loss + (out_stats[0] * 3.0).sum() + (out_stats[1] * 2.0).sum()
    loss.backward()

    def jloss(p, a, st):
        out = jblock.apply({"params": p, "batch_stats": variables["batch_stats"]}, a, train=True,
                           **(dict(stream=st) if stream else {}))
        y, out_stats = out if stream else (out, None)
        loss = jnp.sum(y * y_w)
        if stream:
            loss = loss + jnp.sum(out_stats[0] * 3.0) + jnp.sum(out_stats[1] * 2.0)
        return loss, (y, out_stats)

    argnums = (0, 1, 2) if stream else (0, 1)
    (_, (want, want_stats)), grads = jax.jit(jax.value_and_grad(jloss, argnums=argnums, has_aux=True))(
        variables["params"], x, stats if stream else None)
    share = levels.flip_share()
    _close(_nhwc(y), want, MODULE_RTOL, "output")
    if stream:
        for g, w in zip(out_stats, want_stats):
            _close(g.detach().numpy(), w, 1e-6, "stream statistics")
        for g, w in zip(st, grads[2]):
            _close(g.grad.numpy(), w, MODULE_RTOL, "incoming statistics' gradient")
    _close(_nhwc(xt.grad), grads[1], MODULE_RTOL, "input gradient")
    path, prefix = BLOCK
    ref = state_dict_from_flax({"params": {path[0]: {path[1]: grads[0]}},
                                "batch_stats": {path[0]: {path[1]: variables["batch_stats"]}}})
    for k, p in pblock.named_parameters():
        _close(p.grad.numpy(), ref[prefix + k].numpy(), MODULE_RTOL, k)
    assert np.abs(ref[prefix + "bn1.weight"].numpy()).max() > 0
    print(f"{name}: {len(levels.port)} fake quantizations, JAX's own levels differ at {share:.3g}")
    assert share <= FLIP_SHARE


def _jax_levels_recorded(monkeypatch):
    """JAX's ``fake_quant_ste`` replaced by one that also appends its levels
    (tracers) to the list returned, for a jitted function to hand out."""
    seen = []
    inner = jquant.fake_quant_ste

    def record(x, scale):
        seen.append(jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127.0, 127.0))
        return inner(x, scale)

    for mod in (jquant, jres, jhead):
        monkeypatch.setattr(mod, "fake_quant_ste", record)
    return seen


def test_qat_trunk_matches_jax(monkeypatch):
    """The ResNet-50 ``int8_stream`` QAT trunk in training mode on a 64x64
    input (the stem fake-quantized before the float max-pool, the stream
    through 16 blocks, the float stream at the taps), each package with its
    own levels: the share of the activations' levels that differ, and
    C2..C5 (the trunk with shared levels, gradients included: the
    full-width step, ``tests/test_torch_qat_step.py``)."""
    backbone = dict(type="ResNet", depth=50, quant="int8_stream", qat=True)
    jmodel = jres.ResNet(**{k: v for k, v in backbone.items() if k != "type"})
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    variables = numpy_variables(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tree = {c: {"backbone": variables[c]} for c in ("params", "batch_stats")}
    port = build_backbone(backbone)
    port.load_state_dict({k[len("backbone."):]: v for k, v in state_dict_from_flax(tree).items()}, strict=True)
    port.train()
    port_levels, levels = [], quant.quant_levels

    def record(a, scale):
        port_levels.append(levels(a, scale))
        return port_levels[-1]

    monkeypatch.setattr(quant, "quant_levels", record)
    with torch.no_grad():
        taps = port(_nchw(x))
    # the stem; 16 blocks: conv1-3 (input, kernel) and the output; 4 downsample convs (input, kernel)
    assert len(port_levels) == 1 + 16 * 7 + 4 * 2
    unshared = _jax_levels_recorded(monkeypatch)
    j_taps, j_levels = jax.jit(lambda v, a: (jmodel.apply(v, a, train=True), list(unshared)))(variables, x)
    assert len(j_levels) == len(port_levels)
    acts = [(p, j) for p, j in zip(port_levels, j_levels) if p.shape[0] == x.shape[0]]
    flips = sum(int((p.numpy().transpose(0, 2, 3, 1) != np.asarray(j)).sum()) for p, j in acts)
    unshared_share = flips / sum(p.numel() for p, _ in acts)
    tap_err = max(float(np.abs(_nhwc(t) - np.asarray(r)).max() / np.abs(np.asarray(r)).max())
                  for t, r in zip(taps, j_taps))
    print(f"trunk, each with its own levels: {unshared_share:.3g} of the activations' levels differ, taps within "
          f"{tap_err:.3g} of their max")
    assert unshared_share <= UNSHARED_FLIPS and tap_err <= UNSHARED_RTOL


# ------------------------------------------------------- the port's own paths

STEP_HW = (64, 64)
# the QAT config with its neck and head narrowed, at 64x64, float32
QAT_NARROW = ["model.neck.out_channels=32", "model.bbox_head.in_channels=32", "model.bbox_head.feat_channels=64",
              "model.bbox_head.stacked_convs=2", "model.bbox_head.num_classes=4", f"input_size={STEP_HW}",
              "compute_dtype='float32'"]


@pytest.mark.parametrize("trunk", ["int8_stream", "int8"])
def test_qat_at_eval_is_the_deploy_model(trunk):
    """A QAT model at eval equals the deploy model (the config without
    ``qat``) on the same weights bit for bit, through every int8 conv; both
    load a float model's checkpoint strictly (one parameter tree)."""
    opts = QAT_NARROW + ([] if trunk == "int8_stream" else ["model.backbone.depth=18", "model.backbone.quant='int8'"])
    qat = build_model_and_anchors(Config.fromfile(QAT_CONFIG, opts))[0]
    deploy = build_model_and_anchors(Config.fromfile(QAT_CONFIG, opts + ["model.backbone.qat=False",
                                                                         "model.bbox_head.qat=False"]))[0]
    flat = build_model_and_anchors(Config.fromfile(QAT_CONFIG, opts + [
        "model.backbone.qat=False", "model.bbox_head.qat=False", "model.backbone.quant=None",
        "model.bbox_head.quant=None"]))[0]
    assert qat.backbone.qat and qat.bbox_head.qat and qat.backbone.quant == trunk and deploy.backbone.quant == trunk
    flat.init_weights(torch.Generator().manual_seed(0))
    qat.load_state_dict(flat.state_dict(), strict=True)
    deploy.load_state_dict(flat.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, *STEP_HW).astype(np.float32))
    with torch.no_grad():
        got, want = qat.eval()(x), deploy.eval()(x)
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            assert torch.equal(g, w)


def test_with_cp_under_qat_equals_the_plain_step():
    """``with_cp`` on the QAT ``int8_stream`` trunk (its stream-carrying
    blocks checkpointed, each recomputing its fake quantizations in
    backward): taps and gradients equal to the same step without it."""
    outs = []
    for with_cp in (False, True):
        trunk = build_backbone(dict(type="ResNet", depth=50, quant="int8_stream", qat=True, with_cp=with_cp))
        trunk.init_weights(torch.Generator().manual_seed(0))
        trunk.train()
        calls = []
        inner = quant.quant_levels

        def count(a, scale):
            calls.append(1)
            return inner(a, scale)

        quant.quant_levels = count
        try:
            taps = trunk(torch.from_numpy(np.random.RandomState(4).randn(2, 3, *STEP_HW).astype(np.float32)))
            sum((t * (i + 1)).sum() for i, t in enumerate(taps)).backward()
        finally:
            quant.quant_levels = inner
        outs.append(([t.detach() for t in taps], {k: p.grad for k, p in trunk.named_parameters() if p.requires_grad},
                     len(calls)))
    (taps, grads, n), (cp_taps, cp_grads, cp_n) = outs
    assert cp_n > n  # the recompute fake-quantized again
    for t, c in zip(taps, cp_taps):
        assert torch.equal(t, c)
    for k, g in grads.items():
        _close(cp_grads[k].numpy(), g.numpy(), 1e-6, k)


@pytest.mark.parametrize("qat", [True, False])
def test_the_train_step_turns_tf32_off_for_qat(qat, monkeypatch):
    """``engine.train_step`` holds a QAT model's forward and backward in
    ``quant.qat_precision`` (cuDNN's TF32 off, read by each conv and its
    backward when they run), and then sets TF32 back as it found it; a
    float model's step leaves the setting alone."""
    from radet_tpu_torch.apis.common import anchors_from_cfg, assignment_cfg_from, loss_cfg_from
    from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
    from radet_tpu_torch.engine import build_optimizer, build_train_step
    from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
    from radet_tpu_torch.models import radet_head as phead
    from synthetic_bop import synthetic_bop_records

    opts = QAT_NARROW + ["model.backbone.depth=18", "model.backbone.quant='int8'"]
    if not qat:
        opts += ["model.backbone.qat=False", "model.bbox_head.qat=False", "model.backbone.quant=None",
                 "model.bbox_head.quant=None"]
    cfg = Config.fromfile(QAT_CONFIG, opts)
    model = build_model_and_anchors(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(0))
    anchors, ranges, _ = anchors_from_cfg(cfg)
    seen = ([], [])  # cuDNN's TF32 at each QAT conv's forward and backward

    def probed(conv, x, x_scale=None):
        out = quant.qat_conv_forward(conv, x, x_scale)
        seen[0].append(torch.backends.cudnn.allow_tf32)
        if out.requires_grad:
            out.register_hook(lambda g: seen[1].append(torch.backends.cudnn.allow_tf32))
        return out

    for mod in (pres, phead):
        monkeypatch.setattr(mod, "qat_conv_forward", probed)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    records = synthetic_bop_records(np.random.RandomState(0), 1, STEP_HW, 4)
    batch = collate([InMemoryBOPDataset(records, train_transforms(STEP_HW, max_gt=32, seed=0), max_gt=32)[0]])
    step = build_train_step(model, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    sgd, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, model)
    model.train()
    metrics = step(TrainState(model, sgd), batch_to_device(batch, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    assert torch.backends.cudnn.allow_tf32
    if qat:
        assert seen[0] and seen[1] and not any(seen[0]) and not any(seen[1])
    else:
        assert seen == ([], [])


class _Log(__import__("logging").Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_cli_fine_tunes_qat_and_the_checkpoint_deploys(tmp_path, capsys):
    """``tools.train`` on ``r50_ycbv_pbr_int8_qat.py`` (its neck and head
    narrowed, 64x64, on the CPU) for two steps from a float model's
    checkpoint (every tensor loaded), its periodic eval on the deploy
    arithmetic; then ``tools.test`` with ``r50_ycbv_pbr_int8_stream.py`` on
    the QAT checkpoint."""
    from radet_tpu_torch.data.synthetic import make_synthetic_bop
    from radet_tpu_torch.engine import load_weights, save_weights
    from radet_tpu_torch.tools import test as test_cli
    from radet_tpu_torch.tools import train as train_cli
    from radet_tpu_torch.utils import get_root_logger
    from synthetic_bop import write_png, write_train_config

    root = str(tmp_path)
    ann, prefix = make_synthetic_bop(root, images_per_scene=4, img_hw=STEP_HW, num_classes=4, max_objects=3)
    backgrounds = osp.join(root, "backgrounds")
    __import__("os").makedirs(backgrounds)
    write_png(osp.join(backgrounds, "bg.png"), np.random.RandomState(2).randint(0, 256, (80, 96, 3), np.uint8))
    config = write_train_config(osp.join(root, "qat_train.py"), QAT_CONFIG, ann, prefix, backgrounds)
    opts = QAT_NARROW[:-1] + ["data.samples_per_gpu=2", "data.workers_per_gpu=1", "data.train.classes=None",
                              f"data.train.pipeline.2.img_scale={STEP_HW[::-1]}"]
    data_opts = [f"data.{split}.{k}={v!r}" for split in ("val", "test") for k, v in (
        ("ann_file", ann), ("img_prefix", prefix), ("classes", None), ("pipeline.1.img_scale", STEP_HW[::-1]))]
    float_model = build_model_and_anchors(Config.fromfile(config, opts + [
        "model.backbone.qat=False", "model.bbox_head.qat=False", "model.backbone.quant=None",
        "model.bbox_head.quant=None"]))[0]
    float_model.init_weights(torch.Generator().manual_seed(1))
    float_ckpt = osp.join(root, "float.pth")
    save_weights(float_ckpt, float_model.state_dict())

    log = _Log()
    get_root_logger().addHandler(log)
    try:
        train_cli.main([config, "--work-dir", osp.join(root, "work"), "--device", "cpu", "--max-iters", "2",
                        "--cfg-options", *opts, *data_opts, f"load_from={float_ckpt!r}", "log_config.interval=1",
                        "checkpoint_config.interval=2", "evaluation.interval=2"])
    finally:
        get_root_logger().removeHandler(log)
    n = len(float_model.state_dict())
    assert f"loaded {n}/{n} tensors from pretrained weights" in log.lines
    iters = [ln for ln in log.lines if ln.startswith("iter ")]
    assert len(iters) == 2 and all(np.isfinite(float(v)) for ln in iters for v in [ln.split(" loss ")[1].split()[0]])
    assert any(ln.startswith("eval: bbox_mAP") for ln in log.lines)
    assert any("int8_conv kernel launches" in ln for ln in log.lines)
    weights = load_weights(osp.join(root, "work", "checkpoints"))
    moved = [k for k in weights if k.startswith("bbox_head.") and weights[k].is_floating_point()
             and not torch.equal(weights[k], float_model.state_dict()[k])]
    assert moved
    deploy = build_model_and_anchors(Config.fromfile(STREAM_CONFIG, QAT_NARROW[:-1]))[0]
    deploy.load_state_dict(weights, strict=True)

    capsys.readouterr()
    test_cli.main([STREAM_CONFIG, osp.join(root, "work", "checkpoints"), "--device", "cpu", "--eval", "bbox",
                   "--cfg-options", *QAT_NARROW[:-1], *data_opts])
    metrics = json.loads(capsys.readouterr().out)
    assert 0 <= metrics["bbox_mAP"] <= 1 and "bbox_mAP_50" in metrics


def test_validate_learning_qat_on_the_cpu(capsys):
    """``validate_learning --cpu --qat`` at a tiny size: the float run, the
    PTQ eval, the QAT fine-tune and the deploy eval, with both RESULT
    lines in the JAX tool's format."""
    from radet_tpu_torch.tools import validate_learning

    metrics = validate_learning.main(["--cpu", "--qat", "--iters", "3", "--qat-iters", "2", "--images", "4",
                                      "--img-size", "64", "96", "--workers", "1", "--min-map50", "0"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT")]
    assert len(lines) == 3 and lines[0].startswith("RESULT mAP50=")
    assert lines[1].startswith("RESULT ptq[int8] mAP50=") and "(delta vs float: mAP50 " in lines[1]
    assert lines[2].startswith("RESULT qat[int8] mAP50=") and "PTQ gap after 2 steps)" in lines[2]
    assert sorted(metrics["qat"]) == ["ptq[int8]", "qat[int8]"]
    assert all(0 <= m["bbox_mAP_50"] <= 1 for m in metrics["qat"].values())
