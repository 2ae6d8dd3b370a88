"""Frozen-stage int8 training (``backbone.frozen_int8``) in the port against
the JAX package, float32 on the CPU, on the same seeded numpy weights.

In training mode the frozen stem and stages of a float trunk run the
``int8_stream`` deploy arithmetic (``models/resnet.py::ResNet.
forward_frozen_int8``), the first trainable stage reads the dequantized
stream, and at eval the flag does nothing.  The JAX side is jitted: its
compiled arithmetic is the reference (``tests/test_torch_quant.py``).

- (a) the port's trunk with ``frozen_stages=4`` in training mode is its own
  ``quant='int8_stream'`` trunk at eval, bit for bit;
- (b) the ResNet-50 trunk in training mode against JAX's
  ``ResNet(frozen_int8=True).apply(train=True)`` at 64x64, ``frozen_stages``
  0, 1 and 2 (2: the C2 tap handed out dequantized): each package with its
  own int8 levels, C2..C5 and the levels within ``test_torch_quant.py``'s
  stream tolerances; with the port's levels replayed in JAX, within
  ``REPLAYED_RTOL``;
- (c) one train step of ``configs/bop/r50_ycbv_pbr_frozen_int8.py`` (neck
  and head narrowed, 64x64) against JAX's ``build_train_step`` with the
  levels replayed: losses and gradients within ``test_torch_qat.py``'s
  ``STEP_RTOL``; the frozen parameters take no gradient, layer2 onwards
  finite, non-zero ones;
- (d) at eval the model is the flagship's on the same weights, bit for bit,
  and runs no int8 convolution;
- (e) ``with_cp`` changes no tap and no gradient, and recomputes no frozen
  int8 block;
- (f) ``validate_learning --frozen-int8``, ``profile_train --frozen-int8``,
  and ``tools.train`` on the config for 2 steps from the flagship's
  checkpoint: the frozen tensors kept, the checkpoint loaded by the
  flagship's model with ``strict=True`` and the other way round.

Measured on this file's seeds (an x86-64 CPU): (b) with its own levels the
taps differ from JAX's by at most 0.0245 of a map's max (``STREAM_RTOL``
0.06), on 3.47e-3 of the levels (mean over the tensors; ``STREAM_FLIPS``
0.05), by 2 levels at most (``STREAM_LEVELS`` 3); with shared levels by
6.77e-7 of a map's max (``REPLAYED_RTOL`` 1e-5); (c) losses 2.2e-7,
gradients 1.15e-5 of a tensor's max (``STEP_RTOL`` 1e-2, the QAT step's
bound: the int8 prefix is exact with shared levels, the float stages
differ by float32 rounding); (e) taps and gradients equal.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu.models import resnet as jres
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import assignment_cfg_from, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.engine import build_optimizer, build_train_step, load_weights, save_weights
from radet_tpu_torch.engine import state_dict_from_flax
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
from radet_tpu_torch.models import build_backbone
from radet_tpu_torch.models import resnet as pres
from radet_tpu_torch.utils.config import Config
from test_torch_qat import STEP_RTOL, _close
from test_torch_qat_step import _step_batch
from test_torch_quant import STREAM_FLIPS, STREAM_LEVELS, STREAM_RTOL, _nchw, _nhwc, _rel_err
from torch_parity import jax_assignment_noise, numpy_variables
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(REPO, "configs", "bop", "r50_ycbv_pbr_frozen_int8.py")
FLAGSHIP = osp.join(REPO, "configs", "bop", "r50_ycbv_pbr.py")
HW = (64, 64)
# the configs with the neck and head narrowed, at 64x64, float32
NARROW = ["model.neck.out_channels=32", "model.bbox_head.in_channels=32", "model.bbox_head.feat_channels=64",
          "model.bbox_head.stacked_convs=1", "model.bbox_head.num_classes=4", f"input_size={HW}",
          "compute_dtype='float32'"]
# with shared levels the frozen prefix is exact in both packages: the taps
# differ by the float stages' rounding
REPLAYED_RTOL = 1e-5
FROZEN = ("conv1.", "bn1.", "layer1.")


class SharedInt8:
    """The port's activation quantizations in the trunk (``models/resnet.py``'s
    ``quantize_int8``: the stem's, and each frozen block's conv2 and conv3
    inputs and its output) recorded in call order, and JAX's
    (``radet_tpu/models/resnet.py``'s, patched here only) passed through
    ``jax.pure_callback`` in the same order: each call hands on JAX's own
    levels, or with ``replaying`` set the port's (read when the compiled
    function runs, so that one compilation serves both), and keeps JAX's
    own in ``own``."""

    def __init__(self, monkeypatch):
        self.port, self.own, self.jax_calls, self.replaying = [], {}, 0, False
        inner = pres.quantize_int8

        def record(x, scale):
            self.port.append(inner(x, scale))
            return self.port[-1]

        def levels(i, own):
            self.own[i] = np.asarray(own)
            return np.ascontiguousarray(self.port[i].numpy().transpose(0, 2, 3, 1)) if self.replaying else self.own[i]

        def shared(x, scale):
            i = self.jax_calls
            self.jax_calls += 1
            own = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
            return jax.pure_callback(lambda o: levels(i, o), jax.ShapeDtypeStruct(own.shape, jnp.int8), own)

        monkeypatch.setattr(pres, "quantize_int8", record)
        monkeypatch.setattr(jres, "quantize_int8", shared)

    def flips(self):
        """(share of the quantized elements on which JAX's own level differs
        from the port's, mean over the calls of that share, the largest
        difference in levels); checks that both made the same calls."""
        assert len(self.port) == len(self.own) == self.jax_calls, (len(self.port), len(self.own), self.jax_calls)
        diffs = [np.abs(_nhwc(p).astype(np.int32) - self.own[i].astype(np.int32)) for i, p in enumerate(self.port)]
        return (sum(int((d > 0).sum()) for d in diffs) / sum(d.size for d in diffs),
                float(np.mean([np.mean(d > 0) for d in diffs])), max(int(d.max()) for d in diffs))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's float work on one CPU thread: its ResNet-50s are small
    maps, and beside the other test processes more threads only wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trunk_variables():
    """One numpy variable tree of the JAX ResNet-50 (every ``frozen_stages``
    has the same tree), and the same for the port."""
    variables = numpy_variables(lambda: jres.ResNet(depth=50).init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    tree = {c: {"backbone": variables[c]} for c in ("params", "batch_stats")}
    return variables, {k[len("backbone."):]: v for k, v in state_dict_from_flax(tree).items()}


def _trunk(state_dict, **kw):
    trunk = build_backbone(dict(type="ResNet", depth=50, **kw))
    trunk.load_state_dict(state_dict, strict=True)
    return trunk


def _x(seed=1):
    return np.random.RandomState(seed).randn(2, *HW, 3).astype(np.float32)


def test_frozen_prefix_is_the_stream_deploy_path(trunk_variables):
    """(a) Every stage frozen: the training forward is the ``int8_stream``
    eval forward, tap for tap, bit for bit."""
    sd = trunk_variables[1]
    x = _nchw(_x())
    with torch.no_grad():
        got = _trunk(sd, frozen_int8=True, frozen_stages=4).train()(x)
        want = _trunk(sd, quant="int8_stream", frozen_stages=4).eval()(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("frozen_stages", [0, 1, 2])
def test_trunk_matches_jax(trunk_variables, monkeypatch, frozen_stages):
    """(b) The training-mode trunk against JAX's, each with its own levels
    (C2..C5 within ``STREAM_RTOL``, the levels' flip share within
    ``STREAM_FLIPS`` and ``STREAM_LEVELS``), then with the port's levels
    replayed in JAX (within ``REPLAYED_RTOL``)."""
    variables, sd = trunk_variables
    jmodel = jres.ResNet(depth=50, frozen_int8=True, frozen_stages=frozen_stages)
    port = _trunk(sd, frozen_int8=True, frozen_stages=frozen_stages).train()
    x = _x()
    levels = SharedInt8(monkeypatch)
    taps = port(_nchw(x))
    assert len(levels.port) == 1 + 3 * (0, 3, 7)[frozen_stages]
    assert [t.requires_grad for t in taps] == [i >= frozen_stages for i in range(4)]
    forward = jax.jit(lambda v, a: jmodel.apply(v, a, train=True))
    own = jax.block_until_ready(forward(variables, x))
    _, flips, most = levels.flips()
    errs = [_rel_err(_nhwc(t.detach()), r) for t, r in zip(taps, own)]
    levels.replaying = True
    shared = jax.block_until_ready(forward(variables, x))
    share = levels.flips()[0]
    shared_errs = [_rel_err(_nhwc(t.detach()), r) for t, r in zip(taps, shared)]
    print(f"frozen_stages {frozen_stages}: own levels: taps within {max(errs):.3g} of their max, {flips:.3g} of the "
          f"levels differ, by {most} at most; shared levels: taps within {max(shared_errs):.3g} (JAX's own levels "
          f"off them at {share:.3g})")
    assert max(errs) < STREAM_RTOL and flips <= STREAM_FLIPS and most <= STREAM_LEVELS
    assert max(shared_errs) <= REPLAYED_RTOL


def test_train_step_matches_jax(monkeypatch):
    """(c) One step of the narrowed config in both packages on the same
    weights, batch and assignment noise, the port's levels replayed in JAX:
    losses and every gradient within ``STEP_RTOL``; the frozen stem and
    layer1 without a gradient, layer2 onwards with finite non-zero ones."""
    jax_cfg, cfg = JaxConfig.fromfile(CONFIG, NARROW), Config.fromfile(CONFIG, NARROW)
    jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
    port = build_model_and_anchors(cfg)[0]
    assert port.backbone.frozen_int8 and jax_model.backbone_frozen_int8
    variables = numpy_variables(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    num_classes = int(cfg.model.bbox_head.num_classes)
    batch = _step_batch(1, num_classes)
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    key = jax.random.PRNGKey(7)
    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    step_args = dict(img_norm=cfg.img_norm_cfg.to_dict(), num_classes=num_classes)

    levels = SharedInt8(monkeypatch)
    step = build_train_step(port, anchors, ranges, assignment_cfg=assignment_cfg_from(cfg),
                            loss_cfg=loss_cfg_from(cfg), **step_args)
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    metrics = step(TrainState(port.train(), sgd0), batch_to_device(batch, "cpu"), noise)
    assert len(levels.port) == 1 + 3 * 3

    levels.replaying = True
    import optax

    capture = optax.GradientTransformation(  # its state: the gradients of the step
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
    )
    jstep = jax_build_train_step(jax_model, capture, anchors, ranges, assignment_cfg=jax_assignment_cfg_from(jax_cfg),
                                 loss_cfg=jax_loss_cfg_from(jax_cfg), **step_args)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                           opt_state=capture.init(params))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}
    jstate, ref = jax.block_until_ready(jstep(jstate, jbatch, key))
    share = levels.flips()[0]
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})

    assert float(metrics["num_pos"]) > 10
    loss_errs = {k: _close(float(metrics[k]), float(ref[k]), STEP_RTOL, k)
                 for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm")}
    errs = {}
    for k, p in port.named_parameters():
        if k.startswith(tuple("backbone." + f for f in FROZEN)):
            assert p.grad is None and not p.requires_grad, k
            continue
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        errs[k] = _close(p.grad.numpy(), ref_grads[k].numpy(), STEP_RTOL, k)
    assert all(port.get_parameter(k).grad.abs().max() > 0 for k in errs if k.startswith("backbone.layer2.")
               and k.endswith("conv1.weight"))
    print(f"frozen-int8 step: losses within {max(loss_errs.values()):.3g}, gradients within "
          f"{max(errs.values()):.3g} ({max(errs, key=errs.get)}), JAX's own levels off the shared ones at {share:.3g}")


def test_eval_is_the_flagship_float_path(monkeypatch):
    """(d) At eval the ``frozen_int8`` model on the flagship's weights (loaded
    with ``strict=True``) is the flagship model, bit for bit, and runs no
    int8 convolution."""
    flagship = build_model_and_anchors(Config.fromfile(FLAGSHIP, NARROW))[0]
    fi8 = build_model_and_anchors(Config.fromfile(CONFIG, NARROW))[0]
    fi8.load_state_dict(flagship.state_dict(), strict=True)
    calls = []
    inner = pres.int8_conv_forward
    monkeypatch.setattr(pres, "int8_conv_forward", lambda *a: calls.append(1) or inner(*a))
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, *HW).astype(np.float32))
    with torch.no_grad():
        got, want = fi8.eval()(x), flagship.eval()(x)
    assert not calls
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            assert torch.equal(g, w)
    with torch.no_grad():
        fi8.train()(x)
    assert len(calls) == 10  # layer1's 3 blocks: conv1-3 each, and the downsample


def test_with_cp_changes_nothing(trunk_variables, monkeypatch):
    """(e) ``with_cp``: the same taps and gradients as without it, and no
    frozen int8 block recomputed (as many quantizations)."""
    outs = []
    for with_cp in (False, True):
        trunk = _trunk(trunk_variables[1], frozen_int8=True, frozen_stages=1, with_cp=with_cp).train()
        calls = []
        inner = pres.quantize_int8
        monkeypatch.setattr(pres, "quantize_int8", lambda a, s: calls.append(1) or inner(a, s))
        taps = trunk(_nchw(_x(4)[:1]))
        sum((t * (i + 1)).sum() for i, t in enumerate(taps)).backward()
        monkeypatch.setattr(pres, "quantize_int8", inner)
        outs.append(([t.detach() for t in taps], {k: p.grad for k, p in trunk.named_parameters() if p.requires_grad},
                     len(calls)))
    (taps, grads, n), (cp_taps, cp_grads, cp_n) = outs
    assert n == cp_n == 10
    for t, c in zip(taps, cp_taps):
        assert torch.equal(t, c)
    assert grads.keys() == cp_grads.keys() and not any(k.startswith(FROZEN) for k in grads)
    for k, g in grads.items():
        assert torch.equal(cp_grads[k], g), k


# --------------------------------------------------------------- the tools


def test_validate_learning_frozen_int8(capsys):
    """(f) ``validate_learning --frozen-int8`` at a tiny size: the float run,
    then the two fine-tunes, with the JAX tool's three RESULT lines."""
    from radet_tpu_torch.tools import validate_learning

    metrics = validate_learning.main(["--cpu", "--depth", "50", "--frozen-int8", "--iters", "1",
                                      "--frozen-int8-iters", "1", "--images", "2", "--batch", "2", "--img-size", "64",
                                      "64", "--feat", "32", "--stacked-convs", "1", "--workers", "1",
                                      "--min-map50", "0"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT")]
    assert len(lines) == 4 and lines[0].startswith("RESULT mAP50=")
    assert lines[1].startswith("RESULT frozen-float mAP50=") and lines[2].startswith("RESULT frozen-int8 mAP50=")
    assert lines[3].startswith("RESULT frozen-int8-delta mAP50=") and lines[3].endswith("1 fine-tune steps each)")
    assert sorted(metrics["frozen_int8"]) == ["frozen-float", "frozen-int8"]


def test_profile_train_frozen_int8(capsys):
    """(f) ``profile_train --frozen-int8 --device cpu``: the step runs, on the
    plain int8 convolution (no kernel launch on the CPU)."""
    from radet_tpu_torch.tools import profile_train

    out = profile_train.main(["--device", "cpu", "--frozen-int8", "--batch", "1", "--iters", "1", "--input-size",
                              *map(str, HW), "--step-only", "--num-classes", "4"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["frozen_int8"] and out["step_ms"] > 0 and out["int8_launches_per_step"] == 0


def test_train_cli_and_checkpoints_interchange(tmp_path):
    """(f) ``tools.train`` on the config (narrowed, 64x64) for 2 steps from
    the flagship's checkpoint (every tensor loaded), one periodic eval: the
    frozen tensors unchanged, layer2 and the head moved; its checkpoint
    loads into the flagship's model with ``strict=True``."""
    from radet_tpu_torch.data.synthetic import make_synthetic_bop
    from radet_tpu_torch.tools import train as train_cli
    from radet_tpu_torch.utils import get_root_logger
    from synthetic_bop import write_png, write_train_config
    from test_torch_qat import _Log

    root = str(tmp_path)
    ann, prefix = make_synthetic_bop(root, images_per_scene=2, img_hw=HW, num_classes=4, max_objects=3)
    backgrounds = osp.join(root, "backgrounds")
    os.makedirs(backgrounds)
    write_png(osp.join(backgrounds, "bg.png"), np.random.RandomState(2).randint(0, 256, (80, 96, 3), np.uint8))
    config = write_train_config(osp.join(root, "fi8_train.py"), CONFIG, ann, prefix, backgrounds)
    opts = NARROW[:-1] + ["data.samples_per_gpu=1", "data.workers_per_gpu=1", "data.train.classes=None",
                          f"data.train.pipeline.2.img_scale={HW[::-1]}"]
    data_opts = [f"data.val.{k}={v!r}" for k, v in (
        ("ann_file", ann), ("img_prefix", prefix), ("classes", None), ("pipeline.1.img_scale", HW[::-1]))]
    flagship = build_model_and_anchors(Config.fromfile(FLAGSHIP, NARROW))[0]
    flagship.init_weights(torch.Generator().manual_seed(1))
    start = flagship.state_dict()
    flagship_ckpt = osp.join(root, "flagship.pth")
    save_weights(flagship_ckpt, start)

    log = _Log()
    get_root_logger().addHandler(log)
    try:
        train_cli.main([config, "--work-dir", osp.join(root, "work"), "--device", "cpu", "--max-iters", "2",
                        "--cfg-options", *opts, *data_opts, f"load_from={flagship_ckpt!r}", "log_config.interval=1",
                        "checkpoint_config.interval=2", "evaluation.interval=2"])
    finally:
        get_root_logger().removeHandler(log)
    assert f"loaded {len(start)}/{len(start)} tensors from pretrained weights" in log.lines
    iters = [ln for ln in log.lines if ln.startswith("iter ")]
    assert len(iters) == 2 and all(np.isfinite(float(ln.split(" loss ")[1].split()[0])) for ln in iters)
    assert any(ln.startswith("eval: bbox_mAP") for ln in log.lines)
    weights = load_weights(osp.join(root, "work", "checkpoints"))
    assert weights.keys() == start.keys()
    for k in start:
        if k.startswith(tuple("backbone." + f for f in FROZEN)):
            assert torch.equal(weights[k], start[k]), k
    for k in ("backbone.layer2.0.conv1.weight", "bbox_head.atss_cls.weight"):
        assert not torch.equal(weights[k], start[k]), k
    flagship.load_state_dict(weights, strict=True)
