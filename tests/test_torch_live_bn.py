"""Live BatchNorm (``norm_eval=False``) and gradient checkpointing
(``backbone.with_cp``) in the port against the JAX package, float32 on
the CPU, on the same seeded numpy weights and inputs
(``torch_parity.numpy_variables``):

- each block kind in training mode against ``apply(..., train=True,
  mutable=['batch_stats'])``, in float64 (``jax.enable_x64``): output and
  new running statistics within 1e-10 of max |ref|, the parameters'
  gradients within 1e-10 of the largest; ResNeSt's gate BN on its pooled
  map at batch 1 (variance 0) and 2;
- one narrow train step (ResNet-18, widths 64, 128x160, batch 2) at
  ``frozen_stages`` -1 and 1 against the JAX train step, the trunks taking
  each ReLU on the same side: losses within 1e-5, gradients within 1e-4
  and every running mean and variance within 1e-5 of its tensor's max
  |ref|; the statistics through a checkpoint;
- ``with_cp=True`` against the same step without it: gradients within 1e-6,
  running statistics updated once; and a ResNet-18 trunk against JAX's
  ``nn.remat`` one, in float64 as the blocks;
- eval mode uses the running statistics; ``norm_eval=True`` trains as
  before, its statistics untouched.
"""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu.models import resnet as jres
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import assignment_cfg_from, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
from radet_tpu_torch.engine import CheckpointManager, build_optimizer, build_train_step, state_dict_from_flax
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
from radet_tpu_torch.models import build_backbone
from radet_tpu_torch.models import resnet as pres
from radet_tpu_torch.utils.config import Config
from synthetic_bop import synthetic_bop_records
from test_torch_backbones import BACKBONE, BLOCK, SPLIT_ATTENTION, _blocks, _carry, _nchw
from torch_parity import FLAGSHIP, NARROW, jax_assignment_noise, numpy_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

STAT_RTOL = 1e-5
# the narrow flagship on ResNet-18 with live BN at validate_learning's input
# size: at 64x96 layer4's BNs see 12 values a channel, and the rounding of
# their float32 statistics alone moves P5-P7's gradients by 1e-4 of their max
STEP_HW = (128, 160)
LIVE = [o for o in NARROW if not o.startswith("input_size")] + [
    f"input_size={STEP_HW}", "model.backbone.depth=18", "model.backbone.norm_eval=False", "data.samples_per_gpu=2"]


def _close(port, ref, rtol, what=""):
    """|port - ref| <= rtol * max(|ref|, tiny) (tests/test_torch_train.py's)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


def _live(module):
    """``module``'s BatchNorms with batch statistics, in training mode."""
    for m in module.modules():
        if isinstance(m, pres.BatchNorm):
            m.norm_eval = False
    return module.train()


def _stats(sd):
    return {k: v for k, v in sd.items() if "running_" in k}


def _nested(tree, path):
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _state_dict(variables, path, avg_down=None):
    """``state_dict_from_flax`` of a float64 tree placed at ``path``, in
    float64: the converter writes float32, so the tree goes through it as
    float32 high and low parts, added back in float64."""
    tree = {c: _nested(t, path) for c, t in variables.items()}
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    lo = jax.tree_util.tree_map(lambda a, h: np.asarray(np.asarray(a, np.float64) - h, np.float32), tree, hi)
    sd_hi, sd_lo = state_dict_from_flax(hi, avg_down), state_dict_from_flax(lo, avg_down)
    return {k: v.double() + sd_lo[k].double() for k, v in sd_hi.items()}


def _train_apply(flax_module, variables, x):
    """JAX's training-mode output, new batch statistics and the gradients
    of sum(out^2) / 2 with respect to the parameters (outputs summed over a
    tuple)."""
    def loss(params):
        out, mutated = flax_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         jnp.asarray(x), train=True, mutable=["batch_stats"])
        outs = out if isinstance(out, tuple) else (out,)
        return 0.5 * sum(jnp.sum(o ** 2) for o in outs), (out, mutated["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return out, jax.tree_util.tree_map(np.asarray, stats), jax.tree_util.tree_map(np.asarray, grads)


def _port_apply(port_module, x):
    """The port's training-mode output(s) and sum(out^2) / 2's backward."""
    out = _live(port_module)(_nchw(x))
    outs = out if isinstance(out, tuple) else (out,)
    (0.5 * sum(o.square().sum() for o in outs)).backward()
    return outs


def _check_module(flax_module, port_module, x, where, avg_down=None):
    """One training-mode forward and backward of both in float64, where
    rounding cannot hide a wrong formula (a pooled gate's variance over two
    samples, E[x^2] - mean^2 in float32, is ill-conditioned): outputs and
    running statistics within 1e-10 of max |ref|, every gradient within
    1e-10 of the module's largest (a bias in front of a batch-statistics BN
    has none).  Returns (the variables before, JAX's new statistics by the
    port's names), both in float64."""
    path, prefix = where
    variables = _carry(flax_module, port_module, x, where, avg_down, train=False)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref, stats, grads = _train_apply(flax_module.clone(dtype=jnp.float64), variables, x.astype(np.float64))
    port_outs = _port_apply(port_module.double(), x.astype(np.float64))
    for got, want in zip(port_outs, ref if isinstance(ref, tuple) else (ref,)):
        _close(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want), 1e-10, "output")
    sd = _state_dict({"params": grads, "batch_stats": stats}, path, avg_down)
    for k, v in _stats(port_module.state_dict()).items():
        _close(v.numpy(), sd[prefix + k].numpy(), 1e-10, k)
    scale = max(np.abs(v.numpy()).max() for k, v in sd.items() if "running_" not in k)
    for k, p in port_module.named_parameters():
        err = np.abs(p.grad.numpy() - sd[prefix + k].numpy()).max() / scale
        assert err <= 1e-10, f"{k} gradient: error {err:.3g} of the largest gradient"
    return _state_dict(variables, path, avg_down), {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("name", ["basic_avg_down_s2", "bottleneck_grouped_s2", "bottle2neck_stage_s2",
                                  "bottle2neck_normal", "split_attention_bottleneck_s2", "regnet_bottleneck_s2"])
def test_block_with_batch_statistics_matches_jax(name, rng):
    flax_block, port_block, cin = _blocks()[name]
    x = rng.randn(2, 17, 23, cin).astype(np.float32)
    old, new = _check_module(flax_block.clone(norm_eval=False), port_block, x, BLOCK, "avg_down" in name)
    # the statistics moved: 0.9 of the old plus 0.1 of the batch's
    assert not torch.allclose(new["bn1.running_var"], old[BLOCK[1] + "bn1.running_var"])


@pytest.mark.parametrize("batch", [1, 2])
def test_split_attention_gate_batch_statistics_match_jax(batch, rng):
    """The gate BN normalizes the pooled (N, C, 1, 1) map: its statistics run
    over N alone, so at batch 1 its variance is 0 and it returns its bias."""
    flax_conv = jres.SplitAttentionConv(channels=16, groups=2, radix=2, norm_eval=False)
    x = rng.randn(batch, 9, 11, 16).astype(np.float32)
    port_conv = pres.SplitAttentionConv(16, 1, 2, 2)
    old, new = _check_module(flax_conv, port_conv, x, SPLIT_ATTENTION)
    if batch == 1:
        assert torch.equal(port_conv.bn1.running_var, 0.9 * old[SPLIT_ATTENTION[1] + "bn1.running_var"])
        _close(new["bn1.running_var"].numpy(), port_conv.bn1.running_var.numpy(), 1e-12, "0.9 of the old")


# ------------------------------------------------------------ the whole step


def _narrow_pair(frozen_stages):
    opts = LIVE + [f"model.backbone.frozen_stages={frozen_stages}"]
    jax_cfg, cfg = JaxConfig.fromfile(FLAGSHIP, opts), Config.fromfile(FLAGSHIP, opts)
    jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
    port, _, _, _ = build_model_and_anchors(cfg)
    h, w = STEP_HW
    variables = numpy_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), train=False))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jax_cfg, cfg, jax_model, variables, port, anchors, ranges


def _batch():
    ds = InMemoryBOPDataset(synthetic_bop_records(np.random.RandomState(0), 2, STEP_HW, 4),
                            train_transforms(STEP_HW, max_gt=32, seed=0), max_gt=32)
    return collate([ds[i] for i in range(2)])


def _port_step(cfg, port, anchors, ranges, batch, noise):
    """One zero-lr SGD step of ``port`` in training mode; returns the metrics."""
    step = build_train_step(port, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    port.train()
    return step(TrainState(port, sgd0), batch_to_device(batch, "cpu"), noise)


def _shared_trunk_relus(monkeypatch):
    """Both packages' ResNet modules see a stand-in for their ``F`` / ``nn``:
    the port's records the side of each ReLU input (x > 0), JAX's applies
    the recorded sides in the same call order (x * mask), so that both
    trunks take every ReLU the same way.  Batch statistics centre each BN's
    output on 0, where a ReLU input within rounding of 0 lands on opposite
    sides in two float32 runs and moves its channel's gradient (ROADMAP,
    Queue 3's not-faults; ``chip_smoke.py::relu_decisions``).  Returns the
    recorded masks."""
    masks = []

    def record(x, inplace=False):
        masks.append((x > 0).detach().numpy().transpose(0, 2, 3, 1))
        return F.relu(x)

    def replay(x):
        return x * jnp.asarray(masks.pop(0), x.dtype)

    monkeypatch.setattr(pres, "F", types.SimpleNamespace(**dict(vars(F), relu=record)))
    monkeypatch.setattr(jres, "nn", types.SimpleNamespace(**dict(vars(flax.linen), relu=replay)))
    return masks


@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_train_step_with_batch_statistics_matches_jax(frozen_stages, tmp_path, monkeypatch):
    """JAX passes ``train`` into every block, frozen or not: the stem's and
    the frozen stages' BNs also normalize with batch statistics and update
    their running statistics (mmdet's ``_freeze_stages`` would put them in
    eval mode).  The trunks share their ReLU decisions."""
    jax_cfg, cfg, jax_model, variables, port, anchors, ranges = _narrow_pair(frozen_stages)
    batch = _batch()
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    key = jax.random.PRNGKey(7)
    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    before = {k: v.clone() for k, v in _stats(port.state_dict()).items()}
    masks = _shared_trunk_relus(monkeypatch)
    metrics = _port_step(cfg, port, anchors, ranges, batch, noise)
    assert len(masks) == 1 + 2 * 8  # the stem's, two in each block

    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
    )
    jstep = jax_build_train_step(
        jax_model, capture, anchors, ranges, img_norm=jax_cfg.img_norm_cfg.to_dict(), num_classes=4,
        assignment_cfg=jax_assignment_cfg_from(jax_cfg), loss_cfg=jax_loss_cfg_from(jax_cfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=variables["batch_stats"], opt_state=capture.init(params))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}
    jstate, ref = jstep(jstate, jbatch, key)
    assert not masks  # JAX's trunk made as many ReLU calls, of the same shapes
    ref_sd = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                   "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)})

    assert float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        _close(float(metrics[k]), float(ref[k]), 1e-5, k)
    for name, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_sd[name].numpy(), 1e-4, name)
        else:
            assert p.grad is None and not ref_sd[name].any(), name
    stats = _stats(port.state_dict())
    assert len(stats) == 2 * 20  # ResNet-18: the stem, 16 block BNs, 3 downsample BNs
    for k, v in stats.items():
        _close(v.numpy(), ref_sd[k].numpy(), STAT_RTOL, k)
        assert not torch.equal(v, before[k]), f"{k} did not move"  # frozen stages too

    # the statistics travel with the trainer's checkpoints
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    tx, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    ckpt.save(1, TrainState(port, tx, step=1), force=True)
    other = build_model_and_anchors(cfg)[0]
    restored = ckpt.restore(TrainState(other, build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"),
                                                              None, other)[0]))
    for k, v in _stats(restored.model.state_dict()).items():
        assert torch.equal(v, stats[k]), k


def test_eval_mode_uses_running_statistics(rng):
    bb = build_backbone(dict(type="ResNet", depth=18, norm_eval=False, frozen_stages=-1))
    frozen = build_backbone(dict(type="ResNet", depth=18, norm_eval=True, frozen_stages=-1))
    x = torch.from_numpy(rng.randn(2, 3, 32, 48).astype(np.float32))
    frozen.load_state_dict(bb.state_dict())
    bb.eval()
    with torch.no_grad():
        for a, b in zip(bb(x), frozen(x)):
            assert torch.equal(a, b)
    before = {k: v.clone() for k, v in _stats(frozen.state_dict()).items()}
    frozen.train()
    frozen(x)
    for k, v in _stats(frozen.state_dict()).items():
        assert torch.equal(v, before[k]), k  # norm_eval=True never touches them
    bb.train()
    live = bb(x)
    frozen.eval()
    assert not torch.allclose(live[-1], frozen(x)[-1])


# ------------------------------------------------------------ checkpointing


def test_with_cp_equals_the_plain_step():
    """The same step with ``with_cp``: gradients within 1e-6 and the running
    statistics updated once, though each block's forward runs twice."""
    _, cfg, _, variables, plain, anchors, ranges = _narrow_pair(-1)
    cp_cfg = Config.fromfile(FLAGSHIP, LIVE + ["model.backbone.frozen_stages=-1", "model.backbone.with_cp=True"])
    cp = build_model_and_anchors(cp_cfg)[0]
    assert cp.backbone.with_cp and not plain.backbone.with_cp
    cp.load_state_dict(plain.state_dict(), strict=True)
    batch = _batch()
    _, n, g = batch["dist_vals"].shape
    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.PRNGKey(3), 2, g, n, 10))
    calls = []
    hook = cp.backbone.layer2[0].bn1.register_forward_hook(lambda *a: calls.append(1))
    got = _port_step(cp_cfg, cp, anchors, ranges, batch, noise)
    hook.remove()
    assert len(calls) == 2  # the block's forward, and its recompute in backward
    want = _port_step(cfg, plain, anchors, ranges, batch, noise)
    for k in want:
        _close(float(got[k]), float(want[k]), 1e-6, k)
    grads = dict(plain.named_parameters())
    for name, p in cp.named_parameters():
        _close(p.grad.numpy(), grads[name].grad.numpy(), 1e-6, name)
    ref = _stats(plain.state_dict())
    for k, v in _stats(cp.state_dict()).items():
        _close(v.numpy(), ref[k].numpy(), 1e-6, k)
    init = state_dict_from_flax(variables)
    k = "backbone.layer2.0.bn1.running_mean"
    _close((ref[k] - 0.9 * init[k]).numpy(), (cp.state_dict()[k] - 0.9 * init[k]).numpy(), 1e-5, "one update")


def test_with_cp_trunk_matches_jax_remat(rng):
    """A ResNet-18 trunk with ``with_cp`` and live BN against JAX's
    ``nn.remat`` one, in float64: C2..C5, the statistics (flax keeps the
    primal forward's update only) and the gradients of sum(C2..C5^2) / 2."""
    flax_bb = jres.ResNet(depth=18, frozen_stages=-1, norm_eval=False, with_cp=True)
    port_bb = build_backbone(dict(type="ResNet", depth=18, frozen_stages=-1, norm_eval=False, with_cp=True))
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    _check_module(flax_bb, port_bb, x, BACKBONE)


@pytest.mark.parametrize("backbone", [
    dict(type="ResNet", depth=50), dict(type="ResNeXt", depth=50, groups=32),
    dict(type="Res2Net", depth=50), dict(type="ResNeSt", depth=50), dict(type="RegNet", arch="regnetx_400mf"),
    dict(type="ResNetV1d", depth=18),
], ids=lambda b: b["type"])
def test_every_trunk_builds_with_cp_and_live_bn(backbone):
    """Every trunk takes both options with the plain build's parameter and
    buffer names (checkpoints interchangeable), and sets every BN live."""
    plain = build_backbone(backbone)
    both = build_backbone(dict(backbone, with_cp=True, norm_eval=False))
    assert list(both.state_dict()) == list(plain.state_dict())
    bns = [m for m in both.modules() if isinstance(m, pres.BatchNorm)]
    assert bns and all(not m.norm_eval for m in bns) and both.with_cp
