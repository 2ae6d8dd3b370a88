"""The port's training path against the JAX package, float32 on the CPU.

Losses (every ``BBOX_LOSS_FNS`` entry, focal, BCE) within 1e-6 relative,
gradients included; ``radet_loss`` within 1e-5; the LR schedules within
1e-7; five optimizer steps (AdamW, clip, frozen stages, ``custom_keys``
groups) within 1e-6 of optax; one whole ``build_train_step`` call on the
narrow flagship (64x96, widths 64, 2 stacked convs, 4 classes) from the same
weights, batch and assignment noise: losses within 1e-5 relative, every
gradient within 1e-4 of its tensor's max abs.  Then the host data path
against the JAX transforms and loader, checkpoint resume, the entry point's
refusals, and ``train_detector`` with JAX made unimportable.
"""

import os
import os.path as osp
import pickle
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.data import loader as jax_loader
from radet_tpu.data import pipeline as jax_pipeline
from radet_tpu.engine.optim import build_lr_schedule as jax_build_lr_schedule
from radet_tpu.engine.optim import build_optimizer as jax_build_optimizer
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu.models.radet_loss import radet_loss as jax_radet_loss
from radet_tpu.ops import losses as jax_losses
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch import train_detector
from radet_tpu_torch.apis.common import assignment_cfg_from, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.core.anchors import anchor_centers, generate_anchors
from radet_tpu_torch.data import (
    DataLoader,
    GenerateDistanceMap,
    InMemoryBOPDataset,
    Pad,
    RandomFlip,
    SampleDistanceAtAnchors,
    build_pipeline,
    collate,
    train_transforms,
)
from radet_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    load_meta,
    load_weights,
    save_weights,
    write_meta,
)
from radet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device, build_train_step
from radet_tpu_torch.models.radet_loss import radet_loss
from radet_tpu_torch.ops import losses
from radet_tpu_torch.utils.config import Config
from torch_parity import (
    FLAGSHIP,
    IMG_HW,
    NARROW,
    flax_and_port_models,
    jax_assignment_noise,
    state_dict_from_flax,
)
from synthetic_bop import synthetic_bop_records as synthetic_records
from torch_threads import default_torch_threads, one_thread_env, one_torch_thread  # noqa: F401 (fixtures)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAIN = NARROW + ["data.samples_per_gpu=2"]


def _close(port, ref, rtol, what=""):
    """|port - ref| <= rtol * max(|ref|, tiny), elementwise on the scale of the tensor."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / scale
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


# ---------------------------------------------------------------- losses


def _boxes(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", sorted(losses.BBOX_LOSS_FNS) + ["focal", "bce"])
def test_loss_and_gradient_match_jax(name, rng):
    n = 64
    if name == "focal":
        x = rng.randn(n, 5).astype(np.float32) * 2
        labels = rng.randint(0, 6, n)  # 5 is the background
        w = rng.uniform(0, 2, n).astype(np.float32)
        kw = dict(num_classes=5, gamma=2.0, alpha=0.25, avg_factor=7.5, loss_weight=1.5)
        ref_fn = lambda a: jax_losses.sigmoid_focal_loss(a, jnp.asarray(labels), jnp.asarray(w), **kw)
        port_fn = lambda a: losses.sigmoid_focal_loss(a, torch.from_numpy(labels), torch.from_numpy(w), **kw)
    elif name == "bce":
        x = rng.randn(n).astype(np.float32) * 3
        t = rng.uniform(0, 1, n).astype(np.float32)
        w = rng.uniform(0, 2, n).astype(np.float32)
        ref_fn = lambda a: jax_losses.bce_with_logits(a, jnp.asarray(t), jnp.asarray(w), avg_factor=9.0)
        port_fn = lambda a: losses.bce_with_logits(a, torch.from_numpy(t), torch.from_numpy(w), avg_factor=9.0)
    else:
        x = _boxes(rng, n)
        target = _boxes(rng, n)
        target[:16] = x[:16] + rng.uniform(-2, 2, (16, 4)).astype(np.float32)
        if "IoU" in name and name != "BoundedIoULoss":
            # identical boxes (IoU = 1, CIoU's double where); the others have
            # a kink there (|d|, min(tw/pw, pw/tw)) where the frameworks'
            # subgradients differ
            target[:8] = x[:8]
        w = rng.uniform(0, 2, n).astype(np.float32)
        ref_fn = lambda a: jax_losses.BBOX_LOSS_FNS[name](a, jnp.asarray(target), jnp.asarray(w), avg_factor=11.0)
        port_fn = lambda a: losses.BBOX_LOSS_FNS[name](a, torch.from_numpy(target), torch.from_numpy(w),
                                                      avg_factor=torch.tensor(11.0))
    ref, ref_grad = jax.value_and_grad(ref_fn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_fn(xt)
    out.backward()
    assert np.isfinite(xt.grad.numpy()).all()
    _close(out.item(), float(ref), 1e-6, name)
    _close(xt.grad.numpy(), ref_grad, 1e-6, f"{name} gradient")


@pytest.mark.parametrize("bbox_type,extra", [("GIoULoss", ()), ("IoULoss", (("linear", True),))])
def test_radet_loss_matches_jax(bbox_type, extra, rng):
    anchors, _, _, _ = generate_anchors(IMG_HW)
    b, n, c, g = 2, anchors.shape[0], 4, 5
    cls = rng.randn(b, n, c).astype(np.float32)
    reg = np.abs(rng.randn(b, n, 4)).astype(np.float32) * 3 + 1
    iou = rng.randn(b, n).astype(np.float32)
    gt_boxes = np.stack([_boxes(rng, g) for _ in range(b)])
    gt_labels = rng.randint(0, c, (b, g)).astype(np.int32)
    gt_idx = rng.choice([-2, -1, -1, -1, 0, 1, 2, 3, 4], (b, n)).astype(np.int32)
    weight = np.where(gt_idx >= 0, rng.randint(1, 4, (b, n)), np.where(gt_idx == -1, 1, 0)).astype(np.float32)
    kw = dict(num_classes=c, bbox_loss_type=bbox_type, bbox_loss_extra=extra)

    def ref_fn(cl, rg, io):
        return jax_radet_loss(cl, rg, io, jnp.asarray(anchors), gt_boxes, gt_labels, gt_idx, weight, **kw)

    ref = jax.jit(ref_fn)(cls, reg, iou)
    ref_grads = jax.jit(jax.grad(lambda *a: sum(v for k, v in ref_fn(*a).items() if k.startswith("loss")),
                                 argnums=(0, 1, 2)))(cls, reg, iou)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (cls, reg, iou)]
    out = radet_loss(*xs, torch.from_numpy(anchors), torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels),
                     torch.from_numpy(gt_idx), torch.from_numpy(weight), **kw)
    sum(v for k, v in out.items() if k.startswith("loss")).backward()
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos"):
        _close(out[k].item(), float(ref[k]), 1e-5, k)
    for x, gr, what in zip(xs, ref_grads, ("cls", "reg", "iou")):
        _close(x.grad.numpy(), gr, 1e-5, f"d/d{what}")


# ------------------------------------------------------ schedules, optimizer

SCHEDULES = {
    "onecycle": dict(policy="onecycle", max_lr=0.01, total_steps=1000, pct_start=0.05),
    "step_linear": dict(policy="step", step=[600, 900], warmup="linear", warmup_iters=50, warmup_ratio=0.001),
    "step_constant": dict(policy="step", step=[600], warmup="constant", warmup_iters=50, warmup_ratio=0.1),
    "step_exp": dict(policy="step", step=[600, 900], gamma=0.5, warmup="exp", warmup_iters=50,
                     warmup_ratio=0.01),
    "fixed": dict(policy="fixed"),
}


@pytest.mark.parametrize("policy", list(SCHEDULES))
def test_lr_schedule_matches_jax(policy):
    # steps 0, 1, mid-warmup, peak / warmup end, the milestones, total_steps, past it
    steps = [0, 1, 25, 49, 50, 599, 600, 900, 1000, 1500]
    ref = jax_build_lr_schedule(SCHEDULES[policy], 0.01)
    port = build_lr_schedule(SCHEDULES[policy], 0.01)
    np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps], rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def narrow():
    """Both packages' narrow flagship with the same random weights."""
    jax_cfg = JaxConfig.fromfile(FLAGSHIP, TRAIN)
    cfg = Config.fromfile(FLAGSHIP, TRAIN)
    jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
    port, p_anchors, p_ranges, _ = build_model_and_anchors(cfg)
    np.testing.assert_array_equal(p_ranges, ranges)
    variables = flax_and_port_models(jax_model, port)
    return jax_cfg, cfg, jax_model, variables, port, anchors, ranges


def test_optimizer_matches_optax(narrow):
    """Five steps from the same gradients: AdamW, the clip at 35 (binding on
    some steps), stem and layer1 frozen, two nested ``custom_keys`` groups."""
    _, _, _, variables, port, _, _ = narrow
    opt_cfg = dict(type="AdamW", lr=0.01, weight_decay=0.05,
                   paramwise_cfg=dict(custom_keys={"bbox_head": dict(lr_mult=2.0),
                                                   "bbox_head.cls": dict(lr_mult=0.5, decay_mult=0.0),
                                                   "neck": dict(lr_mult=0.1, decay_mult=0.5)}))
    lr_cfg = dict(policy="onecycle", max_lr=0.01, total_steps=20, pct_start=0.2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx, _ = jax_build_optimizer(opt_cfg, lr_cfg, dict(max_norm=35.0), params, frozen_stages=1)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt_state = tx.init(params)

    model = port
    model.load_state_dict(state_dict_from_flax(variables))
    ptx, _ = build_optimizer(opt_cfg, lr_cfg, dict(max_norm=35.0), model)
    named = dict(model.named_parameters())
    frozen0 = {k: p.detach().clone() for k, p in named.items() if not p.requires_grad}
    rng = np.random.RandomState(0)
    clipped = []
    for step in range(5):
        scale = (0.2, 2.0)[step % 2]  # global norm below and above 35
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32) * scale * 1e-2, params)
        sd = state_dict_from_flax({"params": grads, "batch_stats": variables["batch_stats"]})
        for k, p in named.items():
            p.grad = sd[k].clone() if p.requires_grad else None
        trainable = {k for k, p in named.items() if p.requires_grad}
        ref_norm = np.sqrt(sum(float((sd[k].double() ** 2).sum()) for k in trainable))
        norm = ptx.step()
        # float32 sums over tensors of up to 2.4M elements
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-4)
        clipped.append(ref_norm > 35.0)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert any(clipped) and not all(clipped)
    ref = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, params),
                                "batch_stats": variables["batch_stats"]})
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    for k, v in frozen0.items():
        assert torch.equal(named[k].detach(), v), k
    lrs = sorted({g["lr"] for g in ptx.optimizer.param_groups})
    assert len(lrs) == 4  # default, bbox_head, bbox_head.cls and neck groups
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(dict(type="RMSprop"), lr_cfg, None, model)


# ------------------------------------------------------------ the whole step


def _batch(cfg, n=2, seed=0):
    anchors, _, _, _ = generate_anchors(IMG_HW)
    ds = InMemoryBOPDataset(synthetic_records(np.random.RandomState(seed), n, IMG_HW, 4),
                            train_transforms(IMG_HW, max_gt=32, seed=seed), max_gt=32)
    return collate([ds[i] for i in range(n)])


# its gradients at 1e-4 of each tensor's max hold on torch's default thread
# count, not on one (ROADMAP.md, Queue 3)
@pytest.mark.usefixtures("default_torch_threads")
def test_train_step_matches_jax(narrow):
    jax_cfg, cfg, jax_model, variables, port, anchors, ranges = narrow
    port.load_state_dict(state_dict_from_flax(variables))
    batch = _batch(cfg)
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    # the JAX step's optimizer stores the gradients as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
    )
    jstep = jax_build_train_step(
        jax_model, capture, anchors, ranges, img_norm=jax_cfg.img_norm_cfg.to_dict(), num_classes=4,
        assignment_cfg=jax_assignment_cfg_from(jax_cfg), loss_cfg=jax_loss_cfg_from(jax_cfg),
    )
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=variables["batch_stats"], opt_state=capture.init(params))
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}
    jstate, ref = jstep(jstate, jbatch, key)
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})

    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    step = build_train_step(port, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    dev_batch = batch_to_device(batch, "cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    state = TrainState(port, sgd0)
    metrics = step(state, dev_batch, noise)
    assert state.step == 1 and float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        _close(float(metrics[k]), float(ref[k]), 1e-5, k)
    for name, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-4, name)
        else:
            assert p.grad is None and not ref_grads[name].any(), name

    # the flagship optimizer: frozen stages bit for bit, the rest moves
    tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), port)
    state = TrainState(port, tx)
    metrics = step(state, dev_batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    moved = 0
    for name, p in port.named_parameters():
        if p.requires_grad:
            moved += not torch.equal(p.detach(), before[name])
        else:
            assert torch.equal(p.detach(), before[name]), name
    assert moved > 100


class _JnpX64:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX package's
    explicit float32 casts (preprocessing, GroupNorm, the head's outputs)
    keep float64 under it."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _float64_grads(opt_state, batch_stats):
    """The JAX step's float64 gradients as a port state dict in float64:
    ``state_dict_from_flax`` gives float32 tensors, so the gradients go
    through it as a float32 head and tail whose sum is exact to 2^-48."""
    g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), opt_state)
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), g)
    lo = jax.tree_util.tree_map(lambda a, h: (a - h.astype(np.float64)).astype(np.float32), g, hi)
    hi_sd = state_dict_from_flax({"params": hi, "batch_stats": batch_stats})
    lo_sd = state_dict_from_flax({"params": lo, "batch_stats": batch_stats})
    return {k: hi_sd[k].double() + lo_sd[k].double() for k in hi_sd}


def test_train_step_matches_jax_in_float64(monkeypatch):
    """The float32 case above holds its gradients at 1e-4 of each tensor's
    max only on torch's default thread count (ROADMAP Queue 3): in float64,
    on one thread, the same narrow step of both packages (the JAX package
    under x64, its float32 casts read as float64; the port's model in
    float64) agrees to 1e-10 of each tensor's max and its losses to 1e-12,
    so the float32 gap is the order of float32 reductions.  The JAX
    package is not edited: its modules' ``jnp`` and the dtype table of
    ``radet_tpu/models/builder.py`` are patched for this test only."""
    import radet_tpu.models.builder as jax_builder

    assert torch.get_num_threads() == 1
    cfg = Config.fromfile(FLAGSHIP, TRAIN)
    batch = _batch(cfg)
    with jax.enable_x64(True):
        monkeypatch.setitem(jax_builder._DTYPES, "float64", jnp.float64)
        for name, mod in list(sys.modules.items()):
            if name.startswith("radet_tpu.") and getattr(mod, "jnp", None) is jnp:
                monkeypatch.setattr(mod, "jnp", _JnpX64())
        jax_cfg = JaxConfig.fromfile(FLAGSHIP, TRAIN + ["compute_dtype='float64'"])
        jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
        port, _, _, _ = build_model_and_anchors(cfg, dtype=torch.float64)
        variables = flax_and_port_models(jax_model, port)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        capture = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
        )
        jstep = jax_build_train_step(
            jax_model, capture, anchors, ranges, img_norm=jax_cfg.img_norm_cfg.to_dict(), num_classes=4,
            assignment_cfg=jax_assignment_cfg_from(jax_cfg), loss_cfg=jax_loss_cfg_from(jax_cfg),
        )
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                               opt_state=capture.init(params))
        key = jax.random.PRNGKey(7)
        jstate, ref = jstep(jstate, {k: jnp.asarray(batch[k]) for k in
                                     ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}, key)
        ref_grads = _float64_grads(jstate.opt_state, variables["batch_stats"])
        b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
        noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    assert noise[0].dtype == torch.float64 and all(v.dtype == torch.float64 for v in ref_grads.values())
    port = port.double()
    port.load_state_dict({k: v.double() if v.is_floating_point() else v
                          for k, v in state_dict_from_flax(variables).items()})
    step = build_train_step(port, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                            assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
    sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
    metrics = step(TrainState(port, sgd0), batch_to_device(batch, "cpu"), noise)
    assert float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        _close(float(metrics[k]), float(ref[k]), 1e-12, k)
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad.dtype == torch.float64, name
            _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-10, name)


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    cfg = Config.fromfile(FLAGSHIP, TRAIN)
    batches = [batch_to_device(_batch(cfg, seed=s), "cpu") for s in range(3)]

    def fresh(seed):
        model, anchors, ranges, _ = build_model_and_anchors(cfg)
        model.init_weights(torch.Generator().manual_seed(seed))
        tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), model)
        step = build_train_step(model, anchors, ranges, img_norm=cfg.img_norm_cfg.to_dict(), num_classes=4,
                                assignment_cfg=assignment_cfg_from(cfg), loss_cfg=loss_cfg_from(cfg))
        return TrainState(model, tx, seed=11), step

    state, step = fresh(0)
    for bt in batches:
        last = step(state, bt)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=2, interval=2)
    resumed, rstep = fresh(0)
    for bt in batches[:2]:
        rstep(resumed, bt)
    assert ckpt.save(2, resumed) and not ckpt.save(3, resumed)
    resumed, rstep = fresh(1)  # other weights: the restore must replace them all
    assert ckpt.restore(resumed).step == 2
    again = rstep(resumed, batches[2])
    assert resumed.step == state.step == 3
    for k in last:
        assert torch.equal(again[k], last[k]), k
    for (k, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    write_meta(ckpt.directory, dict(classes=["a"]))
    assert load_meta(str(tmp_path / "checkpoints" / "2")) == dict(classes=["a"])
    # weights-only files and manager roots give the same weights
    save_weights(str(tmp_path / "w.pth"), state.model.state_dict(), meta=dict(CLASSES=["a"]))
    for src in (tmp_path / "w.pth", tmp_path / "checkpoints", tmp_path / "checkpoints" / "2"):
        sd = load_weights(str(src))
        assert sd.keys() == state.model.state_dict().keys()


# ----------------------------------------------------------- host data path


def test_transforms_match_jax():
    rec = synthetic_records(np.random.RandomState(3), 1, (60, 90), 4, max_objects=4)[0]
    anchors, _, _, _ = generate_anchors(IMG_HW)
    centers = anchor_centers(anchors)

    def run(ts):
        results = dict(img=rec["img"].copy(), img_shape=(60, 90), gt_bboxes=rec["gt_bboxes"].copy(),
                       gt_labels=rec["gt_labels"].copy(), gt_masks=rec["gt_masks"].copy())
        for t in ts:
            results = t(results)
        return results

    ref = run([jax_pipeline.RandomFlip(1.0), jax_pipeline.GenerateDistanceMap(),
               jax_pipeline.SampleDistanceAtAnchors(centers, max_gt=8), jax_pipeline.Pad(size=IMG_HW)])
    out = run([RandomFlip(1.0), GenerateDistanceMap(), SampleDistanceAtAnchors(centers, max_gt=8),
               Pad(size=IMG_HW)])
    for k in ("img", "gt_bboxes", "gt_masks", "distance_maps", "dist_vals", "pad_shape"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out["dist_vals"].any()
    built = build_pipeline([dict(type="RandomFlip", flip_ratio=0.0), dict(type="GenerateDistanceMap"),
                            dict(type="LabelAssignment"), dict(type="Pad", size_divisor=16)],
                           input_size=IMG_HW, anchor_centers=centers, max_gt=8)
    ref = run([jax_pipeline.GenerateDistanceMap(), jax_pipeline.SampleDistanceAtAnchors(centers, max_gt=8),
               jax_pipeline.Pad(size=IMG_HW)])
    out = built(dict(img=rec["img"].copy(), img_shape=(60, 90), gt_bboxes=rec["gt_bboxes"].copy(),
                     gt_labels=rec["gt_labels"].copy(), gt_masks=rec["gt_masks"].copy()))
    for k in ("img", "dist_vals"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_loader_matches_jax():
    data = [dict(x=np.full((3,), i, np.float32), i=np.int64(i)) for i in range(11)]
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=4, shard_id=1, num_shards=2, infinite=True)
    ref_it, it = iter(jax_loader.DataLoader(data, **kw)), iter(DataLoader(data, **kw))
    for _ in range(5):  # across an epoch boundary
        a, b = next(ref_it), next(it)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    assert len(DataLoader(data, **kw)) == len(jax_loader.DataLoader(data, **kw))


def test_samples_are_packed_and_resampled():
    recs = synthetic_records(np.random.RandomState(0), 3, IMG_HW, 4)
    recs[1] = dict(recs[1], gt_bboxes=np.zeros((0, 4), np.float32), gt_labels=np.zeros(0, np.int64),
                   gt_masks=np.zeros((0,) + IMG_HW, np.uint8))
    ds = InMemoryBOPDataset(recs, train_transforms(IMG_HW, max_gt=2, flip_ratio=0.0), max_gt=2)
    s = ds[0]
    assert s["image"].shape == IMG_HW + (3,) and s["dist_vals"].shape == (129, 2)
    assert s["dist_vals"].dtype == np.float16 and s["gt_valid"].sum() == min(len(recs[0]["gt_bboxes"]), 2)
    np.testing.assert_array_equal(s["gt_boxes"][s["gt_valid"]], recs[0]["gt_bboxes"][:2])
    assert ds[1]["img_id"] != 1  # no GT: another record is drawn


# ----------------------------------------------------------- the entry point


def test_unported_training_options_raise(tmp_path):
    from fixtures import make_synthetic_bop

    cfg = Config.fromfile(FLAGSHIP, TRAIN)
    ann, prefix = make_synthetic_bop(str(tmp_path / "bop"), images_per_scene=2, img_hw=IMG_HW, num_classes=4)
    files = Config.fromfile(FLAGSHIP, TRAIN + [f"data.train.ann_file={ann!r}", f"data.train.img_prefix={prefix!r}",
                                               "data.train.classes=None"])
    # the flagship's own train_pipeline is ported; its RandomBackground directory (data/coco) is not
    # here, and training fails where the JAX package's dataset build does
    from radet_tpu.apis.common import build_dataset as jax_build_dataset

    jax_files = JaxConfig.fromfile(FLAGSHIP, TRAIN + [f"data.train.ann_file={ann!r}",
                                                      f"data.train.img_prefix={prefix!r}", "data.train.classes=None"])
    with pytest.raises(RuntimeError, match="No background images") as ref:
        jax_build_dataset(jax_files, "train", test_mode=False)
    with pytest.raises(RuntimeError) as got:
        train_detector(files, work_dir=str(tmp_path), device="cpu")
    assert str(got.value) == str(ref.value)
    # the mask-free distance maps are ported (item 17): both packages' maps of one box, the same fill colour drawn
    rec = synthetic_records(np.random.RandomState(2), 1, IMG_HW, 4)[0]
    for method in ("gdt", "mbd"):
        results = dict(img=rec["img"], gt_bboxes=np.array([[4.0, 6.0, 60.0, 50.0]], np.float32))
        got = GenerateDistanceMap(with_gt_mask=False, distance_transform=method, seed=5)(dict(results))
        random.seed(5)
        want = jax_pipeline.GenerateDistanceMap(with_gt_mask=False, distance_transform=method)(dict(results))
        assert got["distance_maps"].shape == (1,) + IMG_HW and got["distance_maps"].max() == 1.0
        np.testing.assert_allclose(got["distance_maps"], want["distance_maps"], rtol=0, atol=2e-5)
    entries = [dict(type="LoadAnnotations", with_bbox=True, with_bop_mask=True), dict(type="CosyPoseAug", p=0.8)]
    assert [type(t).__name__ for t in build_pipeline(entries).transforms] == [
        type(t).__name__ for t in jax_pipeline.build_pipeline(entries).transforms] == ["LoadAnnotations",
                                                                                      "CosyPoseAug"]
    ds = InMemoryBOPDataset(synthetic_records(np.random.RandomState(0), 2, IMG_HW, 4),
                            train_transforms(IMG_HW, max_gt=32), max_gt=32)
    # the periodic eval reaches an unported val dataset type at step 1
    eval_cfg = Config.fromfile(FLAGSHIP, TRAIN + ["evaluation.interval=1", "data.workers_per_gpu=1",
                                                  "data.val.type='CocoDataset'"])
    with pytest.raises(NotImplementedError, match="item 12"):
        train_detector(eval_cfg, work_dir=str(tmp_path), dataset=ds, device="cpu", max_iters=2)
    assert CheckpointManager(str(tmp_path / "checkpoints")).latest_step() == 1  # kept on the way out
    # the anchor heads train (tests/test_torch_anchor_slice.py); mmdet's sampler zoo under a sampling loss does not
    retina = Config.fromfile(osp.join(REPO, "configs/atss/retina_r50_fpn_ycbv_pbr.py"), [
        "model.bbox_head.loss_cls.type='CrossEntropyLoss'", "train_cfg.sampler.type='RandomSampler'"])
    with pytest.raises(NotImplementedError, match="item 12"):
        train_detector(retina, work_dir=str(tmp_path), dataset=ds, device="cpu")


def test_train_detector_resumes_and_loads_weights(tmp_path):
    records = synthetic_records(np.random.RandomState(1), 4, IMG_HW, 4)
    # checkpoints at step 2 only, and where each run ends: no test reads a step-1 checkpoint
    opts = TRAIN + ["checkpoint_config.interval=2", "log_config.interval=1", "data.workers_per_gpu=1"]
    cfg = Config.fromfile(FLAGSHIP, opts)

    def run(work_dir, cfg=cfg, **kw):
        # a fresh flip generator per run: each run reads the same samples
        ds = InMemoryBOPDataset(records, train_transforms(IMG_HW, max_gt=32, seed=0), max_gt=32)
        return train_detector(cfg, work_dir=str(tmp_path / work_dir), dataset=ds, device="cpu",
                              eval_during_train=False, **kw)

    first = run("a", max_iters=2)
    weights = {k: v.clone() for k, v in first.model.state_dict().items()}
    auto = run("a", resume_from="auto", max_iters=3)
    other = run("b", resume_from=str(tmp_path / "a" / "checkpoints" / "2"), max_iters=3)
    assert auto.step == other.step == 3 and osp.exists(tmp_path / "b" / "config.py")
    for (k, v), w in zip(auto.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(v, w), k  # step 3 from step 2's checkpoint, twice
    save_weights(str(tmp_path / "w.pth"), weights)
    loaded = run("c", Config.fromfile(FLAGSHIP, opts + [f"load_from={str(tmp_path / 'w.pth')!r}"]),
                 max_iters=0)
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, weights[k]), k


def test_train_detector_runs_with_jax_unimportable(tmp_path):
    """Train two steps, write the weights, and detect with them, in a
    process where JAX and the JAX package cannot be imported."""
    with open(tmp_path / "records.pkl", "wb") as f:
        pickle.dump(synthetic_records(np.random.RandomState(0), 4, IMG_HW, 4), f)
    code = f"""
import os, pickle, sys
for name in ("jax", "jaxlib", "flax", "optax", "radet_tpu"):
    sys.modules[name] = None
import radet_tpu_torch
from radet_tpu_torch.data import InMemoryBOPDataset, train_transforms
from radet_tpu_torch.engine import save_weights
from radet_tpu_torch.utils.config import Config
cfg = Config.fromfile({FLAGSHIP!r}, {TRAIN!r} + ["runner.max_iters=2", "log_config.interval=1",
                      "checkpoint_config.interval=1", "data.workers_per_gpu=2"])
with open({str(tmp_path / 'records.pkl')!r}, "rb") as f:
    ds = InMemoryBOPDataset(pickle.load(f), train_transforms({IMG_HW!r}, max_gt=32, seed=0), max_gt=32)
state = radet_tpu_torch.train_detector(cfg, work_dir={str(tmp_path)!r}, dataset=ds, device="cpu")
assert state.step == 2, state.step
assert sorted(os.listdir({str(tmp_path / 'checkpoints')!r})) == ["1", "2", "meta.json"]
save_weights({str(tmp_path / 'w.pth')!r}, state.model.state_dict())
det = radet_tpu_torch.init_detector(cfg, {str(tmp_path / 'w.pth')!r}, device="cpu")
out = radet_tpu_torch.inference_detector(det, ds[0]["image"])
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "flax", "optax", "radet_tpu")]
assert not loaded, loaded
print("trained", state.step, sorted(out))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=one_thread_env(PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "trained 2 ['boxes', 'labels', 'scores']" in proc.stdout
