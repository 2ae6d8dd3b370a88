"""One whole QAT train step of ``configs/bop/r50_ycbv_pbr_int8_qat.py`` in
the port against the JAX package's, float32 on the CPU at full width, with
shared int8 levels (``tests/test_torch_qat.py`` has the primitives, the
modules, the narrow ResNet-18 'int8' blocks and the port's own paths, and
the helpers used here): losses, gradients and one AdamW update, both steps
run once for the file (the JAX step's compile takes most of its time)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radet_tpu.apis.common import assignment_cfg_from as jax_assignment_cfg_from
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.common import loss_cfg_from as jax_loss_cfg_from
from radet_tpu.engine.train_step import TrainState as JaxTrainState
from radet_tpu.engine.train_step import build_train_step as jax_build_train_step
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import assignment_cfg_from, build_model_and_anchors, loss_cfg_from
from radet_tpu_torch.data import InMemoryBOPDataset, collate, train_transforms
from radet_tpu_torch.engine import build_optimizer, build_train_step, state_dict_from_flax
from radet_tpu_torch.engine.train_step import TrainState, batch_to_device
from radet_tpu_torch.utils.config import Config
from synthetic_bop import synthetic_bop_records
from test_torch_qat import FLIP_SHARE, QAT_CONFIG, STEP_HW, STEP_RTOL, SharedLevels, _close
from torch_parity import jax_assignment_noise, numpy_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)


def _step_batch(n, num_classes, seed=0):
    ds = InMemoryBOPDataset(synthetic_bop_records(np.random.RandomState(seed), n, STEP_HW, num_classes),
                            train_transforms(STEP_HW, max_gt=32, seed=seed), max_gt=32)
    return collate([ds[i] for i in range(n)])


def _check_adamw_update(cfg, port, port_grads, ref_grads):
    """The config's AdamW (clip at 35) on the port's gradients against the
    same optimizer on JAX's (held to optax in
    ``tests/test_torch_train.py::test_optimizer_matches_optax``): an element
    whose gradient stands above the gradients' error moves by the same step
    (Adam's first step is lr * sign), every one by at most 2 lr, frozen ones
    not at all."""
    named = dict(port.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    moves = []
    for grads in (port_grads, ref_grads):
        for k, p in named.items():
            with torch.no_grad():
                p.copy_(before[k])
            p.grad = grads[k].clone() if p.requires_grad else None
        tx, _ = build_optimizer(cfg.optimizer.to_dict(), cfg.lr_config.to_dict(), cfg.grad_clip.to_dict(), port)
        tx.step()
        moves.append({k: (p.detach() - before[k]).numpy() for k, p in named.items()})
    lr = float(cfg.optimizer.lr)
    for k, p in named.items():
        moved, want = moves[0][k], moves[1][k]
        if not p.requires_grad:
            assert not moved.any() and not want.any(), k
            continue
        assert np.abs(moved - want).max() <= 2.0001 * lr, k
        g = np.abs(ref_grads[k].numpy())
        sure = g > 2 * STEP_RTOL * g.max()
        ulp = float(np.spacing(np.abs(before[k].numpy()).max()))  # of the parameters the moves are read from
        np.testing.assert_allclose(moved[sure], want[sure], rtol=0, atol=1e-3 * lr + 2 * ulp, err_msg=k)
        assert sure.any() or not g.any(), k


@pytest.fixture(scope="module")
def qat_steps():
    """One train step of ``r50_ycbv_pbr_int8_qat.py`` at its full widths
    (ResNet-50 'int8_stream', FPN and head 256, 21 classes) at 64x64 in
    float32 in the port and in JAX, on the same weights, batch and
    assignment noise, with shared levels.  Returns (config, the port's
    model, its metrics, its gradients, JAX's metrics, JAX's gradients, the
    share of the levels JAX would have decided otherwise)."""
    opts = [f"input_size={STEP_HW}", "compute_dtype='float32'"]
    jax_cfg, cfg = JaxConfig.fromfile(QAT_CONFIG, opts), Config.fromfile(QAT_CONFIG, opts)
    jax_model, anchors, ranges, _ = jax_build_model_and_anchors(jax_cfg)
    port = build_model_and_anchors(cfg)[0]
    variables = numpy_variables(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, *STEP_HW, 3)),
                                                       train=False))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    num_classes = int(cfg.model.bbox_head.num_classes)
    batch = _step_batch(1, num_classes)
    b, n, g = batch["dist_vals"].shape[0], anchors.shape[0], batch["gt_boxes"].shape[1]
    key = jax.random.PRNGKey(7)
    noise = tuple(torch.from_numpy(a) for a in jax_assignment_noise(jax.random.fold_in(key, 0), b, g, n, 10))
    step_args = dict(img_norm=cfg.img_norm_cfg.to_dict(), num_classes=num_classes)

    with pytest.MonkeyPatch.context() as monkeypatch:
        levels = SharedLevels(monkeypatch)
        step = build_train_step(port, anchors, ranges, assignment_cfg=assignment_cfg_from(cfg),
                                loss_cfg=loss_cfg_from(cfg), **step_args)
        sgd0, _ = build_optimizer(dict(type="SGD", lr=0.0), dict(policy="fixed"), None, port)
        port.train()
        metrics = step(TrainState(port, sgd0), batch_to_device(batch, "cpu"), noise)

        capture = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g_, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g_), g_),
        )
        jstep = jax_build_train_step(jax_model, capture, anchors, ranges,
                                     assignment_cfg=jax_assignment_cfg_from(jax_cfg),
                                     loss_cfg=jax_loss_cfg_from(jax_cfg), **step_args)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=variables["batch_stats"], opt_state=capture.init(params))
        jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "dist_vals")}
        jstate, ref = jstep(jstate, jbatch, key)
        share = levels.flip_share()
    ref_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
                                      "batch_stats": variables["batch_stats"]})
    grads = {k: None if p.grad is None else p.grad.clone() for k, p in port.named_parameters()}
    return cfg, port, metrics, grads, ref, ref_grads, share


@pytest.mark.parametrize("case", ["full_width", "full_width_adamw"])
def test_qat_train_step_matches_jax(case, qat_steps):
    """The QAT config's whole step (``qat_steps``) against JAX's:
    ``full_width``, the losses and every gradient within ``STEP_RTOL``, the
    frozen stem and layer1 without one, JAX's own levels off the shared
    ones at most ``FLIP_SHARE``; ``full_width_adamw``, one update of the
    config's AdamW from the two gradients (``_check_adamw_update``)."""
    cfg, port, metrics, grads, ref, ref_grads, share = qat_steps
    if case == "full_width_adamw":
        _check_adamw_update(cfg, port, grads, ref_grads)
        return
    assert float(metrics["num_pos"]) > 10
    for k in ("loss_cls", "loss_bbox", "loss_iou", "num_pos", "loss", "grad_norm"):
        _close(float(metrics[k]), float(ref[k]), STEP_RTOL, k)
    errs = {}
    for k, p in port.named_parameters():
        if p.requires_grad:
            errs[k] = _close(grads[k].numpy(), ref_grads[k].numpy(), STEP_RTOL, k)
        else:
            assert grads[k] is None and k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")), k
    assert np.abs(ref_grads["bbox_head.cls_convs.0.gn.weight"].numpy()).max() > 0
    print(f"QAT step: losses {float(metrics['loss']):.6f} vs {float(ref['loss']):.6f}, gradients max error "
          f"{max(errs.values()):.3g} ({max(errs, key=errs.get)}), JAX's own levels differ at {share:.3g}")
    assert share <= FLIP_SHARE
