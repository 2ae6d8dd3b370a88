"""The AnchorHead's sampler zoo in the port (``core/sampler_cores.py``,
``models/anchor_loss.py::random_sample_masks``, the sampler branches of
``anchor_head_loss`` and ``apis/common.py::anchor_head_spec``) against the
JAX package, on the CPU, on seeded numpy inputs.  The port's uniforms are
the JAX package's own draws (``torch_parity.jax_sampler_draws`` walks its
key tree), so every selection is compared element for element.

| compared                                              | tolerance          |
|-------------------------------------------------------|--------------------|
| ranks, every sampler's masks, ScoreHLR's groups       | exact              |
| ScoreHLR's label weights                              | 1e-6               |
| ``anchor_head_loss`` under each of the seven samplers | 1e-5 relative      |
| ``anchor_head_spec``'s sampler kwargs, the refusals    | equal, same errors |
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.apis.common import anchor_head_spec as jax_anchor_head_spec
from radet_tpu.core import sampler_cores as J
from radet_tpu.core.anchor_generator import build_anchor_generator as jax_build_generator
from radet_tpu.core.anchor_generator import flat_anchors_for_input as jax_flat_anchors
from radet_tpu.core.box_coder import build_bbox_coder as jax_build_coder
from radet_tpu.models import anchor_loss as jax_anchor_loss
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch.apis.common import anchor_head_spec
from radet_tpu_torch.core import sampler_cores as P
from radet_tpu_torch.core.box_coder import build_bbox_coder
from radet_tpu_torch.models import anchor_loss
from radet_tpu_torch.utils.config import Config
from torch_parity import ANCHOR_CONFIGS, jax_sampler_draws
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

B, N, MAX_GT = 3, 400, 6


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, ref, what=""):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and (got == ref).all(), f"{what}: {int((got != ref).sum())} elements differ"


def _keys(seed):
    """The batch key, and each image's (kp, kn) under it: the keys the JAX
    samplers split, as ``jax_sampler_draws`` walks them."""
    key = jax.random.PRNGKey(seed)
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, B))
    return key, pairs[:, 0], pairs[:, 1]


def _case(seed, pos_rate=0.05, tie_losses=False):
    """(B, N) assignment (-1 ignore / 0 negative / g + 1), max overlaps,
    per-anchor losses, decoded boxes and scores."""
    rng = np.random.RandomState(seed)
    u = rng.rand(B, N)
    assigned = np.where(u < pos_rate, rng.randint(1, MAX_GT + 1, (B, N)), np.where(u < pos_rate + 0.1, -1, 0))
    assigned[0, assigned[0] > 3] = 1  # image 0: fewer GTs than slots
    pos = assigned > 0
    overlaps = np.where(pos, rng.uniform(0.5, 1.0, (B, N)), rng.uniform(0.0, 0.4, (B, N))).astype(np.float32)
    overlaps[(assigned == 0) & (rng.rand(B, N) < 0.3)] = 0.0
    loss = (np.round(rng.rand(B, N) * 20) / 20 if tie_losses else rng.rand(B, N)).astype(np.float32)
    xy = rng.uniform(0, 200, (B, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 60, (B, N, 2))], -1).astype(np.float32)
    scores = (np.round(rng.rand(B, N) * 50) / 50).astype(np.float32)  # ties
    return dict(assigned=assigned.astype(np.int32), pos=pos, neg=assigned == 0, overlaps=overlaps, loss=loss,
                boxes=boxes, scores=scores)


@pytest.mark.parametrize("descending", [False, True])
def test_ranks_break_ties_as_jax(descending):
    rng = np.random.RandomState(0)
    mask = rng.rand(B, N) < 0.6
    values = (rng.randint(0, 7, (B, N)) / 7.0).astype(np.float32)  # many ties
    ref = jax.vmap(lambda m, v: J._ranks_by(m, v, descending=descending))(mask, values)
    _eq(P._ranks_by(_t(mask), _t(values), descending=descending), ref, "ranks")


# (num, pos_fraction, neg_pos_ub): under and over quota, the cap binding or not
QUOTAS = [(64, 0.25, -1.0), (1024, 0.5, -1.0), (256, 0.5, 3.0), (40, 0.5, 0.5)]


@pytest.mark.parametrize("num,pos_fraction,ub", QUOTAS)
@pytest.mark.parametrize("tie_losses", [False, True])
def test_ohem_and_random_masks_match_jax(num, pos_fraction, ub, tie_losses):
    c = _case(1, tie_losses=tie_losses)
    key, _, _ = _keys(1)
    jp, jn = jax.vmap(lambda p, n, l: J.ohem_sample_masks(p, n, l, num=num, pos_fraction=pos_fraction,
                                                          neg_pos_ub=ub))(c["pos"], c["neg"], c["loss"])
    pp, pn = P.ohem_sample_masks(_t(c["pos"]), _t(c["neg"]), _t(c["loss"]), num=num, pos_fraction=pos_fraction,
                                 neg_pos_ub=ub)
    _eq(pp, jp, "OHEM positives")
    _eq(pn, jn, "OHEM negatives")
    jp, jn = jax.vmap(lambda k, p, n: jax_anchor_loss.random_sample_masks(
        k, p, n, num=num, pos_fraction=pos_fraction, neg_pos_ub=ub))(jax.random.split(key, B), c["pos"], c["neg"])
    draws = P.injected_draws(jax_sampler_draws(key, B, N))
    pp, pn = anchor_loss.random_sample_masks(draws, _t(c["pos"]), _t(c["neg"]), num=num,
                                             pos_fraction=pos_fraction, neg_pos_ub=ub)
    _eq(pp, jp, "RandomSampler positives")
    _eq(pn, jn, "RandomSampler negatives")
    assert int(pp.sum(-1).max()) <= int(num * pos_fraction) and int((pp.sum(-1) + pn.sum(-1)).max()) <= num


@pytest.mark.parametrize("floor_thr,floor_fraction,num_bins", [(-1, 0.0, 3), (0, 0.5, 3), (0.1, 0.3, 2),
                                                                (-1, 0.0, 1)])
@pytest.mark.parametrize("quota", [20, 150, 500])
def test_iou_balanced_neg_masks_match_jax(floor_thr, floor_fraction, num_bins, quota):
    c = _case(2)
    key, _, kn = _keys(2)
    q = np.array([quota, quota // 2, quota + 7], np.int32)
    ref = jax.vmap(lambda k, n, o, qq: J.iou_balanced_neg_masks(
        k, n, o, qq, floor_thr=floor_thr, floor_fraction=floor_fraction, num_bins=num_bins))(
        kn, c["neg"], c["overlaps"], jnp.asarray(q))
    got = P.iou_balanced_neg_masks(P.injected_draws(jax_sampler_draws(key, B, N, num_bins)), _t(c["neg"]),
                                   _t(c["overlaps"]), _t(q).long(), floor_thr=floor_thr,
                                   floor_fraction=floor_fraction, num_bins=num_bins)
    _eq(got, ref, "IoU-balanced negatives")
    assert (got.sum(-1).numpy() == np.minimum(c["neg"].sum(-1), q)).all()


@pytest.mark.parametrize("num_expected", [8, 30, 128])
@pytest.mark.parametrize("pos_rate", [0.05, 0.3])
def test_instance_balanced_pos_masks_match_jax(num_expected, pos_rate):
    c = _case(3, pos_rate=pos_rate)
    key, kp, _ = _keys(3)
    ref = jax.vmap(lambda k, p, a: J.instance_balanced_pos_masks(k, p, a, num_expected, max_gt=MAX_GT))(
        kp, c["pos"], c["assigned"])
    got = P.instance_balanced_pos_masks(P.injected_draws(jax_sampler_draws(key, B, N)), _t(c["pos"]),
                                        _t(c["assigned"]), num_expected, max_gt=MAX_GT)
    _eq(got, ref, "instance-balanced positives")


@pytest.mark.parametrize("iou_thr", [0.3, 0.5])
def test_nms_match_groups_match_jax(iou_thr):
    c = _case(4)
    valid = c["neg"] & (c["scores"] > 0.3)
    valid[2] = False  # an image with nothing to group
    j_seed, j_rank = jax.vmap(lambda b, s, v: J.nms_match_groups(b, s, v, iou_thr))(c["boxes"], c["scores"], valid)
    p_seed, p_rank = P.nms_match_groups(_t(c["boxes"]), _t(c["scores"]), _t(valid), iou_thr)
    _eq(p_seed, j_seed, "group seeds")
    _eq(p_rank, j_rank, "ranks in group")
    assert int(p_seed.max()) >= 0 and (p_seed[2] == -1).all()


@pytest.mark.parametrize("score_thr", [0.05, 0.9, 1.1])  # most, few, no negative scored
@pytest.mark.parametrize("quota,k,bias", [(60, 0.5, 0.0), (350, 1.0, 0.2)])
def test_score_hlr_neg_masks_match_jax(score_thr, quota, k, bias):
    c = _case(5)
    key, _, kn = _keys(5)
    q = np.full(B, quota, np.int32)
    j_sel, j_w = jax.vmap(lambda kk, n, s, b, qq: J.score_hlr_neg_masks(
        kk, n, s, b, qq, score_thr=score_thr, iou_thr=0.5, k=k, bias=bias))(
        kn, c["neg"], c["scores"], c["boxes"], jnp.asarray(q))
    p_sel, p_w = P.score_hlr_neg_masks(P.injected_draws(jax_sampler_draws(key, B, N)), _t(c["neg"]),
                                       _t(c["scores"]), _t(c["boxes"]), _t(q).long(), score_thr=score_thr,
                                       iou_thr=0.5, k=k, bias=bias)
    _eq(p_sel, j_sel, "ScoreHLR negatives")
    np.testing.assert_allclose(p_w.numpy(), np.asarray(j_w), rtol=0, atol=1e-6)


SAMPLE_WITH = {
    "ohem": ("OHEMSampler", ()),
    "iou_balanced": ("IoUBalancedNegSampler", (("floor_fraction", 0.5), ("floor_thr", 0.0), ("num_bins", 3))),
    "instance_balanced": ("InstanceBalancedPosSampler", ()),
    "score_hlr": ("ScoreHLRSampler", (("bias", 0.1), ("k", 0.5), ("score_thr", 0.3))),
    "combined": ("CombinedSampler", (("neg_sampler", "iou_balanced"), ("pos_sampler", "instance_balanced"))),
    "combined_random_ohem": ("CombinedSampler", (("neg_sampler", "ohem"), ("pos_sampler", "random"))),
    "combined_ohem_random": ("CombinedSampler", (("neg_sampler", "random"), ("pos_sampler", "ohem"))),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_WITH))
@pytest.mark.parametrize("num,pos_fraction,ub", [(64, 0.25, -1.0), (256, 0.5, 2.0)])
def test_sample_with_matches_jax(name, num, pos_fraction, ub):
    stype, extra = SAMPLE_WITH[name]
    c = _case(6, pos_rate=0.1)
    key, _, _ = _keys(6)
    side = dict(per_loss=c["loss"], max_overlaps=c["overlaps"], assigned=c["assigned"], decoded_boxes=c["boxes"],
                max_fg_score=c["scores"])
    names = sorted(side)
    ref = jax.vmap(lambda k, p, n, *s: J.sample_with(
        stype, k, p, n, num=num, pos_fraction=pos_fraction, neg_pos_ub=ub, max_gt=MAX_GT, extra=extra,
        **dict(zip(names, s))))(jax.random.split(key, B), c["pos"], c["neg"], *(side[k] for k in names))
    got = P.sample_with(stype, P.injected_draws(jax_sampler_draws(key, B, N)), _t(c["pos"]), _t(c["neg"]),
                        num=num, pos_fraction=pos_fraction, neg_pos_ub=ub, max_gt=MAX_GT, extra=extra,
                        **{k: _t(v) for k, v in side.items()})
    _eq(got[0], ref[0], f"{name} positives")
    _eq(got[1], ref[1], f"{name} negatives")
    assert (got[2] is None) == (ref[2] is None)
    if ref[2] is not None:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6, atol=1e-6)


def _loss_inputs(seed=0):
    """A 2-image batch over the 300 anchors of a 2-level, 3-ratio grid at
    64x80, 3 classes: logits, deltas, anchors and padded GTs."""
    rng = np.random.RandomState(seed)
    gen = jax_build_generator(dict(type="AnchorGenerator", strides=[8, 16], ratios=[0.5, 1.0, 2.0], scales=[4]))
    anchors = jax_flat_anchors(gen, (64, 80))[0]
    b, g, c, n = 2, 4, 3, anchors.shape[0]
    xy = rng.uniform(0, [60, 44], (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 30, (b, g, 2))], -1).astype(np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    labels = rng.randint(0, c, (b, g)).astype(np.int32)
    cls = rng.randn(b, n, c).astype(np.float32)
    reg = (rng.randn(b, n, 4) * 0.3).astype(np.float32)
    return cls, reg, anchors, gt, labels, valid


LOSS_SAMPLERS = {
    "PseudoSampler": (0, "RandomSampler", ()),
    "RandomSampler": (64, "RandomSampler", ()),
    "OHEMSampler": (64, "OHEMSampler", ()),
    "IoUBalancedNegSampler": (64, "IoUBalancedNegSampler", (("num_bins", 3),)),
    "InstanceBalancedPosSampler": (64, "InstanceBalancedPosSampler", ()),
    "ScoreHLRSampler": (64, "ScoreHLRSampler", (("k", 0.5),)),
    "CombinedSampler": (64, "CombinedSampler", (("neg_sampler", "iou_balanced"),
                                                ("pos_sampler", "instance_balanced"))),
}


@pytest.mark.parametrize("sampler", sorted(LOSS_SAMPLERS))
def test_anchor_head_loss_with_each_sampler_matches_jax(sampler):
    """RPN's recipe (sigmoid CE, L1 on the deltas) under each sampler on the
    same draws: losses within 1e-5 relative, the sampled positives' count
    equal; the gradients of the logits too."""
    num, stype, extra = LOSS_SAMPLERS[sampler]
    cls, reg, anchors, gt, labels, valid = _loss_inputs()
    kw = dict(num_classes=3, pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, cls_loss="CrossEntropyLoss",
              bbox_loss_type="L1Loss", sampler_num=num, sampler_pos_fraction=0.25, sampler_type=stype,
              sampler_extra=extra)
    coder = dict(type="DeltaXYWHBBoxCoder")
    key = jax.random.PRNGKey(7)
    j_enc, j_dec = jax_build_coder(coder)

    def ref_total(c):
        out = jax_anchor_loss.anchor_head_loss(c, jnp.asarray(reg), jnp.asarray(anchors), jnp.asarray(gt),
                                               jnp.asarray(labels), jnp.asarray(valid), encode_fn=j_enc,
                                               decode_fn=j_dec, rng=key, **kw)
        return out["loss_cls"] + out["loss_bbox"], out

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(ref_total, has_aux=True))(jnp.asarray(cls))
    enc, dec = build_bbox_coder(coder)
    cls_t = _t(cls).requires_grad_(True)
    got = anchor_loss.anchor_head_loss(cls_t, _t(reg), _t(anchors), _t(gt), _t(labels).long(), _t(valid),
                                       encode_fn=enc, decode_fn=dec,
                                       rng=P.injected_draws(jax_sampler_draws(key, 2, anchors.shape[0])), **kw)
    (got["loss_cls"] + got["loss_bbox"]).backward()
    assert float(got["num_pos"]) == float(ref["num_pos"]) > 0
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    ref_grad = np.asarray(ref_grad)
    assert np.abs(cls_t.grad.numpy() - ref_grad).max() <= 1e-5 * np.abs(ref_grad).max()


def test_anchor_head_loss_refuses_as_jax():
    """A sampler under a focal loss, and a sampler without a random source,
    raise the JAX package's AssertionError."""
    cls, reg, anchors, gt, labels, valid = _loss_inputs()
    enc, dec = build_bbox_coder(dict(type="DeltaXYWHBBoxCoder"))
    args = (_t(cls), _t(reg), _t(anchors), _t(gt), _t(labels).long(), _t(valid))
    j_enc, j_dec = jax_build_coder(dict(type="DeltaXYWHBBoxCoder"))
    j_args = tuple(jnp.asarray(a) for a in (cls, reg, anchors, gt, labels, valid))
    for cls_loss, rng in (("FocalLoss", torch.Generator()), ("CrossEntropyLoss", None)):
        kw = dict(num_classes=3, cls_loss=cls_loss, sampler_num=64)
        with pytest.raises(AssertionError):
            jax_anchor_loss.anchor_head_loss(*j_args, encode_fn=j_enc, decode_fn=j_dec,
                                             rng=None if rng is None else jax.random.PRNGKey(0), **kw)
        with pytest.raises(AssertionError):
            anchor_loss.anchor_head_loss(*args, encode_fn=enc, decode_fn=dec, rng=rng, **kw)


def test_score_hlr_refuses_dense_grids_as_jax():
    """ScoreHLR above 8192 anchors raises in both packages, before any draw."""
    n = 8193
    pos, neg = np.zeros((1, n), bool), np.ones((1, n), bool)
    side = dict(decoded_boxes=np.zeros((1, n, 4), np.float32), max_fg_score=np.zeros((1, n), np.float32))
    with pytest.raises(AssertionError, match="quadratic"):
        J.sample_with("ScoreHLRSampler", jax.random.PRNGKey(0), pos[0], neg[0], num=256, pos_fraction=0.5,
                      **{k: v[0] for k, v in side.items()})
    with pytest.raises(AssertionError, match="quadratic"):
        P.sample_with("ScoreHLRSampler", None, _t(pos), _t(neg), num=256, pos_fraction=0.5,
                      **{k: _t(v) for k, v in side.items()})


RETINA = ANCHOR_CONFIGS["retina"]
CE_HEAD = ["model.bbox_head.loss_cls.type='CrossEntropyLoss'", "model.bbox_head.loss_cls.use_sigmoid=True",
           "model.bbox_head.loss_bbox.type='L1Loss'"]
SPEC_SAMPLERS = {
    "PseudoSampler": dict(type="PseudoSampler"),
    "RandomSampler": dict(type="RandomSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1, add_gt_as_proposals=False),
    "OHEMSampler": dict(type="OHEMSampler", num=512, pos_fraction=0.25, neg_pos_ub=3),
    "IoUBalancedNegSampler": dict(type="IoUBalancedNegSampler", num=512, pos_fraction=0.25, floor_thr=-1,
                                  floor_fraction=0, num_bins=3),
    "InstanceBalancedPosSampler": dict(type="InstanceBalancedPosSampler", num=256, pos_fraction=0.5),
    "ScoreHLRSampler": dict(type="ScoreHLRSampler", num=512, pos_fraction=0.25, neg_pos_ub=-1, k=0.5, bias=0.0,
                            score_thr=0.05, iou_thr=0.5),
    "CombinedSampler": dict(type="CombinedSampler", num=512, pos_fraction=0.25,
                            pos_sampler=dict(type="InstanceBalancedPosSampler"),
                            neg_sampler=dict(type="IoUBalancedNegSampler", floor_thr=-1, floor_fraction=0, num_bins=3)),
}


@pytest.mark.parametrize("sampler", sorted(SPEC_SAMPLERS))
@pytest.mark.parametrize("loss", ["ce", "focal"])
def test_anchor_head_spec_sampler_matches_jax(sampler, loss):
    """Each ``train_cfg.sampler`` type read as the JAX package reads it;
    under the config's focal loss every one becomes the PseudoSampler."""
    path, options = RETINA
    options = options + (CE_HEAD if loss == "ce" else []) + [f"train_cfg.sampler={SPEC_SAMPLERS[sampler]!r}"]
    got = anchor_head_spec(Config.fromfile(path, options))["loss_kwargs"]
    ref = jax_anchor_head_spec(JaxConfig.fromfile(path, options))["loss_kwargs"]
    assert got == ref
    assert ("sampler_type" in got) == (loss == "ce" and sampler != "PseudoSampler")


@pytest.mark.parametrize("sampler", [
    dict(type="RandomSampler", num=256, pos_fraction=0.5, add_gt_as_proposals=True),
    dict(type="BalancedPosSampler", num=256, pos_fraction=0.5),
    dict(type="CombinedSampler", num=256, pos_fraction=0.5, pos_sampler=dict(type="ScoreHLRSampler")),
], ids=["add_gt_as_proposals", "unknown_type", "unknown_component"])
def test_anchor_head_spec_refuses_as_jax(sampler):
    path, options = RETINA
    options = options + CE_HEAD + [f"train_cfg.sampler={sampler!r}"]
    with pytest.raises((AssertionError, KeyError)) as ref:
        jax_anchor_head_spec(JaxConfig.fromfile(path, options))
    with pytest.raises(ref.type):
        anchor_head_spec(Config.fromfile(path, options))
