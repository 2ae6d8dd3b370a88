"""The generic anchor heads' modules in the port against the JAX package,
float32 on the CPU, on seeded numpy inputs (the ATSS and RetinaNet
configs' generators and coders at 128x160, 3 classes).

| compared                                        | tolerance                   |
|-------------------------------------------------|-----------------------------|
| generator anchors and valid flags               | exact                       |
| delta encode / decode, pairwise IoU             | 1e-6 relative               |
| ATSS / MaxIoU assignment (continuous GTs)       | exact                       |
| ``batched_nms_plain`` vs ``batched_nms_device`` | exact                       |
| ``get_bboxes_anchor`` detections                | labels exact, boxes 1e-4    |
| ``atss_loss`` / ``anchor_head_loss``            | 1e-5 relative, gradients too |
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.core import anchor_assign as jax_assign
from radet_tpu.core.anchor_generator import build_anchor_generator as jax_build_generator
from radet_tpu.core.anchor_generator import flat_anchors_for_input as jax_flat_anchors
from radet_tpu.core.box_coder import build_bbox_coder as jax_build_coder
from radet_tpu.core.box_coder import delta_decode as jax_delta_decode
from radet_tpu.core.box_coder import delta_encode as jax_delta_encode
from radet_tpu.core.box_ops import bbox_iou_pairwise as jax_iou_pairwise
from radet_tpu.models import anchor_loss as jax_anchor_loss
from radet_tpu.models.postprocess import get_bboxes as jax_get_bboxes
from radet_tpu.models.postprocess import get_bboxes_anchor as jax_get_bboxes_anchor
from radet_tpu.ops.vote_nms import batched_nms_device
from radet_tpu_torch.core import anchor_assign
from radet_tpu_torch.core.anchor_generator import build_anchor_generator, flat_anchors_for_input
from radet_tpu_torch.core.anchors import generate_anchors
from radet_tpu_torch.core.box_coder import build_bbox_coder, delta_decode, delta_encode
from radet_tpu_torch.core.box_ops import bbox_iou_pairwise
from radet_tpu_torch.models import anchor_loss
from radet_tpu_torch.models.postprocess import get_bboxes, get_bboxes_anchor
from radet_tpu_torch.ops.vote_nms import batched_nms, batched_nms_plain
from radet_tpu_torch.utils.config import Config
from torch_parity import ANCHOR_CONFIGS, ANCHOR_HW
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

HEADS = sorted(ANCHOR_CONFIGS)


def _close(port, ref, rtol, what=""):
    """max |port - ref| <= rtol * max |ref|."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


def _head_cfg(name):
    path, options = ANCHOR_CONFIGS[name]
    return Config.fromfile(path, options).model.bbox_head.to_dict()


def _generator_cfg(name):
    return _head_cfg(name)["anchor_generator"]


def _gt(rng, b, g, n_valid, hw=ANCHOR_HW):
    """(B, G) padded GT boxes with continuous random corners inside ``hw``;
    image i has n_valid[i] valid boxes, the padding is zeros."""
    h, w = hw
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int32)
    for i, n in enumerate(n_valid):
        xy = rng.uniform(0, [w - 12, h - 12], (n, 2))
        wh = rng.uniform(8, [w / 2, h / 2], (n, 2))
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1)
        valid[i, :n] = True
        labels[i, :n] = rng.randint(0, 3, n)
    return boxes, labels, valid


# ---------------------------------------------------------------- anchors


@pytest.mark.parametrize("hw", [(480, 640), ANCHOR_HW, (100, 150)])
@pytest.mark.parametrize("name", HEADS)
def test_anchor_generator_matches_jax(name, hw):
    cfg = _generator_cfg(name)
    gen, ref = build_anchor_generator(dict(cfg)), jax_build_generator(dict(cfg))
    anchors, flags, counts = flat_anchors_for_input(gen, hw)
    r_anchors, r_flags, r_counts = jax_flat_anchors(ref, hw)
    np.testing.assert_array_equal(anchors, r_anchors)
    np.testing.assert_array_equal(flags, r_flags)
    assert counts == r_counts and gen.num_base_anchors == ref.num_base_anchors
    if hw == (480, 640):  # the counts the configs run at
        assert sum(counts) == {"atss": 6400, "retina": 57600}[name]
    # cells past a smaller pad shape are flagged out
    sizes = [(-(-hw[0] // s[1]), -(-hw[1] // s[0])) for s in gen.strides]
    pad = (hw[0] - 40, hw[1] - 70)
    flags = gen.valid_flags(sizes, pad)
    for got, want in zip(flags, ref.valid_flags(sizes, pad)):
        np.testing.assert_array_equal(got, want)
    assert 0 < flags[0].sum() < flags[0].size


def test_other_generators_and_coders_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_anchor_generator(dict(type="SSDAnchorGenerator", strides=[8], ratios=[[2]],
                                    basesize_ratio_range=(0.15, 0.9)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_bbox_coder(dict(type="TBLRBBoxCoder", normalizer=0.125))
    # RADet's square anchors are the one-anchor case of the generator
    ref, _, _, counts = generate_anchors(ANCHOR_HW)
    gen = build_anchor_generator(dict(type="AnchorGenerator", ratios=[1.0], octave_base_scale=8,
                                      scales_per_octave=1, strides=[8, 16, 32, 64, 128]))
    anchors, _, got_counts = flat_anchors_for_input(gen, ANCHOR_HW)
    np.testing.assert_array_equal(anchors, ref)
    assert got_counts == counts


# ---------------------------------------------------------------- boxes


@pytest.mark.parametrize("name", HEADS)
def test_delta_coder_and_pairwise_iou_match_jax(name, rng):
    coder = _head_cfg(name)["bbox_coder"]
    means, stds = coder["target_means"], coder["target_stds"]
    anchors, _, _ = flat_anchors_for_input(build_anchor_generator(dict(_generator_cfg(name))), ANCHOR_HW)
    gt, _, _ = _gt(rng, 2, anchors.shape[0], [anchors.shape[0]] * 2)
    enc = delta_encode(torch.from_numpy(anchors)[None], torch.from_numpy(gt), means, stds)
    ref = jax_delta_encode(jnp.asarray(anchors)[None], jnp.asarray(gt), means, stds)
    _close(enc.numpy(), ref, 1e-6, "encode")
    # deltas past the wh_ratio_clip bound, and a per-image (B, 1) border clamp
    deltas = (rng.randn(2, anchors.shape[0], 4) * 2).astype(np.float32)
    deltas[:, :20, 2:] = 9.0
    hw = np.float32([[100, 150], [128, 160]])
    dec = delta_decode(torch.from_numpy(anchors)[None], torch.from_numpy(deltas), means, stds,
                       max_shape=(torch.from_numpy(hw[:, :1]), torch.from_numpy(hw[:, 1:])))
    ref = jax_delta_decode(jnp.asarray(anchors)[None], jnp.asarray(deltas), means, stds,
                           max_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
    _close(dec.numpy(), ref, 1e-6, "decode")
    assert (dec[0, :, 2] <= 150).all() and (dec[1, :, 3] <= 128).all() and (dec >= 0).all()
    assert (dec[..., 2] == 150).any()  # the clamp bites
    # the built coder's closures, without a border clamp
    encode, decode = build_bbox_coder(coder)
    j_encode, j_decode = jax_build_coder(coder)
    _close(decode(torch.from_numpy(anchors), encode(torch.from_numpy(anchors), torch.from_numpy(gt[0]))).numpy(),
           j_decode(jnp.asarray(anchors), j_encode(jnp.asarray(anchors), jnp.asarray(gt[0]))), 1e-6, "coder")
    iou = bbox_iou_pairwise(torch.from_numpy(gt[:, :50]), torch.from_numpy(anchors)[None])
    _close(iou.numpy(), jax_iou_pairwise(jnp.asarray(gt[:, :50]), jnp.asarray(anchors)[None]), 1e-6, "iou")


# ---------------------------------------------------------------- assignment


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_atss_assign_matches_jax(seed, inside):
    rng = np.random.RandomState(seed)
    anchors, _, counts = flat_anchors_for_input(build_anchor_generator(dict(_generator_cfg("atss"))), ANCHOR_HW)
    gt, labels, valid = _gt(rng, 3, 8, [5, 8, 1])
    mask = rng.rand(anchors.shape[0]) < 0.8 if inside else None
    got, got_max = anchor_assign.atss_assign(
        torch.from_numpy(anchors), counts, torch.from_numpy(gt), torch.from_numpy(valid), topk=9,
        inside_mask=None if mask is None else torch.from_numpy(mask))
    ref, ref_max = jax.jit(jax.vmap(lambda g, v: jax_assign.atss_assign(
        jnp.asarray(anchors), counts, g, v, topk=9, inside_mask=None if mask is None else jnp.asarray(mask))))(
        jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _close(got_max.numpy(), ref_max, 1e-6, "max overlaps")
    assert (got > 0).sum() > 10 and got.max() <= valid.sum(1).max()
    lab, tgt, pos = anchor_assign.assigned_to_dense_targets(got, torch.from_numpy(gt), torch.from_numpy(labels), 3)
    r_lab, r_tgt, r_pos = jax.vmap(lambda a, g, gl: jax_assign.assigned_to_dense_targets(a, g, gl, 3))(
        ref, jnp.asarray(gt), jnp.asarray(labels))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(r_lab))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(r_tgt))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(r_pos))


MAX_IOU_VARIANTS = {
    "retina": dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
    "first_max": dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, gt_max_assign_all=False),
    "neg_window": dict(pos_iou_thr=0.6, neg_iou_thr=(0.1, 0.4), min_pos_iou=0.3),
    "no_low_quality": dict(pos_iou_thr=0.5, neg_iou_thr=0.4, match_low_quality=False),
}


@pytest.mark.parametrize("variant", sorted(MAX_IOU_VARIANTS))
def test_max_iou_assign_matches_jax(variant, rng):
    kw = MAX_IOU_VARIANTS[variant]
    anchors, _, _ = flat_anchors_for_input(build_anchor_generator(dict(_generator_cfg("retina"))), ANCHOR_HW)
    gt, _, valid = _gt(rng, 3, 8, [6, 0, 2])  # the second image has no GT: all background
    got, got_max = anchor_assign.max_iou_assign(torch.from_numpy(anchors), torch.from_numpy(gt),
                                                torch.from_numpy(valid), **kw)
    ref, ref_max = jax.jit(jax.vmap(lambda g, v: jax_assign.max_iou_assign(jnp.asarray(anchors), g, v, **kw)))(
        jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _close(got_max.numpy(), ref_max, 1e-6, "max overlaps")
    assert (got[1] == 0).all() and (got[0] > 0).sum() > 5 and (got[0] == 0).any()
    if variant != "no_low_quality":
        assert (got[0] == -1).any()


# ---------------------------------------------------------------- NMS


def _nms_inputs(rng, b, k, tie_scores=False, num_labels=5):
    """Clustered (B, K) candidates in random order, ~70% valid; with
    ``tie_scores`` the scores take 20 values, so the lowest-index rule
    decides most picks."""
    centers = rng.uniform(30, 300, (b, 6, 2))
    idx = rng.randint(0, 6, (b, k))
    c = np.take_along_axis(centers, idx[..., None], 1) + rng.randn(b, k, 2) * 4
    wh = rng.uniform(20, 40, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(1, 21, (b, k)) / 20.0 if tie_scores else rng.uniform(0.05, 1, (b, k))).astype(np.float32)
    labels = ((idx + rng.randint(0, 2, (b, k))) % num_labels).astype(np.int32)
    valid = rng.rand(b, k) < 0.7
    return boxes, scores, labels, valid


def _jax_nms(arrays, iou_threshold, max_out):
    fn = jax.vmap(lambda *a: batched_nms_device(*a, iou_threshold=iou_threshold, max_out=max_out))
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in arrays))]


NMS_CASES = {"random": (False, 0.6, 100), "ties": (True, 0.6, 100), "truncated": (False, 0.5, 7),
             "high_threshold": (True, 0.9, 300)}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_batched_nms_plain_matches_jax(case, rng):
    ties, thr, max_out = NMS_CASES[case]
    arrays = _nms_inputs(rng, 3, 300, tie_scores=ties)
    ref = _jax_nms(arrays, thr, max_out)
    got = batched_nms_plain(*(torch.from_numpy(a) for a in arrays), iou_threshold=thr, max_out=max_out)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert 0 < got[3].sum(1).min() and (max_out == 7) == bool(got[3].all())
    # presorted by score (ties in index order, invalid last): the dispatch
    # on a CPU tensor gives the same slots, in float64 too
    boxes, scores, labels, valid = arrays
    order = np.argsort(-np.where(valid, scores, -1.0), axis=1, kind="stable")
    srt = [np.take_along_axis(boxes, order[..., None], 1)] + [np.take_along_axis(a, order, 1)
                                                               for a in (scores, labels, valid)]
    for dtype in (torch.float32, torch.float64):
        t = [torch.from_numpy(a) for a in srt]
        t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
        out = batched_nms(*t, iou_threshold=thr, max_out=max_out)
        for g, r in zip(out, ref):
            np.testing.assert_array_equal(g.numpy().astype(r.dtype), r)


def test_batched_nms_plain_empty_and_no_slots():
    arrays = [torch.zeros(2, 16, 4), torch.zeros(2, 16), torch.zeros(2, 16, dtype=torch.int32),
              torch.zeros(2, 16, dtype=torch.bool)]
    boxes, labels, scores, valid = batched_nms_plain(*arrays, max_out=5)
    assert not valid.any() and (labels == -1).all() and not boxes.any() and not scores.any()
    assert batched_nms_plain(*arrays, max_out=0)[0].shape == (2, 0, 4)


# ---------------------------------------------------------------- postprocess


def _maps(rng, levels, a, c, centerness):
    cls = [rng.randn(2, h, w, a * c).astype(np.float32) * 2 for h, w in levels]
    reg = [rng.randn(2, h, w, a * 4).astype(np.float32) * 0.5 for h, w in levels]
    ctr = [rng.randn(2, h, w, a).astype(np.float32) for h, w in levels] if centerness else None
    return cls, reg, ctr


@pytest.mark.parametrize("nms_pre,nms_topk", [(1000, 1024), (40, 300)])
@pytest.mark.parametrize("name", HEADS)
def test_get_bboxes_anchor_matches_jax(name, nms_pre, nms_topk, rng):
    head = _head_cfg(name)
    gen = build_anchor_generator(dict(head["anchor_generator"]))
    anchors, _, counts = flat_anchors_for_input(gen, ANCHOR_HW)
    levels = [(-(-ANCHOR_HW[0] // s), -(-ANCHOR_HW[1] // s)) for s in (8, 16, 32, 64, 128)]
    cls, reg, ctr = _maps(rng, levels, gen.num_base_anchors[0], 3, name == "atss")
    level_anchors = np.split(anchors, np.cumsum(counts)[:-1])
    shapes = np.float32([[100, 150], [128, 160]])
    scales = np.float32([[0.5, 0.6, 0.5, 0.6], [1.25, 1.25, 1.25, 1.25]])
    test_cfg = dict(nms_pre=nms_pre, score_thr=0.05, nms=dict(type="nms", iou_threshold=0.6),
                    max_per_img=100, nms_topk=nms_topk)
    decode = jax_build_coder(head["bbox_coder"])[1]

    @jax.jit
    def ref_fn(cls, reg, ctr, shapes, scales):
        return jax_get_bboxes_anchor(cls, reg, ctr, level_anchors, shapes, scales, decode, test_cfg=test_cfg)

    ref = ref_fn(*([[jnp.asarray(m) for m in ms] if ms is not None else None for ms in (cls, reg, ctr)]),
                          jnp.asarray(shapes), jnp.asarray(scales))
    t = lambda ms: None if ms is None else [torch.from_numpy(m) for m in ms]  # noqa: E731
    args = (t(cls), t(reg), t(ctr), t(level_anchors), torch.from_numpy(shapes), torch.from_numpy(scales),
            build_bbox_coder(head["bbox_coder"])[1])
    det = get_bboxes_anchor(*args, test_cfg=test_cfg)
    rv, dv = np.asarray(ref.valid), det.valid.numpy()
    np.testing.assert_array_equal(dv, rv)
    assert dv.sum(1).min() > 20
    np.testing.assert_array_equal(det.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(ref.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-4)


def test_radet_nms_type_matches_jax(rng):
    """RADet's ``nms.type='nms'``: class-aware greedy NMS ranked by cls * iou."""
    levels = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    maps = [[rng.randn(2, h, w, d).astype(np.float32) for h, w in levels] for d in (4, 4, 1)]
    maps[1] = [np.abs(m) for m in maps[1]]
    anchors, _, _, counts = generate_anchors((64, 96))
    level_anchors = np.split(anchors, np.cumsum(counts)[:-1])
    shapes = np.float32([[60, 90], [64, 80]])
    scales = np.float32([[0.5, 0.6, 0.5, 0.6], [1.25, 1.25, 1.25, 1.25]])
    test_cfg = dict(score_thr=0.3, nms_topk=60, max_per_img=100, nms=dict(type="nms", iou_threshold=0.5))
    ref = jax_get_bboxes(*maps, level_anchors, jnp.asarray(shapes), jnp.asarray(scales),
                         test_cfg=dict(test_cfg, approx_topk=False))
    det = get_bboxes(*[[torch.from_numpy(m) for m in ms] for ms in maps], [torch.from_numpy(a) for a in level_anchors],
                     torch.from_numpy(shapes), torch.from_numpy(scales), test_cfg=test_cfg)
    rv, dv = np.asarray(ref.valid), det.valid.numpy()
    np.testing.assert_array_equal(dv, rv)
    assert 5 < dv.sum(1).min() and dv.sum() < dv.size
    np.testing.assert_array_equal(det.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=0)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- losses


ATSS_VARIANTS = {"centerness": dict(quality="centerness"), "iou_quality": dict(quality="iou"),
                 "inside_mask": dict(quality="centerness")}
ANCHOR_VARIANTS = {
    "retina": dict(),
    "sigmoid_ce_l1": dict(cls_loss="CrossEntropyLoss", bbox_loss_type="L1Loss", pos_weight=2.0),
    "decoded_giou": dict(reg_decoded_bbox=True, bbox_loss_type="GIoULoss", neg_iou_thr=(0.0, 0.3)),
}


def _loss_inputs(name, rng, n_valid=(5, 2)):
    head = _head_cfg(name)
    gen = build_anchor_generator(dict(head["anchor_generator"]))
    anchors, _, counts = flat_anchors_for_input(gen, ANCHOR_HW)
    n = anchors.shape[0]
    gt, labels, valid = _gt(rng, 2, 6, list(n_valid))
    cls = (rng.randn(2, n, 3) * 2).astype(np.float32)
    reg = (rng.randn(2, n, 4) * 0.3).astype(np.float32)
    ctr = rng.randn(2, n).astype(np.float32)
    return head, anchors, counts, (gt, labels, valid), (cls, reg, ctr)


def _compare_losses(port_fn, ref_fn, inputs):
    """Every loss component and the gradient of their sum wrt each input."""
    jin = [jnp.asarray(x) for x in inputs]
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(lambda *x: (ref_fn(*x)["loss_total"], ref_fn(*x)), has_aux=True,
                                                     argnums=tuple(range(len(jin)))))(*jin)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    got = port_fn(*ts)
    got["loss_total"].backward()
    for k in got:
        _close(float(got[k].detach()), float(ref[k]), 1e-5, k)
    assert float(got["num_pos"]) > 5
    for t, g in zip(ts, ref_grads):
        assert np.isfinite(t.grad.numpy()).all()
        _close(t.grad.numpy(), np.asarray(g), 1e-5, "gradient")


def _with_total(fn):
    def run(*a, **kw):
        out = dict(fn(*a, **kw))
        out["loss_total"] = sum(v for k, v in out.items() if k.startswith("loss_"))
        return out
    return run


@pytest.mark.parametrize("variant", sorted(ATSS_VARIANTS))
def test_atss_loss_matches_jax(variant, rng):
    head, anchors, counts, (gt, labels, valid), inputs = _loss_inputs("atss", rng)
    kw = dict(num_classes=3, topk=9, bbox_loss_type="GIoULoss", bbox_loss_weight=2.0, **ATSS_VARIANTS[variant])
    mask = rng.rand(anchors.shape[0]) < 0.9 if variant == "inside_mask" else None
    j_enc, j_dec = jax_build_coder(head["bbox_coder"])
    enc, dec = build_bbox_coder(head["bbox_coder"])

    def ref_fn(cls, reg, ctr):
        return _with_total(jax_anchor_loss.atss_loss)(
            cls, reg, ctr, jnp.asarray(anchors), tuple(counts), jnp.asarray(gt), jnp.asarray(labels),
            jnp.asarray(valid), encode_fn=j_enc, decode_fn=j_dec,
            valid_mask=None if mask is None else jnp.asarray(mask), **kw)

    def port_fn(cls, reg, ctr):
        return _with_total(anchor_loss.atss_loss)(
            cls, reg, ctr, torch.from_numpy(anchors), counts, torch.from_numpy(gt), torch.from_numpy(labels),
            torch.from_numpy(valid), encode_fn=enc, decode_fn=dec,
            valid_mask=None if mask is None else torch.from_numpy(mask), **kw)

    _compare_losses(port_fn, ref_fn, inputs)


@pytest.mark.parametrize("variant", sorted(ANCHOR_VARIANTS))
def test_anchor_head_loss_matches_jax(variant, rng):
    head, anchors, _, (gt, labels, valid), inputs = _loss_inputs("retina", rng)
    kw = dict(num_classes=3, pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, smooth_l1_beta=0.11)
    kw.update(ANCHOR_VARIANTS[variant])
    j_enc, j_dec = jax_build_coder(head["bbox_coder"])
    enc, dec = build_bbox_coder(head["bbox_coder"])

    def ref_fn(cls, reg):
        return _with_total(jax_anchor_loss.anchor_head_loss)(
            cls, reg, jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid),
            encode_fn=j_enc, decode_fn=j_dec, **kw)

    def port_fn(cls, reg):
        return _with_total(anchor_loss.anchor_head_loss)(
            cls, reg, torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(labels),
            torch.from_numpy(valid), encode_fn=enc, decode_fn=dec, **kw)

    _compare_losses(port_fn, ref_fn, inputs[:2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        anchor_loss.anchor_head_loss(*(torch.from_numpy(x) for x in inputs[:2]), torch.from_numpy(anchors),
                                     torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(valid),
                                     encode_fn=enc, decode_fn=dec, sampler_num=256, **kw)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("allowed_border", [-1, 0])
@pytest.mark.parametrize("name", HEADS)
def test_anchor_head_spec_matches_jax(name, allowed_border):
    """The assigner and loss options read from the config, and the anchor
    mask of ``train_cfg.allowed_border``."""
    from radet_tpu.apis.common import anchor_head_spec as jax_anchor_head_spec
    from radet_tpu.utils.config import Config as JaxConfig
    from radet_tpu_torch.apis.common import anchor_head_spec

    path, options = ANCHOR_CONFIGS[name]
    options = options + [f"train_cfg.allowed_border={allowed_border}"]
    got, ref = anchor_head_spec(Config.fromfile(path, options)), jax_anchor_head_spec(JaxConfig.fromfile(path, options))
    assert got["head_type"] == ref["head_type"] and got["loss_kwargs"] == ref["loss_kwargs"]
    if allowed_border < 0:
        assert got["valid_mask"] is None and ref["valid_mask"] is None
    else:
        np.testing.assert_array_equal(got["valid_mask"], ref["valid_mask"])
        assert 0 < got["valid_mask"].sum() < got["valid_mask"].size
