"""mmdet's box coders and anchor generators in the port
(``core/box_coder.py``, ``core/anchor_generator.py``) against the JAX
package, float32 on the CPU, on seeded numpy boxes; and the head builder's
refusal of a generator whose levels differ in anchor count.

| compared                                                      | tolerance       |
|---------------------------------------------------------------|-----------------|
| each coder's encode and decode (Bucketing: its 4 targets,     | 1e-6 relative   |
|   boxes and localisation confidence; labels and weights exact)|                 |
| each generator's base and grid anchors, valid and responsible | exact           |
|   flags, PointGenerator's points                              |                 |
| unknown types, the builder's refusal                          | the same errors |
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.core import anchor_generator as jgen
from radet_tpu.core import box_coder as jcoder
from radet_tpu.models.builder import head_spec_from_cfg as jax_head_spec_from_cfg
from radet_tpu_torch.core import anchor_generator as pgen
from radet_tpu_torch.core import box_coder as pcoder
from radet_tpu_torch.models.builder import head_spec_from_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

B, K = 2, 64
HW = np.float32([[100, 150], [128, 160]])  # per-image (h, w)


def _close(port, ref, rtol=1e-6, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, what
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3g} of max |ref| (limit {rtol})"


def _boxes(rng, shape, lo=0.0, hi=160.0):
    xy = rng.uniform(lo, hi - 20, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(4, 60, shape + (2,))], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _max_shapes():
    """(JAX's, the port's) per-image max_shape, as ``get_bboxes_anchor``
    passes it: a pair of (B, 1) columns."""
    return (HW[:, 0:1], HW[:, 1:2]), (_t(HW[:, 0:1]), _t(HW[:, 1:2]))


CODERS = {
    "tblr": dict(type="TBLRBBoxCoder", normalizer=0.125),
    "delta": dict(type="DeltaXYWHBBoxCoder", target_means=(0.1, -0.1, 0.0, 0.05), target_stds=(0.1, 0.1, 0.2, 0.2)),
    "legacy": dict(type="LegacyDeltaXYWHBBoxCoder", target_means=(0.0, 0.0, 0.0, 0.0),
                   target_stds=(0.1, 0.1, 0.2, 0.2)),
    "delta_no_clip": dict(type="DeltaXYWHBBoxCoder", clip_border=False),
}


@pytest.mark.parametrize("name", sorted(CODERS))
def test_coder_encode_decode_match_jax(name):
    """Encode of GT boxes and decode of random deltas, clamped at each
    image's border; the boxes reach past the border so the clamp binds."""
    rng = np.random.RandomState(0)
    anchors, gt = _boxes(rng, (B, K)), _boxes(rng, (B, K), lo=-10, hi=190)
    deltas = (rng.randn(B, K, 4) * 0.5).astype(np.float32)
    j_enc, j_dec = jcoder.build_bbox_coder(dict(CODERS[name]))
    enc, dec = pcoder.build_bbox_coder(dict(CODERS[name]))
    ref = j_enc(jnp.asarray(anchors), jnp.asarray(gt))
    _close(enc(_t(anchors), _t(gt)), ref, what="encode")
    j_shape, p_shape = _max_shapes()
    for jm, pm in ((None, None), ((100.0, 150.0), (100.0, 150.0)), (j_shape, p_shape)):
        ref_boxes = np.asarray(j_dec(jnp.asarray(anchors), jnp.asarray(deltas), max_shape=jm))
        got = dec(_t(anchors), _t(deltas), max_shape=pm)
        _close(got, ref_boxes, what=f"decode, max_shape {jm}")
    if name != "delta_no_clip":  # the clamp bound at the border (legacy: w - 1, h - 1)
        border = 1.0 if name == "legacy" else 0.0
        assert (got[..., 2].numpy() == HW[:, 1:2] - border).any()


def test_legacy_coder_plus_one_matches_jax():
    """mmdet v1's delta coder through its own functions, at the image
    border: widths x2 - x1 + 1, the clamp at max_shape - 1."""
    rng = np.random.RandomState(1)
    anchors = _boxes(rng, (K,))
    anchors[:8, 2] = 159.0  # anchors touching the right border of a 160-wide image
    gt = _boxes(rng, (K,), lo=-5, hi=170)
    _close(pcoder.legacy_delta_encode(_t(anchors), _t(gt)), jcoder.legacy_delta_encode(anchors, gt))
    deltas = (rng.randn(K, 4) * 0.3).astype(np.float32)
    got = pcoder.legacy_delta_decode(_t(anchors), _t(deltas), max_shape=(128, 160))
    _close(got, jcoder.legacy_delta_decode(anchors, deltas, max_shape=(128, 160)))
    assert got[:, 2].max() == 159.0


def test_yolo_and_pseudo_coders_match_jax():
    rng = np.random.RandomState(2)
    anchors, gt = _boxes(rng, (B, K)), _boxes(rng, (B, K))
    for stride in (8.0, 32.0):
        j_enc, j_dec = jcoder.build_bbox_coder(dict(type="YOLOBBoxCoder", eps=1e-6))
        enc, dec = pcoder.build_bbox_coder(dict(type="YOLOBBoxCoder", eps=1e-6))
        ref = np.asarray(j_enc(jnp.asarray(anchors), jnp.asarray(gt), stride))
        got = enc(_t(anchors), _t(gt), stride)
        _close(got, ref, what="YOLO encode")
        assert ((got[..., :2] > 0) & (got[..., :2] < 1)).all()  # the center offsets clamped
        preds = rng.rand(B, K, 4).astype(np.float32)
        _close(dec(_t(anchors), _t(preds), stride), j_dec(jnp.asarray(anchors), jnp.asarray(preds), stride),
               what="YOLO decode")
    enc, dec = pcoder.build_bbox_coder(dict(type="PseudoBBoxCoder"))
    assert enc(_t(anchors), _t(gt)) is not None and torch.equal(enc(_t(anchors), _t(gt)), _t(gt))
    assert torch.equal(dec(_t(anchors), _t(gt)), _t(gt))


BUCKETING = [dict(type="BucketingBBoxCoder", num_buckets=14, scale_factor=1.7),
             dict(type="BucketingBBoxCoder", num_buckets=7, scale_factor=3.0, offset_topk=1,
                  offset_upperbound=0.5, cls_ignore_neighbor=False, clip_border=False)]


@pytest.mark.parametrize("cfg", BUCKETING, ids=["sabl", "odd_no_clip"])
def test_bucketing_coder_matches_jax(cfg):
    """Bucketing's four targets and its (boxes, loc_confidence) decode of a
    (cls, offset) pair; a single tensor raises TypeError in both."""
    rng = np.random.RandomState(3)
    n = 50
    props, gt = _boxes(rng, (n,)), _boxes(rng, (n,))
    j_enc, j_dec = jcoder.build_bbox_coder(dict(cfg))
    enc, dec = pcoder.build_bbox_coder(dict(cfg))
    ref, got = j_enc(jnp.asarray(props), jnp.asarray(gt)), enc(_t(props), _t(gt))
    _close(got[0], ref[0], what="offsets")
    for i, what in ((1, "offset weights"), (2, "bucket labels"), (3, "cls weights")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=what)
    side = -(-cfg["num_buckets"] // 2)
    cls = rng.randn(n, 4 * side).astype(np.float32)
    off = (rng.randn(n, 4 * side) * 0.3).astype(np.float32)
    for shape in (None, (120, 150)):
        ref_boxes, ref_conf = j_dec(jnp.asarray(props), (jnp.asarray(cls), jnp.asarray(off)), max_shape=shape)
        boxes, conf = dec(_t(props), (_t(cls), _t(off)), max_shape=shape)
        _close(boxes, ref_boxes, what=f"decoded boxes, max_shape {shape}")
        _close(conf, ref_conf, what="loc confidence")
    with pytest.raises(TypeError):
        j_dec(jnp.asarray(props), jnp.asarray(cls))
    with pytest.raises(TypeError):
        dec(_t(props), _t(cls))


def test_unknown_coder_raises_as_jax():
    for build in (jcoder.build_bbox_coder, pcoder.build_bbox_coder):
        with pytest.raises(KeyError, match="unsupported bbox_coder"):
            build(dict(type="DistancePointBBoxCoder"))


SSD_RATIOS = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
GENERATORS = {
    "anchor_octave": dict(type="AnchorGenerator", octave_base_scale=4, scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                          strides=[8, 16, 32, 64, 128]),
    "anchor_centers": dict(type="AnchorGenerator", scales=[8], ratios=[0.5, 1.0, 2.0], strides=[(8, 6), 16],
                           centers=[(3.0, 2.0), (7.5, 7.5)], scale_major=False),
    "anchor_offset": dict(type="AnchorGenerator", scales=[2, 4], ratios=[1.0], strides=[16, 32],
                          base_sizes=[12, 24], center_offset=0.5),
    "ssd300_coco": dict(type="SSDAnchorGenerator", strides=[8, 16, 32, 64, 100, 300], ratios=SSD_RATIOS,
                        basesize_ratio_range=(0.15, 0.9)),
    "ssd300_voc": dict(type="SSDAnchorGenerator", strides=[8, 16, 32, 64, 100, 300], ratios=SSD_RATIOS,
                       basesize_ratio_range=(0.2, 0.9)),
    "ssd512_coco": dict(type="SSDAnchorGenerator", input_size=512, strides=[8, 16, 32, 64, 128, 256, 512],
                        ratios=[[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]], basesize_ratio_range=(0.1, 0.9)),
    "legacy": dict(type="LegacyAnchorGenerator", scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64],
                   center_offset=0.5),
    "legacy_ssd": dict(type="LegacySSDAnchorGenerator", strides=[8, 16, 32, 64, 100, 300], ratios=SSD_RATIOS,
                       basesize_ratio_range=(0.15, 0.9)),
    "yolo": dict(type="YOLOAnchorGenerator", strides=[32, 16, 8],
                 base_sizes=[[(116, 90), (156, 198), (373, 326)], [(30, 61), (62, 45), (59, 119)],
                             [(10, 13), (16, 30), (33, 23)]]),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("hw", [(300, 300), (128, 160)])
def test_generator_matches_jax(name, hw):
    """Base anchors, the flattened grid and its valid flags, and the flags
    at a smaller pad shape."""
    gen, ref = pgen.build_anchor_generator(dict(GENERATORS[name])), jgen.build_anchor_generator(dict(GENERATORS[name]))
    assert type(gen).__name__ == type(ref).__name__ and gen.num_base_anchors == ref.num_base_anchors
    for got, want in zip(gen.base_anchors, ref.base_anchors):
        np.testing.assert_array_equal(got, want)
    anchors, flags, counts = pgen.flat_anchors_for_input(gen, hw)
    r_anchors, r_flags, r_counts = jgen.flat_anchors_for_input(ref, hw)
    np.testing.assert_array_equal(anchors, r_anchors)
    np.testing.assert_array_equal(flags, r_flags)
    assert counts == r_counts
    sizes = [(-(-hw[0] // s[1]), -(-hw[1] // s[0])) for s in gen.strides]
    pad = (hw[0] - 40, hw[1] - 70)
    for got, want in zip(gen.valid_flags(sizes, pad), ref.valid_flags(sizes, pad)):
        np.testing.assert_array_equal(got, want)
    if name == "yolo":
        gt = _boxes(np.random.RandomState(4), (5,), hi=min(hw))
        resp = gen.responsible_flags(sizes, gt)
        for got, want in zip(resp, ref.responsible_flags(sizes, gt)):
            np.testing.assert_array_equal(got, want)
        assert all(0 < r.sum() <= 5 * 3 for r in resp)


def test_point_generator_matches_jax():
    gen, ref = pgen.build_anchor_generator(dict(type="PointGenerator")), jgen.PointGenerator()
    for size, stride in (((6, 9), 16.0), ((1, 4), 8.0)):
        np.testing.assert_array_equal(gen.grid_points(size, stride), ref.grid_points(size, stride))
        np.testing.assert_array_equal(gen.valid_flags(size, (size[0], 2)), ref.valid_flags(size, (size[0], 2)))
    for g in (gen, ref):
        with pytest.raises(AssertionError):
            g.valid_flags((2, 3), (3, 3))


@pytest.mark.parametrize("cfg,error", [
    (dict(type="DenseAnchorGenerator", strides=[8]), KeyError),
    (dict(type="SSDAnchorGenerator", strides=[8, 16, 32], ratios=[[2], [2], [2]], basesize_ratio_range=(0.3, 0.9)),
     ValueError),
    (dict(type="SSDAnchorGenerator", input_size=640, strides=[8, 16, 32], ratios=[[2], [2], [2]],
          basesize_ratio_range=(0.15, 0.9)), ValueError),
], ids=["unknown", "ssd_ratio_range", "ssd_input_size"])
def test_generator_refusals_match_jax(cfg, error):
    for build in (jgen.build_anchor_generator, pgen.build_anchor_generator):
        with pytest.raises(error):
            build(dict(cfg))


@pytest.mark.parametrize("name", ["ssd300_coco", "legacy", "yolo", "anchor_octave"])
def test_head_spec_refuses_non_uniform_generators_as_jax(name):
    """A head takes one anchor count for every level: the SSD generator (4
    and 6 a level) is refused with the JAX builder's AssertionError; the
    legacy and YOLO generators pass."""
    head = dict(type="AnchorHead", num_classes=3, in_channels=32, anchor_generator=dict(GENERATORS[name]),
                loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True))
    if name.startswith("ssd"):
        for spec in (jax_head_spec_from_cfg, head_spec_from_cfg):
            with pytest.raises(AssertionError, match="uniform"):
                spec(dict(head))
        return
    assert head_spec_from_cfg(dict(head)) == jax_head_spec_from_cfg(dict(head))
