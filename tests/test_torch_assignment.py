"""The port's batched label assignment (radet_tpu_torch/core/assignment.py)
against ``radet_tpu.core.assignment.assign_labels``, float32 on the CPU.

The JAX function runs per image under its own key; the port runs the whole
batch once with the same noise, drawn by JAX from that key chain
(``torch_parity.jax_assignment_noise``).  With shared noise the result is
exact: ``gt_idx`` equal, ``weight`` within 1e-6.

Anchors are those of a 128x192 input (512 over five levels), so GTs of 10
to 140 px reach several levels and give pools both smaller than
``positive_num`` (drawn with replacement) and larger (drawn without).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radet_tpu.core.assignment import assign_labels as jax_assign_labels
from radet_tpu_torch.core.anchors import generate_anchors
from radet_tpu_torch.core.assignment import assign_labels, candidate_mask
from torch_parity import jax_assignment_noise
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: F401 (autouse: passed tests' files removed)

IMG_HW = (128, 192)
B, G = 3, 8
SIDES = (10, 20, 40, 80, 140)


def _gts(seed=0):
    """Boxes of mixed sizes (overlapping, so ambiguity resolution matters),
    padded to G with invalid slots; odd GTs get continuous distance values,
    even ones binary masks."""
    anchors, ranges, _, _ = generate_anchors(IMG_HW)
    n = anchors.shape[0]
    h, w = IMG_HW
    cx = (anchors[:, 0] + anchors[:, 2]) / 2
    cy = (anchors[:, 1] + anchors[:, 3]) / 2
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    dist = np.zeros((B, n, G), np.float32)
    for b, ng in enumerate((4, 6, 7)):
        for g in range(ng):
            sw = float(rng.choice(SIDES))
            sh = min(sw * rng.uniform(0.7, 1.3), h - 1.0)
            x1, y1 = rng.uniform(0, w - sw), rng.uniform(0, h - sh)
            boxes[b, g] = [x1, y1, x1 + sw, y1 + sh]
            valid[b, g] = True
            inside = (cx > x1) & (cx < x1 + sw) & (cy > y1) & (cy < y1 + sh)
            dist[b, :, g] = inside * (rng.uniform(0.05, 1.0, n) if g % 2 else 1.0)
    return anchors, ranges, boxes, valid, dist.astype(np.float16)


CASES = {
    "defaults": {},
    "adapt_positive_num": dict(adapt_positive_num=True),
    "no_balance_sample": dict(balance_sample=False),
    "uniform_sampling": dict(random_sample_by_distance=False),
    "multiply_samplepro": dict(multiply_samplepro_for_weight=True),
    "max_dis": dict(ambiguous_sample="max_dis"),
    "max_dis_adapt_uniform": dict(ambiguous_sample="max_dis", adapt_positive_num=True,
                                  random_sample_by_distance=False),
    "adapt_multiply_no_balance": dict(adapt_positive_num=True, multiply_samplepro_for_weight=True,
                                      balance_sample=False),
}


@pytest.mark.parametrize("impl", ["vectorized", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_assignment_matches_jax(case, impl):
    kw = dict(CASES[case], positive_num=10, neg_threshold=0.2)
    anchors, ranges, boxes, valid, dist = _gts()
    n = anchors.shape[0]
    cap = 40 if kw.get("adapt_positive_num") else 10
    key = jax.random.PRNGKey(3)
    ref = jax.jit(jax.vmap(
        lambda k, gb, gv, dv: jax_assign_labels(
            k, jnp.asarray(anchors), jnp.asarray(ranges), gb, gv, dv, impl=impl, **kw)
    ))(jax.random.split(key, B), boxes, valid, dist)
    pool, draw = jax_assignment_noise(key, B, G, n, cap)
    out = assign_labels(
        torch.from_numpy(anchors), torch.from_numpy(ranges), torch.from_numpy(boxes),
        torch.from_numpy(valid), torch.from_numpy(dist), impl=impl,
        gumbel_pool=torch.from_numpy(pool), gumbel_draw=torch.from_numpy(draw), **kw,
    )
    gt_idx, weight = np.asarray(ref.gt_idx), np.asarray(ref.weight)
    np.testing.assert_array_equal(out.gt_idx.numpy(), gt_idx)
    np.testing.assert_allclose(out.weight.numpy(), weight, rtol=0, atol=1e-6)
    assert out.gt_idx.dtype == torch.int32 and out.weight.dtype == torch.float32
    # the case reaches what it is about: positives, ignores, and pools on
    # both sides of positive_num
    pos = gt_idx >= 0
    assert pos.sum() > 20 and (gt_idx == -2).any()
    per_gt = [np.bincount(gt_idx[b][pos[b]], minlength=G) for b in range(B)]
    assert max(c.max() for c in per_gt) >= 10 and any(((c > 0) & (c < 10)).any() for c in per_gt)
    if kw.get("balance_sample", True) and not kw.get("multiply_samplepro_for_weight"):
        assert (weight[pos] > 1).any()  # a small pool was drawn with replacement


def test_generator_noise_is_reproducible_and_well_formed():
    anchors, ranges, boxes, valid, dist = _gts(seed=1)
    args = [torch.from_numpy(a) for a in (anchors, ranges, boxes, valid, dist)]
    a = assign_labels(*args, generator=torch.Generator().manual_seed(5))
    b = assign_labels(*args, generator=torch.Generator().manual_seed(5))
    c = assign_labels(*args, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.gt_idx, b.gt_idx) and torch.equal(a.weight, b.weight)
    assert not torch.equal(a.gt_idx, c.gt_idx)
    # positives lie among the candidates of their GT; negatives weigh 1
    cand = candidate_mask(args[0], args[1], args[2], args[3])
    pos = a.gt_idx >= 0
    assert torch.gather(cand, 2, a.gt_idx.clamp(min=0).long()[..., None])[..., 0][pos].all()
    assert (a.weight[a.gt_idx == -1] == 1).all() and (a.weight[a.gt_idx == -2] == 0).all()


def test_bad_arguments_raise():
    anchors, ranges, boxes, valid, dist = (torch.from_numpy(a) for a in _gts())
    with pytest.raises(ValueError, match="ambiguous_sample"):
        assign_labels(anchors, ranges, boxes, valid, dist, ambiguous_sample="nearest")
    with pytest.raises(ValueError, match="impl"):
        assign_labels(anchors, ranges, boxes, valid, dist, impl="loop")
    with pytest.raises(ValueError, match="noise shapes"):
        assign_labels(anchors, ranges, boxes, valid, dist, gumbel_pool=torch.zeros(1, 1, 1),
                      gumbel_draw=torch.zeros(1, 1, 1, 1))
