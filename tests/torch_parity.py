"""Shared set-up of the parity tests between ``radet_tpu`` and
``radet_tpu_torch`` (tests/test_torch_*.py): one seeded flax model, its
variables randomised with numpy, and the port's model holding the same
weights through ``radet_tpu_torch.engine.convert.state_dict_from_flax``."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from radet_tpu_torch.engine.convert import state_dict_from_flax

# ResNet-50 trunk, FPN and head at width 64 with 2 stacked convs, 4 classes
SMALL_MODEL = dict(
    type="RADet",
    backbone=dict(type="ResNet", depth=50, frozen_stages=1, norm_eval=True),
    neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048], out_channels=64,
              start_level=1, add_extra_convs="on_output", num_outs=5),
    bbox_head=dict(type="RADetHead", num_classes=4, in_channels=64, stacked_convs=2,
                   feat_channels=64),
)
IMG_HW = (64, 96)
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_detector_parity.py's bar, float32
FLAGSHIP = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs/bop/r50_ycbv_pbr.py")
# config overrides giving SMALL_MODEL's widths at IMG_HW, in float32
NARROW = [
    "model.neck.out_channels=64",
    "model.bbox_head.in_channels=64",
    "model.bbox_head.feat_channels=64",
    "model.bbox_head.stacked_convs=2",
    "model.bbox_head.num_classes=4",
    f"input_size={IMG_HW}",
    "compute_dtype='float32'",
]


def randomize(tree, rng, path=()):
    """Numpy copy of a flax variable tree with BN/GN affines and statistics,
    conv biases and the per-level scales drawn from ``rng`` (flax's init
    leaves them at identity/zero, which would hide a mapping error)."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = randomize(v, rng, p)
            continue
        v = np.asarray(v, np.float32)
        n = v.shape
        if p[-1] == "mean":
            v = rng.randn(*n) * 0.5
        elif p[-1] == "var":
            v = rng.rand(*n) + 0.5
        elif p[-1] == "scale" and "BatchNorm_0" in p:
            # below 1, as in a trained trunk: with flax's He init and unit
            # gammas the residual stream doubles its variance per block and
            # C5 reaches ~2e3, where float32 rounding alone exceeds 1e-4
            v = rng.uniform(0.3, 0.7, n)
        elif p[-1] == "scale":
            v = rng.randn(*n) * 0.2 + 1
        elif p[-1] == "scales":
            v = 1.0 + 0.1 * np.arange(n[0])
        elif p[-1] == "bias":
            v = rng.randn(*n) * (0.5 if "conv_cls" in p else 0.1)
        out[k] = np.asarray(v, np.float32)
    return out


def flax_and_port_models(jax_model, port_model, img_hw=IMG_HW, seed=0):
    """Seeded flax init, randomised; the port model loads the same weights
    (strict).  Returns the numpy variable tree."""
    h, w = img_hw
    init = jax.jit(lambda key, x: jax_model.init(key, x, train=False))
    variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, variables), np.random.RandomState(seed))
    port_model.load_state_dict(state_dict_from_flax(variables), strict=True)
    port_model.eval()
    return variables


def jax_assignment_noise(key, b, g, n, cap):
    """The noise ``radet_tpu``'s assignment draws for a batch under ``key``,
    as numpy: per image ``split(key, b)``, per GT ``split(image_key, g)``,
    then ``k_with, k_without = split(gt_key)``; ``gumbel(k_without, (n,))``
    scores the anchors and ``gumbel(k_with, (cap, cap))`` is what
    ``jax.random.categorical(k_with, logits, shape=(cap,))`` adds to the
    slot logits.  Returns (gumbel_pool (b, g, n), gumbel_draw (b, g, cap, cap))."""
    image_keys = jax.random.split(key, b)
    gt_keys = jax.vmap(lambda k: jax.random.split(k, g))(image_keys)
    pairs = jax.vmap(jax.vmap(jax.random.split))(gt_keys)  # (b, g, [k_with, k_without])
    pool = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (n,))))(pairs[:, :, 1])
    draw = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (cap, cap))))(pairs[:, :, 0])
    return np.array(pool), np.array(draw)

