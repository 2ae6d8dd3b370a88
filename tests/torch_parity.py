"""Shared set-up of the parity tests between ``radet_tpu`` and
``radet_tpu_torch`` (tests/test_torch_*.py): one seeded flax model, its
variables randomised with numpy, and the port's model holding the same
weights through ``radet_tpu_torch.engine.convert.state_dict_from_flax``;
the flagship narrowed (``NARROW``), the ATSS and RetinaNet configs
narrowed (``ANCHOR_CONFIGS``, :func:`anchor_pair`), and the backbone zoo's
configs with their neck and head narrowed (``ZOO_CONFIGS``,
:func:`zoo_pair`), and any config with options (:func:`config_pair`)."""

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
        elif p[-1] == "l2_norm_weight":  # SSD-VGG's L2Norm, 20 at init
            v = rng.uniform(10, 30, n)
        elif p[-1] == "bias":
            v = rng.randn(*n) * (0.5 if "conv_cls" in p else 0.1)
        out[k] = np.asarray(v, np.float32)
    return out


def numpy_variables(init_fn, seed=0):
    """A variable tree of ``init_fn``'s shapes (``jax.eval_shape``, so
    nothing is compiled), drawn with numpy: the head's kernels from
    N(0, 0.01^2) as the JAX head initialises them, every other kernel from
    N(0, 1 / fan_in), the rest as :func:`randomize` draws it.  A second
    where a jitted init of a 50-layer trunk takes ten.  (A head as wide as
    its input would leave GroupNorm on P7's 1x1 map, two channels a group,
    at the mercy of float32 rounding: gradients that move 1e-3 under a
    1e-7 change of the weights.)"""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        keys = [p.key for p in path]
        if keys[-1] != "kernel":
            return np.zeros(s.shape, np.float32)
        std = 0.01 if "bbox_head" in keys else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) * std).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn))
    return randomize(tree, rng)


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



# the serving tests' detector: NARROW on the CPU with the test_cfg of
# tests/test_torch_slice.py (exact top-k, nms_topk above the 516 candidate pairs)
SERVE_TEST_CFG = ["test_cfg.approx_topk=False", "test_cfg.nms_topk=1024"]


def serving_pair():
    """(radet_tpu Detector, radet_tpu_torch Detector on the CPU) of the
    narrowed flagship, carrying the same weights."""
    from radet_tpu.apis.inference import Detector as JaxDetector
    from radet_tpu.utils.config import Config as JaxConfig
    from radet_tpu_torch import init_detector

    jax_det = JaxDetector(JaxConfig.fromfile(FLAGSHIP, NARROW + SERVE_TEST_CFG))
    cpu_options = [o for o in NARROW if not o.startswith("compute_dtype")] + SERVE_TEST_CFG
    det = init_detector(FLAGSHIP, cfg_options=cpu_options, device="cpu")
    jax_det.variables = flax_and_port_models(jax_det.model, det.model)
    return jax_det, det


def assert_same_detections(got, want):
    """Per-image detection dicts: valid and labels equal, scores within
    1e-5, boxes within 1e-2 px."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["boxes"]) == len(w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-2)


# the anchor-head configs (configs/atss) at 128x160 with an FPN of width 32,
# 3 classes and ATSS's tower at one 32-wide block, in float32
ANCHOR_HW = (128, 160)
_ANCHOR_NARROW = [
    "model.neck.out_channels=32",
    "model.bbox_head.in_channels=32",
    "model.bbox_head.num_classes=3",
    f"input_size={ANCHOR_HW}",
    "compute_dtype='float32'",
]
ANCHOR_CONFIGS = {
    "atss": (osp.join(osp.dirname(osp.dirname(FLAGSHIP)), "atss", "atss_r50_fpn_ycbv_pbr.py"),
             _ANCHOR_NARROW + ["model.bbox_head.feat_channels=32", "model.bbox_head.stacked_convs=1"]),
    "retina": (osp.join(osp.dirname(osp.dirname(FLAGSHIP)), "atss", "retina_r50_fpn_ycbv_pbr.py"),
               _ANCHOR_NARROW),
}


def anchor_pair(name, seed=0):
    """The narrowed anchor-head config ``name`` ('atss' or 'retina') in both
    packages, one seeded flax model with randomised weights, and the port's
    model on the CPU holding them.  Returns (jax_cfg, cfg, jax_model,
    variables, port model, anchors, level counts)."""
    from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
    from radet_tpu.utils.config import Config as JaxConfig
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.utils.config import Config

    path, options = ANCHOR_CONFIGS[name]
    jax_cfg, cfg = JaxConfig.fromfile(path, options), Config.fromfile(path, options)
    jax_model, anchors, _, counts = jax_build_model_and_anchors(jax_cfg)
    port, p_anchors, _, p_counts = build_model_and_anchors(cfg)
    np.testing.assert_array_equal(p_anchors, anchors)
    assert list(p_counts) == list(counts)
    variables = flax_and_port_models(jax_model, port, img_hw=ANCHOR_HW, seed=seed)
    return jax_cfg, cfg, jax_model, variables, port, anchors, counts


# configs/bop's backbone zoo: NARROW's neck and head, the trunk at its
# published widths, exact top-k over all candidate pairs
ZOO_CONFIGS = {name: osp.join(osp.dirname(FLAGSHIP), f"{name}_ycbv_pbr.py")
               for name in ("x50_32x4d", "r2_50", "s50", "regnetx32")}
ZOO_NARROW = NARROW + SERVE_TEST_CFG


def zoo_pair(name, seed=0, options=()):
    """The zoo config ``name`` (a key of ``ZOO_CONFIGS``) in both packages
    with ``ZOO_NARROW`` and ``options``: :func:`config_pair`."""
    return config_pair(ZOO_CONFIGS[name], ZOO_NARROW + list(options), seed)


def config_pair(path, options, seed=0):
    """The config at ``path`` with ``options`` in both packages, one seeded
    variable tree (:func:`numpy_variables`), and the port's model on the
    CPU holding it.  Returns (jax_cfg, cfg, jax_model, variables, port
    model, anchors, regress ranges, level counts)."""
    from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
    from radet_tpu.utils.config import Config as JaxConfig
    from radet_tpu_torch.apis.common import build_model_and_anchors
    from radet_tpu_torch.utils.config import Config

    jax_cfg, cfg = JaxConfig.fromfile(path, options), Config.fromfile(path, options)
    jax_model, anchors, ranges, counts = jax_build_model_and_anchors(jax_cfg)
    port, p_anchors, p_ranges, p_counts = build_model_and_anchors(cfg)
    np.testing.assert_array_equal(p_anchors, anchors)
    np.testing.assert_array_equal(p_ranges, ranges)
    assert list(p_counts) == list(counts)
    h, w = cfg.input_size
    variables = numpy_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), train=False), seed)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.eval()
    return jax_cfg, cfg, jax_model, variables, port, anchors, ranges, counts


def jax_sampler_draws(key, b, n, num_bins=3):
    """The uniforms ``radet_tpu``'s samplers draw for a batch of ``b``
    images of ``n`` anchors under ``key``, by the port's roles
    (``radet_tpu_torch.core.sampler_cores``), as (b, n) numpy arrays.  Per
    image ``split(key, b)``, then ``kp, kn = split(image_key)``: 'pos' and
    'neg' are ``uniform(kp)``, ``uniform(kn)``; 'groups', 'extra' and
    'down' the three keys of ``split(kp, 3)``; 'bin<b>' ``fold_in(k1, b)``
    and 'topup', 'floor', 'rest' k2, k3, k4 of ``split(kn, 4)``; 'rand' and
    'inv' the two of ``split(kn)``."""
    def image(k):
        kp, kn = jax.random.split(k)
        k1, k2, k3, k4 = jax.random.split(kn, 4)
        keys = dict(pos=kp, neg=kn, topup=k2, floor=k3, rest=k4)
        keys.update(zip(("groups", "extra", "down"), jax.random.split(kp, 3)))
        keys.update(zip(("rand", "inv"), jax.random.split(kn)))
        keys.update({f"bin{i}": jax.random.fold_in(k1, i) for i in range(num_bins)})
        return {role: jax.random.uniform(kk, (n,)) for role, kk in keys.items()}

    return {role: np.array(v) for role, v in jax.vmap(image)(jax.random.split(key, b)).items()}
