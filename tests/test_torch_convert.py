"""Weight conversion between the packages: the port's
``state_dict_from_flax`` is the exact inverse of
``tools/convert_torch_weights.py::convert_mmdet_detector``, and the port's
model loads mmdet-named state dicts (and checkpoint files) with strict=True."""

import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from radet_tpu.models import build_detector as jax_build_detector
from radet_tpu_torch import init_detector
from radet_tpu_torch.engine.convert import state_dict_from_flax
from radet_tpu_torch.models import build_detector
from radet_tpu_torch.utils.config import Config
from torch_parity import SMALL_MODEL

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools"))
from convert_torch_weights import convert_mmdet_detector  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: E402, F401 (autouse: passed tests' files removed)

FLAGSHIP = "configs/bop/r50_ycbv_pbr.py"


def _seeded_state_dict(seed=0):
    """mmdet-named state dict of the small model, every entry random."""
    model = build_detector(SMALL_MODEL, dtype="float32")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return model.state_dict()


def _roundtrip(sd):
    flat = {}
    convert_mmdet_detector({k: v.numpy() for k, v in sd.items()}, flat)
    return state_dict_from_flax(traverse_util.unflatten_dict(flat))


def test_inverse_of_convert_mmdet_detector():
    sd = _seeded_state_dict()
    back = _roundtrip(sd)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k
    model = build_detector(SMALL_MODEL, dtype="float32")
    model.load_state_dict(back, strict=True)


def test_loads_released_layout_with_bn_step_counters(tmp_path):
    """A released mmdet checkpoint carries ``num_batches_tracked`` per BN and
    wraps the weights as {"state_dict": ..., "meta": ...}; both load."""
    sd = dict(_seeded_state_dict(seed=1))
    bn_prefixes = [k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")]
    assert len(bn_prefixes) == 53  # ResNet-50: stem + 16 blocks x 3 + 4 downsample
    for p in bn_prefixes:
        sd[p + ".num_batches_tracked"] = torch.tensor(1000)
    path = tmp_path / "radet.pth"
    torch.save({"state_dict": sd, "meta": {"CLASSES": ("a", "b", "c", "d")}}, path)
    cfg = Config.fromfile(FLAGSHIP)
    cfg.model = SMALL_MODEL
    cfg.input_size = (64, 96)
    det = init_detector(cfg, checkpoint=str(path), device="cpu")
    loaded = det.model.state_dict()
    for k, v in loaded.items():
        assert torch.equal(v, sd[k]), k
    assert det.classes and det.classes[0] == "master_chef_can"  # the config's names win
    with pytest.raises(RuntimeError, match="Missing key"):
        bad = {k: v for k, v in sd.items() if "atss_reg" not in k}
        build_detector(SMALL_MODEL).load_state_dict(bad, strict=True)


def test_flagship_flax_tree_maps_onto_the_port():
    """The full-width flagship's flax variables (shapes only, zeros) convert
    and load strictly: names and shapes agree at 256 channels, 21 classes."""
    cfg = Config.fromfile(FLAGSHIP)
    jax_model = jax_build_detector(cfg.model.to_dict(), dtype="float32")
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros)
    port = build_detector(cfg.model.to_dict(), dtype="float32")
    port.load_state_dict(sd, strict=True)
    assert sd["bbox_head.atss_cls.weight"].shape == (21, 256, 3, 3)
    assert sd["bbox_head.scales.4.scale"].shape == ()


def test_rejects_variables_without_a_place():
    flat = {}
    convert_mmdet_detector({k: v.numpy() for k, v in _seeded_state_dict().items()}, flat)
    flat[("params", "bbox_head", "conv_extra", "kernel")] = np.zeros((3, 3, 64, 4), np.float32)
    with pytest.raises(ValueError, match="conv_extra"):
        state_dict_from_flax(traverse_util.unflatten_dict(flat))
