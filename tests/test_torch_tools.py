"""The port's measuring and deploy tools against the JAX package's, on the
CPU in float32 at the narrow widths of ``tests/torch_parity.py`` (64x96):

- ``tools/convert_jax_weights.py`` (orbax weights -> port ``.pth``), then
  ``python -m radet_tpu_torch.tools.export_model --verify`` (a
  ``torch.export`` program with vote-NMS inside), against
  ``tools/export_model.py --checkpoint`` (StableHLO) on the same weights and
  images; the loaded program bit for bit equal to the eager step;
- the converter on other configs and checkpoint forms, and back through
  ``tools/convert_torch_weights.py`` to the original variables;
- ``get_flops``: the JAX tool's parameter count, the analytic convolution
  FLOPs, and the JAX tool's FLOP count within 5%;
- ``eval_metric`` on a ``tools.test --out`` pickle against the test CLI's
  metrics and ``radet_tpu.apis.test.evaluate_results``;
- the three profilers' outputs; the NMS operators under
  ``torch.library.opcheck``.

The JAX tools build their variables with ``init_variables``, a jitted flax
init that takes ~30 s for a ResNet-50 on the CPU; the tests hand them zeros
of the same tree instead (``jax.eval_shape``): the tools read only its
structure (a template for the checkpoint, or the FLOP count's input).
"""

import io
import json
import os.path as osp
import pickle
import sys
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import radet_tpu.apis.common as jax_common
from radet_tpu.apis.common import build_dataset as jax_build_dataset
from radet_tpu.apis.common import build_model_and_anchors as jax_build_model_and_anchors
from radet_tpu.apis.test import evaluate_results as jax_evaluate_results
from radet_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from radet_tpu.engine.checkpoint import save_weights as jax_save_weights
from radet_tpu.utils.config import Config as JaxConfig
from radet_tpu_torch import init_detector
from radet_tpu_torch.apis.common import build_infer_module, build_model_and_anchors
from radet_tpu_torch.engine.checkpoint import load_checkpoint
from radet_tpu_torch.ops import vote_nms_cuda
from radet_tpu_torch.ops.vote_nms import batched_nms_plain, vote_nms_plain
from radet_tpu_torch.tools import eval_metric, export_model, get_flops
from radet_tpu_torch.tools import profile_infer, profile_pipeline, profile_train
from radet_tpu_torch.tools import test as test_cli
from radet_tpu_torch.utils.config import Config
from synthetic_bop import write_bop_test_set
from torch_parity import (
    ANCHOR_CONFIGS,
    FLAGSHIP,
    IMG_HW,
    NARROW,
    SERVE_TEST_CFG,
    TOL,
    ZOO_CONFIGS,
    ZOO_NARROW,
    assert_same_detections,
    numpy_variables,
)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, "tools"))
import convert_jax_weights  # noqa: E402
import convert_torch_weights  # noqa: E402
import export_model as jax_export_model  # noqa: E402
import get_flops as jax_get_flops  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse: one torch thread)
from torch_tmp import drop_module_tmp, drop_passed_tmp_path  # noqa: E402, F401 (autouse: passed tests' files removed)

CPU_NARROW = [o for o in NARROW if not o.startswith("compute_dtype")] + SERVE_TEST_CFG
# the export and the anchor heads' conversions trace, save and load whole
# steps: on a ResNet-18 trunk they cost a third of ResNet-50's time
R18 = ["model.backbone.depth=18"]
FLAGSHIP_PARAMS = 32159327  # configs/bop/r50_ycbv_pbr.py at full width, both packages
# FLOPs, the port's FlopCounterMode count over the JAX tool's XLA count: XLA
# skips a padded window's taps and counts elementwise work.  Measured on
# this repository's CPU runs: the narrow flagship 53.02 / 53.64 = 0.9885 at
# the config's 480x640, the full one 120.96 / 119.88 = 1.009; at 64x96 the
# padding of the 2x3 to 1x1 maps (C5, P6, P7) tips it to 1.094, so the test
# compares at 480x640.
FLOP_RATIO_BOUND = 0.05


_SHAPES = {}


def variable_shapes(model, hw):
    """``jax.eval_shape`` of the flax init at ``hw``, once per model config."""
    key = (repr(model), tuple(hw))
    if key not in _SHAPES:
        h, w = hw
        _SHAPES[key] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
                                                         train=False))
    return _SHAPES[key]


def jax_variables(model, hw, seed=0):
    shapes = variable_shapes(model, hw)
    return numpy_variables(lambda: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), seed)


@pytest.fixture
def fast_jax_init(monkeypatch):
    """The JAX tools' ``init_variables``: zeros of the init's shapes."""
    monkeypatch.setattr(jax_common, "init_variables", lambda model, hw: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), variable_shapes(model, hw)))


def run_main(monkeypatch, module, argv):
    """A JAX tool's ``main()`` (which parses ``sys.argv``), its stdout returned."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return out.getvalue()


def images(b, hw, seed=1):
    h, w = hw
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3), np.uint8)


def per_image(boxes, scores, labels, valid):
    boxes, scores, labels, valid = (np.asarray(t) for t in (boxes, scores, labels, valid))
    return [dict(boxes=boxes[i][valid[i]], scores=scores[i][valid[i]], labels=labels[i][valid[i]])
            for i in range(len(boxes))]


# ------------------------------------------------------------ export, converter


def test_exported_step_matches_the_jax_artifact(tmp_path, monkeypatch, fast_jax_init):
    """One seeded flagship (narrow, on a ResNet-18 trunk) saved by the JAX
    package, converted to a ``.pth``, exported by each package's tool at
    batch 2; both artifacts run on the same uint8 images."""
    jax_cfg = JaxConfig.fromfile(FLAGSHIP, NARROW + SERVE_TEST_CFG + R18)
    jax_model = jax_build_model_and_anchors(jax_cfg)[0]
    variables = jax_variables(jax_model, IMG_HW)
    ckpt = str(tmp_path / "jax_weights")
    jax_save_weights(ckpt, variables, meta=dict(classes=["a", "b", "c", "d"]))
    pth = str(tmp_path / "port" / "weights.pth")
    options = CPU_NARROW + R18
    convert_jax_weights.main([ckpt, pth, "--config", FLAGSHIP, "--cfg-options", *options])
    assert load_checkpoint(pth)[1] == ("a", "b", "c", "d")  # meta.json travelled beside the .pth

    pt2 = str(tmp_path / "step.pt2")
    program = export_model.main([FLAGSHIP, pt2, "--checkpoint", pth, "--batch-size", "2", "--device", "cpu",
                                 "--verify", "--cfg-options", *options])
    hlo = str(tmp_path / "step.stablehlo")
    run_main(monkeypatch, jax_export_model, [FLAGSHIP, hlo, "--checkpoint", ckpt, "--batch-size", 2,
                                             "--cfg-options", *NARROW, *SERVE_TEST_CFG, *R18])

    h, w = IMG_HW
    imgs = images(2, IMG_HW)
    shapes = np.asarray([[h, w], [h - 10, w - 20]], np.float32)
    scales = np.ones((2, 4), np.float32)
    with open(hlo, "rb") as f:
        want = [np.asarray(t) for t in jax.export.deserialize(bytearray(f.read())).call(imgs, shapes, scales)]
    got = program(*(torch.from_numpy(a) for a in (imgs, shapes, scales)))
    assert int(want[3].sum()) > 0
    assert_same_detections(per_image(*got), per_image(*want))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_, **TOL)

    module = export_model.build_module(Config.fromfile(FLAGSHIP, options), pth, torch.device("cpu"))
    with torch.no_grad():
        eager = module(*(torch.from_numpy(a) for a in (imgs, shapes, scales)))
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


def _back_to_flax(sd):
    """``tools/convert_torch_weights.py``'s mapping of a port state dict.  It
    names the head's last convs as RADet's (conv_cls, conv_reg, conv_iou)
    and has no entry for AnchorHead's (KeyError after the trunk, neck and
    towers are mapped)."""
    flat = {}
    try:
        convert_torch_weights.convert_mmdet_detector({k: v.numpy() for k, v in sd.items()}, flat)
    except KeyError as e:
        assert "atss_cls" in str(e) and "bbox_head.conv_cls.weight" in sd
    return flat


# ATSS's head convs under the names convert_mmdet_detector gives them
_HEAD_NAMES = {"atss_cls": "conv_cls", "atss_reg": "conv_reg", "atss_centerness": "conv_iou"}
CONVERT_CASES = {
    "atss": (ANCHOR_CONFIGS["atss"][0], ANCHOR_CONFIGS["atss"][1] + R18),
    "retina": (ANCHOR_CONFIGS["retina"][0], ANCHOR_CONFIGS["retina"][1] + R18),
    "x50_32x4d": (ZOO_CONFIGS["x50_32x4d"], ZOO_NARROW),
    "resnetv1d": (FLAGSHIP, NARROW + SERVE_TEST_CFG + R18 + ["model.backbone.type='ResNetV1d'"]),
}


@pytest.mark.parametrize("name", sorted(CONVERT_CASES))
def test_converter_roundtrip(name, tmp_path):
    """JAX variables (a full TrainState in a ``CheckpointManager`` root) ->
    ``.pth`` -> ``init_detector`` (strict) -> ``convert_torch_weights`` ->
    the original variables, bit for bit; the root and its step directory
    give the same file.  ATSS's step exports through ``batched_nms``."""
    path, options = CONVERT_CASES[name]
    jax_cfg = JaxConfig.fromfile(path, options)
    jax_model = jax_build_model_and_anchors(jax_cfg)[0]
    variables = jax_variables(jax_model, tuple(jax_cfg.input_size))
    root = str(tmp_path / "checkpoints")
    manager = JaxCheckpointManager(root)
    state = types.SimpleNamespace(step=3, params=variables["params"], batch_stats=variables["batch_stats"],
                                  opt_state={"count": np.zeros((), np.int32)})
    manager.save(3, state, force=True, wait=True)
    manager.close()
    cpu_options = [o for o in options if not o.startswith("compute_dtype")]
    pth = str(tmp_path / "port.pth")
    convert_jax_weights.main([root, pth, "--config", path, "--cfg-options", *cpu_options])
    from_step = convert_jax_weights.convert(osp.join(root, "3"), str(tmp_path / "step.pth"), path, cpu_options)
    det = init_detector(path, pth, cfg_options=cpu_options, device="cpu")
    sd = det.model.state_dict()
    assert set(sd) == set(from_step) and all(torch.equal(sd[k], from_step[k]) for k in sd)

    flat = _back_to_flax(sd)
    want = traverse_util.flatten_dict(variables)
    if name == "retina":  # convert_mmdet_detector stops at AnchorHead's last convs
        want = {k: v for k, v in want.items() if k[2] not in ("conv_cls", "conv_reg")}
    elif name == "atss":
        want = {k[:2] + (_HEAD_NAMES.get(k[2], k[2]),) + k[3:]: v for k, v in want.items()}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k], np.float32).reshape(v.shape), v, err_msg=str(k))

    if name == "atss":
        module = build_infer_module(det.cfg, det.model, det.anchors, det.level_counts).eval()
        example = export_model.example_inputs(1, det.input_size, "cpu")
        program = export_model.export(module, example)
        assert any("batched_nms" in str(n.target) for n in program.graph.nodes)
        with torch.no_grad():
            eager = module(*example)
        for g, e in zip(program.module()(*example), eager):
            assert torch.equal(g, e)


# ------------------------------------------------------------------ get_flops


def test_get_flops_counts(monkeypatch, fast_jax_init):
    """Parameters at full width equal the JAX tool's; FLOPs at narrow width
    equal the analytic sum over the convolutions and lie within 5% of the
    JAX tool's XLA count."""
    jax_cfg = JaxConfig.fromfile(FLAGSHIP)
    shapes = jax.eval_shape(lambda: jax_build_model_and_anchors(jax_cfg)[0].init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)), train=False))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"])) == FLAGSHIP_PARAMS
    out = io.StringIO()
    with redirect_stdout(out):
        full = get_flops.main([FLAGSHIP, "--cpu", "--cfg-options", f"input_size={IMG_HW}"])
    assert full["params"] == FLAGSHIP_PARAMS
    assert f"count: {FLAGSHIP_PARAMS} parameters, {full['flops']} FLOPs" in out.getvalue()

    cfg = Config.fromfile(FLAGSHIP, CPU_NARROW)
    model = build_model_and_anchors(cfg, dtype="float32")[0].eval()
    x = torch.zeros((2, 3) + IMG_HW)
    analytic = []

    def conv_flops(mod, inputs, output):
        n, ci = inputs[0].shape[:2]
        kh, kw = mod.kernel_size
        analytic.append(2 * n * output.shape[2] * output.shape[3] * mod.out_channels * (ci // mod.groups) * kh * kw)

    hooks = [m.register_forward_hook(conv_flops) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    flops = get_flops.count_flops(model, x)
    for hk in hooks:
        hk.remove()
    assert flops == sum(analytic) > 0

    full_size = [o for o in CPU_NARROW if not o.startswith("input_size")]
    with redirect_stdout(io.StringIO()):
        port = get_flops.main([FLAGSHIP, "--device", "cpu", "--cfg-options", *full_size])
    text = run_main(monkeypatch, jax_get_flops, [FLAGSHIP, "--cfg-options", *full_size])
    jax_gflops = float(text.split("flops:")[1].split("GFLOPs")[0])
    assert abs(port["flops"] / 1e9 / jax_gflops - 1) < FLOP_RATIO_BOUND, (port["flops"] / 1e9, jax_gflops)
    assert {"input:", "params:", "flops:"} <= {ln.split()[0] for ln in text.splitlines() if ln.strip()}


# ---------------------------------------------------------------- eval_metric


def test_eval_metric_matches_the_test_cli_and_jax(tmp_path, capsys):
    names = ["a", "b", "c", "d"]
    ann = write_bop_test_set(str(tmp_path), np.random.RandomState(0), [(3, IMG_HW)], names)
    opts = CPU_NARROW + ["data.samples_per_gpu=2"] + [f"data.test.{k}={v!r}" for k, v in (
        ("ann_file", ann), ("img_prefix", osp.join(str(tmp_path), "test") + "/"), ("classes", names),
        ("pipeline.1.img_scale", IMG_HW[::-1]))]
    model = build_model_and_anchors(Config.fromfile(FLAGSHIP, opts), dtype="float32")[0]
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.bbox_head.atss_cls.bias.zero_()  # scores clear score_thr
    ckpt, out = str(tmp_path / "w.pth"), str(tmp_path / "results.pkl")
    torch.save({"state_dict": model.state_dict(), "meta": {}}, ckpt)
    test_cli.main([FLAGSHIP, ckpt, "--device", "cpu", "--eval", "bbox", "--out", out, "--cfg-options", *opts])
    want = json.loads(capsys.readouterr().out)
    got = eval_metric.main([FLAGSHIP, out, "--cfg-options", *opts])
    assert json.loads(capsys.readouterr().out) == got == want
    assert want["bbox_mAP"] >= 0 and "bbox_mAP_50" in want
    classwise = eval_metric.main([FLAGSHIP, out, "--eval-options", "classwise=True", "--cfg-options", *opts])
    assert {f"bbox_AP_{n}" for n in names} <= set(classwise)

    with open(out, "rb") as f:
        results = pickle.load(f)
    assert sum(len(r["boxes"]) for r in results) > 0
    jax_metrics = jax_evaluate_results(jax_build_dataset(JaxConfig.fromfile(FLAGSHIP, opts), "test"), results)
    assert jax_metrics == pytest.approx(want, abs=1e-12)


# ------------------------------------------------------------------ profilers


def test_profilers_on_the_cpu(capsys):
    narrow = ["--cfg-options", *CPU_NARROW]
    infer = profile_infer.main(["--device", "cpu", "--batch", "2", "--iters", "2", "--top", "5", *narrow])
    text = capsys.readouterr().out
    for heading in ("== inference step:", "roofline lower bound:", "-- by module", "-- top 5"):
        assert heading in text
    assert set(infer["by_module"]) == {"backbone/stem", "backbone/layer1", "backbone/layer2", "backbone/layer3",
                                       "backbone/layer4", "neck", "bbox_head", "postprocess", "preprocess"}
    assert sum(m["share"] for m in infer["by_module"].values()) == pytest.approx(1.0, abs=1e-9)
    assert infer["by_module"]["postprocess"]["ms"] > 0 and infer["busy_share"] is None
    assert infer["bound_ms"] == pytest.approx(sum(m["bound_ms"] for m in infer["by_module"].values()))
    with pytest.raises(SystemExit):  # --quant is ported (tests/test_torch_quant.py): its levels are checked
        profile_infer.main(["--device", "cpu", "--quant", "int4"])

    train = profile_train.main(["--device", "cpu", "--batch", "2", "--iters", "2", "--input-size",
                                *map(str, IMG_HW), "--depth", "18"])
    assert json.loads(capsys.readouterr().out) == train
    for key in ("batch", "input_size", "step_ms", "img_per_s", "fwd_ms", "fwd_loss_ms", "bwd_opt_ms",
                "assign_ms", "assign_frac", "step_tflops", "mfu", "peak_tflops", "device"):
        assert key in train
    assert not train["frozen_int8"] and train["int8_launches_per_step"] == 0
    assert train["mfu"] == pytest.approx(train["step_tflops"] / (train["step_ms"] / 1e3) / train["peak_tflops"],
                                         rel=1e-12)
    with pytest.raises(AssertionError, match="frozen_int8"):  # a BasicBlock trunk has no int8_stream path
        profile_train.main(["--device", "cpu", "--frozen-int8", "--depth", "18"])

    for pipeline, modes in (("train", ["thread", "process"]), ("test", ["thread"])):
        summary = profile_pipeline.main(["--pipeline", pipeline, "--samples", "8", "--workers", "1", "--batch",
                                         "2", "--mode", *modes, "--input-size", *map(str, IMG_HW)])
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last) == summary
        assert set(summary["loader_scaling"]) == {f"{m}x1" for m in modes}
        assert summary["cores_needed"] == pytest.approx(summary["target_img_s"] / summary["single_core_img_s"])
        assert summary["target_img_s"] == profile_pipeline.TARGET_IMG_S[pipeline]


@pytest.mark.parametrize("tool, argv", [
    (get_flops, [FLAGSHIP]),
    (export_model, [FLAGSHIP, "unused.pt2"]),
    (profile_infer, []),
    (profile_train, []),
])
def test_tools_run_on_the_card_by_default(tool, argv, monkeypatch):
    """Without ``--device cpu`` (or ``--cpu``) a tool asks for the card,
    and without one it raises; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


# ------------------------------------------------------------------ operators


def _candidates(b=2, k=48, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, k, 2).astype(np.float32) * 60
    wh = rng.rand(b, k, 2).astype(np.float32) * 30 + 5
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return (torch.from_numpy(np.concatenate([xy, xy + wh], -1)), torch.from_numpy(scores),
            torch.from_numpy(rng.rand(b, k).astype(np.float32)), torch.from_numpy(rng.randint(0, 3, (b, k), np.int32)),
            torch.from_numpy(rng.rand(b, k) < 0.9))


@pytest.mark.parametrize("op", ["vote_nms", "batched_nms"])
def test_nms_operators(op):
    """Both custom operators pass ``torch.library.opcheck``; their fake
    outputs have the real ones' shapes and types; the CPU path is the plain
    version and counts no kernel launch."""
    boxes, cluster, vote, labels, valid = _candidates()
    if op == "vote_nms":
        args = (boxes, cluster, vote, labels, valid, 0.5, 20, True, 0.025, False)
        plain = vote_nms_plain(boxes, cluster, vote, labels, valid, iou_threshold=0.5, max_out=20,
                               iou_enable=True)
    else:
        args = (boxes, cluster, labels, valid, 0.5, 20)
        plain = batched_nms_plain(boxes, cluster, labels, valid, iou_threshold=0.5, max_out=20)
    overload = getattr(torch.ops.radet_tpu_torch, op).default
    report = torch.library.opcheck(overload, args)
    assert set(report.values()) == {"SUCCESS"}, report
    launches = (vote_nms_cuda.LAUNCHES, vote_nms_cuda.NMS_LAUNCHES)
    real = overload(*args)
    assert (vote_nms_cuda.LAUNCHES, vote_nms_cuda.NMS_LAUNCHES) == launches
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = overload(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    for r, f, p in zip(real, fake, plain):
        assert r.shape == f.shape == p.shape and r.dtype == f.dtype == p.dtype
        assert torch.equal(r, p)
