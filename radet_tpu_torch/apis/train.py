"""Config-driven training on one device (port of
``radet_tpu/apis/train.py::train_detector``).

The loop is plain Python around :func:`engine.train_step.build_train_step`:
take a batch from the loader over ``cfg.data.train`` (or the ``dataset``
given), stage it on the device, take a step, and every
``log_config.interval`` steps read the metrics (the loop's only wait for
the device), every ``checkpoint_config.interval`` steps write a full
checkpoint, and every ``evaluation.interval`` steps evaluate on
``cfg.data.val`` (COCO bbox metrics; with ``evaluation.save_best`` the best
weights so far go to ``<work_dir>/best_weights.pth``).  The log line gives
the ms per step, img/s and the ms per step spent waiting for the loader.
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess
import time
from typing import Optional

import torch

from ..data.loader import DataLoader
from ..engine.checkpoint import (
    CheckpointManager,
    load_weights,
    resolve_manager_root,
    save_weights,
    write_meta,
)
from ..engine.optim import build_optimizer
from ..engine.train_step import TrainState, batch_to_device, build_train_step, build_train_step_anchor
from ..utils.logging import get_root_logger
from .common import (
    _to_dict,
    anchor_head_spec,
    assignment_cfg_from,
    build_dataset,
    build_infer_for_cfg,
    build_model_and_anchors,
    head_type_from_cfg,
    loss_cfg_from,
    normalizer_from_cfg,
)
from .test import evaluate_results, run_inference


def check_trainable_quant(model_cfg) -> None:
    """int8 is a deploy-time switch: its rounding has no gradient, so a quant
    config trains only with ``qat=True`` (straight-through fake quant)."""
    for part in ("backbone", "bbox_head"):
        pcfg = model_cfg.get(part, {})
        if pcfg.get("quant") and not pcfg.get("qat"):
            raise ValueError(
                f"model.{part}.quant={pcfg.get('quant')!r} without qat=True is a deploy-time "
                "option: train the float config, or set qat=True"
            )


def _merge_pretrained(model, state_dict, logger) -> None:
    """Load the entries of ``state_dict`` whose name and shape the model has;
    report what was used and what was skipped."""
    own = model.state_dict()
    used = {k: v for k, v in state_dict.items() if k in own and own[k].shape == v.shape}
    for k in state_dict:
        if k not in used:
            logger.warning(f"pretrained key skipped: {k}")
    model.load_state_dict(used, strict=False)
    logger.info(f"loaded {len(used)}/{len(own)} tensors from pretrained weights")


def _git_hash() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def train_detector(
    cfg,
    work_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    max_iters: Optional[int] = None,
    seed: Optional[int] = None,
    eval_during_train: bool = True,
    *,
    dataset=None,
    device="cuda",
) -> TrainState:
    """Train the detector of ``cfg`` on ``device`` and return the final state.

    ``dataset``: any indexable source of training sample dicts
    (``data.bop.pack_sample``'s keys), e.g. ``data.InMemoryBOPDataset``;
    by default the ``BOPDataset`` of ``cfg.data.train``, read by
    ``cfg.data.workers_per_gpu`` loader workers in batches of
    ``cfg.data.samples_per_gpu``.  ``resume_from``: 'auto' (this work
    dir's latest checkpoint), a manager root, a step directory, or another
    run's work dir.  Convolutions run in
    ``cfg.compute_dtype`` on a card and in float32 on the CPU.  The periodic
    eval draws no random numbers, so a run with it takes the same steps as
    one without."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to train on the CPU")
    work_dir = work_dir or cfg.get("work_dir", "work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    seed = seed if seed is not None else int(cfg.get("seed", 0))
    logger = get_root_logger(osp.join(work_dir, f"train_{int(time.time())}.log"))
    logger.info(f"torch {torch.__version__}, device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg.dump(osp.join(work_dir, "config.py"))

    check_trainable_quant(cfg.model)
    head_type = head_type_from_cfg(cfg)
    if dataset is None:
        dataset = build_dataset(cfg, "train", test_mode=False)
    model, anchors, ranges, counts = build_model_and_anchors(
        cfg, dtype=None if device.type == "cuda" else "float32"
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    # model.pretrained: backbone or partial weights; load_from: a whole detector
    for source in (cfg.model.get("pretrained"), cfg.get("load_from")):
        if source:
            logger.info(f"loading weights from {source}")
            _merge_pretrained(model, load_weights(source), logger)
    model.to(device).train()

    tx, schedule = build_optimizer(
        _to_dict(cfg.optimizer), _to_dict(cfg.lr_config),
        _to_dict(cfg.grad_clip) if cfg.get("grad_clip") is not None else None, model,
    )
    state = TrainState(model, tx, seed=seed + 1)

    ckpt_cfg = cfg.get("checkpoint_config")
    ckpt = CheckpointManager(
        osp.join(work_dir, "checkpoints"),
        max_to_keep=int(ckpt_cfg.get("max_to_keep", 3)) if ckpt_cfg else 3,
        interval=int(ckpt_cfg.get("interval", 10000)) if ckpt_cfg else 10000,
    )
    if resume_from:
        if resume_from in ("auto", True):
            if ckpt.restore(state) is None:
                logger.warning("resume requested but work_dir has no checkpoint; starting fresh")
        else:
            root, step = resolve_manager_root(str(resume_from))
            if CheckpointManager(root).restore(state, step=step) is None:
                raise FileNotFoundError(f"no checkpoint restorable from {resume_from}")
        if state.step:
            logger.info(f"resumed from step {state.step}")

    img_norm = _to_dict(cfg.img_norm_cfg)
    num_classes = int(cfg.model.bbox_head.num_classes)
    if head_type == "RADetHead":
        train_step = build_train_step(
            model, anchors, ranges, img_norm=img_norm, num_classes=num_classes,
            assignment_cfg=assignment_cfg_from(cfg), normalizer=normalizer_from_cfg(cfg),
            loss_cfg=loss_cfg_from(cfg),
        )
    else:  # ATSSHead, AnchorHead: IoU assignment inside the step, no distance maps
        train_step = build_train_step_anchor(model, anchors, counts, img_norm=img_norm,
                                             num_classes=num_classes, spec=anchor_head_spec(cfg))
    classes = list(getattr(dataset, "CLASSES", None) or cfg.data.train.get("classes") or ())
    logger.info(f"train dataset: {len(dataset)} samples, {len(classes)} classes")
    write_meta(ckpt.directory, dict(classes=classes, git_hash=_git_hash()))

    batch_size = int(cfg.data.get("samples_per_gpu", 16))
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=bool(cfg.data.get("shuffle", True)),
        num_workers=int(cfg.data.get("workers_per_gpu", 8)),
        seed=seed,
        infinite=True,
        worker_mode=str(cfg.data.get("worker_mode", "thread")),
    )
    total_iters = max_iters if max_iters is not None else int(cfg.runner.get("max_iters", 100000))
    log_cfg = cfg.get("log_config")
    log_interval = int(log_cfg.get("interval", 50)) if log_cfg else 50
    eval_cfg = cfg.get("evaluation")
    eval_interval = int(eval_cfg.get("interval", 10000)) if eval_cfg else 0
    save_best = str(eval_cfg.get("save_best") or "") if eval_cfg else ""
    # COCO-protocol metrics are bbox_-prefixed; a dataset's own protocol
    # (VOC's mAP, AP50) names them bare: the bare name is the fallback
    best_key = save_best if save_best.startswith("bbox_") else f"bbox_{save_best}"
    best_score = float("-inf")
    eval_cache: dict = {}  # the val dataset and inference step, built once

    last_saved = -1
    it = iter(loader)
    t_log = time.time()
    data_wait = 0.0  # seconds spent in next(it) since the last log line
    try:
        for _ in range(state.step, total_iters):
            t_data = time.perf_counter()
            batch = next(it)
            data_wait += time.perf_counter() - t_data
            metrics = train_step(state, batch_to_device(batch, device, train_step.batch_keys))
            step = state.step
            if log_interval and step % log_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_log) / log_interval
                t_log = time.time()
                logger.info(
                    f"iter {step}/{total_iters} lr {schedule(step):.2e} "
                    + " ".join(f"{k} {v:.4f}" for k, v in values.items())
                    + f" | {dt * 1000:.1f} ms/iter ({batch_size / dt:.1f} img/s), data wait "
                    f"{data_wait / log_interval * 1000:.1f} ms/iter"
                )
                data_wait = 0.0
            if ckpt.interval and step % ckpt.interval == 0:
                ckpt.save(step, state, force=True)
                last_saved = step
                logger.info(f"checkpoint saved at step {step}")
            if eval_during_train and eval_interval and step % eval_interval == 0:
                eval_metrics = _run_eval(cfg, model, anchors, counts, logger, eval_cache)
                key = best_key if best_key in (eval_metrics or {}) else save_best
                score = (eval_metrics or {}).get(key)
                if save_best and score is not None and score > best_score:
                    best_score = score
                    path = osp.join(work_dir, "best_weights.pth")
                    save_weights(path, model.state_dict(), meta=dict(CLASSES=classes, step=step, **{key: score}))
                    logger.info(f"new best {key}={score:.4f} at step {step}, saved to {path}")
    except BaseException:
        # keep the last complete step before the error propagates
        if state.step > 0 and state.step != last_saved:
            try:
                ckpt.save(state.step, state, force=True)
                logger.info(f"emergency checkpoint saved at step {state.step}")
            except OSError as err:
                logger.error(f"emergency checkpoint failed: {err}")
        raise
    finally:
        it.close()  # stops the loader's producer thread
    if last_saved != state.step:
        ckpt.save(state.step, state, force=True)
    return state


def _run_eval(cfg, model, anchors, counts, logger, cache):
    """COCO bbox metrics of ``model`` on ``cfg.data.val`` with the config's
    test_cfg, or None (with a warning) when the val data cannot be read.
    The dataset and the inference step are built at the first call and kept
    in ``cache``; ``run_inference`` puts the model in eval mode for the run
    and back in train mode after it."""
    if "dataset" not in cache:
        try:
            cache["dataset"] = build_dataset(cfg, "val")
        except (FileNotFoundError, KeyError) as err:
            logger.warning(f"skipping eval: {err}")
            return None
        cache["infer"] = build_infer_for_cfg(cfg, model, anchors, counts)
    results = run_inference(
        model, cache["dataset"], anchors=anchors, level_counts=counts,
        img_norm=cfg.img_norm_cfg.to_dict(), test_cfg=cfg.test_cfg.to_dict(),
        batch_size=int(cfg.data.get("samples_per_gpu", 8)),
        num_workers=int(cfg.data.get("workers_per_gpu", 8)), normalizer=normalizer_from_cfg(cfg),
        infer_step=cache["infer"],
    )
    metrics = evaluate_results(cache["dataset"], results)
    logger.info("eval: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return metrics
