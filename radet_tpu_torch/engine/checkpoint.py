"""Checkpoints with ``torch.save`` (port of ``radet_tpu/engine/checkpoint.py``).

A full checkpoint (``CheckpointManager``) holds what resuming needs to take
the same next step as a run that never stopped: the model's state dict,
the optimizer's and the schedule's state, the step, and the seed and state
of the assignment-noise generator.  Layout: ``<root>/<step>/checkpoint.pth``
with ``meta.json`` in the root.  A weights-only file (``save_weights``)
holds ``{"state_dict", "meta"}``, which ``init_detector`` loads.  Files are
written to a temporary name and renamed, so a crash never leaves half a
checkpoint.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
from typing import Any, Dict, Optional

import torch

FILENAME = "checkpoint.pth"


def _atomic_save(obj, path: str) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, interval: int = 10000):
        self.directory = osp.abspath(directory)
        self.max_to_keep = max_to_keep
        self.interval = interval
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and osp.exists(osp.join(self.directory, d, FILENAME))
        )

    def save(self, step: int, state, force: bool = False) -> bool:
        """Write ``state`` (an ``engine.train_step.TrainState``) at ``step``
        when ``step`` is on the interval or ``force``; keeps the newest
        ``max_to_keep``."""
        if not force and (step % self.interval != 0):
            return False
        payload = dict(
            step=int(state.step),
            model=state.model.state_dict(),
            tx=state.tx.state_dict(),
            seed=state.seed,
            generator=state.generator.get_state(),
        )
        _atomic_save(payload, osp.join(self.directory, str(step), FILENAME))
        for old in self.steps()[: -self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(osp.join(self.directory, str(old)), ignore_errors=True)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state`` in place; returns ``state``, or None when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # loaded on the CPU: the optimizer moves its state to the parameters'
        # device itself and keeps its step counters on the host
        payload = torch.load(osp.join(self.directory, str(step), FILENAME),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.tx.load_state_dict(payload["tx"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])
        state.generator.set_state(payload["generator"])
        return state


def save_weights(path: str, state_dict: Dict[str, torch.Tensor], meta: Dict[str, Any] | None = None):
    """Weights-only checkpoint: ``{"state_dict", "meta"}`` in one ``.pth``
    file (``meta`` e.g. ``{"CLASSES": [...]}``, as in mmdet checkpoints)."""
    _atomic_save({"state_dict": state_dict, "meta": dict(meta or {})}, osp.abspath(path))


def write_meta(path: str, meta: Dict[str, Any]) -> None:
    """Write ``meta.json`` into a checkpoint (or manager-root) directory."""
    with open(osp.join(osp.abspath(path), "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load_meta(path: str) -> Dict[str, Any]:
    """Checkpoint meta if present, looked up in the given directory, its
    parent and grandparent (a step directory's manager root); {} if absent."""
    path = osp.abspath(path)
    for cand in (path, osp.dirname(path), osp.dirname(osp.dirname(path))):
        p = osp.join(cand, "meta.json")
        if osp.exists(p):
            with open(p) as f:
                return json.load(f)
    return {}


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a ``save_weights`` file, a full checkpoint
    file, a manager step directory, or a manager root (its latest step)."""
    path = osp.abspath(path)
    if osp.isdir(path):
        root, step = resolve_manager_root(path)
        step = step if step is not None else CheckpointManager(root).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        path = osp.join(root, str(step), FILENAME)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in payload and "tx" in payload:
        return payload["model"]
    return payload.get("state_dict", payload)


def resolve_manager_root(path: str):
    """Map a user-given resume path to (manager_root, step | None).

    Accepts a manager root, a step directory (<root>/<step>), or a work dir
    holding a 'checkpoints' subdirectory; raises FileNotFoundError otherwise."""
    path = osp.abspath(path)
    if not osp.isdir(path):
        raise FileNotFoundError(f"resume path does not exist: {path}")
    base = osp.basename(path.rstrip("/"))
    if base.isdigit() and osp.isdir(osp.dirname(path)):
        return osp.dirname(path), int(base)
    if any(d.isdigit() for d in os.listdir(path)):
        return path, None
    sub = osp.join(path, "checkpoints")
    if osp.isdir(sub):
        return sub, None
    raise FileNotFoundError(f"no checkpoints found under resume path: {path}")
