"""Optimizer, LR schedules and gradient clipping (port of
``radet_tpu/engine/optim.py``).

The recipe of the reference runtime config: AdamW (lr 4e-4, betas
(0.9, 0.999), weight decay 0.05, eps 1e-8), a linear OneCycle schedule, and
the whole gradient clipped to L2 norm 35 before the update.  Types: AdamW
(decoupled decay), Adam and SGD (torch's coupled L2, which is what the JAX
package chains in front of them); ``paramwise_cfg.custom_keys`` become
param groups (mmcv's longest-key-first substring match on the dotted
parameter name) with their own lr and decay multipliers.

Frozen backbone stages are ``requires_grad=False`` in the model, and only
trainable parameters enter the optimizer, so frozen ones get neither an
update nor weight decay (the JAX package masks them with
``optax.set_to_zero``).

The schedule is read at the optimizer's step count before the update, as
optax does: step 0's update uses ``schedule(0)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

_RMSPROP = "ROADMAP.md Queue 1 item 16, RMSprop"


def onecycle_linear(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.05,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """OneCycle with linear anneal (torch's OneCycleLR formula), held at the
    final lr past ``total_steps`` instead of raising."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up = max(1.0, float(total_steps) * pct_start - 1.0)
    down = max(1.0, float(total_steps) - 1.0 - up)

    def schedule(step: int) -> float:
        s = float(step)
        if s <= up:
            return initial + (max_lr - initial) * (s / up)
        return max(max_lr + (final - max_lr) * ((s - up) / down), final)

    return schedule


def step_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_iters: int = 0,
    warmup_ratio: float = 1.0 / 3.0,
    warmup: str = "linear",
) -> Callable[[int], float]:
    """mmcv StepLrUpdaterHook by iteration, with a 'linear', 'constant' or
    'exp' warmup."""
    if warmup not in ("linear", "constant", "exp"):
        raise ValueError(f"unsupported warmup type {warmup!r} (linear/constant/exp)")
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        s = float(step)
        lr = base_lr * gamma ** sum(s >= m for m in ms)
        if warmup_iters > 0 and s < warmup_iters:
            frac = s / warmup_iters
            if warmup == "constant":
                factor = warmup_ratio
            elif warmup == "exp":
                factor = warmup_ratio ** (1.0 - frac)
            else:
                factor = 1.0 - (1.0 - warmup_ratio) * (1.0 - frac)
            lr = lr * factor
        return lr

    return schedule


def build_lr_schedule(lr_cfg: Dict, base_lr: float) -> Callable[[int], float]:
    policy = str(lr_cfg.get("policy", "onecycle")).lower()
    if policy == "onecycle":
        return onecycle_linear(
            max_lr=float(lr_cfg.get("max_lr", base_lr)),
            total_steps=int(lr_cfg.get("total_steps", 100100)),
            pct_start=float(lr_cfg.get("pct_start", 0.05)),
            div_factor=float(lr_cfg.get("div_factor", 25.0)),
            final_div_factor=float(lr_cfg.get("final_div_factor", 1e4)),
        )
    if policy == "step":
        return step_lr(
            base_lr,
            lr_cfg.get("step", []),
            gamma=float(lr_cfg.get("gamma", 0.1)),
            warmup_iters=int(lr_cfg.get("warmup_iters", 0)) if lr_cfg.get("warmup") else 0,
            warmup_ratio=float(lr_cfg.get("warmup_ratio", 1.0 / 3.0)),
            warmup=str(lr_cfg.get("warmup") or "linear"),
        )
    if policy in ("fixed", "constant"):
        return lambda step: base_lr
    raise ValueError(f"unsupported lr policy {policy!r} (onecycle/step/fixed)")


class ScheduledLR(torch.optim.lr_scheduler.LRScheduler):
    """Sets each param group's lr to ``schedule(step) * lr_mult``."""

    def __init__(self, optimizer, schedule: Callable[[int], float], lr_mults: Sequence[float]):
        self.schedule = schedule
        self.lr_mults = list(lr_mults)
        super().__init__(optimizer)

    def get_lr(self) -> List[float]:
        lr = self.schedule(self.last_epoch)
        return [lr * m for m in self.lr_mults]

    def state_dict(self) -> Dict:
        return {"last_epoch": self.last_epoch, "_step_count": self._step_count}

    def load_state_dict(self, state_dict: Dict) -> None:
        self.last_epoch = int(state_dict["last_epoch"])
        self._step_count = int(state_dict["_step_count"])
        lrs = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self._last_lr = lrs


class ClippedOptimizer:
    """The port of the JAX package's optax chain: global-norm clip, the
    optimizer's update, then the schedule's next step.

    :meth:`step` returns the pre-clip gradient norm (the ``grad_norm``
    metric) as a device tensor; nothing in it waits for the device."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler: ScheduledLR, max_norm=None):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.max_norm = max_norm
        self.params = [p for g in optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        if self.max_norm:
            norm = torch.nn.utils.clip_grad_norm_(self.params, self.max_norm)
        else:
            norm = torch.nn.utils.get_total_norm([p.grad for p in self.params if p.grad is not None])
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def _param_groups(model: torch.nn.Module, custom_keys: Dict[str, Dict]):
    """Trainable parameters grouped by the longest custom key contained in
    their dotted name: [(key or '__default__', params)] of the non-empty
    groups."""
    ordered = sorted(custom_keys, key=len, reverse=True)
    groups: Dict[str, list] = {"__default__": []}
    for key in ordered:
        groups[key] = []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        key = next((k for k in ordered if k in name), "__default__")
        groups[key].append(p)
    return [(k, ps) for k, ps in groups.items() if ps]


def build_optimizer(
    optimizer_cfg: Dict,
    lr_cfg: Dict,
    grad_clip: Dict | None,
    model: torch.nn.Module,
):
    """Returns (ClippedOptimizer, schedule) over ``model``'s trainable
    parameters."""
    cfg = dict(optimizer_cfg)
    otype = str(cfg.get("type", "adamw")).lower()
    base_lr = float(cfg.get("lr", 4e-4))
    weight_decay = float(cfg.get("weight_decay", 0.05 if otype == "adamw" else 0.0))
    schedule = build_lr_schedule(dict(lr_cfg or {}), base_lr)
    paramwise = dict(cfg.get("paramwise_cfg") or {})
    custom_keys = {str(k): dict(v) for k, v in dict(paramwise.get("custom_keys") or {}).items()}

    groups, lr_mults = [], []
    for key, params in _param_groups(model, custom_keys):
        mults = custom_keys.get(key, {})
        lr_mults.append(float(mults.get("lr_mult", 1.0)))
        groups.append(dict(params=params, weight_decay=weight_decay * float(mults.get("decay_mult", 1.0))))

    betas = tuple(float(b) for b in cfg.get("betas", (0.9, 0.999)))
    eps = float(cfg.get("eps", 1e-8))
    if otype == "adamw":
        opt = torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=eps)
    elif otype == "adam":
        opt = torch.optim.Adam(groups, lr=base_lr, betas=betas, eps=eps)
    elif otype == "sgd":
        momentum = float(cfg.get("momentum", 0.0))
        opt = torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                              nesterov=bool(cfg.get("nesterov", False)))
    elif otype == "rmsprop":
        raise NotImplementedError(
            "RMSprop is not ported: optax adds eps inside the square root and torch outside it, "
            f"so it needs its own update ({_RMSPROP})"
        )
    else:
        raise ValueError(f"unsupported optimizer type {otype!r} (AdamW/Adam/SGD/RMSprop)")
    max_norm = float(grad_clip.get("max_norm", 35.0)) if grad_clip else None
    return ClippedOptimizer(opt, ScheduledLR(opt, schedule, lr_mults), max_norm), schedule
