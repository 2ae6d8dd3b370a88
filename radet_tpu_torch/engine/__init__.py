from .checkpoint import CheckpointManager, load_weights, save_weights
from .convert import state_dict_from_flax
from .infer_step import build_infer_step
from .optim import build_optimizer
from .train_step import TrainState, build_train_step

__all__ = [
    "CheckpointManager",
    "TrainState",
    "build_infer_step",
    "build_optimizer",
    "build_train_step",
    "load_weights",
    "save_weights",
    "state_dict_from_flax",
]
