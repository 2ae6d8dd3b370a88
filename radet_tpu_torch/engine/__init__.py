from .convert import state_dict_from_flax
from .infer_step import build_infer_step

__all__ = ["build_infer_step", "state_dict_from_flax"]
