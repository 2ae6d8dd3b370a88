from .config import Config, apply_overrides, load_config, merge_dict
from .logging import get_root_logger

__all__ = ["Config", "apply_overrides", "get_root_logger", "load_config", "merge_dict"]
