from .config import Config, apply_overrides, load_config, merge_dict

__all__ = ["Config", "apply_overrides", "load_config", "merge_dict"]
