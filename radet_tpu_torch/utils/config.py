"""Python-file config system with ``_base_`` inheritance and dotted overrides.

Port of ``radet_tpu/utils/config.py`` (pure Python, no framework): a config
is a plain python file whose module-level variables become a nested dict.
``_base_`` is a list of relative paths merged depth-first (child wins).  A
dict value containing ``_delete_: True`` replaces the base dict instead of
merging into it.
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
from typing import Any, Dict, Sequence

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


def merge_dict(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``child`` on top of ``base`` (child wins).

    Neither argument is mutated (the ``_delete_`` marker is stripped from the
    RESULT, not from ``child``), so merges are idempotent."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict):
            delete = bool(v.get(DELETE_KEY, False))
            v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            if not delete and isinstance(out.get(k), dict):
                out[k] = merge_dict(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(path: str) -> Dict[str, Any]:
    path = osp.abspath(osp.expanduser(path))
    if not osp.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        src = f.read()
    namespace: Dict[str, Any] = {"__file__": path}
    exec(compile(src, path, "exec"), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def load_config(path: str) -> Dict[str, Any]:
    """Load a python config file, resolving ``_base_`` inheritance."""
    cfg = _exec_config_file(path)
    base_paths = cfg.pop(BASE_KEY, [])
    if isinstance(base_paths, str):
        base_paths = [base_paths]
    merged: Dict[str, Any] = {}
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(path)))
    for bp in base_paths:
        merged = merge_dict(merged, load_config(osp.join(cfg_dir, bp)))
    return merge_dict(merged, cfg)


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_kv_options(pairs: Sequence[str] | None) -> Dict[str, Any]:
    """['k=v', ...] -> dict with literal-eval'd values (the ``--eval-options``
    flag of the test CLI)."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        k, _, v = pair.partition("=")
        out[k] = _parse_value(v)
    return out


def apply_overrides(cfg: Dict[str, Any], options: Sequence[str]) -> Dict[str, Any]:
    """Apply ``key.sub=value`` overrides (deep set; value literal-eval'd).

    Integer path components index into lists, mirroring mmcv's DictAction
    ``a.b.0.c=...`` behaviour.
    """
    cfg = copy.deepcopy(cfg)
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"override must be key=value, got: {opt!r}")
        key, value = opt.split("=", 1)
        parts = key.split(".")
        node: Any = cfg
        for p in parts[:-1]:
            node = node[int(p)] if isinstance(node, list) else node.setdefault(p, {})
        leaf = parts[-1]
        if isinstance(node, list):
            node[int(leaf)] = _parse_value(value)
        else:
            node[leaf] = _parse_value(value)
    return cfg


class Config:
    """Attribute-style view over the nested config dict.

    ``cfg.model.bbox_head.num_classes`` works; missing keys raise
    AttributeError. ``.get()``, ``[]`` and ``.to_dict()`` are provided so
    downstream code can treat it as a mapping when convenient.
    """

    def __init__(self, data: Dict[str, Any], filename: str | None = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "filename", filename)

    @classmethod
    def fromfile(cls, path: str, options: Sequence[str] | None = None) -> "Config":
        cfg = load_config(path)
        if options:
            cfg = apply_overrides(cfg, options)
        return cls(cfg, filename=path)

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            v = data[name]
            return Config(v) if isinstance(v, dict) else v
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        v = self._data[name]
        return Config(v) if isinstance(v, dict) else v

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self):
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        v = self._data.get(name, default)
        return Config(v) if isinstance(v, dict) else v

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, Config(v) if isinstance(v, dict) else v) for k, v in self._data.items())

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def dump(self, path: str) -> None:
        """Write the resolved config as ``key = value`` lines."""
        import pprint

        with open(path, "w") as f:
            for k, v in self._data.items():
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")

    def __repr__(self) -> str:
        import pprint

        return f"Config({pprint.pformat(self._data)})"
