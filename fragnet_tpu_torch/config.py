"""Config system: YAML with ``${key.path}`` interpolation and dotted access —
an OmegaConf-compatible subset, so the reference's experiment YAML schema
(fragnet/exps/*/config.yaml, loaded at train/finetune/finetune_gat2.py:74-78)
works unchanged. PyYAML is imported only when a file is read or written,
so a config built in code (``Config(dict)``) needs no YAML package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config:
    """Attribute/key access wrapper over a nested dict."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, _wrap(v)) for k, v in self._data.items())

    def get(self, key: str, default: Any = None) -> Any:
        cur: Any = self._data
        for part in key.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return _wrap(cur)

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return _wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def to_dict(self) -> Dict[str, Any]:
        import copy

        return copy.deepcopy(self._data)

    def update(self, other) -> None:
        """Deep-merge ``other`` into self (CLI override semantics,
        finetune_gat2.py:78)."""
        src = other.to_dict() if isinstance(other, Config) else dict(other)
        _deep_merge(self._data, src)

    def set_path(self, dotted: str, value: Any) -> None:
        cur = self._data
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _unwrap(value)


def _wrap(v: Any) -> Any:
    return Config(v) if isinstance(v, dict) else v


def _unwrap(v: Any) -> Any:
    return v.to_dict() if isinstance(v, Config) else v


def _deep_merge(dst: Dict, src: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _resolve(node: Any, root: Dict[str, Any]) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        def repl(m):
            cur: Any = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return str(_resolve(cur, root))

        prev = None
        while prev != node and isinstance(node, str) and _INTERP.search(node):
            prev = node
            node = _INTERP.sub(repl, node)
        return node
    return node


def load_config(path: str, resolve: bool = True) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if resolve:
        data = _resolve(data, data)
    return Config(data)


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
