"""Config composition for the port's CLI: YAML groups + dotted overrides.

The port's own copy of what its eval entry point needs from
camliflow_tpu/utils/config.py (same semantics, so both CLIs read the shared
`conf/` tree alike): `Config` is a dict with attribute access, `compose`
merges the base file and the model/testset groups, then the `override:`
block, then `key=value` overrides. PyYAML is imported only when a file or an
override value is parsed.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any


class Config(dict):
    """Dict with attribute access and recursive wrapping."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = value

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, list):
            value = [Config(v) if isinstance(v, dict) else v for v in value]
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, Config):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, Config) else v for v in value]
            else:
                out[key] = value
        return out


def deep_merge(base: Config, update: dict) -> Config:
    """Recursively merge `update` into a copy of `base` (update wins)."""
    out = Config(copy.deepcopy(base.to_dict() if isinstance(base, Config) else base))
    for key, value in update.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _fix_numbers(node: Any) -> Any:
    """YAML 1.1 loads '1e-3' as a string; convert such scalars to float."""
    if isinstance(node, dict):
        return {k: _fix_numbers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_fix_numbers(v) for v in node]
    if isinstance(node, str) and _SCI_FLOAT.match(node):
        return float(node)
    return node


def load_yaml(path: str | Path) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    data.pop("_package_", None)
    return Config(_fix_numbers(data))


def _coerce(text: str) -> Any:
    """YAML-parse a scalar override value ('1'->int, 'true'->bool, ...), with
    a numeric fallback for '1e-3', which YAML 1.1 reads as a string."""
    import yaml

    value = yaml.safe_load(text)
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            return value
    return value


def parse_overrides(cfg: Config, overrides: list[str]) -> Config:
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key=value, got: {item}")
        key, value = item.split("=", 1)
        cfg.set_path(key.strip(), _coerce(value.strip()))
    return cfg


def apply_override_block(cfg: Config) -> Config:
    """Merge an `override:` sub-tree into the root."""
    block = cfg.pop("override", None)
    if block:
        cfg = deep_merge(cfg, block.to_dict() if isinstance(block, Config) else block)
    return cfg


def compose(
    conf_dir: str | Path,
    model: str | None = None,
    testset: str | None = None,
    base: str = "evaluator.yaml",
    overrides: list[str] | None = None,
) -> Config:
    """Base file + model and testset groups + `override:` block + overrides."""
    conf_dir = Path(conf_dir)
    cfg = load_yaml(conf_dir / base)
    for group, name in (("model", model), ("testset", testset)):
        if name is not None:
            cfg = deep_merge(cfg, load_yaml(conf_dir / group / f"{name}.yaml").to_dict())
    cfg = apply_override_block(cfg)
    if overrides:
        cfg = parse_overrides(cfg, overrides)
    return cfg
