"""Hydra-style configuration composition over the port's JSON config tree.

The port's copy of `dexrobot_isaac_tpu/utils/config.py`. The machine the
port runs on has no PyYAML, so the `cfg/` tree is kept as JSON files, each
equal to `yaml.safe_load` of its YAML twin (a test holds them equal). The
composition rules are the JAX package's:

- a top-level `defaults:` list (paths relative to the config dir, composed
  depth-first, `_self_` position respected)
- deep-merging with `_delete_: true` meaning "replace this subtree"
- dotted CLI overrides `a.b.c=value` with YAML-typed scalar values
- `task=Name` / `train=Name` group swaps and the CLI aliases
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

_DEFAULT_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg"
)

ALIASES = {
    "numEnvs": "env.numEnvs",
    "device": "device",
    "seed": "train.seed",
    "test": "train.test",
    "checkpoint": "train.checkpoint",
    "maxIterations": "train.maxIterations",
    "testGamesNum": "train.testGamesNum",
    "reloadInterval": "train.reloadInterval",
    "headless": "env.headless",
    "viewer": "env.viewer",
    "videoRecord": "env.videoRecord",
    "videoStream": "env.videoStream",
    "controlMode": "task.controlMode",
    "episodeLength": "env.episodeLength",
    "experimentName": "train.logging.experimentName",
    "logLevel": "train.logging.logLevel",
}

_GROUPS = ("task", "train", "physics", "base", "experiments")


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge override into base (copy). `_delete_: true` replaces subtrees."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k == "_delete_":
            continue
        if isinstance(v, dict) and v.get("_delete_", False):
            out[k] = copy.deepcopy({kk: x for kk, x in v.items() if kk != "_delete_"})
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _compose_file(rel_path: str, config_dir: str) -> Dict:
    """Load one config file, recursively composing its defaults list."""
    path = os.path.join(config_dir, rel_path + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file not found: {path}")
    with open(path) as f:
        own = json.load(f)
    defaults: List[str] = own.pop("defaults", [])
    merged: Dict = {}
    self_done = False
    base_dir = os.path.dirname(rel_path)
    for entry in defaults:
        if entry == "_self_":
            merged = deep_merge(merged, own)
            self_done = True
            continue
        sub = entry.lstrip("/") if "/" in entry or not base_dir else os.path.join(base_dir, entry)
        merged = deep_merge(merged, _compose_file(sub, config_dir))
    if not self_done:
        merged = deep_merge(merged, own)
    return merged


def set_by_path(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    cur = cfg
    for k in keys[:-1]:
        if k not in cur or not isinstance(cur[k], dict):
            cur[k] = {}
        cur = cur[k]
    cur[keys[-1]] = value


def get_by_path(cfg: Dict, dotted: str, default: Any = None) -> Any:
    cur = cfg
    for k in dotted.split("."):
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


# YAML 1.1 scalars as PyYAML's safe_load resolves them (the subset a CLI
# value can take): bools, null, ints, floats (a float needs a '.'), .inf/.nan
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")


def parse_value(text: str) -> Any:
    """YAML-typed scalar parsing for CLI values; `[...]`/`{...}` as JSON, and
    a flat YAML flow list of scalars (`[a, b, 1.5]`) element by element."""
    t = text.strip()
    if t in _BOOL:
        return _BOOL[t]
    if t in _NULL:
        return None
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t.startswith("-") else float("inf")
    if t in (".nan", ".NaN", ".NAN"):
        return float("nan")
    if t[:1] in "[{":
        try:
            return json.loads(t)
        except json.JSONDecodeError:
            if t[0] == "[" and t[-1] == "]" and not any(c in t[1:-1] for c in "[]{}"):
                inner = t[1:-1].strip()
                return [parse_value(x) for x in inner.split(",")] if inner else []
            return text
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    return t


def load_config(
    overrides: Sequence[str] = (),
    config_name: str = "config",
    config_dir: Optional[str] = None,
) -> Dict:
    """Compose the root config + apply CLI overrides (`task=BlindGrasping`,
    `numEnvs=2048`, `sim.dt=0.01`)."""
    config_dir = config_dir or _DEFAULT_CONFIG_DIR
    cfg = _compose_file(config_name, config_dir)
    dotted = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value: {ov!r}")
        key, _, val = ov.partition("=")
        key = key.strip()
        if key in _GROUPS:
            cfg = deep_merge(cfg, _compose_file(f"{key}/{val.strip()}", config_dir))
        else:
            dotted.append((key, val))
    for key, val in dotted:
        set_by_path(cfg, ALIASES.get(key, key), parse_value(val))
    validate_config(cfg)
    return cfg


_TOP_LEVEL_KEYS = {"device", "sim", "env", "task", "train"}


def validate_config(cfg: Dict) -> None:
    """Fail fast on structurally broken configs and typo'd top-level keys."""
    unknown = sorted(set(cfg) - _TOP_LEVEL_KEYS)
    if unknown:
        raise ValueError(
            f"Unknown top-level config keys {unknown} "
            f"(expected {sorted(_TOP_LEVEL_KEYS)}; typo'd override?)"
        )
    missing = [k for k in ("sim.dt", "env.numEnvs", "task.name") if get_by_path(cfg, k) is None]
    if missing:
        raise ValueError(f"Config missing required keys: {missing}")
    if get_by_path(cfg, "sim.dt") <= 0:
        raise ValueError("sim.dt must be positive")
    if get_by_path(cfg, "env.numEnvs") < 1:
        raise ValueError("env.numEnvs must be >= 1")
