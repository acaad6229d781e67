"""Python-file configs with ``_base_`` inheritance and CLI overrides.

The port's own copy of opensora_tpu/utils/config.py; it reads the same
``configs/**/*.py`` files:

- a config is a plain Python file; every module-level non-dunder name is an
  entry;
- a ``_base_`` entry (str or list, relative to the file) loads first and is
  deep-merged under the file's entries; ``_delete_: True`` in a dict replaces
  the base dict instead of merging;
- CLI overrides use dotted paths (``--a.b.c value``), typed after the value
  they replace; alias flags (``--num-steps``, ...) map into
  ``sampling_option``.

Unlike the JAX package there is no ``AE_SPATIAL_COMPRESSION`` environment
side channel: :func:`ae_spatial_compression` reads the config, and callers
pass the value on explicitly.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys
import types
from typing import Any, Dict, List, Optional

DEFAULT_AE_SPATIAL_COMPRESSION = 16


class Config(dict):
    """A dict with attribute access."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def _unwrap(o):
            if isinstance(o, dict):
                return {k: _unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [_unwrap(v) for v in o]
            return o

        return _unwrap(self)


def _exec_config_file(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    spec = importlib.util.spec_from_file_location(f"_osp_torch_config_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # lets a config import its siblings
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)

    def _keep(k: str, v: Any) -> bool:
        if k == "_base_":
            return True
        if k.startswith("__"):
            return False
        return not isinstance(v, (types.ModuleType, types.FunctionType, type))

    return {k: v for k, v in vars(mod).items() if _keep(k, v)}


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``override`` on top of ``base`` honoring ``_delete_``."""
    out = dict(base)
    for key, val in override.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict) and not val.get("_delete_", False):
            out[key] = _merge(out[key], val)
        else:
            if isinstance(val, dict):
                val = {k: v for k, v in val.items() if k != "_delete_"}
            out[key] = val
    return out


def load_config(path: str) -> Config:
    raw = _exec_config_file(path)
    bases = raw.pop("_base_", None)
    cfg: Dict[str, Any] = {}
    if bases is not None:
        if isinstance(bases, str):
            bases = [bases]
        for b in bases:
            bpath = os.path.join(os.path.dirname(os.path.abspath(path)), b)
            cfg = _merge(cfg, load_config(bpath).to_dict())
    return Config.wrap(_merge(cfg, raw))


def _convert_value(s: str, old: Any) -> Any:
    """Type-convert a CLI string against the existing value's type."""
    if isinstance(old, bool):
        if s.lower() in ("true", "1", "yes"):
            return True
        if s.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {s!r}")
    if isinstance(old, int):
        try:
            return int(s)
        except ValueError:
            return float(s)
    if isinstance(old, float):
        return float(s)
    if isinstance(old, (list, tuple, dict)) or old is None:
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            if old is None:
                for caster in (int, float):
                    try:
                        return caster(s)
                    except ValueError:
                        pass
                if s.lower() in ("true", "false"):
                    return s.lower() == "true"
            return s
    return s


def _set_dotted(cfg: Config, dotted: str, raw_val: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = Config()
        node = node[k]
    node[keys[-1]] = _convert_value(raw_val, node.get(keys[-1]))


# alias flags -> sampling_option fields
_ALIASES = {
    "resolution": ("sampling_option", "resolution"),
    "aspect_ratio": ("sampling_option", "aspect_ratio"),
    "num_frames": ("sampling_option", "num_frames"),
    "num_steps": ("sampling_option", "num_steps"),
    "guidance": ("sampling_option", "guidance"),
    "guidance_img": ("sampling_option", "guidance_img"),
    "seed": ("sampling_option", "seed"),
    "flow_shift": ("sampling_option", "flow_shift"),
}


def parse_overrides(cfg: Config, argv: List[str]) -> Config:
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected positional argument {arg!r}")
        key = arg[2:].replace("-", "_") if "." not in arg else arg[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {arg}")
            val = argv[i + 1]
            i += 2
        if key in _ALIASES:
            sect, field = _ALIASES[key]
            if sect not in cfg:
                cfg[sect] = Config()
            cfg[sect][field] = _convert_value(val, cfg[sect].get(field))
        else:
            _set_dotted(cfg, key, val)
    return cfg


def parse_configs(argv: Optional[List[str]] = None) -> Config:
    """Load a config file (first positional arg) and apply CLI overrides."""
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        raise ValueError("usage: <script> CONFIG [--dotted.key value ...]")
    cfg = parse_overrides(load_config(argv[0]), argv[1:])
    cfg["config_path"] = os.path.abspath(argv[0])
    return cfg


def ae_spatial_compression(cfg: Optional[dict] = None) -> int:
    """Pixels per latent token edge (AE stride x patch size): the config's
    ``ae_spatial_compression``, 16 when it has none."""
    d = (cfg or {}).get("ae_spatial_compression")
    return int(d) if d is not None else DEFAULT_AE_SPATIAL_COMPRESSION


def create_experiment_workspace(cfg: Config, output_root: Optional[str] = None) -> str:
    """``<outputs>/<exp_name>`` (a timestamp when the config names none),
    created, with the resolved config written to its config.json."""
    import json
    import time

    root = output_root or cfg.get("outputs", "outputs")
    exp_dir = os.path.join(root, cfg.get("exp_name") or time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=str)
    return exp_dir
