"""Component registry.

Mirrors the reference's mmengine Registry semantics (reference:
opensora/registry.py:7-41) without the mmengine dependency: modules register
under a string ``type`` key and are built from config dicts via
``build_module``. Anything that is not a dict passes through unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: str | None = None):
        def _register(mod: Callable):
            key = name if name is not None else mod.__name__
            if key in self._modules:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._modules[key] = mod
            return mod

        return _register

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"{key!r} is not registered in {self.name}. "
                f"Available: {sorted(self._modules)}"
            )
        return self._modules[key]


MODELS = Registry("models")
DATASETS = Registry("datasets")


def build_module(module: Any, builder: Registry = MODELS, **kwargs) -> Any:
    """Build a module from a config dict with a ``type`` key.

    Matches reference ``build_module`` (opensora/registry.py:7-30): dicts are
    dispatched through the registry, other values pass through.
    """
    if module is None:
        return None
    if isinstance(module, dict):
        cfg = dict(module)
        if "type" not in cfg:
            raise KeyError(f"config dict must contain 'type': {cfg}")
        kind = cfg.pop("type")
        cfg.update(kwargs)
        return builder.get(kind)(**cfg)
    return module
