"""Registry for further light types (counterpart of
core_tpu/lights/extra.py; the reference's plugin registry,
environment.cc:119-135): a light class registered with the module of its
functions is dispatched like the built-in types."""
from __future__ import annotations

_REGISTRY: dict[type, object] = {}


def register(cls, module):
    _REGISTRY[cls] = module


def module_for(light):
    for cls, mod in _REGISTRY.items():
        if isinstance(light, cls):
            return mod
    raise NotImplementedError(
        f"light type {type(light).__name__} is not ported to core_tpu_torch "
        "and not registered (lights.extra.register)")
