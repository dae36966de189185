"""Typed parameter maps (counterpart of core_tpu/params.py, copied).

Mirrors the reference's paraMap_t/parameter_t (include/core_api/params.h:
40-129): string/int/bool/float/point/color values with typed getParam
access and defaults.  Python dicts carry the values; this wrapper adds the
reference's get-with-default semantics and point/color coercions.
"""
from __future__ import annotations


class ParamMap(dict):
    """dict with typed getters (reference paraMap_t::getParam)."""

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        if isinstance(v, (tuple, list)):
            return float(v[0])
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_point(self, key: str, default=(0.0, 0.0, 0.0)):
        v = self.get(key, default)
        if isinstance(v, (int, float)):
            return (float(v),) * 3
        return tuple(float(x) for x in tuple(v)[:3])

    def get_color(self, key: str, default=(0.0, 0.0, 0.0)):
        v = self.get(key, default)
        if isinstance(v, (int, float)):
            return (float(v),) * 3
        t = tuple(float(x) for x in v)
        return t[:3] if len(t) >= 3 else t + (0.0,) * (3 - len(t))

    def get_color4(self, key: str, default=(0.0, 0.0, 0.0, 1.0)):
        v = self.get(key, default)
        if isinstance(v, (int, float)):
            return (float(v),) * 3 + (1.0,)
        t = tuple(float(x) for x in v)
        return t + (1.0,) * (4 - len(t)) if len(t) < 4 else t[:4]
