"""Typed key/value plugin configuration with query introspection
(``mitsuba_im_tpu/core/properties.py``, copied: the port imports nothing of
the JAX package).

A plugin factory reads its parameters from a :class:`Properties` bag
through the typed getters, which record every query and, when recording is
on, the default used; nested plugins arrive in ``children``.  Transforms
are the port's :class:`~.transform.Transform`.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from .transform import Transform


class Properties:
    TYPES = (
        "boolean",
        "integer",
        "float",
        "point",
        "vector",
        "transform",
        "animatedtransform",
        "spectrum",
        "string",
        "data",
    )

    def __init__(self, plugin_name: str = "", values: dict[str, Any] | None = None):
        self.plugin_name = plugin_name
        self.id = ""
        self._values: dict[str, Any] = dict(values or {})
        self._queried: set[str] = set()
        # query-recording support (fork feature)
        self._record = False
        self._recorded: dict[str, Any] = {}  # name -> default used
        # named child objects (nested plugins: bsdf under shape, etc.)
        self.children: dict[str, Any] = {}

    # -- storage -----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._values

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    def __setitem__(self, name, value):
        self.set(name, value)

    def keys(self):
        return list(self._values.keys())

    def raw(self, name):
        return self._values[name]

    # -- typed getters (record queries + defaults like the fork) -----------
    def _get(self, name: str, default, caster):
        self._queried.add(name)
        if self._record and name not in self._values:
            self._recorded[name] = default
        if name in self._values:
            return caster(self._values[name])
        if default is _REQUIRED:
            raise KeyError(
                f"Property '{name}' missing for plugin '{self.plugin_name}'"
            )
        return default

    def get_bool(self, name, default=None):
        return self._get(name, _req(default), _to_bool)

    def get_int(self, name, default=None):
        return self._get(name, _req(default), lambda v: int(_num(v)))

    def get_float(self, name, default=None):
        return self._get(name, _req(default), lambda v: float(_num(v)))

    def get_string(self, name, default=None):
        return self._get(name, _req(default), str)

    def get_point(self, name, default=None):
        return self._get(name, _req(default), _to_vec3)

    def get_vector(self, name, default=None):
        return self._get(name, _req(default), _to_vec3)

    def get_transform(self, name, default=None):
        if default is None:
            default = Transform()
        return self._get(name, default, _to_transform)

    def get_spectrum(self, name, default=None):
        return self._get(name, _req(default), _to_rgb)

    # -- introspection (configurator analog) --------------------------------
    def record_queries_and_defaults(self, enable: bool = True):
        self._record = enable
        if enable:
            self._recorded = {}
        return self

    @property
    def recorded_defaults(self) -> dict[str, Any]:
        """Names and defaults of every property queried but not set."""
        return dict(self._recorded)

    @property
    def queried(self) -> set[str]:
        return set(self._queried)

    def unqueried(self) -> list[str]:
        return [k for k in self._values if k not in self._queried]

    def merge(self, other: "Properties") -> "Properties":
        """Overlay other's explicitly-set values (fork properties.h:246)."""
        out = Properties(self.plugin_name, self._values)
        out.children = dict(self.children)
        for k in other._values:
            out._values[k] = other._values[k]
        for k, v in other.children.items():
            out.children[k] = v
        return out

    def diff(self, defaults: dict[str, Any]) -> dict[str, Any]:
        """Minimal change set vs defaults (configurator.cpp:184-190)."""
        out = {}
        for k, v in self._values.items():
            if k not in defaults or not _val_eq(defaults[k], v):
                out[k] = v
        return out

    def copy(self) -> "Properties":
        p = Properties(self.plugin_name, self._values)
        p.children = dict(self.children)
        p.id = self.id
        return p

    def __repr__(self):
        return f"Properties({self.plugin_name!r}, {self._values!r}, children={list(self.children)})"


class _Required:
    pass


_REQUIRED = _Required()


def _req(default):
    return _REQUIRED if default is None else default


def _to_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes")
    return bool(v)


def _num(v):
    if isinstance(v, str):
        return float(v)
    return v


def _to_vec3(v):
    a = np.asarray(v, dtype=np.float64)
    if a.ndim == 0:
        a = np.full(3, float(a))
    return a.reshape(3)


def _to_rgb(v):
    if isinstance(v, (int, float)):
        return np.full(3, float(v))
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        return np.full(3, a[0])
    return a[:3]


def _to_transform(v):
    if isinstance(v, Transform):
        return v
    return Transform(np.asarray(v, np.float64).reshape(4, 4))


def _val_eq(a, b):
    try:
        if isinstance(a, Transform) or isinstance(b, Transform):
            return isinstance(a, Transform) and isinstance(b, Transform) and np.allclose(a.m, b.m)
        return bool(np.all(np.asarray(a) == np.asarray(b)))
    except Exception:
        return a == b
