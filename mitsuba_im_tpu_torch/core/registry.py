"""Plugin registry (``mitsuba_im_tpu/core/registry.py``): factories
registered under ``(category, name)`` that turn a ``Properties`` bag into a
host-side description (a record, an id, a sensor) for the scene builder.

The port registers every name the JAX package registers (its ``utility``
category, the ``mtsutil`` tools, is not ported), each with its port.
"""
from __future__ import annotations

import logging
import warnings
from typing import Callable

from .properties import Properties

_REGISTRY: dict[str, dict[str, Callable]] = {}

CATEGORIES = (
    "integrator",
    "bsdf",
    "shape",
    "emitter",
    "sensor",
    "sampler",
    "film",
    "rfilter",
    "texture",
    "medium",
    "phase",
    "volume",
    "subsurface",
)

log = logging.getLogger("mitsuba_im_tpu_torch")


def register(category: str, name: str):
    """Decorator: register a plugin factory ``fn(props, ctx=None)``."""

    def deco(fn):
        _REGISTRY.setdefault(category, {})[name] = fn
        return fn

    return deco


def warn_substitution(category: str, what: str) -> None:
    """Say loudly that plugin ``category`` is rendered with the
    approximation ``what``: a ``UserWarning`` and a log line, never a silent
    alias.  (The JAX package's version takes a third argument that its
    callers do not pass, so there the call raises ``TypeError``; ROADMAP
    C11.)"""
    msg = f"plugin substitution: {category}: {what}"
    log.warning(msg)
    warnings.warn(msg, stacklevel=2)


def create(category: str, props: Properties, ctx=None):
    """Instantiate plugin ``props.plugin_name`` of ``category``; ``ctx`` is
    the ``SceneBuilder`` during scene loading."""
    _ensure_loaded()
    cat = _REGISTRY.get(category, {})
    name = props.plugin_name
    if name not in cat:
        raise ValueError(
            f"Unknown {category} plugin '{name}'. Available: {sorted(cat)}")
    return cat[name](props, ctx)


def available_plugins(category: str) -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY.get(category, {}).keys())


_loaded = False


def _ensure_loaded():
    """Import the plugin modules once (they register themselves).  None of
    them builds a kernel at import."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    import importlib

    for mod in ("bsdf", "emitter", "sensor", "sampler", "film", "texture",
                "media", "scene.shapes", "integrators", "subsurface"):
        importlib.import_module(f"mitsuba_im_tpu_torch.{mod}")
