"""Scene configurator: plugin parameters found by instantiation, and live
reconfiguration (``mitsuba_im_tpu/interactive/configurator.py``, a copy on
the port's registry; Mitsuba IM's ``configurator.cpp``).

A plugin instantiated with query recording on
(``Properties.record_queries_and_defaults``, Mitsuba IM's
``Properties::recordQueriesAndDefaults``) lists every parameter it reads
and the default it used; edits are diffed against those defaults to a
minimal change set; the dropdowns come from the registry; and integrator,
sampler and film swaps go to a live render through
``RenderActor.update_settings``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..core.properties import Properties
from ..core.registry import available_plugins, create
from ..render.job import RenderSettings


# categories whose factories are safe to dry-instantiate without a scene
# build context (shape/emitter/texture factories register geometry through
# the SceneBuilder and need a live ctx)
_INTROSPECTABLE = ("integrator", "sampler", "rfilter", "film")


def extract_parameters(category: str, name: str) -> dict[str, dict[str, Any]]:
    """Instantiate ``name`` with recording on; return
    {param: {"type": ..., "default": ...}} (configurator.cpp:139-160)."""
    props = Properties(name)
    props.record_queries_and_defaults(True)
    try:
        create(category, props)
    except Exception:
        pass  # partial records are still useful (required params raise)
    out = {}
    for k, v in props.recorded_defaults.items():
        out[k] = {"type": type(v).__name__ if v is not None else "any",
                  "default": v}
    return out


def describe_category(category: str) -> dict[str, dict]:
    """All plugins of a category with their parameter schemas — the
    dropdown-population analog (plugins discoverable without declarations)."""
    out = {}
    for name in available_plugins(category):
        if category in _INTROSPECTABLE:
            out[name] = extract_parameters(category, name)
        else:
            out[name] = {}
    return out


@dataclass
class Changes:
    """Pending plugin swaps staged by a UI (configurator.cpp Changes)."""

    integrator: tuple[str, dict] | None = None
    sampler: tuple[str, dict] | None = None
    rfilter: str | None = None
    spp: int | None = None

    def empty(self) -> bool:
        return (self.integrator is None and self.sampler is None
                and self.rfilter is None and self.spp is None)


class SceneConfigurator:
    """Stage parameter edits and apply them to a live RenderActor.

    Mirrors the imgui configurator flow: ``available()`` fills dropdowns,
    ``stage_*`` records edits, ``diff()`` reduces them to the minimal
    non-default set (the merge analog), ``apply(actor)`` swaps the config
    into the running renderer at the next pass boundary.
    """

    def __init__(self, settings: RenderSettings):
        self.settings = settings
        self.changes = Changes()

    # -- discovery -----------------------------------------------------------
    def available(self, category: str) -> list[str]:
        return available_plugins(category)

    def parameters(self, category: str, name: str) -> dict:
        return extract_parameters(category, name)

    # -- staging -------------------------------------------------------------
    def stage_integrator(self, name: str, **params):
        self.changes.integrator = (name, params)

    def stage_sampler(self, name: str, **params):
        self.changes.sampler = (name, params)

    def stage_rfilter(self, name: str):
        self.changes.rfilter = name

    def stage_spp(self, spp: int):
        self.changes.spp = int(spp)

    def diff(self) -> dict:
        """Minimal change set vs the recorded defaults (merge analog)."""
        out = {}
        if self.changes.integrator is not None:
            name, params = self.changes.integrator
            defaults = extract_parameters("integrator", name)
            minimal = {
                k: v for k, v in params.items()
                if k not in defaults or defaults[k]["default"] != v
            }
            out["integrator"] = {"name": name, **minimal}
        if self.changes.sampler is not None:
            name, params = self.changes.sampler
            out["sampler"] = {"name": name, **params}
        if self.changes.rfilter is not None:
            out["rfilter"] = self.changes.rfilter
        if self.changes.spp is not None:
            out["spp"] = self.changes.spp
        return out

    # -- application ---------------------------------------------------------
    def apply(self, actor=None) -> RenderSettings:
        """Build the new settings; if ``actor`` is given, queue the swap
        (configurator.cpp:291-362 applies integrator/film/sensor live)."""
        import copy

        from ..film.film import FILTER_NAMES, DEFAULT_RADIUS

        s = copy.copy(self.settings)
        if self.changes.integrator is not None:
            name, params = self.changes.integrator
            props = Properties(name)
            for k, v in params.items():
                props.set(k, v)

            class _Ctx:
                pass

            ctx = _Ctx()
            ctx.settings = s
            create("integrator", props, ctx)
        if self.changes.sampler is not None:
            name, params = self.changes.sampler
            s.sampler = name
            if "sampleCount" in params:
                s.spp = int(params["sampleCount"])
        if self.changes.rfilter is not None:
            s.rfilter = FILTER_NAMES[self.changes.rfilter]
            s.rfilter_radius = DEFAULT_RADIUS[s.rfilter]
        if self.changes.spp is not None:
            s.spp = self.changes.spp
        self.settings = s
        self.changes = Changes()
        if actor is not None:
            actor.update_settings(s)
        return s
