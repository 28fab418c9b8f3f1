"""Film and reconstruction-filter factories
(``mitsuba_im_tpu/film/__init__.py``): the keyword factories, and the
registered plugins that read a ``Properties`` bag and call them.

A filter factory returns the record ``dict(ftype, radius)`` (``radius``
None for the filter's default); ``hdrfilm``, ``ldrfilm`` and ``mfilm``
write the image size, the filter and the output format into a
``RenderSettings``, ``ldrfilm`` its tone mapping too (applied by
``render/job.py::save_render``).  ``tiledhdrfilm`` raises: ``film/tiled.py``
is not ported.
"""
from __future__ import annotations

from ..core.properties import Properties
from ..core.registry import register, register_unported
from .film import (F_BOX, F_CATMULLROM, F_GAUSSIAN, F_LANCZOS, F_MITCHELL,
                   F_TENT)


def box() -> dict:
    return dict(ftype=F_BOX, radius=None)


def tent() -> dict:
    return dict(ftype=F_TENT, radius=None)


def gaussian(stddev: float = 0.5) -> dict:
    """The truncated Gaussian; its radius is 4 ``stddev``."""
    return dict(ftype=F_GAUSSIAN, radius=4.0 * stddev)


def mitchell() -> dict:
    return dict(ftype=F_MITCHELL, radius=None)


def catmullrom() -> dict:
    return dict(ftype=F_CATMULLROM, radius=None)


def lanczos(lobes: int = 3) -> dict:
    """The windowed sinc; its radius is the number of ``lobes``."""
    return dict(ftype=F_LANCZOS, radius=float(int(lobes)))


def hdrfilm(settings, width: int = 768, height: int = 576,
            rfilter: dict | None = None):
    """``hdrfilm``: the image size and, when given, the filter record;
    without one the settings keep theirs (the Gaussian by default)."""
    settings.width = int(width)
    settings.height = int(height)
    if rfilter:
        settings.rfilter = rfilter["ftype"]
        settings.rfilter_radius = rfilter.get("radius")
    return settings


def ldrfilm(settings, width: int = 768, height: int = 576,
            rfilter: dict | None = None, gamma: float = -1.0,
            tonemap: str = "gamma", exposure: float = 0.0,
            key: float = 0.18):
    """``ldrfilm``: as :func:`hdrfilm`, PNG output through the tone mapping
    (``gamma`` <= 0 is sRGB; ``tonemap`` "gamma" or "reinhard")."""
    hdrfilm(settings, width, height, rfilter)
    settings.film_format = "png"
    settings.gamma, settings.tonemap = gamma, tonemap
    settings.exposure, settings.key = exposure, key
    return settings


# the rfilter plugins by name (the keys of ``film.FILTER_NAMES``)
RFILTERS = {"box": box, "tent": tent, "gaussian": gaussian,
            "mitchell": mitchell, "catmullrom": catmullrom,
            "lanczos": lanczos}


# -- the registered plugins ------------------------------------------------

def _apply_film(props: Properties, ctx, fmt):
    if ctx is None:
        return {}
    s = ctx.settings
    hdrfilm(s, props.get_int("width", 768), props.get_int("height", 576),
            props.children.get("rfilter"))
    s.film_format = props.get_string("fileFormat", fmt)
    s.banner = props.get_bool("banner", False)
    return {}


@register("film", "hdrfilm")
def _hdrfilm(props: Properties, ctx=None):
    props.get_string("pixelFormat", "rgb")
    props.get_string("componentFormat", "float16")
    return _apply_film(props, ctx, "openexr")


@register("film", "ldrfilm")
def _ldrfilm(props: Properties, ctx=None):
    out = _apply_film(props, ctx, "png")
    if ctx is not None:
        s = ctx.settings
        s.gamma = props.get_float("gamma", -1.0)
        s.tonemap = props.get_string("tonemapMethod", "gamma")
        s.exposure = props.get_float("exposure", 0.0)
        s.key = props.get_float("key", 0.18)
    return out


@register("film", "mfilm")
def _mfilm(props: Properties, ctx=None):
    out = _apply_film(props, ctx, "matlab")
    if ctx is not None and ctx.settings.film_format in ("matlab",
                                                        "mathematica"):
        ctx.settings.film_format = "numpy"
        ctx.settings.width = props.get_int("width", 1)
        ctx.settings.height = props.get_int("height", 1)
    return out


register_unported("film", ("tiledhdrfilm",),
                  "queue A item 5 (film/tiled.py)")


def _rfilter_plugin(name):
    def make(props: Properties, ctx=None):
        if name == "gaussian":
            return gaussian(props.get_float("stddev", 0.5))
        if name == "lanczos":
            return lanczos(props.get_int("lobes", 3))
        return RFILTERS[name]()

    return make


for _name in RFILTERS:
    register("rfilter", _name)(_rfilter_plugin(_name))
