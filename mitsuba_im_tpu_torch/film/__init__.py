"""Film and reconstruction-filter factories
(``mitsuba_im_tpu/film/__init__.py``), taking keyword arguments where the
reference reads a ``Properties`` bag.

A filter factory returns the record ``dict(ftype, radius)`` (``radius``
None for the filter's default); ``hdrfilm`` and ``ldrfilm`` write the
image size and the filter into a ``RenderSettings``.  Tone mapping and
file output are not ported.
"""
from __future__ import annotations

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
            rfilter: dict | None = None):
    """``ldrfilm``: as :func:`hdrfilm` (its tone mapping is not ported)."""
    return hdrfilm(settings, width, height, rfilter)


# the rfilter plugins by name (the keys of ``film.FILTER_NAMES``)
RFILTERS = {"box": box, "tent": tent, "gaussian": gaussian,
            "mitchell": mitchell, "catmullrom": catmullrom,
            "lanczos": lanczos}
