"""Emitter record factories (``mitsuba_im_tpu/emitter/__init__.py``): the
keyword factories, and the registered plugins that read a ``Properties``
bag and call them.

Each returns the host record that ``SceneBuilder.add_emitter`` takes
(``sunsky`` returns two).  An ``area`` record is attached to a shape by the
builder (``SceneBuilder.attach_area_emitter``), which adds the shape's
kind, row and surface area.  The sun's direction is ``sun_direction`` when
given, else the solar position at the given date, time and place (the
JAX package's defaults: 15:00 on 10 July 2010 in Tokyo), turned by
``to_world``.  The keyword ``envmap`` record takes pixel arrays
(``table.envmap_record``); the ``envmap`` plugin loads its ``filename``
through ``io/bitmap.py`` (linear: EXR, RGBE, PFM; 8-bit formats
sRGB-decoded).
"""
from __future__ import annotations

import numpy as np

from ..core.properties import Properties
from ..core.registry import register
from ..core.transform import Transform
from . import hosek
from . import sunsky as ss  # the module; ``sunsky`` below is the factory
from . import table as et


def _rgb(value) -> np.ndarray:
    return np.broadcast_to(np.asarray(value, np.float64), (3,)).copy()


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / max(np.linalg.norm(v), 1e-12)


def _xf(to_world) -> Transform:
    return to_world if to_world is not None else Transform()


def area(radiance=1.0, sampling_weight: float = 1.0) -> dict:
    return dict(type=et.EM_AREA, radiance=_rgb(radiance),
                weight=sampling_weight)


def point(intensity=1.0, position=None, to_world=None,
          sampling_weight: float = 1.0) -> dict:
    """A point light at ``position``, else at ``to_world``'s origin."""
    pos = (np.asarray(position, np.float64) if position is not None
           else _xf(to_world).apply_point([0, 0, 0]))
    return dict(type=et.EM_POINT, intensity=_rgb(intensity), position=pos,
                weight=sampling_weight)


def spot(intensity=1.0, cutoff_angle: float = 20.0, beam_width=None,
         to_world=None, sampling_weight: float = 1.0) -> dict:
    """A spot light at ``to_world``'s origin shining along its +z; the
    falloff begins at ``beam_width`` (3/4 of the cutoff by default)."""
    xf = _xf(to_world)
    beam = cutoff_angle * 3.0 / 4.0 if beam_width is None else beam_width
    return dict(type=et.EM_SPOT, intensity=_rgb(intensity),
                position=xf.apply_point([0, 0, 0]),
                direction=_unit(xf.apply_vector([0, 0, 1])),
                cos_cutoff=np.cos(np.deg2rad(cutoff_angle)),
                cos_falloff=np.cos(np.deg2rad(beam)),
                weight=sampling_weight)


def directional(irradiance=1.0, direction=None, to_world=None,
                sampling_weight: float = 1.0) -> dict:
    """Light travelling along ``direction``, else along ``to_world``'s
    +z."""
    d = (direction if direction is not None
         else _xf(to_world).apply_vector([0, 0, 1]))
    return dict(type=et.EM_DIRECTIONAL, intensity=_rgb(irradiance),
                direction=_unit(d), weight=sampling_weight)


def collimated(power=1.0, to_world=None,
               sampling_weight: float = 1.0) -> dict:
    """A beam from ``to_world``'s origin along its +z."""
    xf = _xf(to_world)
    return dict(type=et.EM_COLLIMATED, intensity=_rgb(power),
                position=xf.apply_point([0, 0, 0]),
                direction=_unit(xf.apply_vector([0, 0, 1])),
                weight=sampling_weight)


def constant(radiance=1.0, sampling_weight: float = 1.0) -> dict:
    return dict(type=et.EM_CONSTANT, radiance=_rgb(radiance),
                weight=sampling_weight)


def sun_direction(sun_direction=None, year: int = 2010, month: int = 7,
                  day: int = 10, hour: float = 15.0, minute: float = 0.0,
                  second: float = 0.0, latitude: float = 35.6894,
                  longitude: float = 139.6917, timezone: float = 9.0,
                  to_world=None) -> np.ndarray:
    """The unit vector toward the sun: ``sun_direction``, or the solar
    position of the date, time and place turned by ``to_world``."""
    if sun_direction is not None:
        return _unit(sun_direction)
    d = ss.sun_direction_from_time(
        year=year, month=month, day=day, hour=hour, minute=minute,
        second=second, latitude=latitude, longitude=longitude,
        timezone=timezone)
    return _unit(_xf(to_world).apply_vector(d))


def sky(sky_model: str = "hosek", resolution: int = 512,
        turbidity: float = 3.0, ground_albedo=0.15, stretch: float = 1.0,
        scale: float = 1.0, extend: bool = True, to_world=None,
        sampling_weight: float = 1.0, **sun_position) -> dict:
    """The analytic sky baked into an ``EM_ENVMAP`` record:
    ``sky_model`` "hosek" (Hosek-Wilkie, ``ground_albedo``'s mean) or
    "preetham"; ``sun_position`` as :func:`sun_direction` takes it."""
    d = sun_direction(to_world=to_world, **sun_position)
    if sky_model == "preetham":
        pixels = ss.preetham_sky_pixels(
            resolution=resolution, sun_dir=d, turbidity=turbidity,
            stretch=stretch, scale=scale, extend=extend)
    else:
        pixels = hosek.hosek_sky_pixels(
            resolution, d, turbidity, float(np.mean(_rgb(ground_albedo))),
            stretch, scale, extend)
    return et.envmap_record(pixels, 1.0, _xf(to_world).m[:3, :3],
                            sampling_weight)


def sun(turbidity: float = 3.0, scale: float = 1.0,
        sun_radius_scale: float = 1.0, to_world=None,
        sampling_weight: float = 1.0, **sun_position) -> dict:
    """The solar disk as a directional delta emitter: its irradiance is the
    extinct disk radiance times the disk's solid angle."""
    d = sun_direction(to_world=to_world, **sun_position)
    rad = ss.sun_radiance_rgb(d, turbidity, scale)
    omega = ss.sun_solid_angle(sun_radius_scale)
    return dict(type=et.EM_DIRECTIONAL, intensity=rad * omega, direction=-d,
                weight=sampling_weight)


def sunsky(sky_model: str = "hosek", resolution: int = 512,
           ground_albedo=0.15, stretch: float = 1.0, extend: bool = True,
           sun_radius_scale: float = 1.0, **shared) -> list[dict]:
    """The compound sun and sky: [the sky record, the sun record]."""
    return [sky(sky_model, resolution, ground_albedo=ground_albedo,
                stretch=stretch, extend=extend, **shared),
            sun(sun_radius_scale=sun_radius_scale, **shared)]


# -- the registered plugins ------------------------------------------------

def _weight(props: Properties) -> float:
    return props.get_float("samplingWeight", 1.0)


@register("emitter", "area")
def _area(props: Properties, ctx=None):
    return area(props.get_spectrum("radiance", np.ones(3)), _weight(props))


@register("emitter", "point")
def _point(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    pos = props.get_point("position", None) if "position" in props else None
    return point(props.get_spectrum("intensity", np.ones(3)), pos, xf,
                 _weight(props))


@register("emitter", "spot")
def _spot(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    cutoff = props.get_float("cutoffAngle", 20.0)
    beam = props.get_float("beamWidth", cutoff * 3.0 / 4.0)
    return spot(props.get_spectrum("intensity", np.ones(3)), cutoff, beam,
                xf, _weight(props))


@register("emitter", "directional")
def _directional(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    d = props.get_vector("direction", None) if "direction" in props else None
    return directional(props.get_spectrum("irradiance", np.ones(3)), d, xf,
                       _weight(props))


@register("emitter", "collimated")
def _collimated(props: Properties, ctx=None):
    xf = props.get_transform("toWorld", Transform())
    return collimated(props.get_spectrum("power", np.ones(3)), xf,
                      _weight(props))


@register("emitter", "constant")
def _constant(props: Properties, ctx=None):
    return constant(props.get_spectrum("radiance", np.ones(3)),
                    _weight(props))


@register("emitter", "envmap")
def _envmap(props: Properties, ctx=None):
    from ..io import bitmap as bmp

    path = props.get_string("filename")
    if ctx is not None:
        path = ctx.resolve_path(path)
    pixels = bmp.load(path)[..., :3]
    xf = props.get_transform("toWorld", Transform())
    return et.envmap_record(pixels, props.get_float("scale", 1.0),
                            xf.m[:3, :3], _weight(props))


def _sun_position(props: Properties) -> dict:
    """:func:`sun_direction`'s keywords from the reference's SunParameters
    properties."""
    if "sunDirection" in props:
        return dict(sun_direction=props.get_vector("sunDirection"))
    return dict(
        year=props.get_int("year", 2010), month=props.get_int("month", 7),
        day=props.get_int("day", 10), hour=props.get_float("hour", 15.0),
        minute=props.get_float("minute", 0.0),
        second=props.get_float("second", 0.0),
        latitude=props.get_float("latitude", 35.6894),
        longitude=props.get_float("longitude", 139.6917),
        timezone=props.get_float("timezone", 9.0))


def _sky_record(props: Properties) -> dict:
    model = props.get_string("skyModel", "hosek")
    kw = dict(resolution=props.get_int("resolution", 512),
              turbidity=props.get_float("turbidity", 3.0),
              stretch=props.get_float("stretch", 1.0),
              scale=props.get_float("scale", 1.0),
              extend=props.get_bool("extend", True))
    if model != "preetham":
        kw["ground_albedo"] = props.get_spectrum("groundAlbedo",
                                                 [0.15, 0.15, 0.15])
    return sky(model, to_world=props.get_transform("toWorld", Transform()),
               sampling_weight=_weight(props), **kw, **_sun_position(props))


def _sun_record(props: Properties) -> dict:
    return sun(props.get_float("turbidity", 3.0),
               props.get_float("scale", 1.0),
               props.get_float("sunRadiusScale", 1.0),
               props.get_transform("toWorld", Transform()), _weight(props),
               **_sun_position(props))


@register("emitter", "sky")
def _sky(props: Properties, ctx=None):
    return _sky_record(props)


@register("emitter", "sun")
def _sun(props: Properties, ctx=None):
    return _sun_record(props)


@register("emitter", "sunsky")
def _sunsky(props: Properties, ctx=None):
    return [_sky_record(props), _sun_record(props)]
