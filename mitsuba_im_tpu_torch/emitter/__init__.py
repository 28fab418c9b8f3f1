"""Emitter record factories (``mitsuba_im_tpu/emitter/__init__.py``),
taking keyword arguments where the reference reads a ``Properties`` bag.

Each returns the host record that ``SceneBuilder.add_emitter`` takes
(``sunsky`` returns two).  An ``area`` record is attached to a shape by the
builder (``SceneBuilder.attach_area_emitter``), which adds the shape's
kind, row and surface area.  The sun's direction is ``sun_direction`` when
given, else the solar position at the given date, time and place (the
JAX package's defaults: 15:00 on 10 July 2010 in Tokyo), turned by
``to_world``.  ``envmap`` records come from pixel arrays
(``table.envmap_record``); loading image files is not ported.
"""
from __future__ import annotations

import numpy as np

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
