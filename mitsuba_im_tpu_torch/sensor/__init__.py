"""Sensor factories (``mitsuba_im_tpu/sensor/__init__.py``), taking keyword
arguments where the reference reads a ``Properties`` bag.

Each returns a host (CPU) :class:`~.table.Sensor`; ``SceneBuilder.build``
moves it to the scene's device.  ``settings`` (a ``RenderSettings``), when
given, sets the crop aspect from its width and height, as the reference's
scene context does.
"""
from __future__ import annotations

import numpy as np

from ..core.transform import Transform
from . import table as st


def _common(stype, to_world=None, near_clip=1e-2, far_clip=1e4,
            shutter_open=0.0, shutter_close=0.0, settings=None, **kw):
    aspect = 1.0
    if settings is not None:
        aspect = settings.width / max(settings.height, 1)
    return st.make_sensor(
        stype, to_world if to_world is not None else Transform(),
        near=near_clip, far=far_clip, shutter_open=shutter_open,
        shutter_time=shutter_close - shutter_open, aspect=aspect,
        device="cpu", **kw)


def perspective(to_world=None, fov=None, focal_length=None, fov_axis="x",
                **common) -> st.Sensor:
    """The pinhole; ``focal_length`` (35 mm equivalent, a number or a
    string such as "50mm") sets the field of view when ``fov`` is not
    given, else 45 degrees."""
    if fov is None and focal_length is not None:
        fl = float(str(focal_length).replace("mm", ""))
        fov = float(np.rad2deg(2 * np.arctan(36.0 / (2 * fl))))
    if fov is None:
        fov = 45.0
    return _common(st.S_PERSPECTIVE, to_world, fov_deg=fov,
                   fov_axis=fov_axis, **common)


def perspective_rdist(kc="0, 0", **kw) -> st.Sensor:
    """The pinhole; the radial distortion ``kc`` is ignored, as in the
    reference."""
    return perspective(**kw)


def thinlens(to_world=None, fov=45.0, fov_axis="x", aperture_radius=0.1,
             focus_distance=1.0, **common) -> st.Sensor:
    return _common(st.S_THINLENS, to_world, fov_deg=fov, fov_axis=fov_axis,
                   aperture_radius=aperture_radius,
                   focus_distance=focus_distance, **common)


def _axis_scales(to_world):
    m = (to_world if to_world is not None else Transform()).m
    return (float(np.linalg.norm(m[:3, 0])), float(np.linalg.norm(m[:3, 1])))


def orthographic(to_world=None, **common) -> st.Sensor:
    """Half-extents from the lengths of ``to_world``'s x and y axes."""
    sx, sy = _axis_scales(to_world)
    return _common(st.S_ORTHOGRAPHIC, to_world, scale_x=sx, scale_y=sy,
                   **common)


def telecentric(to_world=None, aperture_radius=0.1, focus_distance=1.0,
                **common) -> st.Sensor:
    sx, sy = _axis_scales(to_world)
    return _common(st.S_TELECENTRIC, to_world, scale_x=sx, scale_y=sy,
                   aperture_radius=aperture_radius,
                   focus_distance=focus_distance, **common)


def spherical(to_world=None, **common) -> st.Sensor:
    return _common(st.S_SPHERICAL, to_world, **common)


def radiancemeter(to_world=None, **common) -> st.Sensor:
    return _common(st.S_RADIANCEMETER, to_world, **common)


def irradiancemeter(to_world=None, **common) -> st.Sensor:
    return _common(st.S_IRRADIANCEMETER, to_world, **common)


def fluencemeter(to_world=None, **common) -> st.Sensor:
    """A radiance meter, as in the reference."""
    return _common(st.S_RADIANCEMETER, to_world, **common)
