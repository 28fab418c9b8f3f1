"""Sensors (``mitsuba_im_tpu/sensor/table.py``): perspective only.

A sensor is a dataclass of float32 tensors plus a static type;
:func:`sample_ray_v` maps film-plane uv in [0,1)^2 to world-space primary
rays over the flat wavefront.  Other sensor types raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Float, host_tensor
from ..core import v3 as v
from ..core.v3 import V3
from ..core.transform import Transform

S_PERSPECTIVE = 0
S_THINLENS = 1
S_ORTHOGRAPHIC = 2
S_SPHERICAL = 3
S_RADIANCEMETER = 4
S_TELECENTRIC = 5
S_IRRADIANCEMETER = 6


@dataclasses.dataclass(frozen=True)
class Sensor:
    to_world: torch.Tensor  # (4, 4) camera -> world
    tan_x: torch.Tensor  # () tan(fov_x / 2)
    tan_y: torch.Tensor  # ()
    type: int = S_PERSPECTIVE


SENSOR_LEAVES = ("to_world", "tan_x", "tan_y")


def make_sensor(stype: int, to_world: Transform, fov_deg: float = 45.0,
                fov_axis: str = "x", aspect: float = 1.0,
                *, device) -> Sensor:
    """aspect = width/height of the crop window."""
    t = np.tan(np.deg2rad(fov_deg) / 2.0)
    if fov_axis == "x":
        tan_x, tan_y = t, t / aspect
    elif fov_axis == "y":
        tan_x, tan_y = t * aspect, t
    elif fov_axis in ("smaller", "larger"):
        pick_x = (aspect >= 1.0) == (fov_axis == "larger")
        tan_x, tan_y = (t, t / aspect) if pick_x else (t * aspect, t)
    else:  # diagonal
        d = np.hypot(aspect, 1.0)
        tan_x, tan_y = t * aspect / d, t / d
    return Sensor(to_world=host_tensor(to_world.m, np.float32, device),
                  tan_x=host_tensor(tan_x, np.float32, device),
                  tan_y=host_tensor(tan_y, np.float32, device), type=stype)


def sample_ray_v(sensor: Sensor, uv_u, uv_v, u_lens_a, u_lens_b):
    """Flat (N,) film/aperture coordinates -> (o: V3, d: V3, weight).

    Film-to-camera mapping of the reference perspective.cpp: u=0 maps to
    camera +x (the lookAt "left" vector), v=0 to camera +y.  The pinhole
    ignores the aperture sample."""
    if sensor.type != S_PERSPECTIVE:
        raise NotImplementedError(
            f"sensor type {sensor.type}: only the perspective sensor is ported")
    x = (1.0 - 2.0 * uv_u) * sensor.tan_x
    y = (1.0 - 2.0 * uv_v) * sensor.tan_y
    d_cam = V3(x, y, torch.ones_like(x)).normalized()
    o_cam = v.zeros(x.shape, x.device)

    tw = sensor.to_world
    o = V3(
        tw[0, 0] * o_cam.x + tw[0, 1] * o_cam.y + tw[0, 2] * o_cam.z + tw[0, 3],
        tw[1, 0] * o_cam.x + tw[1, 1] * o_cam.y + tw[1, 2] * o_cam.z + tw[1, 3],
        tw[2, 0] * o_cam.x + tw[2, 1] * o_cam.y + tw[2, 2] * o_cam.z + tw[2, 3],
    )
    d = V3(
        tw[0, 0] * d_cam.x + tw[0, 1] * d_cam.y + tw[0, 2] * d_cam.z,
        tw[1, 0] * d_cam.x + tw[1, 1] * d_cam.y + tw[1, 2] * d_cam.z,
        tw[2, 0] * d_cam.x + tw[2, 1] * d_cam.y + tw[2, 2] * d_cam.z,
    ).normalized()
    return o, d, torch.ones(x.shape, dtype=Float, device=x.device)
