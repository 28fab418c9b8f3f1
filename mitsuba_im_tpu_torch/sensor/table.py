"""Sensors (``mitsuba_im_tpu/sensor/table.py``): perspective, thinlens,
orthographic, telecentric, spherical, radiancemeter and irradiancemeter.

A sensor is a dataclass of float32 tensors plus a static type;
:func:`sample_ray_v` maps film-plane uv in [0,1)^2 (and an aperture
sample) to world-space primary rays over the flat wavefront.  Light-tracing
connections (``connect``) come with the particle tracer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Float, host_tensor
from ..core import v3 as v
from ..core.v3 import V3, PI
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
    to_camera: torch.Tensor  # (4, 4) world -> camera
    tan_x: torch.Tensor  # () tan(fov_x / 2)
    tan_y: torch.Tensor  # ()
    near: torch.Tensor
    far: torch.Tensor
    aperture_radius: torch.Tensor
    focus_distance: torch.Tensor
    scale_x: torch.Tensor  # orthographic half-extents
    scale_y: torch.Tensor
    shutter_open: torch.Tensor
    shutter_time: torch.Tensor
    type: int = S_PERSPECTIVE


SENSOR_LEAVES = tuple(f.name for f in dataclasses.fields(Sensor)
                      if f.name != "type")


def make_sensor(stype: int, to_world: Transform, fov_deg: float = 45.0,
                fov_axis: str = "x", aspect: float = 1.0,
                near: float = 1e-2, far: float = 1e4,
                aperture_radius: float = 0.0, focus_distance: float = 1.0,
                scale_x: float = 1.0, scale_y: float = 1.0,
                shutter_open: float = 0.0, shutter_time: float = 0.0,
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
    vals = dict(to_world=to_world.m, to_camera=to_world.inv, tan_x=tan_x,
                tan_y=tan_y, near=near, far=far,
                aperture_radius=aperture_radius,
                focus_distance=focus_distance, scale_x=scale_x,
                scale_y=scale_y, shutter_open=shutter_open,
                shutter_time=shutter_time)
    return Sensor(**{k: host_tensor(vals[k], np.float32, device)
                     for k in SENSOR_LEAVES}, type=stype)


def _lens(sensor: Sensor, u_lens_a, u_lens_b):
    """Aperture offset on the lens disk (concentric map times the radius)."""
    px, py = v.square_to_uniform_disk_concentric(u_lens_a, u_lens_b)
    return px * sensor.aperture_radius, py * sensor.aperture_radius


def sample_ray_v(sensor: Sensor, uv_u, uv_v, u_lens_a, u_lens_b):
    """Flat (N,) film/aperture coordinates -> (o: V3, d: V3, weight).

    Film-to-camera mapping of the reference perspective.cpp: u=0 maps to
    camera +x (the lookAt "left" vector), v=0 to camera +y.  The pinhole,
    spherical and meter sensors ignore the aperture sample; the weight is 1
    for every sensor, as in the reference."""
    x = (1.0 - 2.0 * uv_u) * sensor.tan_x
    y = (1.0 - 2.0 * uv_v) * sensor.tan_y
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    o_cam = v.zeros(x.shape, x.device)

    if sensor.type == S_PERSPECTIVE:
        d_cam = V3(x, y, ones).normalized()
    elif sensor.type == S_THINLENS:
        fd = sensor.focus_distance
        p_focus = V3(x * fd, y * fd, fd.expand(x.shape))
        ax, ay = _lens(sensor, u_lens_a, u_lens_b)
        o_cam = V3(ax, ay, zeros)
        d_cam = (p_focus - o_cam).normalized()
    elif sensor.type in (S_ORTHOGRAPHIC, S_TELECENTRIC):
        o_cam = V3((1.0 - 2.0 * uv_u) * sensor.scale_x,
                   (1.0 - 2.0 * uv_v) * sensor.scale_y, zeros)
        if sensor.type == S_TELECENTRIC:
            ax, ay = _lens(sensor, u_lens_a, u_lens_b)
            o_cam = o_cam + V3(ax, ay, zeros)
        d_cam = V3(zeros, zeros, ones)
    elif sensor.type == S_SPHERICAL:
        phi = (1.0 - 2.0 * uv_u) * PI
        theta = uv_v * PI
        st, ct = torch.sin(theta), torch.cos(theta)
        d_cam = V3(st * torch.sin(phi), ct, -st * torch.cos(phi))
    elif sensor.type == S_IRRADIANCEMETER:
        d_cam = v.square_to_cosine_hemisphere(uv_u, uv_v)
    elif sensor.type == S_RADIANCEMETER:
        d_cam = V3(zeros, zeros, ones)
    else:
        raise ValueError(f"unknown sensor type {sensor.type}")

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


def connect_v(sensor: Sensor, p: V3):
    """Project world points onto the film (``mitsuba_im_tpu/sensor/
    table.py::connect``, :192): (u, v in [0, 1), the camera's world
    position, distance, the pinhole's image-plane importance
    1 / (4 tan_x tan_y cos^3 theta), valid).  Pinhole projection (the
    perspective sensor, a thin lens of zero aperture)."""
    m = sensor.to_camera
    pc = [m[k, 0] * p.x + m[k, 1] * p.y + m[k, 2] * p.z + m[k, 3]
          for k in range(3)]
    z = pc[2]
    valid = z > sensor.near
    zs = torch.where(valid, z, 1.0)
    u = 0.5 * (1.0 - pc[0] / zs / sensor.tan_x)
    w = 0.5 * (1.0 - pc[1] / zs / sensor.tan_y)
    valid = valid & (u >= 0) & (u < 1) & (w >= 0) & (w < 1)
    cw = sensor.to_world[:3, 3]
    cam = V3(*(cw[k].expand(z.shape) for k in range(3)))
    delta = p - cam
    dist = torch.sqrt(torch.clamp_min(delta.dot(delta), 1e-20))
    cos_theta = z / torch.clamp_min(dist, 1e-12)
    a_img = 4.0 * sensor.tan_x * sensor.tan_y
    importance = 1.0 / torch.clamp_min(a_img * cos_theta ** 3, 1e-12)
    return u, w, cam, dist, importance, valid
