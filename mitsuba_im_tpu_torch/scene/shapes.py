"""Analytic shapes and the area-emitter attachment
(``mitsuba_im_tpu/scene/shapes.py``: ``_attach_area_emitter``, the
``sphere`` and ``disk`` plugins), taking keyword arguments where the
reference reads a ``Properties`` bag.

The functions work on any builder with the ``SceneBuilder`` interface
(``new_shape``, ``add_sphere``, ``add_disk``, ``add_emitter``,
``shape_emitter``), the JAX package's included, so one description of a
scene fills both.
"""
from __future__ import annotations

import numpy as np

from ..core.transform import Transform
from ..emitter.table import AK_DISK, AK_SPHERE, AK_TRIMESH


def attach_area_emitter(b, record: dict, shape_id: int, kind=AK_TRIMESH,
                        prim: int = 0, surface_area: float = 1.0) -> int:
    """Add the ``area`` emitter ``record`` to the shape ``shape_id`` of
    kind ``kind`` (its sphere or disk row ``prim``, its ``surface_area``);
    returns the emitter id."""
    rec = dict(record, shape=shape_id, area_kind=kind, prim=prim,
               surface_area=surface_area)
    eid = b.add_emitter(rec)
    b.shape_emitter[shape_id] = eid
    return eid


def sphere(b, bsdf_id: int, center=(0.0, 0.0, 0.0), radius: float = 1.0,
           to_world: Transform | None = None,
           emitter: dict | None = None) -> int:
    """A sphere (``to_world`` moves its centre and scales its radius by the
    mean axis scale); with an ``area`` record ``emitter`` it emits.
    Returns the shape id."""
    xf = to_world if to_world is not None else Transform()
    center = xf.apply_point(center)
    radius = float(radius * np.linalg.norm(xf.m[:3, :3], axis=0).mean())
    sid = b.new_shape(bsdf_id)
    prim = b.add_sphere(center, radius, sid)
    if emitter is not None:
        attach_area_emitter(b, emitter, sid, AK_SPHERE, prim,
                            4.0 * np.pi * radius * radius)
    return sid


def disk(b, bsdf_id: int, to_world: Transform | None = None,
         flip_normals: bool = False, emitter: dict | None = None) -> int:
    """The unit disk in the xy plane facing +z, placed by ``to_world`` (its
    radius is the length of the transformed x axis); ``flip_normals`` turns
    it to face -z.  With an ``area`` record ``emitter`` it emits from its
    front.  Returns the shape id."""
    xf = to_world if to_world is not None else Transform()
    c = xf.apply_point([0, 0, 0])
    s_axis = xf.apply_vector([1, 0, 0])
    t_axis = xf.apply_vector([0, 1, 0])
    radius = float(np.linalg.norm(s_axis))
    n = np.cross(s_axis, t_axis)
    n /= max(np.linalg.norm(n), 1e-12)
    if flip_normals:
        n = -n
    s_u = s_axis / max(np.linalg.norm(s_axis), 1e-12)
    t_u = np.cross(n, s_u)
    sid = b.new_shape(bsdf_id)
    prim = b.add_disk(c, n, s_u, t_u, radius, sid)
    if emitter is not None:
        attach_area_emitter(b, emitter, sid, AK_DISK, prim,
                            np.pi * radius * radius)
    return sid
