"""Compiled scene: every table the wavefront needs, as torch tensors on one
device (``mitsuba_im_tpu/scene/scene.py``).

Scenes above ``BRUTE_FORCE_MAX`` triangles, and instanced scenes, carry
their two-level cluster hierarchy (``clusters``).  Bump and normal maps
tilt the shading frame of every interaction (:meth:`Scene._perturb_frame_v`).
A scene with deformable shapes carries the frame-1 mirror of its triangle
tables (``motion``); :meth:`Scene.with_time` is the scene at one shutter
time, which a render pass shares across its wavefront.  Participating
media (``media``, a one-row vacuum table without any) are named per shape
(``shape_interior``, ``shape_exterior``) and for the camera
(``camera_medium``), as in the reference.  Subsurface scattering is not
ported; a scene that needs it raises where it is built (:mod:`.bridge`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, EPSILON
from ..accel import intersect as isect
from ..accel.hierarchy import Hierarchy
from ..bsdf.common import (BSDFTable, LaneParams3, resolve_v, BUMP_HEIGHT,
                           BUMP_NORMAL, column_textures)
from ..core import v3 as v
from ..emitter.table import EmitterTable
from ..media.medium import MediumTable
from ..sensor.table import Sensor
from ..texture.texture import TextureTable, eval_texture_v
from .geometry import Geometry, Hit, Interaction3, compute_interaction_v


@dataclasses.dataclass(frozen=True)
class Scene:
    geom: Geometry
    bsdfs: BSDFTable
    textures: TextureTable
    emitters: EmitterTable
    sensor: Sensor
    shape_bsdf: torch.Tensor  # (S,) int32
    shape_emitter: torch.Tensor  # (S,) int32
    media: MediumTable
    shape_interior: torch.Tensor  # (S,) int32 medium ids
    shape_exterior: torch.Tensor  # (S,) int32
    clusters: Hierarchy | None = None  # large scenes only
    # frame-1 triangle tables of deformable shapes (MOTION_KEYS, row for
    # row with geom's), or None
    motion: dict | None = None
    # (shutter_open, shutter_time) of the sensor as float32 values on the
    # host, read once where the scene is built, so that a motion pass's
    # shutter time needs no read from the device
    shutter: tuple = (0.0, 0.0)
    camera_medium: int = INVALID  # the sensor's medium id

    @property
    def device(self) -> torch.device:
        return self.geom.tri_p0.device

    def with_time(self, t) -> "Scene":
        """The scene at shutter time ``t`` (a float32 value): triangle
        positions, edges and the shading rows' edges and normals lerped as
        ``a + (b - a) * t`` (``mitsuba_im_tpu/scene/scene.py:46-76``), and
        a motion hierarchy traversed at ``t``.  A static scene is returned
        as it is."""
        if self.motion is None:
            return self
        t = float(np.float32(t))
        g, m = self.geom, self.motion

        def lerp(a, b):
            return a + (b - a) * t

        shad1 = torch.cat([m["e1"], m["e2"], m["n0"], m["n1"], m["n2"],
                           g.tri_shad[:, 15:]], dim=1)
        geom = dataclasses.replace(
            g, tri_p0=lerp(g.tri_p0, m["p0"]), tri_e1=lerp(g.tri_e1, m["e1"]),
            tri_e2=lerp(g.tri_e2, m["e2"]), tri_shad=lerp(g.tri_shad, shad1))
        clusters = None if self.clusters is None else self.clusters.at_time(t)
        return dataclasses.replace(self, geom=geom, clusters=clusters)

    def ray_intersect_v(self, o, d, tmin=EPSILON, tmax=1e30, active=None,
                        coherent=False) -> Hit:
        """o, d: V3 of flat (N,) components."""
        return isect.intersect_v(self.geom, o, d, tmin, tmax,
                                 clusters=self.clusters, active=active,
                                 coherent=coherent)

    def occluded_v(self, o, d, tmin, tmax, active=None) -> torch.Tensor:
        return isect.occluded_v(self.geom, o, d, tmin, tmax,
                                clusters=self.clusters, active=active)

    def interaction_v(self, o, d, hit: Hit) -> Interaction3:
        it = compute_interaction_v(self.geom, o, d, hit)
        if self.bsdfs.has_bump:
            it = self._perturb_frame_v(it, d)
        return it

    def _perturb_frame_v(self, it: Interaction3, d) -> Interaction3:
        """Bump and normal mapping (``bumpmap.cpp``, ``normalmap.cpp``): tilt
        the shading frame by the row's texture before any BSDF sees it. A
        height map tilts the normal by the one-sided differences of its mean
        channel along u and v (eps 5e-4, times ``bump_scale``; the reference
        calls them central, and computes these); a normal map's rgb is a
        tangent-space normal in [-1, 1]^3. The new normal is flipped into ng's
        hemisphere, and ``ss``, ``ts`` and ``wi_local`` follow it. Textures are
        looked up unfiltered."""
        sid = torch.where(it.shape == INVALID, 0, it.shape)
        bid = v.gather_row(self.shape_bsdf, sid)
        bid = torch.where(bid == INVALID, 0, bid)
        b = self.bsdfs
        bump_tex = v.gather_row(b.bump_tex, bid)
        bump_kind = v.gather_row(b.bump_kind, bid)
        active = (bump_kind > 0) & (bump_tex != INVALID) & it.valid

        tex = column_textures(b, self.textures, "bump_tex")
        c = eval_texture_v(tex, bump_tex, it.uv_u, it.uv_v, None)
        ns = it.ns
        if BUMP_HEIGHT in b.bump_kinds:
            eps = 5e-4
            bump_scale = v.gather_row(b.bump_scale, bid)
            h0 = c.mean()
            hu = eval_texture_v(tex, bump_tex, it.uv_u + eps, it.uv_v,
                                None).mean()
            hv = eval_texture_v(tex, bump_tex, it.uv_u, it.uv_v + eps,
                                None).mean()
            dhdu = (hu - h0) / eps * bump_scale
            dhdv = (hv - h0) / eps * bump_scale
            n_height = (it.ns - it.ss * dhdu - it.ts_ * dhdv).normalized()
            ns = v.where(bump_kind == BUMP_HEIGHT, n_height, ns)
        if BUMP_NORMAL in b.bump_kinds:
            nt = (c * 2.0 - 1.0).normalized()
            n_map = (it.ss * nt.x + it.ts_ * nt.y + it.ns * nt.z).normalized()
            ns = v.where(bump_kind == BUMP_NORMAL, n_map, ns)
        ns = v.where(active, ns, it.ns)
        ns = v.where(ns.dot(it.ng) < 0, -ns, ns)
        ss = (it.ss - ns * ns.dot(it.ss)).normalized()
        ts = ns.cross(ss)
        wi_local = v.to_local((ss, ts, ns), -d)
        return dataclasses.replace(it, ns=ns, ss=ss, ts_=ts,
                                   wi_local=wi_local)

    def bsdf_at_v(self, it: Interaction3, u_sel=None,
                  duv=None) -> LaneParams3:
        """The lanes' BSDF parameters at their uvs; ``u_sel`` picks BLEND
        components and ``duv`` (screen-space uv derivatives) filters
        bitmaps through their MIP pyramids."""
        sid = torch.where(it.shape == INVALID, 0, it.shape)
        return resolve_v(self.bsdfs, self.textures, self.shape_bsdf[sid],
                         it.uv_u, it.uv_v, u_sel, duv)

    def emitter_at_id(self, shape_id) -> torch.Tensor:
        sid = torch.where(shape_id == INVALID, 0, shape_id)
        return torch.where(shape_id == INVALID, INVALID,
                           self.shape_emitter[sid])
