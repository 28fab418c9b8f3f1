"""Compiled scene: every table the wavefront needs, as torch tensors on one
device (``mitsuba_im_tpu/scene/scene.py``).

Scenes above ``BRUTE_FORCE_MAX`` triangles carry their two-level cluster
hierarchy (``clusters``).  Bump mapping, deformable motion, instancing,
participating media and subsurface scattering are not ported; a scene that
needs them raises where it is built (:mod:`.bridge`) or used.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import INVALID, EPSILON
from ..accel import intersect as isect
from ..accel.hierarchy import Hierarchy
from ..bsdf.common import BSDFTable, LaneParams3, resolve_v
from ..emitter.table import EmitterTable
from ..sensor.table import Sensor
from .geometry import Geometry, Hit, Interaction3, compute_interaction_v


@dataclasses.dataclass(frozen=True)
class Scene:
    geom: Geometry
    bsdfs: BSDFTable
    emitters: EmitterTable
    sensor: Sensor
    shape_bsdf: torch.Tensor  # (S,) int32
    shape_emitter: torch.Tensor  # (S,) int32
    clusters: Hierarchy | None = None  # large scenes only

    @property
    def device(self) -> torch.device:
        return self.geom.tri_p0.device

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
        if self.bsdfs.has_bump:
            raise NotImplementedError("bump / normal mapping is not ported yet")
        return compute_interaction_v(self.geom, o, d, hit)

    def bsdf_at_v(self, it: Interaction3) -> LaneParams3:
        sid = torch.where(it.shape == INVALID, 0, it.shape)
        return resolve_v(self.bsdfs, self.shape_bsdf[sid])

    def emitter_at_id(self, shape_id) -> torch.Tensor:
        sid = torch.where(shape_id == INVALID, 0, shape_id)
        return torch.where(shape_id == INVALID, INVALID,
                           self.shape_emitter[sid])
