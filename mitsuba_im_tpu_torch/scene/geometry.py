"""Flattened scene geometry and surface interactions
(``mitsuba_im_tpu/scene/geometry.py``).

All triangle meshes are one SoA soup; analytic spheres and disks keep
exact quadric intersections.  Every kind is padded to at least one
unhittable entry, as in the reference.  Under shared-BLAS instancing the
triangle tables hold each group's geometry once, in its local space; a
hit's instance id (``Hit.inst``) picks the rotation ``inst_rot`` that
takes its geometric and shading normals to world space (the reference's
``compute_interaction_v``, ``geometry.py:304-318``), its point is world
space (o + d t).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, host_tensor
from ..core import v3 as v
from ..core.v3 import V3, PI

# Hit kinds
KIND_NONE = 0
KIND_TRI = 1
KIND_SPHERE = 2
KIND_DISK = 3

SHAD_ROW = 24  # 21 used + 3 pad (see Geometry.tri_shad)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Device-resident primitive soup."""

    tri_p0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3)
    tri_e2: torch.Tensor  # (T, 3)
    tri_shape: torch.Tensor  # (T,) int32
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_shape: torch.Tensor  # (S,) int32
    disk_center: torch.Tensor  # (D, 3)
    disk_n: torch.Tensor  # (D, 3)
    disk_s: torch.Tensor  # (D, 3)
    disk_t: torch.Tensor  # (D, 3)
    disk_radius: torch.Tensor  # (D,)
    disk_shape: torch.Tensor  # (D,) int32
    # packed per-triangle shading row [e1 e2 n0 n1 n2 uv0 uv1 uv2 pad]
    # (shading normals and uvs at the three vertices): one row gather per
    # interaction
    tri_shad: torch.Tensor  # (T, SHAD_ROW)
    # per-instance normal rotations of shared-BLAS instancing (row 0 the
    # identity): the inverse transposes of the instances' linear parts
    inst_rot: torch.Tensor  # (I, 3, 3)
    n_tris: int = 0  # real (unpadded) counts
    n_spheres: int = 0
    n_disks: int = 0
    instanced: bool = False  # more than the identity in inst_rot


GEOMETRY_LEAVES = tuple(f.name for f in dataclasses.fields(Geometry)
                        if f.type == "torch.Tensor")


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-lane closest-hit record."""

    t: torch.Tensor
    kind: torch.Tensor  # int32, KIND_*
    prim: torch.Tensor  # int32 index within the kind's table
    shape: torch.Tensor  # int32 shape id (INVALID when miss)
    u: torch.Tensor  # tri: barycentric u
    v: torch.Tensor
    inst: torch.Tensor | None = None  # int32 instance id (instanced scenes)

    @property
    def valid(self) -> torch.Tensor:
        return self.kind > KIND_NONE


@dataclasses.dataclass(frozen=True)
class Interaction3:
    """Component-SoA shading-point record."""

    p: V3
    t: torch.Tensor
    ng: V3
    ns: V3
    ss: V3
    ts_: V3
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    wi_local: V3
    shape: torch.Tensor  # int32
    valid: torch.Tensor  # bool


def pack_shading_rows(e1, e2, n0, n1, n2, uv0, uv1, uv2) -> np.ndarray:
    """(T, SHAD_ROW) packed shading rows from numpy component arrays."""
    pad = np.zeros((e1.shape[0], SHAD_ROW - 21), e1.dtype)
    return np.concatenate([e1, e2, n0, n1, n2, uv0, uv1, uv2, pad], axis=1)


def make_geometry(tri_data: dict | None, spheres: dict | None = None,
                  disks: dict | None = None, *, device,
                  inst_rot: np.ndarray | None = None) -> Geometry:
    """Build a Geometry from host numpy dicts: triangles (keys p0 e1 e2 n0
    n1 n2 uv0 uv1 uv2 shape), spheres (center radius shape) and disks
    (center n s t radius shape).  Every kind is padded to one unhittable
    entry when empty, as in the reference.  ``inst_rot`` (I, 3, 3): the
    instances' normal rotations under shared-BLAS instancing."""
    if tri_data is None or len(tri_data.get("p0", ())) == 0:
        far = 3.0e37
        z = np.zeros((1, 3), np.float32)
        uvz = np.zeros((1, 2), np.float32)
        tri_data = dict(p0=z + far, e1=z, e2=z, n0=z, n1=z, n2=z,
                        uv0=uvz, uv1=uvz, uv2=uvz,
                        shape=np.full(1, INVALID, np.int32))
        n_tris = 0
    else:
        n_tris = len(tri_data["p0"])
    if spheres is None or len(spheres.get("center", ())) == 0:
        spheres = dict(center=np.full((1, 3), 3.0e37, np.float32),
                       radius=np.zeros(1, np.float32),
                       shape=np.full(1, INVALID, np.int32))
        n_spheres = 0
    else:
        n_spheres = len(spheres["center"])
    if disks is None or len(disks.get("center", ())) == 0:
        disks = dict(center=np.full((1, 3), 3.0e37, np.float32),
                     n=np.array([[0, 0, 1]], np.float32),
                     s=np.array([[1, 0, 0]], np.float32),
                     t=np.array([[0, 1, 0]], np.float32),
                     radius=np.zeros(1, np.float32),
                     shape=np.full(1, INVALID, np.int32))
        n_disks = 0
    else:
        n_disks = len(disks["center"])

    def f(x):
        return host_tensor(x, np.float32, device)

    def i(x):
        return host_tensor(x, np.int32, device)

    shad = pack_shading_rows(
        *(np.asarray(tri_data[k], np.float32)
          for k in ("e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")))
    return Geometry(
        tri_p0=f(tri_data["p0"]), tri_e1=f(tri_data["e1"]),
        tri_e2=f(tri_data["e2"]), tri_shape=i(tri_data["shape"]),
        sph_center=f(spheres["center"]), sph_radius=f(spheres["radius"]),
        sph_shape=i(spheres["shape"]),
        disk_center=f(disks["center"]), disk_n=f(disks["n"]),
        disk_s=f(disks["s"]), disk_t=f(disks["t"]),
        disk_radius=f(disks["radius"]), disk_shape=i(disks["shape"]),
        tri_shad=f(shad),
        inst_rot=f(np.eye(3, dtype=np.float32)[None] if inst_rot is None
                   else inst_rot),
        n_tris=n_tris, n_spheres=n_spheres, n_disks=n_disks,
        instanced=inst_rot is not None and len(inst_rot) > 1,
    )


def compute_interaction_v(geom: Geometry, o: V3, d: V3,
                          hit: Hit) -> Interaction3:
    """Expand a Hit into a shading-point record (o, d: V3)."""
    is_tri = hit.kind == KIND_TRI
    is_sph = hit.kind == KIND_SPHERE
    tp = torch.where(is_tri, hit.prim, 0)
    sp = torch.where(is_sph, hit.prim, 0)
    dp = torch.where(hit.kind == KIND_DISK, hit.prim, 0)

    p = o + d * hit.t

    # --- triangle attributes: ONE packed row gather -----------------------
    row = geom.tri_shad[tp]
    e1 = V3(row[:, 0], row[:, 1], row[:, 2])
    e2 = V3(row[:, 3], row[:, 4], row[:, 5])
    n0 = V3(row[:, 6], row[:, 7], row[:, 8])
    n1 = V3(row[:, 9], row[:, 10], row[:, 11])
    n2 = V3(row[:, 12], row[:, 13], row[:, 14])
    ng_tri = e1.cross(e2).normalized()
    w = 1.0 - hit.u - hit.v
    ns_tri = (n0 * w + n1 * hit.u + n2 * hit.v).normalized()
    if geom.instanced:
        # BLAS-local normals to world space, per instance
        rot = geom.inst_rot.reshape(-1, 9)
        ii = hit.inst.clamp(0, rot.shape[0] - 1).long()
        rc = [rot[:, k][ii] for k in range(9)]

        def rot_v3(n):
            return V3(rc[0] * n.x + rc[1] * n.y + rc[2] * n.z,
                      rc[3] * n.x + rc[4] * n.y + rc[5] * n.z,
                      rc[6] * n.x + rc[7] * n.y + rc[8] * n.z).normalized()

        ng_tri = rot_v3(ng_tri)
        ns_tri = rot_v3(ns_tri)
    uvu_tri = row[:, 15] * w + row[:, 17] * hit.u + row[:, 19] * hit.v
    uvv_tri = row[:, 16] * w + row[:, 18] * hit.u + row[:, 20] * hit.v

    # --- sphere attributes ---
    ns_sph = (p - v.gather_v3(geom.sph_center, sp)).normalized()
    theta, phi = v.spherical_coordinates(ns_sph)
    uvu_sph = phi / (2 * PI)
    uvv_sph = theta / PI

    # --- disk attributes ---
    dn = v.gather_v3(geom.disk_n, dp)
    local = p - v.gather_v3(geom.disk_center, dp)
    lx = local.dot(v.gather_v3(geom.disk_s, dp))
    ly = local.dot(v.gather_v3(geom.disk_t, dp))
    r_ = torch.sqrt(lx * lx + ly * ly) / torch.clamp_min(
        geom.disk_radius[dp], 1e-20)
    phi_d = torch.atan2(ly, lx)
    phi_d = torch.where(phi_d < 0, phi_d + 2 * PI, phi_d)

    ng = v.where(is_tri, ng_tri, v.where(is_sph, ns_sph, dn))
    ns = v.where(is_tri, ns_tri, v.where(is_sph, ns_sph, dn))
    uv_u = torch.where(is_tri, uvu_tri, torch.where(is_sph, uvu_sph, r_))
    uv_v = torch.where(is_tri, uvv_tri,
                       torch.where(is_sph, uvv_sph, phi_d / (2 * PI)))

    ss, ts_ = v.coordinate_system(ns)
    wi_local = v.to_local((ss, ts_, ns), -d)
    return Interaction3(
        p=p, t=hit.t, ng=ng, ns=ns, ss=ss, ts_=ts_, uv_u=uv_u, uv_v=uv_v,
        wi_local=wi_local,
        shape=torch.where(hit.valid, hit.shape, INVALID),
        valid=hit.valid,
    )
