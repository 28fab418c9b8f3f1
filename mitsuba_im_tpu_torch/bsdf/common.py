"""BSDF parameter tables and per-lane resolution
(``mitsuba_im_tpu/bsdf/common.py``), for untextured records, and the
record factories of the ported types (``mitsuba_im_tpu/bsdf/__init__.py``).

Each scene BSDF is one row of typed parameters; lanes gather their row into
a :class:`LaneParams3`.  Texture references, MASK/BLEND unwrapping and bump
mapping are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import INVALID, host_tensor
from ..core import v3 as v
from ..core.v3 import V3
from .ior import lookup_conductor
from .microfacet import DIST_BECKMANN, DIST_GGX, DIST_PHONG

# Type codes (one per reference bsdf plugin)
DIFFUSE = 0
ROUGHDIFFUSE = 1
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
THINDIELECTRIC = 5
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
NULL_BSDF = 11
DIFFTRANS = 12
COATING = 13
MASK = 14
BLEND = 15
BUMPMAP_WRAP = 16
HK = 17
IRAWAN = 18

BUMP_NONE = 0
FLAG_TWOSIDED = 1

_DISTS = {"beckmann": DIST_BECKMANN, "ggx": DIST_GGX, "phong": DIST_PHONG,
          "as": DIST_BECKMANN}

TEXTURE_COLUMNS = ("refl_tex", "spec_tex", "trans_tex", "alpha_tex",
                   "opacity_tex", "weight_tex", "bump_tex")


@dataclasses.dataclass(frozen=True)
class BSDFTable:
    """The columns the ported BSDFs read; the reference's other columns
    (transmittance, dielectric IOR, exponents, wrapper links) join with
    their BSDFs."""

    type: torch.Tensor  # (B,) int32
    dist: torch.Tensor  # (B,) int32 microfacet distribution
    refl: torch.Tensor  # (B, 3) diffuse reflectance
    spec: torch.Tensor  # (B, 3) specular reflectance
    eta: torch.Tensor  # (B, 3) conductor ior (rgb)
    k: torch.Tensor  # (B, 3) conductor absorption
    alpha_u: torch.Tensor  # (B,) roughness
    alpha_v: torch.Tensor  # (B,)
    flags: torch.Tensor  # (B,) int32 (twosided)
    used_types: tuple = (DIFFUSE,)
    unwrap_depth: int = 0  # MASK/BLEND nesting budget
    has_bump: bool = False
    textured: bool = False  # some texture column != INVALID


BSDF_LEAVES = ("type", "dist", "refl", "spec", "eta", "k", "alpha_u",
               "alpha_v", "flags")
_INT_LEAVES = ("type", "dist", "flags")


def default_record() -> dict:
    return dict(
        type=DIFFUSE, dist=DIST_BECKMANN,
        refl=np.full(3, 0.5), refl_tex=INVALID,
        spec=np.ones(3), spec_tex=INVALID,
        trans=np.ones(3), trans_tex=INVALID,
        eta=np.zeros(3), k=np.ones(3), eta_s=1.5046,
        alpha_u=0.1, alpha_v=0.1, alpha_tex=INVALID,
        exponent=30.0,
        opacity=np.full(3, 0.5), opacity_tex=INVALID,
        flags=0, nested=INVALID, nested2=INVALID,
        weight=0.5, weight_tex=INVALID,
        bump_tex=INVALID, bump_kind=BUMP_NONE, bump_scale=1.0,
    )


def conductor_record(material: str = "Cu", ext_eta: float = 1.000277,
                     rough: bool = False, alpha: float = 0.1,
                     alpha_u: float | None = None,
                     alpha_v: float | None = None,
                     distribution: str = "beckmann") -> dict:
    """A ``conductor`` / ``roughconductor`` record, as the reference's
    plugin factory builds it from its properties (defaults included): eta
    and k of the named material divided by the exterior IOR, unit
    specular reflectance."""
    rec = default_record()
    rec["type"] = ROUGHCONDUCTOR if rough else CONDUCTOR
    eta, k = lookup_conductor(material)
    rec["eta"] = eta / ext_eta
    rec["k"] = k / ext_eta
    rec["spec"] = np.ones(3)
    if rough:
        rec["alpha_u"] = alpha if alpha_u is None else alpha_u
        rec["alpha_v"] = alpha if alpha_v is None else alpha_v
        rec["dist"] = _DISTS.get(distribution, DIST_BECKMANN)
    return rec


def table_from_arrays(arrays: dict, used_types, unwrap_depth: int,
                      has_bump: bool, device) -> BSDFTable:
    """A BSDFTable from numpy columns (from ``scene/build.py`` or the bridge);
    ``arrays`` also carries the TEXTURE_COLUMNS."""
    cols = {k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                           else np.float32, device) for k in BSDF_LEAVES}
    textured = any(bool((np.asarray(arrays[k]) != INVALID).any())
                   for k in TEXTURE_COLUMNS)
    return BSDFTable(**cols, used_types=tuple(used_types),
                     unwrap_depth=int(unwrap_depth), has_bump=bool(has_bump),
                     textured=textured)


def build_table(records: list[dict], device) -> BSDFTable:
    recs = records or [default_record()]
    types = {int(r["type"]) for r in recs}
    if BLEND in types:
        depth = 4
    elif MASK in types:
        depth = 1
    else:
        depth = 0
    arrays = {k: np.stack([np.asarray(r[k]) for r in recs])
              for k in BSDF_LEAVES + TEXTURE_COLUMNS}
    return table_from_arrays(
        arrays, sorted(types), depth,
        any(int(r.get("bump_kind", BUMP_NONE)) != BUMP_NONE for r in recs),
        device)


@dataclasses.dataclass(frozen=True)
class LaneParams3:
    """Per-lane BSDF parameters of the ported types: spectra are V3,
    scalars flat (N,)."""

    type: torch.Tensor
    dist: torch.Tensor
    refl: V3
    spec: V3
    eta: V3
    k: V3
    alpha_u: torch.Tensor
    alpha_v: torch.Tensor
    flags: torch.Tensor
    used_types: tuple = (DIFFUSE,)


def resolve_v(table: BSDFTable, bsdf_id: torch.Tensor) -> LaneParams3:
    """Gather each lane's parameter row (no texture or wrapper support, so
    the reference's mask opacity is 1 and its uv lookups drop out).
    Roughness is clamped to at least 1e-4, as the reference does."""
    if table.textured or table.unwrap_depth > 0:
        raise NotImplementedError(
            "textured BSDF parameters and MASK/BLEND wrappers are not "
            "ported yet")
    bid = torch.where(bsdf_id == INVALID, 0, bsdf_id)
    return LaneParams3(
        type=table.type[bid], dist=table.dist[bid],
        refl=v.gather_v3(table.refl, bid), spec=v.gather_v3(table.spec, bid),
        eta=v.gather_v3(table.eta, bid), k=v.gather_v3(table.k, bid),
        alpha_u=torch.clamp_min(table.alpha_u[bid], 1e-4),
        alpha_v=torch.clamp_min(table.alpha_v[bid], 1e-4),
        flags=table.flags[bid], used_types=table.used_types)
