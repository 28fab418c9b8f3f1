"""BSDF parameter tables and per-lane resolution
(``mitsuba_im_tpu/bsdf/common.py``), for untextured records.

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
DIST_BECKMANN = 0  # mitsuba_im_tpu/bsdf/microfacet.py
FLAG_TWOSIDED = 1

TEXTURE_COLUMNS = ("refl_tex", "spec_tex", "trans_tex", "alpha_tex",
                   "opacity_tex", "weight_tex", "bump_tex")


@dataclasses.dataclass(frozen=True)
class BSDFTable:
    """The columns the ported BSDFs read; the reference's other columns
    (specular, IOR, roughness, wrapper links) join with their BSDFs."""

    type: torch.Tensor  # (B,) int32
    refl: torch.Tensor  # (B, 3) diffuse reflectance
    flags: torch.Tensor  # (B,) int32 (twosided)
    used_types: tuple = (DIFFUSE,)
    unwrap_depth: int = 0  # MASK/BLEND nesting budget
    has_bump: bool = False
    textured: bool = False  # some texture column != INVALID


BSDF_LEAVES = ("type", "refl", "flags")


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


def table_from_arrays(arrays: dict, used_types, unwrap_depth: int,
                      has_bump: bool, device="cpu") -> BSDFTable:
    """A BSDFTable from numpy columns (from ``scene/build.py`` or the bridge);
    ``arrays`` also carries the TEXTURE_COLUMNS."""
    cols = {k: host_tensor(arrays[k], np.float32 if k == "refl" else np.int32,
                           device) for k in BSDF_LEAVES}
    textured = any(bool((np.asarray(arrays[k]) != INVALID).any())
                   for k in TEXTURE_COLUMNS)
    return BSDFTable(**cols, used_types=tuple(used_types),
                     unwrap_depth=int(unwrap_depth), has_bump=bool(has_bump),
                     textured=textured)


def build_table(records: list[dict], device="cpu") -> BSDFTable:
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
    refl: V3
    flags: torch.Tensor
    used_types: tuple = (DIFFUSE,)


def resolve_v(table: BSDFTable, bsdf_id: torch.Tensor) -> LaneParams3:
    """Gather each lane's parameter row (no texture or wrapper support, so
    the reference's mask opacity is 1 and its uv lookups drop out)."""
    if table.textured or table.unwrap_depth > 0:
        raise NotImplementedError(
            "textured BSDF parameters and MASK/BLEND wrappers are not "
            "ported yet")
    bid = torch.where(bsdf_id == INVALID, 0, bsdf_id)
    return LaneParams3(type=table.type[bid], refl=v.gather_v3(table.refl, bid),
                       flags=table.flags[bid], used_types=table.used_types)
