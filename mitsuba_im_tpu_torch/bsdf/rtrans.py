"""Rough dielectric transmittance tables, evaluation side
(``mitsuba_im_tpu/bsdf/rtrans.py``): the directional transmittance
T(cos_theta_i; alpha, eta) through a rough dielectric boundary and its
cosine-weighted hemispherical average, which ``roughplastic`` interpolates
for its diffuse term and its lobe-selection probability (the reference's
``rtrans.h``).

The grid is the JAX package's ``data/rtrans.npz``, copied into this
package: (2 distributions, 2 eta blocks, NE etas, NA alphas, NT angles),
read by trilinear interpolation (8 taps a lane).  Its generator (QMC
integration) is not ported.

Axis warps: eta w = ((eta' - 1) / (ETA_MAX - 1))**0.25 with eta' =
max(eta, 1/eta), block 0 for eta > 1 and 1 for eta < 1; alpha w =
sqrt(alpha / ALPHA_MAX); theta w = cos_theta.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from .microfacet import DIST_GGX

NE, NA, NT = 16, 16, 32
ETA_MAX = 4.0
ALPHA_MAX = 1.0

DATA_PATH = Path(__file__).resolve().parent.parent / "data" / "rtrans.npz"


@functools.lru_cache(maxsize=None)
def load_tables(device: torch.device):
    """(trans (2*2*NE*NA*NT,), diff (2*2*NE*NA,)) float32 on ``device``,
    flattened, read once per device."""
    with np.load(DATA_PATH) as z:
        trans = np.asarray(z["trans"], np.float32).reshape(-1)
        diff = np.asarray(z["diff"], np.float32).reshape(-1)
    return (torch.from_numpy(trans).to(device),
            torch.from_numpy(diff).to(device))


def _grid_coords(eta_s, alpha, ct):
    blk = (eta_s < 1.0).to(torch.int32)
    e = torch.maximum(eta_s, 1.0 / torch.clamp_min(eta_s, 1e-6))
    fe = ((torch.clamp(e, 1.0, ETA_MAX) - 1.0) / (ETA_MAX - 1.0)) ** 0.25 \
        * (NE - 1)
    fa = torch.sqrt(torch.clamp(alpha, 0.0, ALPHA_MAX) / ALPHA_MAX) * (NA - 1)
    ft = torch.clamp(ct, 0.0, 1.0) * (NT - 1)
    return blk, fe, fa, ft


def _cell(f, n):
    """(integer tap in [0, n - 2], fractional weight) of a grid coordinate."""
    i = torch.clamp(torch.floor(f).to(torch.int32), 0, n - 2)
    return i, f - i


def rtrans_eval_v(dist, ct, alpha, eta_s):
    """Directional rough transmittance T(ct; alpha, eta), per lane (Phong
    and Beckmann read the Beckmann table)."""
    tab = load_tables(ct.device)[0]
    d = (dist == DIST_GGX).to(torch.int32)
    blk, fe, fa, ft = _grid_coords(eta_s, alpha, ct)
    ie, we = _cell(fe, NE)
    ia, wa = _cell(fa, NA)
    it, wt = _cell(ft, NT)
    base = ((d * 2 + blk) * NE + ie) * NA * NT + ia * NT + it

    def tap(de, da, dt):
        return tab[base + de * (NA * NT) + da * NT + dt]

    t00 = tap(0, 0, 0) * (1 - wt) + tap(0, 0, 1) * wt
    t01 = tap(0, 1, 0) * (1 - wt) + tap(0, 1, 1) * wt
    t10 = tap(1, 0, 0) * (1 - wt) + tap(1, 0, 1) * wt
    t11 = tap(1, 1, 0) * (1 - wt) + tap(1, 1, 1) * wt
    t0 = t00 * (1 - wa) + t01 * wa
    t1 = t10 * (1 - wa) + t11 * wa
    return torch.clamp(t0 * (1 - we) + t1 * we, 0.0, 1.0)


def rtrans_diffuse_v(dist, alpha, eta_s):
    """Hemispherical (cosine-weighted) rough transmittance, per lane."""
    tab = load_tables(alpha.device)[1]
    d = (dist == DIST_GGX).to(torch.int32)
    blk, fe, fa, _ = _grid_coords(eta_s, alpha, torch.zeros_like(alpha))
    ie, we = _cell(fe, NE)
    ia, wa = _cell(fa, NA)
    base = ((d * 2 + blk) * NE + ie) * NA + ia

    def tap(de, da):
        return tab[base + de * NA + da]

    t0 = tap(0, 0) * (1 - wa) + tap(0, 1) * wa
    t1 = tap(1, 0) * (1 - wa) + tap(1, 1) * wa
    return torch.clamp(t0 * (1 - we) + t1 * we, 0.0, 1.0)
