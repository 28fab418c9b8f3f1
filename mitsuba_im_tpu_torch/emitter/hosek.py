"""Hosek-Wilkie analytic sky radiance (SIGGRAPH 2012), baked on the host
into a lat-long environment map (``mitsuba_im_tpu/emitter/hosek.py`` and
the sky record of ``mitsuba_im_tpu/emitter/__init__.py``), numpy.

The sky dome is evaluated once, over every texel and the 11 spectral bands
at once, and then rides the ``EM_ENVMAP`` path on the device.  The
coefficient tables are the authors' published fitted dataset, the JAX
package's ``data/hosek_sky.npz`` copied into this package:

  F(theta, gamma) = (1 + c0 exp(c1 / (cos theta + 0.01)))
                  * (c2 + c3 exp(c4 gamma) + c5 cos^2 gamma
                     + c6 chi(c8, gamma) + c7 sqrt(cos theta))
  chi(g, a) = (1 + cos^2 a) / (1 + g^2 - 2 g cos a)^1.5

with the 9 coefficients and the master radiance each blended over a
quintic bezier in the cube-root-warped solar elevation, then bilinearly
over integer turbidity and ground albedo.  The spectral radiance is
integrated against the CIE 1931 fits and taken to linear sRGB with the
reference's XYZ-to-RGB matrix in float32 (the last bits of that product
may differ from the JAX package's, whose matrix product XLA computes).

The Preetham sky, the sun and the time ephemeris are in :mod:`.sunsky`;
the ``sky``, ``sun`` and ``sunsky`` factories of :mod:`..emitter` choose
between the two skies.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from . import table as et

DATA_PATH = Path(__file__).resolve().parent.parent / "data" / "hosek_sky.npz"

# reference src/libcore/spectrum.cpp (ITU-R Rec. BT.709, D65)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)


@functools.lru_cache(maxsize=None)
def _load():
    with np.load(DATA_PATH) as z:
        return {k: z[k] for k in z.files}


def _bezier5(knots, x):
    """Quintic bezier over the knot axis (6, ...) at parameter x."""
    w = np.array([(1 - x) ** 5, 5 * (1 - x) ** 4 * x,
                  10 * (1 - x) ** 3 * x ** 2, 10 * (1 - x) ** 2 * x ** 3,
                  5 * (1 - x) * x ** 4, x ** 5])
    return np.tensordot(w, knots, axes=([0], [0]))


def hosek_coeffs(turbidity: float, albedo: float, elevation: float):
    """Blend the dataset -> ((11, 9) coefficients, (11,) master radiance);
    turbidity in [1, 10], albedo in [0, 1], solar elevation in radians."""
    d = _load()
    data = d["data"]  # (11, 2, 10, 6, 9)
    rad = d["rad"]  # (11, 2, 10, 6)
    t = float(np.clip(turbidity, 1.0, 10.0))
    it = min(int(t), 9)  # bracket [it, it + 1] of the 1-based tables
    rem = t - it
    a = float(np.clip(albedo, 0.0, 1.0))
    x = (max(elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)

    def blend(tab):  # (11, 2, 10, 6, ...)
        lo = _bezier5(np.moveaxis(tab[:, :, it - 1], 2, 0), x)
        if it < 10:
            hi = _bezier5(np.moveaxis(tab[:, :, it], 2, 0), x)
            val = (1 - rem) * lo + rem * hi
        else:
            val = lo
        return (1 - a) * val[:, 0] + a * val[:, 1]

    return blend(data), blend(rad)


def _cie_xyz(lam_nm: np.ndarray):
    """Analytic multi-lobe Gaussian fits to CIE 1931 (Wyman et al. 2013)."""
    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (1.056 * g(lam_nm, 599.8, 37.9, 31.0)
         + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
         - 0.065 * g(lam_nm, 501.1, 20.4, 26.2))
    y = (0.821 * g(lam_nm, 568.8, 46.9, 40.5)
         + 0.286 * g(lam_nm, 530.9, 16.3, 31.1))
    z = (1.217 * g(lam_nm, 437.0, 11.8, 36.0)
         + 0.681 * g(lam_nm, 459.0, 26.0, 13.8))
    return x, y, z


def hosek_sky_pixels(resolution: int, sun_dir, turbidity: float = 3.0,
                     albedo: float = 0.15, stretch: float = 1.0,
                     scale: float = 1.0, extend: bool = True) -> np.ndarray:
    """The Hosek-Wilkie sky as a (resolution / 2, resolution, 3) float32
    lat-long map of linear sRGB radiance (+y up, the envmap's mapping)."""
    H = resolution // 2
    W = resolution
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    elevation = float(np.arcsin(np.clip(sun_dir[1], -1.0, 1.0)))
    coeffs, rad = hosek_coeffs(turbidity, albedo, max(elevation, 0.0))

    v = (np.arange(H) + 0.5) / H
    u = (np.arange(W) + 0.5) / W
    theta = v * np.pi / float(stretch)
    phi = u * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack([
        np.broadcast_to(st * np.sin(phi)[None, :], (H, W)),
        np.broadcast_to(np.cos(theta)[:, None], (H, W)),
        np.broadcast_to(-st * np.cos(phi)[None, :], (H, W)),
    ], -1)

    cos_t = np.clip(dirs[..., 1], 0.0, 1.0)  # zenith angle against up
    below = dirs[..., 1] < 0
    cos_g = np.clip(np.tensordot(dirs, sun_dir, axes=([-1], [0])), -1.0, 1.0)
    gamma = np.arccos(cos_g)

    lam = _load()["wavelengths"]  # (11,)
    # coefficient slots of skymodel.cpp's GetRadianceInternal: the Mie
    # anisotropy g in slot 8, the sqrt(cos theta) weight in slot 7
    A, B, C, D, E, F, G, I, Hc = [coeffs[:, k] for k in range(9)]
    ct = np.maximum(cos_t, 0.0)[..., None]  # (H, W, 1)
    cg = cos_g[..., None]
    gm = gamma[..., None]
    chi = (1.0 + cg * cg) / np.power(1.0 + Hc * Hc - 2.0 * Hc * cg, 1.5)
    Fv = (1.0 + A * np.exp(B / (ct + 0.01))) * (
        C + D * np.exp(E * gm) + F * cg * cg + G * chi + I * np.sqrt(ct))
    spec = np.maximum(Fv * rad, 0.0)  # (H, W, 11) spectral radiance

    xb, yb, zb = _cie_xyz(np.asarray(lam, np.float64))
    dl = float(lam[1] - lam[0])
    xyz = np.stack([np.tensordot(spec, c, axes=([-1], [0])) * dl
                    for c in (xb, yb, zb)], -1)
    rgb = xyz.astype(np.float32) @ _XYZ2RGB.T.astype(np.float32)
    rgb = np.clip(rgb, 0.0, None) * scale
    if extend:  # smooth fade below the horizon (sky.cpp's extend)
        fade = np.clip(1.0 + dirs[..., 1] * 4.0, 0.0, 1.0) ** 2
        rgb = np.where(below[..., None], rgb * fade[..., None], rgb)
    else:
        rgb = np.where(below[..., None], 0.0, rgb)
    return rgb.astype(np.float32)


def sky_record(sun_dir, resolution: int = 512, turbidity: float = 3.0,
               albedo: float = 0.15, stretch: float = 1.0,
               scale: float = 1.0, extend: bool = True, to_world_rot=None,
               weight: float = 1.0) -> dict:
    """The ``sky`` emitter (Hosek model) as an ``EM_ENVMAP`` record: the
    baked map at unit radiance scale (``scale`` scales the pixels, as the
    reference's sky does); ``albedo`` is the ground albedo's mean."""
    pixels = hosek_sky_pixels(resolution, sun_dir, turbidity, albedo,
                              stretch, scale, extend)
    return et.envmap_record(pixels, 1.0, to_world_rot, weight)
