"""Colour support on the host (the numpy half of
``mitsuba_im_tpu/core/spectrum.py``): the sRGB transfer curves, and
blackbody and sampled spectra reduced to linear Rec.709 RGB, which the
scene loader's ``<blackbody>``, ``<spectrum>`` and ``srgb`` values need.

Spectra are RGB triples (the reference's ``SPECTRUM_SAMPLES == 3``
build).  The arithmetic is the reference's, in float64.
"""
from __future__ import annotations

import numpy as np

# Matrices of the reference's spectrum.cpp (ITU-R Rec. BT.709, D65)
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)


def srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = np.maximum(np.asarray(c, np.float32), 0.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * c ** (1.0 / 2.4) - 0.055)


def blackbody_rgb(temperature_k: float) -> np.ndarray:
    """Planck's law at ``temperature_k`` integrated against the CIE curves
    (5 nm steps over 360..830 nm) and converted to linear RGB."""
    lam = np.arange(360.0, 831.0, 5.0) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    intensity = (2 * h * c * c) / (
        lam ** 5 * (np.exp(h * c / (lam * kb * temperature_k)) - 1.0))
    intensity *= 1e-9  # per nm
    x, y, z = _cie_xyz(lam * 1e9)
    X = np.trapezoid(intensity * x, lam * 1e9)
    Y = np.trapezoid(intensity * y, lam * 1e9)
    Z = np.trapezoid(intensity * z, lam * 1e9)
    rgb = _XYZ2RGB @ np.array([X, Y, Z])
    return np.maximum(rgb, 0.0)


def interpolated_rgb(wavelengths_nm, values) -> np.ndarray:
    """A piecewise-linear SPD (zero outside its support) integrated against
    the CIE 1931 observer, normalised so that a flat unit SPD has Y = 1,
    in linear RGB.  Fewer than two samples give 0, as in the reference."""
    wl = np.asarray(wavelengths_nm, np.float64)
    sv = np.asarray(values, np.float64)
    if wl.size < 2:
        return np.zeros(3)
    order = np.argsort(wl)
    wl, sv = wl[order], sv[order]
    lam = np.arange(360.0, 831.0, 1.0)
    spd = np.interp(lam, wl, sv, left=0.0, right=0.0)
    x, y, z = _cie_xyz(lam)
    norm = np.trapezoid(y, lam)
    X = np.trapezoid(spd * x, lam) / norm
    Y = np.trapezoid(spd * y, lam) / norm
    Z = np.trapezoid(spd * z, lam) / norm
    return _XYZ2RGB @ np.array([X, Y, Z])


def _cie_xyz(lam_nm: np.ndarray):
    """Multi-lobe Gaussian fits to CIE 1931 (Wyman et al. 2013)."""

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (
        1.056 * g(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(lam_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(lam_nm, 568.8, 46.9, 40.5) + 0.286 * g(lam_nm, 530.9, 16.3,
                                                         31.1)
    z = 1.217 * g(lam_nm, 437.0, 11.8, 36.0) + 0.681 * g(lam_nm, 459.0, 26.0,
                                                         13.8)
    return x, y, z
