"""Analytic sun and sky (Preetham et al. 1999), computed on the host
(``mitsuba_im_tpu/emitter/sunsky.py``, a numpy copy, bit for bit).

The same parameter surface as the reference ``sky`` / ``sun`` / ``sunsky``
plugins (turbidity, location and time or an explicit sun direction,
stretch, resolution, scale, sunRadiusScale) and the same architecture: the
sky is evaluated into a lat-long environment bitmap when the scene is
built and then rides the environment-map path on the device
(``EM_ENVMAP``); the sun is a directional delta emitter.

The Preetham model is fully analytic (the Perez luminance formula with
turbidity-fit coefficients, and analytic spectral extinction for the
solar disk), so it ships no data tables; :mod:`.hosek` holds the
Hosek-Wilkie sky, the factories' default.  Preetham overestimates zenith
blue at high turbidity and has no ground-albedo coupling.  The solar
position is the Blanco-Muriel PSA algorithm (2001), as the reference's
``sunsky/sunmodel.h`` computes it.
"""
from __future__ import annotations

import numpy as np

EARTH_MEAN_RADIUS = 6371.01  # km
ASTRONOMICAL_UNIT = 149597890.0  # km
SUN_APP_RADIUS = 0.5358  # degrees, mean apparent diameter of the solar disk


# ---------------------------------------------------------------------------
# Solar position (Preetham appendix / PSA algorithm as used by sun.cpp)
# ---------------------------------------------------------------------------

def sun_direction_from_time(year: int, month: int, day: int, hour: float,
                            minute: float, second: float,
                            latitude: float, longitude: float,
                            timezone: float) -> np.ndarray:
    """World-space unit vector toward the sun (Y-up, X-east, -Z-north is not
    assumed: uses the reference's convention X=cos(az), Y=up, Z=sin(az) with
    azimuth from south) — Blanco-Muriel PSA algorithm (2001), the same one
    the reference sun model uses (``sunsky/sunmodel.h`` SunParameters).
    """
    dec_hours = hour + minute / 60.0 + second / 3600.0 - timezone

    # Julian day
    if month <= 2:
        year -= 1
        month += 12
    a = year // 100
    b = 2 - a + a // 4
    jd = (np.floor(365.25 * (year + 4716)) + np.floor(30.6001 * (month + 1))
          + day + b - 1524.5) + dec_hours / 24.0
    elapsed_julian_days = jd - 2451545.0

    # ecliptic coordinates
    omega = 2.1429 - 0.0010394594 * elapsed_julian_days
    mean_longitude = 4.8950630 + 0.017202791698 * elapsed_julian_days
    mean_anomaly = 6.2400600 + 0.0172019699 * elapsed_julian_days
    ecliptic_longitude = (
        mean_longitude + 0.03341607 * np.sin(mean_anomaly)
        + 0.00034894 * np.sin(2 * mean_anomaly) - 0.0001134
        - 0.0000203 * np.sin(omega)
    )
    ecliptic_obliquity = (0.4090928 - 6.2140e-9 * elapsed_julian_days
                          + 0.0000396 * np.cos(omega))

    # celestial coordinates
    sin_el = np.sin(ecliptic_longitude)
    dy = np.cos(ecliptic_obliquity) * sin_el
    dx = np.cos(ecliptic_longitude)
    right_ascension = np.arctan2(dy, dx)
    if right_ascension < 0:
        right_ascension += 2 * np.pi
    declination = np.arcsin(np.sin(ecliptic_obliquity) * sin_el)

    # local horizontal coordinates
    greenwich_mean_sidereal = (6.6974243242 + 0.0657098283 * elapsed_julian_days
                               + dec_hours)
    local_mean_sidereal = np.deg2rad(greenwich_mean_sidereal * 15 + longitude)
    lat_r = np.deg2rad(latitude)
    hour_angle = local_mean_sidereal - right_ascension
    elevation = np.arccos(
        np.cos(lat_r) * np.cos(hour_angle) * np.cos(declination)
        + np.sin(lat_r) * np.sin(declination)
    )
    azimuth = np.arctan2(
        -np.sin(hour_angle),
        np.tan(declination) * np.cos(lat_r)
        - np.sin(lat_r) * np.cos(hour_angle),
    )
    # parallax correction
    elevation += (EARTH_MEAN_RADIUS / ASTRONOMICAL_UNIT) * np.sin(elevation)

    theta = elevation  # angle from zenith
    # reference convention: toSphere(SphericalCoordinates(theta, azimuth))
    # with world Y-up lat-long frame (x = sin(theta) sin(phi), y = cos(theta),
    # z = -sin(theta) cos(phi)) — matches the envmap mapping in table.py.
    st = np.sin(theta)
    return np.array([st * np.sin(azimuth), np.cos(theta),
                     -st * np.cos(azimuth)])


# ---------------------------------------------------------------------------
# Preetham sky
# ---------------------------------------------------------------------------

def _perez(theta, gamma, A, B, C, D, E):
    cos_t = np.maximum(np.cos(theta), 1e-3)
    cg = np.cos(gamma)
    return ((1.0 + A * np.exp(B / cos_t))
            * (1.0 + C * np.exp(D * gamma) + E * cg * cg))


def _zenith_chromaticity(T, ts):
    t2, t3 = ts * ts, ts ** 3
    xz = ((0.00166 * t3 - 0.00375 * t2 + 0.00209 * ts) * T * T
          + (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * ts + 0.00394) * T
          + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * ts + 0.25886))
    yz = ((0.00275 * t3 - 0.00610 * t2 + 0.00317 * ts) * T * T
          + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * ts + 0.00516) * T
          + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * ts + 0.26688))
    return xz, yz


_XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])


def preetham_sky_pixels(resolution: int, sun_dir: np.ndarray,
                        turbidity: float = 3.0, stretch: float = 1.0,
                        scale: float = 1.0,
                        extend: bool = True) -> np.ndarray:
    """Evaluate the Preetham sky into a (res/2, res, 3) lat-long RGB bitmap.

    Mirrors sky.cpp's precompute loop: rows below the horizon are darkened
    smoothly when ``extend`` (the reference's extend=true hemisphere
    extension); ``stretch`` (1..2) lowers the horizon like the reference's
    stretch parameter.  Output is linear RGB radiance (W/(m^2 sr nm)-scaled
    by the standard 683 lm/W photopic conversion so it composes with other
    emitters' radiometric units).
    """
    T = float(turbidity)
    W = int(resolution)
    H = max(W // 2, 1)

    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-12)
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    theta_s = min(theta_s, np.deg2rad(88.0))  # clamp like zenith fits expect

    # Perez coefficients (Preetham table A.2)
    AY, BY = 0.1787 * T - 1.4630, -0.3554 * T + 0.4275
    CY, DY, EY = (-0.0227 * T + 5.3251, 0.1206 * T - 2.5771,
                  -0.0670 * T + 0.3703)
    Ax, Bx = -0.0193 * T - 0.2592, -0.0665 * T + 0.0008
    Cx, Dx, Ex = (-0.0004 * T + 0.2125, -0.0641 * T - 0.8989,
                  -0.0033 * T + 0.0452)
    Ay_, By_ = -0.0167 * T - 0.2608, -0.0950 * T + 0.0092
    Cy_, Dy_, Ey_ = (-0.0079 * T + 0.2102, -0.0441 * T - 1.6537,
                     -0.0109 * T + 0.0529)

    # zenith values
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m^2
    Yz = max(Yz, 1e-3) * 1000.0  # cd/m^2
    xz, yz = _zenith_chromaticity(T, theta_s)

    # texel directions (lat-long, Y-up; matches emitter.table _env_dir_from_uv)
    v = (np.arange(H) + 0.5) / H
    u = (np.arange(W) + 0.5) / W
    theta = v[:, None] * np.pi / float(stretch)
    phi = u[None, :] * 2.0 * np.pi
    st = np.sin(theta)
    dirs = np.stack([
        np.broadcast_to(st * np.sin(phi), (H, W)),
        np.broadcast_to(np.cos(theta), (H, W)),
        np.broadcast_to(-st * np.cos(phi), (H, W)),
    ], axis=-1)

    below = dirs[..., 1] < 0.0
    theta_eval = np.minimum(theta, np.pi / 2 - 1e-3)
    theta_eval = np.broadcast_to(theta_eval, (H, W))
    cos_gamma = np.clip(dirs @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    fY = _perez(theta_eval, gamma, AY, BY, CY, DY, EY) / _perez(
        0.0, theta_s, AY, BY, CY, DY, EY)
    fx = _perez(theta_eval, gamma, Ax, Bx, Cx, Dx, Ex) / _perez(
        0.0, theta_s, Ax, Bx, Cx, Dx, Ex)
    fy = _perez(theta_eval, gamma, Ay_, By_, Cy_, Dy_, Ey_) / _perez(
        0.0, theta_s, Ay_, By_, Cy_, Dy_, Ey_)

    Y = Yz * fY  # cd/m^2
    x = xz * fx
    y = yz * fy

    # Yxy -> XYZ -> linear sRGB; 683 lm/W photopic -> radiometric W/(m^2 sr)
    y_safe = np.maximum(y, 1e-6)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    xyz = np.stack([X, Y, Z], axis=-1) / 683.0
    rgb = xyz @ _XYZ_TO_SRGB.T
    rgb = np.maximum(rgb, 0.0) * scale

    if extend:
        # smooth fade below the horizon (sky.cpp extend: cos^4 hemisphere
        # extension keeps NEE from seeing a hard zero boundary)
        fade = np.clip(1.0 + dirs[..., 1] * 4.0, 0.0, 1.0) ** 2
        rgb = np.where(below[..., None], rgb * fade[..., None], rgb)
    else:
        rgb = np.where(below[..., None], 0.0, rgb)
    return rgb.astype(np.float32)


# ---------------------------------------------------------------------------
# Sun radiance (analytic spectral extinction, Preetham A.1)
# ---------------------------------------------------------------------------

def sun_radiance_rgb(sun_dir: np.ndarray, turbidity: float = 3.0,
                     scale: float = 1.0) -> np.ndarray:
    """Mean RGB radiance of the solar disk after atmospheric extinction.

    Beer-Lambert with the Preetham analytic optical depths (Rayleigh,
    aerosol with Angstrom beta from turbidity, ozone) applied to a 5778 K
    blackbody normalized to the solar constant, sampled at R/G/B
    wavelengths.  The reference integrates tabulated spectra
    (``sunsky/sunmodel.h`` computeSunRadiance); the analytic form tracks it
    within a few percent for turbidity 2-10 at elevations > 5 degrees.
    """
    T = float(turbidity)
    sun_dir = np.asarray(sun_dir, np.float64)
    cos_theta = np.clip(sun_dir[1] / max(np.linalg.norm(sun_dir), 1e-12),
                        -1.0, 1.0)
    theta_s = np.arccos(cos_theta)
    if cos_theta <= 0.0:
        return np.zeros(3, np.float32)

    # relative optical air mass (Kasten & Young)
    m = 1.0 / (cos_theta + 0.15 * (93.885 - np.rad2deg(theta_s)) ** -1.253)

    lam = np.array([0.680, 0.550, 0.440])  # um, RGB sample wavelengths
    # Rayleigh scattering
    tau_r = np.exp(-m * 0.008735 * lam ** -4.08)
    # aerosol (Angstrom turbidity formula)
    beta = 0.04608 * T - 0.04586
    tau_a = np.exp(-m * beta * lam ** -1.3)
    # ozone (l = 0.35 cm NTP; absorption coefficients at RGB wavelengths)
    k_o = np.array([0.007, 0.085, 0.009])
    tau_o = np.exp(-m * k_o * 0.35)
    tau = tau_r * tau_a * tau_o

    # 5778 K blackbody radiance at RGB wavelengths, normalized so the
    # unattenuated disk delivers the solar constant (~1361 W/m^2) through
    # its solid angle, split over the visible band.
    h, c, kb = 6.62607e-34, 2.99792e8, 1.38065e-23
    lam_m = lam * 1e-6
    bb = (2 * h * c * c / lam_m ** 5) / np.expm1(h * c / (lam_m * kb * 5778.0))
    bb = bb / bb[1]  # relative spectrum, green = 1
    # solar disk: half-angle 0.2679 deg -> solid angle 6.87e-5 sr;
    # L_green such that E = L * Omega * (lum-weighted band share ~ 0.4)
    omega_sun = 2 * np.pi * (1 - np.cos(np.deg2rad(SUN_APP_RADIUS / 2)))
    L_green = 1361.0 * 0.4 / omega_sun
    return (bb * tau * L_green * scale).astype(np.float32)


def sun_solid_angle(radius_scale: float = 1.0) -> float:
    return float(2 * np.pi * (1 - np.cos(
        np.deg2rad(SUN_APP_RADIUS / 2) * radius_scale)))
