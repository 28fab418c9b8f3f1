"""Adaptive sampling (``mitsuba_im_tpu/integrators/adaptive.py``, after
``src/integrators/misc/adaptive.cpp``).

Each pixel keeps Welford accumulators of its samples (the mean image, the
luminance's M2 and the count).  Sampling runs in rounds of the base
``spp`` one-sample passes over the pixels still active; after each round a
pixel stops once t * stderr <= maxError * max(|mean luminance|, floor) at
confidence 1 - pValue (t the Student-t quantile of the samples so far,
floor a tenth of the active pixels' median luminance, at least 1e-3), or
after ``maxSampleFactor`` rounds.  The nested integrator renders each pass
(``render/job.py::integrator_fn``) through the camera sample of
``render_film``'s passes, box reconstruction (per-pixel independence is
what the test needs).  The quantiles are the reference's host code,
copied (:func:`_norm_quantile`, :func:`_student_t_quantile`).

Reference observation C17 (ROADMAP §C): the reference pads each round's
pixel list with pixel 0 up to a power-of-two bucket (at least 256) to
bound its recompilations (``adaptive.py:153-155``).  Its pad lanes sample
pixel 0 too, and once pixel 0 has stopped they go on updating its mean,
M2 and count.  The port launches the round's exact active list, with no
pads, so every pixel but pixel 0 after it stops is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import Float
from ..core.v3 import V3

LUM = (0.212671, 0.715160, 0.072169)


def _student_t_quantile(p: float, dof: float) -> float:
    """Two-sided Student-t quantile via the Cornish-Fisher expansion around
    the normal quantile (Hill 1970); plenty accurate for dof >= 4, which the
    base spp guarantees (analog of boost::math::quantile in adaptive.cpp)."""
    # normal quantile (Acklam's rational approximation)
    z = _norm_quantile(1.0 - p / 2.0)
    v = max(dof, 1.0)
    z3, z5, z7 = z ** 3, z ** 5, z ** 7
    t = (z
         + (z3 + z) / (4 * v)
         + (5 * z5 + 16 * z3 + 3 * z) / (96 * v * v)
         + (3 * z7 + 19 * z5 + 17 * z3 - 15 * z) / (384 * v ** 3))
    return float(t)


def _norm_quantile(p: float) -> float:
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_quantile(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def _lum(c: V3) -> torch.Tensor:
    return c.x * LUM[0] + c.y * LUM[1] + c.z * LUM[2]


def adaptive_sample(scene, pix: torch.Tensor, acc: dict, sample_idx: int,
                    seed: int, width: int, height: int, spp: int, kind: int,
                    li_fn) -> None:
    """One sample of each pixel of ``pix``, folded into the Welford
    accumulators ``acc`` (mean (N, 3), m2 (N,), count (N,)) in place."""
    from ..render.job import _camera_sample

    scene, sampler, _px, _py, (o, d, w_sensor), _ = _camera_sample(
        scene, pix, width, height, sample_idx, seed, kind, spp)
    li, _ = li_fn(scene, sampler, o, d)
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor
              for c in li))
    lum = _lum(li)
    c_new = acc["count"][pix] + 1.0
    mu_old = V3.from_array(acc["mean"][pix])
    mu_new = mu_old + (li - mu_old) / c_new
    acc["m2"][pix] = acc["m2"][pix] + (lum - _lum(mu_old)) * (
        lum - _lum(mu_new))
    acc["mean"][pix] = torch.stack(list(mu_new), 1)
    acc["count"][pix] = c_new


def render_adaptive(scene, settings, spp: int | None = None,
                    round_cb=None) -> torch.Tensor:
    """The adaptive image, (H, W, 3) on the scene's device.  ``spp`` (the
    settings' sampleCount) is a round's batch; ``round_cb(round, pixels)``
    sees each round's active pixel ids (numpy) before it runs."""
    from ..render.job import RenderSettings, integrator_fn, sampler_kind

    ip = settings.integrator_props
    max_error = float(ip.get("max_error", 0.05))
    p_value = float(ip.get("p_value", 0.05))
    max_factor = int(ip.get("max_spp", 32))
    nested = dict(ip.get("nested", {"name": "path"}))
    li_fn = integrator_fn(RenderSettings(
        integrator=nested.pop("name", "path"), integrator_props=nested))

    base_spp = int(spp if spp is not None else settings.spp)
    width, height = settings.width, settings.height
    n = width * height
    kind = sampler_kind(settings)
    dev = scene.device
    acc = dict(mean=torch.zeros((n, 3), dtype=Float, device=dev),
               m2=torch.zeros((n,), dtype=Float, device=dev),
               count=torch.zeros((n,), dtype=Float, device=dev))

    pix_active = np.arange(n, dtype=np.int64)
    sample0 = 0
    with torch.no_grad():
        for round_idx in range(max_factor):
            if len(pix_active) == 0:
                break
            if round_cb is not None:
                round_cb(round_idx, pix_active)
            pix = torch.from_numpy(pix_active).to(dev)
            for r in range(base_spp):
                adaptive_sample(scene, pix, acc, sample0 + r, settings.seed,
                                width, height, base_spp, kind, li_fn)
            sample0 += base_spp

            cnt = acc["count"][pix].cpu().numpy()
            mu = acc["mean"][pix].cpu().numpy()
            var = acc["m2"][pix].cpu().numpy() / np.maximum(cnt - 1.0, 1.0)
            stderr = np.sqrt(var / np.maximum(cnt, 1.0))
            tq = _student_t_quantile(p_value, sample0 - 1.0)
            lum = mu @ np.array(LUM, np.float32)
            floor = max(np.percentile(lum, 50) * 0.1, 1e-3)
            ok = tq * stderr <= max_error * np.maximum(np.abs(lum), floor)
            pix_active = pix_active[~ok]
    return acc["mean"].reshape(height, width, 3)
