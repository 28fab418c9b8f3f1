"""Instant radiosity with virtual point lights
(``mitsuba_im_tpu/integrators/vpl.py``).

Each pass walks one camera ray per pixel to its first smooth vertex
(``sppm.py::eye_pass``, up to four delta bounces), adds one next-event
sample of direct light there, and lights the vertex by every virtual point
light of the pass: K = ``n_paths`` x (``max_depth`` - 2) photon deposits of
``sppm.py::photon_trace(want_surface=True)``, each a shadow ray and two
BSDF evaluations (the eye side and the light's own surface) with the
geometry term clamped at ``clamping`` of the scene's radius, averaged per
light path.  Direct light is not taken from the VPLs, so the clamping's
bias stays in the indirect light.

The reference lights every pixel by one VPL at a time, a shadow-ray
wavefront a VPL.  The port evaluates ``VPL_LANES`` // pixels VPLs in one
wavefront (one any-hit launch for all of them, K / batch launches a pass)
and adds their contributions to each pixel one VPL after another, in the
reference's order: every lane's arithmetic and every sum are the
reference's.

The pass's samples land in the image with ``index_put_(accumulate=True)``,
not the reference's ``.at[].add``, as the box film's (``film/film.py``): a
jitter that rounds up to 1 can put two samples in one pixel, and
``index_add_``'s atomics order such sums differently run to run on the
card; a zero sample goes to a pixel of its own lane
(``film.py::spread_inactive``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import Float, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v
from ..emitter import table as em
from ..film.film import spread_inactive
from ..scene.geometry import Interaction3
from ..scene.scene import Scene
from .path import _fake_it_v
from .sppm import _take, eye_pass, index_params, photon_trace

VPL_SEED = 0xC0FFEE
VPL_LANES = 1 << 24  # lanes (pixels x VPLs) of one VPL wavefront


def vpl_pass(scene: Scene, img: torch.Tensor, pass_idx: int, seed: int, *,
             width: int, height: int, n_paths: int, max_bounces: int,
             clamp_dist) -> torch.Tensor:
    """One pass added into ``img``, an (H * W, 3) sum; returns it."""
    dev = scene.device
    n = width * height
    seed = int(seed) & mrng.MASK32
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    (px, py), st, gatherable, _prim = eye_pass(
        scene, mrng.make_sampler_v(pix, pass_idx, seed), width, height,
        max_delta_bounces=4)
    bp_eye = scene.bsdf_at_v(_fake_it_v(st))
    frame = (st["ss"], st["ts"], st["ns"])
    zeros = v.zeros((n,), dev)
    li = st["le"]

    # direct light: one next-event sample a pixel
    s, nee = mrng.next_block4_v(st["sampler"])
    ds = em.sample_direct_v(scene.emitters, scene.geom, st["p"], nee[0],
                            nee[1], nee[2])
    f = bsdf_eval_v(bp_eye, st["wi_local"], v.to_local(frame, ds.d))
    occ = scene.occluded_v(st["p"], ds.d, EPSILON,
                           ds.dist * (1.0 - SHADOW_EPSILON))
    ok = gatherable & (ds.pdf > 0) & ~occ
    li = li + v.where(ok, st["thr"] * ds.value * f
                      / torch.clamp_min(ds.pdf, 1e-20), zeros)

    # the pass's VPLs
    vid = torch.arange(n_paths, dtype=torch.int64, device=dev)
    p_v, pw_v, _wi_v, valid_v, surf = photon_trace(
        scene, mrng.make_sampler_v(vid, pass_idx, seed ^ VPL_SEED),
        max_bounces, want_surface=True)
    bp_vpl = scene.bsdf_at_v(Interaction3(
        p=p_v, t=torch.zeros_like(valid_v, dtype=Float), ng=surf["ns"],
        ns=surf["ns"], ss=surf["ss"], ts_=surf["ts"], uv_u=surf["uv_u"],
        uv_v=surf["uv_v"], wi_local=surf["wi_local"], shape=surf["shape"],
        valid=valid_v))
    k_all = valid_v.shape[0]
    cd2 = float(np.float32(clamp_dist) * np.float32(clamp_dist))

    indirect = zeros
    batch = max(1, VPL_LANES // n)
    for k0 in range(0, k_all, batch):
        kb = min(batch, k_all - k0)
        ks = torch.arange(k0, k0 + kb, device=dev).repeat_interleave(n)
        pe = pix.repeat(kb)
        p_e = _take(st["p"], pe)
        d = _take(p_v, ks) - p_e
        dist2 = d.dot(d)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
        dirw = d / dist
        # the eye side's response (with its cosine)
        f_x = bsdf_eval_v(index_params(bp_eye, pe), _take(st["wi_local"], pe),
                          v.to_local(tuple(_take(c, pe) for c in frame),
                                     dirw))
        # the VPL side's response (with its cosine)
        fr_v = (_take(surf["ss"], ks), _take(surf["ts"], ks),
                _take(surf["ns"], ks))
        f_v = bsdf_eval_v(index_params(bp_vpl, ks),
                          _take(surf["wi_local"], ks),
                          v.to_local(fr_v, -dirw))
        # the clamped geometry term (vpl.cpp's distance clamping)
        g = 1.0 / torch.clamp_min(dist2, cd2)
        occ_v = scene.occluded_v(p_e, dirw, EPSILON,
                                 dist * (1.0 - SHADOW_EPSILON))
        contrib = _take(st["thr"], pe) * f_x * f_v * _take(pw_v, ks) * g
        ok_v = gatherable[pe] & valid_v[ks] & ~occ_v
        c = v.where(ok_v, contrib, v.zeros((kb * n,), dev))
        for b in range(kb):
            indirect = indirect + _take(c, slice(b * n, (b + 1) * n))
    # the K VPLs came from n_paths light paths: average per path
    li = li + indirect / n_paths
    li = V3(*(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
              for c in li))
    ix = torch.clamp(px.to(torch.int32), 0, width - 1).to(torch.int64)
    iy = torch.clamp(py.to(torch.int32), 0, height - 1).to(torch.int64)
    vals = torch.stack(list(li), 1)
    idx = spread_inactive(iy * width + ix, (vals != 0).any(1), n)
    img.index_put_((idx,), vals, accumulate=True)
    return img


def vpl_settings(scene: Scene, ip: dict) -> tuple[int, int, float]:
    """(n_paths, max_bounces, clamp_dist) of the integrator's properties: a
    VPL at light-path depth b plus the eye connection is a path of b + 2
    edges, so max_bounces = max_depth - 2 (max_depth 5 when -1)."""
    md = ip.get("max_depth", 5)
    max_bounces = max((md if md > 0 else 5) - 2, 1)
    bsr = float(scene.emitters.bsphere_radius)
    clamp_dist = float(np.float32(float(ip.get("clamping", 0.1))
                                  * max(bsr, 1e-3)))
    return int(ip.get("vpl_count", 64)), max_bounces, clamp_dist


def render_vpl(scene: Scene, settings, spp: int | None = None
               ) -> torch.Tensor:
    """The VPL image, (H, W, 3) on the scene's device: ``spp`` passes
    (settings.spp / 4 by default), each with its own VPL set and pixel
    jitter."""
    width, height = settings.width, settings.height
    n_passes = spp if spp is not None else max(settings.spp // 4, 1)
    n_paths, max_bounces, clamp_dist = vpl_settings(
        scene, settings.integrator_props)
    img = torch.zeros((height * width, 3), dtype=Float, device=scene.device)
    with torch.no_grad():
        for p in range(n_passes):
            img = vpl_pass(scene, img, p, settings.seed, width=width,
                           height=height, n_paths=n_paths,
                           max_bounces=max_bounces, clamp_dist=clamp_dist)
    return (img / n_passes).reshape(height, width, 3)
