"""Path-space verification harness (``mitsuba_im_tpu/bidir/verification.py``,
the analog of ``verification.cpp:24-60``): the cached quantities of a
subpath from ``integrators/bdpt.py::random_walk`` are derived again from
the stored vertex geometry alone, for radiance (eye) and importance
(light) transport, surface and medium vertices.
"""
from __future__ import annotations

import torch

from ..core import v3 as v
from ..core.v3 import V3


def _dir(a: V3, b: V3):
    d = b - a
    n = torch.sqrt(torch.clamp_min(d.dot(d), 1e-20))
    return d / n, n


def _stack(x: V3) -> torch.Tensor:
    return torch.stack(list(x), dim=-1)


def verify_walk(verts: list, scene=None, adjoint: bool = False) -> dict:
    """Maximum relative mismatch of each vertex's cached forward density
    and of its throughput step against values derived again, over valid
    transitions from non-delta vertices whose sampling density exceeds
    1e-6.  Returns dict(pdf_err, beta_err, checked).

    The throughput invariant is beta[i+1] = beta[i] * f / pdf * w_arrival,
    with the shading-normal correction under importance transport: the
    eval / pdf / sampling-weight triangle that ``verification.cpp`` checks.
    With ``scene`` given and media present, densities go through the
    volume conversion (distance pdf, no cosine) and throughputs through
    sigma_s x phase and the free-flight arrival weight."""
    from ..integrators import bdpt
    from ..media import medium as med

    has_media = scene is not None and scene.media.any
    pdf_errs, beta_errs, checked = [], [], 0
    for i in range(1, len(verts)):
        v0, v1 = verts[i - 1], verts[i]
        d01, dist01 = _dir(v0["p"], v1["p"])
        pdf_sa = bdpt._vertex_pdf(scene, v0, d01, has_media)
        if has_media:
            pdf_area = bdpt._conv_density(scene, pdf_sa, v0["p"], v1["p"],
                                          v1["ns"], v1["is_med"], v1["mid"],
                                          True)
        else:
            pdf_area = bdpt._to_area(pdf_sa, v0["p"], v1["p"], v1["ns"])
        ok = v1["valid"] & ~v0["delta"] & (pdf_sa > 1e-6)
        if not bool(ok.any()):
            continue
        fresh = pdf_area[ok]
        pdf_errs.append(float((torch.abs(v1["pdf_fwd"][ok] - fresh)
                               / torch.clamp_min(torch.abs(fresh), 1e-6))
                              .max()))
        f = bdpt._vertex_f(scene, v0, d01, has_media, adjoint=adjoint)
        step = f * (1.0 / torch.clamp_min(pdf_sa, 1e-20))
        if has_media:
            # the free-flight arrival weight of the segment into v1
            ss_m, st_m, _pt, _g = med.medium_params_v(scene.media,
                                                      v1["mid"])
            sbar = bdpt._seg_sigma(scene, v1["mid"])
            tr = med.transmittance_v(st_m, dist01)
            pdf_t = torch.clamp_min(sbar, 1e-20) * torch.exp(-sbar * dist01)
            p_srf = torch.clamp_min(torch.exp(-sbar * dist01), 1e-20)
            step = step * v.where(v1["is_med"], tr * (ss_m / pdf_t),
                                  tr / p_srf)
        b1 = _stack(v1["beta"])[ok]
        expect = (_stack(v0["beta"]) * _stack(step))[ok]
        mag = torch.clamp_min(torch.abs(b1), 1e-4)
        beta_errs.append(float((torch.abs(b1 - expect) / mag).max()))
        checked += int(ok.sum())
    return dict(pdf_err=max(pdf_errs, default=0.0),
                beta_err=max(beta_errs, default=0.0), checked=checked)

