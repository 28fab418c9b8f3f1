"""Port vs reference: the thirteen untextured BSDF families after DIFFUSE
and ROUGHCONDUCTOR (``mitsuba_im_tpu_torch/bsdf``): their record factories,
``resolve_v``, ``bsdf_eval_v``, ``bsdf_pdf_v`` and ``bsdf_sample_v`` on
4,096 random (wi, wo, u) lanes, their derivatives with respect to refl,
spec and alpha, the Fresnel and rough-transmittance helpers, and HK at
g < 0 (ROADMAP C7).

Tolerances are test_torch_helpers' (rel 1e-5, abs 1e-6), bools exact.
Per quantity of ``bsdf_sample_v``, where a test showed it (the last bits
of sin, cos, atan2, log and pow differ between XLA and PyTorch on the CPU):
- ``COS``: the cosine warp's z = sqrt(1 - x^2 - y^2) scales those bits by
  1/z near the rim, so directions agree to abs 4e-6 and pdfs (z / pi) to
  abs 4e-6 (test_torch_scene's bound for DIFFUSE); a weight that depends
  on z through a Fresnel factor (plastic, coating) to rel 1e-4;
- ``MF``: a sampled microfacet normal (the rough families, Ward) or
  Phong's lobe frame grows them by ~1/cos near grazing: directions to abs
  1e-4, weights and pdfs to rel 3e-4 (test_torch_large_scene's bounds for
  the rough conductor);
- ``HK``: as COS, but HK's transmission term (e^{-tau/ci} - e^{-tau/co}) /
  (ci - co) cancels as ci -> co and scales the sampled z's error by
  ~1/|ci - co|, as it scales exp's last bits in eval: weights to rel
  3e-4, eval to rel 1e-4.  The reference's derivative of ``bsdf.alpha`` is taken in
forward mode (``jax.jacfwd``), as in test_torch_diff; the derivatives are
held to 1e-4 of their largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import close, close_v3, jv3, npy, tv3, unit_vectors

from mitsuba_im_tpu.bsdf import common as jbc
from mitsuba_im_tpu.bsdf import eval as jev
from mitsuba_im_tpu.bsdf import fresnel as jfr
from mitsuba_im_tpu.bsdf import rtrans as jrt
from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.core.registry import create as jcreate
from mitsuba_im_tpu.texture.texture import TextureBuilder
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.bsdf import fresnel as tfr
from mitsuba_im_tpu_torch.bsdf import rtrans as trt
from mitsuba_im_tpu_torch.core.v3 import V3

torch.set_num_threads(2)

N = 4096
GRAD_TOL = 1e-4


def _props(name, children=None, **kw):
    p = Properties(name)
    for k, v in kw.items():
        p.set(k, v)
    p.children.update(children or {})
    return p


def _j(name, children=None, **kw):
    return jcreate("bsdf", _props(name, children, **kw))


def _twosided(rec):
    return jcreate("bsdf", _props("twosided", {"bsdf": rec}))


# tolerances of bsdf_sample_v: wo atol, (rtol, atol) of pdf and weight
COS = dict(eval=(1e-5, 1e-6), wo=4e-6, pdf=(1e-5, 4e-6),
           weight=(1e-4, 1e-6))
MF = dict(eval=(1e-5, 1e-6), wo=1e-4, pdf=(3e-4, 1e-6), weight=(3e-4, 1e-5))
HKT = dict(eval=(1e-4, 1e-6), wo=4e-6, pdf=(1e-5, 4e-6),
           weight=(3e-4, 1e-6))

# case -> (reference records, port records, sample tolerances); each case
# also carries a diffuse row, so dispatch selects among types
CASES = {
    # MF's bounds: the cosine lobe's wo.z = sqrt(1 - x^2 - y^2) magnifies
    # the last bit of the libraries' cos/sin near the horizon (1.88e-6 of
    # COS's 4e-6 on one CPU, past it on another)
    "roughdiffuse": (
        [_j("roughdiffuse", reflectance=[0.7, 0.5, 0.3], alpha=0.5),
         _j("roughdiffuse")],
        [tbc.diffuse_record([0.7, 0.5, 0.3], rough=True, alpha=0.5),
         tbc.diffuse_record(rough=True)], MF),
    "roughdiffuse_twosided": (
        [_twosided(_j("roughdiffuse", alpha=0.3))],
        [tbc.twosided(tbc.diffuse_record(rough=True, alpha=0.3))], COS),
    "conductor": (
        [_j("conductor", material="Au"), _j("conductor", material="Ag",
                                            extEta=1.33)],
        [tbc.conductor_record("Au"), tbc.conductor_record("Ag", 1.33)],
        COS),
    "dielectric": (
        [_j("dielectric"), _j("dielectric", intIOR=1.8, extIOR=1.2,
                              specularTransmittance=[0.9, 0.8, 0.7])],
        [tbc.dielectric_record(),
         tbc.dielectric_record(1.8, 1.2, transmittance=[0.9, 0.8, 0.7])],
        COS),
    "thindielectric": (
        [_j("thindielectric", intIORMaterial="water",
            specularReflectance=[0.9, 0.9, 1.0])],
        [tbc.dielectric_record("water", kind=tbc.THINDIELECTRIC,
                               specular=[0.9, 0.9, 1.0])], COS),
    "roughdielectric_aniso": (
        [_j("roughdielectric", distribution="ggx", alphaU=0.08, alphaV=0.3),
         _j("roughdielectric", distribution="beckmann", alpha=0.25,
            intIOR=1.33)],
        [tbc.dielectric_record(kind=tbc.ROUGHDIELECTRIC, alpha_u=0.08,
                               alpha_v=0.3, distribution="ggx"),
         tbc.dielectric_record(1.33, kind=tbc.ROUGHDIELECTRIC, alpha=0.25)],
        MF),
    "plastic": (
        [_j("plastic", diffuseReflectance=[0.1, 0.3, 0.6]),
         _j("plastic", intIOR=1.9)],
        [tbc.plastic_record(diffuse=[0.1, 0.3, 0.6]),
         tbc.plastic_record(1.9)], COS),
    "roughplastic": (
        [_j("roughplastic", distribution="ggx", alpha=0.2,
            diffuseReflectance=[0.6, 0.2, 0.1]),
         _j("roughplastic", alphaU=0.05, alphaV=0.4, intIOR=1.3)],
        [tbc.plastic_record(diffuse=[0.6, 0.2, 0.1], rough=True, alpha=0.2,
                            distribution="ggx"),
         tbc.plastic_record(1.3, rough=True, alpha_u=0.05, alpha_v=0.4)],
        MF),
    "phong": (
        [_j("phong", exponent=40.0, diffuseReflectance=[0.3, 0.5, 0.2],
            specularReflectance=[0.3, 0.3, 0.3]), _j("phong")],
        [tbc.phong_record(40.0, [0.3, 0.5, 0.2], 0.3), tbc.phong_record()],
        MF),
    "ward_aniso": (
        [_j("ward", alphaU=0.1, alphaV=0.35), _j("ward", alpha=0.2)],
        [tbc.ward_record(alpha_u=0.1, alpha_v=0.35),
         tbc.ward_record(0.2)], MF),
    "null": ([_j("null")], [tbc.null_record()], COS),
    "difftrans": (
        [_j("difftrans", transmittance=[0.6, 0.7, 0.5])],
        [tbc.difftrans_record([0.6, 0.7, 0.5])], COS),
    "coating": (
        [_j("coating", {"bsdf": _j("diffuse", reflectance=[0.2, 0.6, 0.3])},
            thickness=0.5, sigmaA=[0.2, 0.4, 0.8]),
         _j("coating", intIOR=1.7)],
        [tbc.coating_record(tbc.diffuse_record([0.2, 0.6, 0.3]),
                            thickness=0.5, sigma_a=[0.2, 0.4, 0.8]),
         tbc.coating_record(int_ior=1.7)], COS),
    "hk": (
        [_j("hk", {"phase": dict(g=0.3)}, sigmaS=[2.0, 1.5, 1.0],
            sigmaA=[0.05, 0.1, 0.2], thickness=0.5),
         _j("hk", {"phase": dict(g=0.5)}, sigmaT=[1.0, 2.0, 3.0],
            albedo=[0.9, 0.5, 0.2])],
        [tbc.hk_record([2.0, 1.5, 1.0], [0.05, 0.1, 0.2], thickness=0.5,
                       g=0.3),
         tbc.hk_record(sigma_t=[1.0, 2.0, 3.0], albedo=[0.9, 0.5, 0.2],
                       g=0.5)],
        HKT),
}


def _tables(case):
    jrecs, trecs, _ = CASES[case]
    for a, b in zip(jrecs, trecs):
        for k in tbc.BSDF_LEAVES:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    jrecs = jrecs + [jbc.default_record()]
    trecs = trecs + [tbc.default_record()]
    return jbc.build_table(jrecs), tbc.build_table(trecs, "cpu")


def _lanes(rng, n_rows):
    ids = rng.integers(0, n_rows, N).astype(np.int32)
    wi, wo = unit_vectors(rng, N), unit_vectors(rng, N)
    wi[:, 2] = np.abs(wi[:, 2])  # three in four lanes from above
    wi[: N // 4, 2] *= -1.0
    u = rng.random((3, N), dtype=np.float32)
    return ids, wi, wo, u


def _resolve(jt, tt, ids):
    uv = np.zeros((2, N), np.float32)
    jp = jbc.resolve_v(jt, TextureBuilder().build(), jnp.asarray(ids),
                       *(jnp.asarray(a) for a in uv))
    return jp, tbc.resolve_v(tt, None, torch.from_numpy(ids))


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_reference(case):
    """Records equal the reference factories' column for column; resolve,
    eval, pdf and sample match, delta and null_passthrough exactly."""
    rng = np.random.default_rng(100 + list(CASES).index(case))
    jt, tt = _tables(case)
    assert tt.used_types == jt.used_types
    ids, wi, wo, u = _lanes(rng, int(tt.type.shape[0]))
    jp, tp = _resolve(jt, tt, ids)
    for k in ("type", "dist", "flags"):
        np.testing.assert_array_equal(npy(getattr(tp, k)),
                                      npy(getattr(jp, k)), err_msg=k)
    for k in ("eta_s", "alpha_u", "alpha_v", "exponent"):
        np.testing.assert_array_equal(npy(getattr(tp, k)),
                                      npy(getattr(jp, k)), err_msg=k)
    for k in ("refl", "spec", "trans", "eta", "k"):
        for a, b in zip(getattr(tp, k), getattr(jp, k)):
            np.testing.assert_array_equal(npy(a), npy(b), err_msg=k)

    tol = CASES[case][2]
    close_v3(tev.bsdf_eval_v(tp, tv3(wi), tv3(wo)),
             jev.bsdf_eval_v(jp, jv3(wi), jv3(wo)), *tol["eval"])
    close(tev.bsdf_pdf_v(tp, tv3(wi), tv3(wo)),
          jev.bsdf_pdf_v(jp, jv3(wi), jv3(wo)))

    jb = jev.bsdf_sample_v(jp, jv3(wi), *(jnp.asarray(a) for a in u))
    tb = tev.bsdf_sample_v(tp, tv3(wi), *(torch.from_numpy(a) for a in u))
    for k in ("delta", "null_passthrough"):
        np.testing.assert_array_equal(npy(getattr(tb, k)),
                                      npy(getattr(jb, k)), err_msg=k)
    close(tb.eta, jb.eta)
    close_v3(tb.wo, jb.wo, atol=tol["wo"])
    close_v3(tb.weight, jb.weight, *tol["weight"])
    close(tb.pdf, jb.pdf, *tol["pdf"])
    # the family does something on these lanes
    fam = npy(tp.type) == int(CASES[case][1][0]["type"])
    assert fam.sum() > N // 4
    got = npy(tb.weight.x)[fam]
    assert np.isfinite(got).all() and (got > 0).mean() > 0.3


def test_ported_types():
    """Sixteen ported types (IRAWAN too, tests/test_torch_irawan.py);
    BUMPMAP_WRAP (a code no record takes) still raises, while MASK and
    BLEND rows resolve into the rows they wrap."""
    assert len(tev.PORTED) == 16 and tbc.IRAWAN in tev.PORTED
    w = tv3(np.tile([[0.0, 0.0, 1.0]], (4, 1)))
    u = torch.full((4,), 0.5)
    zeros = torch.zeros(4, dtype=torch.int32)
    for t in (tbc.BUMPMAP_WRAP,):
        rec = tbc.default_record()
        rec["type"] = t
        table = tbc.build_table([rec], "cpu")
        for fn, args in ((tev.bsdf_eval_v, (w, w)), (tev.bsdf_pdf_v, (w, w)),
                         (tev.bsdf_sample_v, (w, u, u, u))):
            with pytest.raises(NotImplementedError):
                fn(tbc.resolve_v(table, None, zeros), *args)
    inner = tbc.diffuse_record(0.25)
    for wrapper in (tbc.mask_record(1, opacity=1.0),
                    tbc.blend_record(1, 1, weight=0.3)):
        table = tbc.build_table([wrapper, inner], "cpu")
        p = tbc.resolve_v(table, None, zeros, w.x, w.y, u_sel=u)
        np.testing.assert_array_equal(npy(p.type), tbc.DIFFUSE)
        close_v3(tev.bsdf_eval_v(p, w, w), tv3(np.full((4, 3), 0.25 / np.pi)))
        assert float(tev.bsdf_pdf_v(p, w, w)[0]) > 0
        assert float(tev.bsdf_sample_v(p, w, u, u, u, u).weight.x[0]) > 0


def _np_hk(g, tau, albedo, wi, wo):
    """hk.cpp's single-scattering terms in numpy (float64): HG phase,
    reflection albedo p (1 - exp(-tau (1/ci + 1/co))) / (ci + co), the
    transmission albedo p (exp(-tau/ci) - exp(-tau/co)) / (ci - co), times
    |cos_o|."""
    ci = np.maximum(np.abs(wi[:, 2]), 1e-4)[:, None]
    co = np.maximum(np.abs(wo[:, 2]), 1e-4)[:, None]
    cos_t = -(wi * wo).sum(1)[:, None]
    ph = (1 - g * g) / (4 * np.pi * (1 + g * g - 2 * g * cos_t) ** 1.5)
    fr = albedo * ph * (1 - np.exp(-tau * (1 / ci + 1 / co))) / (ci + co)
    ft = albedo * ph * (np.exp(-tau / ci) - np.exp(-tau / co)) / (ci - co)
    same = (wi[:, 2] * wo[:, 2] > 0)[:, None]
    return np.where(same, fr, ft) * co


def test_hk_back_scattering_unclamped():
    """C7: the reference clamps HK's g (kept in alpha_u) to 1e-4; the port
    keeps g < 0 and matches hk.cpp's formula there (on lanes with |ci - co|
    > 0.05: the transmission term cancels as ci -> co)."""
    rng = np.random.default_rng(60)
    g = -0.6
    rec = tbc.hk_record([2.0, 1.5, 1.0], [0.05, 0.1, 0.2], thickness=0.5,
                        g=g)
    tt = tbc.build_table([rec], "cpu")
    tp = tbc.resolve_v(tt, None, torch.zeros(N, dtype=torch.int32))
    assert float(tp.alpha_u[0]) == np.float32(g)
    jrec = _j("hk", {"phase": dict(g=g)}, sigmaS=[2.0, 1.5, 1.0],
              sigmaA=[0.05, 0.1, 0.2], thickness=0.5)
    jp = jbc.resolve_v(jbc.build_table([jrec]), TextureBuilder().build(),
                       jnp.zeros(4, jnp.int32), jnp.zeros(4), jnp.zeros(4))
    assert float(jp.alpha_u[0]) == np.float32(1e-4)  # the reference's clamp

    wi, wo = unit_vectors(rng, N), unit_vectors(rng, N)
    far = np.abs(np.abs(wi[:, 2]) - np.abs(wo[:, 2])) > 0.05
    got = torch.stack(list(tev.bsdf_eval_v(tp, tv3(wi), tv3(wo))), -1)
    want = _np_hk(g, rec["trans"], rec["refl"], wi.astype(np.float64),
                  wo.astype(np.float64))
    np.testing.assert_allclose(npy(got)[far], want[far], rtol=1e-5,
                               atol=1e-6)
    # back-scattering: light arriving along -wo leaves along wi ~ wo (the
    # deflection's cosine is -wi.wo) more than it goes straight on
    back = ((wi * wo).sum(1) > 0.9) & (wi[:, 2] * wo[:, 2] > 0)
    fwd = ((wi * wo).sum(1) < -0.9) & (wi[:, 2] * wo[:, 2] < 0)
    g_pos = _np_hk(0.6, rec["trans"], rec["refl"], wi, wo)
    assert want[back].mean() > g_pos[back].mean()
    assert want[fwd].mean() < g_pos[fwd].mean()


GRAD_CASES = ("roughdiffuse", "roughdielectric_aniso", "plastic",
              "roughplastic", "phong", "ward_aniso", "coating", "hk")


@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled")
@pytest.mark.parametrize("case", GRAD_CASES)
def test_eval_derivatives_match_jacfwd(case):
    """d sum(eval)/d (refl, spec, alpha_u, alpha_v) of the table, by the
    port's reverse mode against the reference's forward mode."""
    rng = np.random.default_rng(61)
    jt, tt = _tables(case)
    ids, wi, wo, _ = _lanes(rng, int(tt.type.shape[0]))
    uv = [jnp.zeros(N)] * 2
    names = ("refl", "spec", "alpha_u", "alpha_v")

    def jf(cols):
        p = jbc.resolve_v(jt.replace(**cols), TextureBuilder().build(),
                          jnp.asarray(ids), *uv)
        return jev.bsdf_eval_v(p, jv3(wi), jv3(wo)).sum().sum()

    ref = jax.jacfwd(jf)({k: getattr(jt, k) for k in names})
    cols = {k: getattr(tt, k).clone().requires_grad_(True) for k in names}
    # anomaly mode raises where any backward step returns a NaN: a masked
    # lane must not turn its zero cotangent into one
    with torch.autograd.detect_anomaly():
        p = tbc.resolve_v(dataclasses.replace(tt, **cols), None,
                          torch.from_numpy(ids))
        ev = tev.bsdf_eval_v(p, tv3(wi), tv3(wo))
        (ev.x.sum() + ev.y.sum() + ev.z.sum()).backward()
    moved = 0.0
    for k in names:
        r = np.asarray(ref[k])
        g = np.zeros_like(r) if cols[k].grad is None else npy(cols[k].grad)
        assert np.isfinite(g).all(), k
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() / scale < GRAD_TOL, (k, g, r)
        moved += np.abs(g).max()
    assert moved > 0


def test_fresnel_and_rtrans_match_reference():
    """fresnel_dielectric on both sides (total internal reflection
    included), fresnel_diffuse_reflectance, and the rough transmittance
    lookups: the integer taps exactly, the interpolated values to float32
    tolerance."""
    rng = np.random.default_rng(62)
    c = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(0.3, 3.5, N).astype(np.float32)
    got = tfr.fresnel_dielectric(torch.from_numpy(c), torch.from_numpy(eta))
    want = jfr.fresnel_dielectric(jnp.asarray(c), jnp.asarray(eta))
    assert (npy(want[0]) == 1.0).sum() > N // 20  # TIR lanes
    for a, b in zip(got, want):
        close(a, b)
    close(tfr.fresnel_diffuse_reflectance(torch.from_numpy(eta)),
          jfr.fresnel_diffuse_reflectance(jnp.asarray(eta)))

    alpha = rng.uniform(0, 1.2, N).astype(np.float32)
    dist = rng.integers(0, 3, N).astype(np.int32)
    tc = [torch.from_numpy(a) for a in (eta, alpha, c)]
    jc = [jnp.asarray(a) for a in (eta, alpha, c)]
    for a, b in zip(trt._grid_coords(*tc), jrt._grid_coords(*jc)):
        close(a, b)
    for f, n in zip(trt._grid_coords(*tc)[1:], (trt.NE, trt.NA, trt.NT)):
        i, w = trt._cell(f, n)
        j = np.clip(np.floor(np.asarray(f)).astype(np.int32), 0, n - 2)
        np.testing.assert_array_equal(npy(i), j)
    close(trt.rtrans_eval_v(torch.from_numpy(dist), tc[2], tc[1], tc[0]),
          jrt.rtrans_eval_v(jnp.asarray(dist), jc[2], jc[1], jc[0]))
    close(trt.rtrans_diffuse_v(torch.from_numpy(dist), tc[1], tc[0]),
          jrt.rtrans_diffuse_v(jnp.asarray(dist), jc[1], jc[0]))


def test_twosided_mirrors_back_faces():
    """A twosided lane seen from below evaluates as the same lane seen from
    above with both directions mirrored, and samples the mirror image."""
    rng = np.random.default_rng(63)
    rec = tbc.twosided(tbc.plastic_record(diffuse=[0.5, 0.3, 0.2],
                                          rough=True, alpha=0.3))
    tt = tbc.build_table([rec], "cpu")
    p = tbc.resolve_v(tt, None, torch.zeros(N, dtype=torch.int32))
    wi, wo = unit_vectors(rng, N), unit_vectors(rng, N)
    wi[:, 2] = -np.abs(wi[:, 2])
    m = np.array([1, 1, -1], np.float32)
    close_v3(tev.bsdf_eval_v(p, tv3(wi), tv3(wo)),
             tev.bsdf_eval_v(p, tv3(wi * m), tv3(wo * m)))
    u = [torch.from_numpy(a) for a in rng.random((3, N), dtype=np.float32)]
    a = tev.bsdf_sample_v(p, tv3(wi), *u)
    b = tev.bsdf_sample_v(p, tv3(wi * m), *u)
    close_v3(a.wo, V3(b.wo.x, b.wo.y, -b.wo.z))
    close_v3(a.weight, b.weight)
