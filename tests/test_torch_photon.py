"""Port vs reference: photon mapping, VPL and irradiance caching
(``mitsuba_im_tpu_torch/integrators/{sppm,vpl,irrcache}.py``), on the CPU.

Exact: the cell hash, the grid's sorted order and the neighbour runs on
photons that share cells and keys.  At f32 tolerance (rtol 1e-4, atol
1e-6 unless stated; the reference sums in its loop order, the port in the
same order per pixel): the gather on random photons, ``photon_trace``
(surface photons on the Cornell box, rtol 2e-5; volume photons in its
homogeneous-medium variant, rtol 1e-4; the valid flags exact),
``eye_pass``, one ``sppm_pass``, ``beam_gather``, ``vpl_pass`` and the
irradiance cache's dense and grid gathers.  ``render_irrcache`` with the
records' estimate, the sppm and vpl means against the path tracer and the
command line of each name are in tests/test_torch_adaptive.py, beside the
adaptive render, whose nested path tracer compiles the same eager
primitives of the reference.  The reference runs eagerly
(``jax.disable_jit``) at 16^2, with 256 lanes wherever it can, so that
each of its primitives compiles once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy
from test_torch_bdpt import jax_medium_cornell

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.integrators import irrcache as jirr
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.integrators import sppm as jsp
from mitsuba_im_tpu.integrators import vpl as jvpl
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.integrators import irrcache as tirr
from mitsuba_im_tpu_torch.integrators import path as tpath
from mitsuba_im_tpu_torch.integrators import sppm as tsp
from mitsuba_im_tpu_torch.integrators import vpl as tvpl

torch.set_num_threads(2)

RES = 16
N = RES * RES  # pixels, photon paths, VPL paths and cache records alike:
BOUNCES = 2  # one lane count and one photon count (N x BOUNCES) keep the
M = N * BOUNCES  # reference's eager primitives to one compile each
SEED = 7
RTOL, ATOL = 1e-4, 1e-6


def _a(x) -> np.ndarray:
    """A port V3 as (n, 3), any other value as numpy."""
    if isinstance(x, V3):
        return np.stack([npy(c) for c in x], -1)
    return npy(x)


def _t3(a) -> V3:
    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_a(a), npy(b), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def cornell():
    jscene, jsettings = jax_cornell()
    return jscene, bridged(jscene), jsettings


@pytest.fixture(scope="module")
def eye_both(cornell):
    """Both packages' eye passes on the Cornell box (sppm's six delta
    bounces), 16^2."""
    jscene, tscene, _ = cornell
    with jax.disable_jit():
        ref = jsp.eye_pass(jscene, jrng.make_sampler(
            jnp.arange(N, dtype=jnp.uint32), 0, SEED), RES, RES, 6)
    out = tsp.eye_pass(tscene, trng.make_sampler_v(torch.arange(N), 0, SEED),
                       RES, RES, 6)
    return ref, out


def _photons(rng, centers, n, r):
    """n photons around the points ``centers`` (within ~r), a quarter of
    them at shared positions (equal cells and keys), with random powers
    and directions."""
    c = centers[rng.integers(0, len(centers), n)]
    p = (c + rng.normal(scale=r, size=(n, 3))).astype(np.float32)
    p[n // 2: n // 2 + n // 4] = p[: n // 4]
    wi = rng.normal(size=(n, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    power = rng.random((n, 3), dtype=np.float32)
    valid = rng.random(n) > 0.1
    return p, power, wi, valid


def test_cell_hash_and_grid_match_reference():
    rng = np.random.default_rng(1)
    p, _power, _wi, valid = _photons(
        rng, rng.uniform(-2, 2, (40, 3)).astype(np.float32), 4096, 0.2)
    cell = np.float32(0.25)
    c = np.floor(p / cell).astype(np.int32)
    jh = npy(jsp._cell_hash(jnp.asarray(c)))
    th = npy(tsp._cell_hash(*(torch.from_numpy(c[:, k].astype(np.int64))
                              for k in range(3))))
    np.testing.assert_array_equal(th, jh.astype(np.int64))
    # negative coordinates hash as their uint32 words
    assert (c < 0).any()
    jorder, jb = jsp.build_grid(jnp.asarray(p), jnp.asarray(valid),
                                jnp.asarray(cell))
    torder, tb = tsp.build_grid(_t3(p), torch.from_numpy(valid),
                                tsp.cell_tensor(cell, "cpu"))
    np.testing.assert_array_equal(npy(torder), npy(jorder))
    np.testing.assert_array_equal(npy(tb), npy(jb).astype(np.int64))
    # the runs of every query cell, exact
    q = p[::7]
    starts, runs, fulls = tsp.neighbour_runs(tb, _t3(q),
                                             tsp.cell_tensor(cell, "cpu"), 8)
    cq = np.floor(q / cell).astype(np.int32)
    offs = np.asarray(tsp._OFFS, np.int32)
    jbk = jsp._cell_hash(jnp.asarray(cq[None] + offs[:, None]))
    js = np.asarray(jnp.searchsorted(jb, jbk, side="left")).T
    je = np.asarray(jnp.searchsorted(jb, jbk, side="right")).T
    np.testing.assert_array_equal(npy(starts), js)
    np.testing.assert_array_equal(npy(fulls), je - js)
    np.testing.assert_array_equal(npy(runs), np.minimum(je - js, 8))
    assert (je - js).max() > 8  # some runs are capped


def test_gather_matches_reference(cornell, eye_both):
    """The density estimate on random photons around the eye vertices, the
    same inputs in both packages, capped runs included."""
    jscene, tscene, _ = cornell
    (_pos, jst, jgat, _prim), _ = eye_both
    rng = np.random.default_rng(2)
    x = np.asarray(jst["p"])
    cell = np.float32(0.12)
    p, power, wi, valid = _photons(rng, x, M, 0.06)
    r2 = (rng.uniform(0.3, 1.0, N).astype(np.float32) * cell * cell)
    cap = 4
    jorder, jb = jsp.build_grid(jnp.asarray(p), jnp.asarray(valid),
                                jnp.asarray(cell))
    with jax.disable_jit():
        jbp = jscene.bsdf_at(jpath._fake_it(jst))
        jflux, jcnt = jsp.gather(
            jnp.asarray(p), jnp.asarray(power), jnp.asarray(wi), jorder, jb,
            jst["p"], jst["ss"], jst["ts"], jst["ns"], jst["wi_local"], jbp,
            jnp.asarray(r2), jnp.asarray(cell), cap)
    torder, tb = tsp.build_grid(_t3(p), torch.from_numpy(valid),
                                tsp.cell_tensor(cell, "cpu"))
    tst = {k: _t3(np.asarray(jst[k])) for k in ("p", "ss", "ts", "ns",
                                                 "wi_local")}
    uv = np.asarray(jst["uv"])
    tbp = tscene.bsdf_at_v(tpath._fake_it_v(dict(
        tst, ng=tst["ns"], uv_u=torch.from_numpy(uv[:, 0].copy()),
        uv_v=torch.from_numpy(uv[:, 1].copy()),
        shape=torch.from_numpy(np.asarray(jst["shape"])),
        active=torch.from_numpy(np.asarray(jst["active"])))))
    tflux, tcnt = tsp.gather(
        _t3(p), _t3(power), _t3(wi), torder, tb, tst["p"],
        (tst["ss"], tst["ts"], tst["ns"]), tst["wi_local"], tbp,
        torch.from_numpy(r2), tsp.cell_tensor(cell, "cpu"), cap)
    # the pixels whose rays escaped sit at ~1e37 (the sppm pass masks them)
    g = np.asarray(jgat)
    assert (npy(tcnt)[g] > 0).mean() > 0.5  # most pixels find photons
    _close(npy(tcnt)[g], npy(jcnt)[g], 1e-5, 0.0, "count")
    _close(_a(tflux)[g], npy(jflux)[g], 1e-5, 1e-7, "flux")
    # the lanes a caller masks are skipped
    _f, cnt = tsp.gather(
        _t3(p), _t3(power), _t3(wi), torder, tb, tst["p"],
        (tst["ss"], tst["ts"], tst["ns"]), tst["wi_local"], tbp,
        torch.from_numpy(r2), tsp.cell_tensor(cell, "cpu"), cap,
        active=torch.from_numpy(g))
    np.testing.assert_array_equal(npy(cnt), np.where(g, npy(tcnt), 0.0))


@pytest.mark.parametrize("case", ["surface", "volume"])
def test_photon_trace_matches_reference(case):
    jscene, _ = jax_cornell() if case == "surface" else jax_medium_cornell()
    tscene = bridged(jscene)
    with jax.disable_jit():
        ref = jsp.photon_trace(
            jscene, jrng.make_sampler(jnp.arange(N, dtype=jnp.uint32), 0,
                                      SEED), N, BOUNCES, rr_depth=1,
            want_surface=True, want_volume=True)
    out = tsp.photon_trace(tscene, trng.make_sampler_v(torch.arange(N), 0,
                                                       SEED),
                           BOUNCES, rr_depth=1, want_surface=True,
                           want_volume=True)
    np.testing.assert_array_equal(npy(out[3]), npy(ref[3]))
    assert npy(out[3]).mean() > 0.15
    ok = npy(ref[3])
    # a volume event's distance is a logarithm: rtol 1e-4 after one
    rtol, atol = (2e-5, 2e-6) if case == "surface" else (1e-4, 1e-5)
    for k, name in enumerate(("p", "power", "wi")):
        np.testing.assert_allclose(_a(out[k])[ok], npy(ref[k])[ok],
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("ns", "ss", "ts"):
        np.testing.assert_allclose(_a(out[4][name])[ok],
                                   npy(ref[4][name])[ok], rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_array_equal(npy(out[4]["shape"])[ok],
                                  npy(ref[4]["shape"])[ok])
    vout, vref = out[5], ref[5]
    np.testing.assert_array_equal(npy(vout[3]), npy(vref[3]))
    if case == "volume":
        vok = npy(vref[3])
        assert vok.mean() > 0.02
        for k, name in enumerate(("p", "power", "wi")):
            np.testing.assert_allclose(_a(vout[k])[vok], npy(vref[k])[vok],
                                       rtol=rtol, atol=atol, err_msg=name)


def test_eye_pass_matches_reference(eye_both):
    (jpos, jst, jgat, jprim), ((px, py), tst, tgat, tprim) = eye_both
    np.testing.assert_array_equal(npy(tgat), npy(jgat))
    assert npy(tgat).mean() > 0.5
    np.testing.assert_allclose(np.stack([npy(px), npy(py)], -1),
                               npy(jpos), rtol=1e-6)
    g = npy(jgat)
    for k in ("p", "ns", "wi_local", "thr"):
        _close(_a(tst[k])[g], npy(jst[k])[g], 2e-5, 2e-6, k)
    _close(tst["le"], jst["le"], 2e-5, 1e-6, "le")
    _close(tprim["t"], jprim["t"], 2e-5, 1e-6, "t")
    np.testing.assert_array_equal(npy(tst["shape"])[g], npy(jst["shape"])[g])


def _stats0(n, r0, dev="cpu"):
    z = np.zeros((n, 3), np.float32)
    jst = dict(r2=jnp.full((n,), r0 * r0, jnp.float32),
               n=jnp.zeros((n,), jnp.float32), tau=jnp.asarray(z),
               ld=jnp.asarray(z))
    tz = torch.zeros(n)
    tst = dict(r2=torch.full((n,), r0 * r0), n=tz, tau=V3(tz, tz, tz),
               ld=V3(tz, tz, tz))
    return jst, tst


def test_sppm_pass_matches_reference(cornell):
    jscene, tscene, _ = cornell
    r0 = 0.08 * float(jscene.emitters.bsphere_radius)
    jst, tst = _stats0(N, r0)
    # runs of a few photons, under the cap: which photons a capped run
    # keeps turns on their cells, and the floor's photons lie on a cell
    # boundary (y = 0), where the last bit of y picks the cell
    kw = dict(width=RES, height=RES, n_photons=N, max_bounces=BOUNCES,
              cap=8, alpha=0.7)
    with jax.disable_jit():
        jst = jsp.sppm_pass(jscene, jst, jnp.uint32(1), jnp.uint32(SEED),
                            jnp.asarray(r0, jnp.float32), **kw)
    tst = tsp.sppm_pass(tscene, tst, 1, SEED, tsp.cell_tensor(r0, "cpu"),
                        **kw)
    assert (npy(tst["n"]) > 0).mean() > 0.5
    for k in ("r2", "n", "tau", "ld"):
        _close(tst[k], jst[k], 1e-4, 1e-6, k)


def test_beam_gather_matches_reference():
    """The beam estimate in the homogeneous HG fog on the reference's
    volume photons, the same inputs in both packages (2 steps, cap 4)."""
    jscene, _ = jax_medium_cornell()
    tscene = bridged(jscene)
    with jax.disable_jit():
        _p, _pw, _wi, _v, (vp, vpow, vwi, vv) = jsp.photon_trace(
            jscene, jrng.make_sampler(jnp.arange(N, dtype=jnp.uint32), 1,
                                      SEED), N, BOUNCES, want_volume=True)
        (_pos, _st, _g, prim) = jsp.eye_pass(jscene, jrng.make_sampler(
            jnp.arange(N, dtype=jnp.uint32), 0, SEED), RES, RES, 6)
    vp, vpow, vwi, vv = (np.asarray(a) for a in (vp, vpow, vwi, vv))
    assert vv.sum() > 30
    cell = np.float32(0.3)
    u = np.random.default_rng(4).random(N, dtype=np.float32)
    jo, jbk = jsp.build_grid(jnp.asarray(vp), jnp.asarray(vv),
                             jnp.asarray(cell))
    with jax.disable_jit():
        ref = jsp.beam_gather(jscene, jnp.asarray(vp), jnp.asarray(vpow),
                              jnp.asarray(vwi), jo, jbk, prim["o"],
                              prim["d"], prim["t"], prim["mid"],
                              jnp.asarray(cell), 4, 2, jnp.asarray(u))
    cell_t = tsp.cell_tensor(cell, "cpu")
    to, tbk = tsp.build_grid(_t3(vp), torch.from_numpy(vv), cell_t)
    out = tsp.beam_gather(
        tscene, _t3(vp), _t3(vpow), _t3(vwi), to, tbk,
        _t3(np.asarray(prim["o"])), _t3(np.asarray(prim["d"])),
        torch.from_numpy(np.asarray(prim["t"])),
        torch.from_numpy(np.asarray(prim["mid"])), cell_t, 4, 2,
        torch.from_numpy(u))
    assert (_a(out).sum(1) > 0).mean() > 0.25
    _close(out, ref, 1e-4, 1e-7, "beam")


def test_vpl_pass_matches_reference(cornell):
    """One pass lit by 16 light paths x 2 bounces: the reference jitted
    (eagerly, its loop compiles its slices anew for every VPL index)."""
    jscene, tscene, _ = cornell
    cd = float(np.float32(0.05 * float(jscene.emitters.bsphere_radius)))
    kw = dict(width=RES, height=RES, n_paths=16, max_bounces=2)
    ref = jvpl.vpl_pass(jscene, jnp.zeros((RES, RES, 3)), jnp.uint32(1),
                        jnp.uint32(SEED), clamp_dist=jnp.asarray(
                            cd, jnp.float32), **kw)
    old = tvpl.VPL_LANES
    tvpl.VPL_LANES = 5 * N  # five VPLs a wavefront, a partial last one
    try:
        out = tvpl.vpl_pass(tscene, torch.zeros((N, 3)), 1, SEED,
                            clamp_dist=cd, **kw)
    finally:
        tvpl.VPL_LANES = old
    ref = npy(ref).reshape(-1, 3)
    assert ref.mean() > 0
    np.testing.assert_allclose(npy(out), ref, rtol=1e-4, atol=1e-6)


def _records(rng, m):
    """Synthetic cache records: compact ones and a few long-reach ones."""
    p = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    n = rng.normal(size=(m, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    e = rng.random((m, 3), dtype=np.float32)
    r = (rng.uniform(0.05, 0.3, m) ** 2).astype(np.float32)
    r[:40] = rng.uniform(3.0, 10.0, 40)
    valid = rng.uniform(size=m) > 0.05
    return p, n, e, r, valid


@pytest.mark.parametrize("mode", ["dense", "grid"])
def test_gather_cache_matches_reference(mode, monkeypatch):
    """Ward's blend on synthetic records, the same inputs in both packages:
    every record dense (256), and the hybrid gather (512: the 256 of
    largest R dense, the rest in the grid, 8 a cell in both packages)."""
    monkeypatch.setattr(jirr, "GRID_CAP", 8)
    monkeypatch.setattr(tirr, "GRID_CAP", 8)
    rng = np.random.default_rng(5)
    m = N if mode == "dense" else M
    p, n, e, r, valid = _records(rng, m)
    q = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    # query normals of their own: a normal equal to a record's puts
    # sqrt(1 - n.n_i) on its rounding (0 or 2.4e-4)
    qn = rng.normal(size=(256, 3))
    qn = (qn / np.linalg.norm(qn, axis=1, keepdims=True)).astype(np.float32)
    quality = 1.2
    jgrid = tgrid = None
    if mode == "grid":
        order_r = np.argsort(np.where(valid, -r, np.inf))
        dense_ids = np.sort(order_r[:jirr.K_DENSE]).astype(np.int32)
        gm = valid.copy()
        gm[dense_ids] = False
        cell = np.float32(max(quality * float(r[gm].max()), 1e-4))
        jo, jbk = jsp.build_grid(jnp.asarray(p), jnp.asarray(gm),
                                 jnp.asarray(cell))
        jgrid = (jnp.asarray(dense_ids), jo, jbk, jnp.asarray(cell))
        ct = tsp.cell_tensor(cell, "cpu")
        to, tbk = tsp.build_grid(_t3(p), torch.from_numpy(gm), ct)
        tgrid = (torch.from_numpy(dense_ids.astype(np.int64)), to, tbk, ct)
    with jax.disable_jit():
        ref = jirr._gather_cache(jnp.asarray(q), jnp.asarray(qn),
                                 jnp.asarray(p), jnp.asarray(n),
                                 jnp.asarray(e), jnp.asarray(r),
                                 jnp.asarray(valid),
                                 jnp.asarray(quality, jnp.float32),
                                 grid=jgrid)
    rec = dict(p=_t3(p), n=_t3(n), E=torch.from_numpy(e),
               R=torch.from_numpy(r), valid=torch.from_numpy(valid))
    out = tirr.gather_cache(_t3(q), _t3(qn), rec, quality, tgrid)
    assert npy(ref).mean() > 0
    np.testing.assert_allclose(npy(out), npy(ref), rtol=1e-4, atol=1e-6)
