"""Port vs reference: the bidirectional path tracer
(``mitsuba_im_tpu_torch/integrators/bdpt.py``) and the path-space
verification harness (``bidir/verification.py``), on the CPU.

The same per-lane samplers and camera rays go through both packages: the
eye and light subpaths of ``random_walk`` (256 lanes, every vertex's
geometry, throughput, densities and flags), the MIS weight of every
(s, t) strategy up to max_depth 4 on those subpaths, and ``bdpt_sample``'s
radiance and light-image splats at 16^2 (max_depth 2 with the emitters
hidden, 4 with them shown), on the Cornell box and on a scene with
homogeneous HG media (a ``null`` icosahedron and the camera's fog), all
to f32 tolerance; ``render_bdpt`` with and without the light image under
parity_check.py's gate.  The reference runs eagerly (``jax.disable_jit``).

The port alone: a Kajiya-Kay medium vertex's f and densities are the
port's phase functions, not the reference's isotropic stand-in (ROADMAP
C16; bdpt against volpath there is a card test, tests/test_torch_cuda.py,
as 16^2 on the CPU is too noisy for it); the verification harness on the
eye, light and medium subpaths (errors <= 1e-3, as the reference's
slow-marked tests/test_verification.py asks); and ``python -m
mitsuba_im_tpu_torch`` with ``<integrator type="bdpt"/>`` writes
``render()``'s image.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy, parity_gate, tv3
from test_render import CORNELL_XML

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.integrators import bdpt as jbd
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import sample_ray as jsample_ray
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.bidir.verification import verify_walk
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.core import v3 as tv
from mitsuba_im_tpu_torch.film.film import F_BOX
from mitsuba_im_tpu_torch.integrators import bdpt as tbd
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.media import medium as tmed
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.sensor.table import S_PERSPECTIVE, sample_ray_v

torch.set_num_threads(2)

RES = 16
N = RES * RES
SEED = 7
RTOL, ATOL = 2e-5, 1e-6


def _hg(sigma_s, sigma_a, g):
    return dict(kind="homogeneous", sigma_s=np.full(3, sigma_s),
                sigma_a=np.full(3, sigma_a), scale=1.0,
                phase=dict(type=tmed.PH_HG, g=g))


def jax_medium_cornell(inner=None):
    """The Cornell box with a ``null`` icosahedron around a homogeneous
    medium (HG g 0.6 unless ``inner`` is another record) on the floor, and
    the camera and the icosahedron's outside in an HG fog; built by the
    JAX package, 16^2, bdpt."""
    b = JBuilder()
    scenes._cornell_box(b)
    b.media_records += [_hg(0.15, 0.02, 0.5),
                        inner or _hg(1.6, 0.1, 0.6)]
    null = b.add_bsdf(tbc.null_record())
    b.add_trimesh(scenes.icosahedron((0.0, 0.45, 0.1), 0.4),
                  b.new_shape(null, interior=1, exterior=0))
    b.camera_medium = 0
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(S_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    b.settings.width = b.settings.height = RES
    b.settings.rfilter = F_BOX
    b.settings.integrator = "bdpt"
    b.settings.integrator_props = dict(max_depth=3)
    return b.build()


@pytest.fixture(scope="module")
def cornell():
    jscene, jsettings = jax_cornell()
    return jscene, bridged(jscene), jsettings


@pytest.fixture(scope="module")
def medium_cornell():
    jscene, jsettings = jax_medium_cornell()
    return jscene, bridged(jscene), jsettings


def _camera(jscene, tscene):
    """Both packages' samplers after the camera block and the camera rays
    of N lanes."""
    with jax.disable_jit():
        js = jrng.make_sampler(jnp.arange(N, dtype=jnp.uint32), 0, SEED)
        js, blk = jrng.next_block4(js)
        o, d, _ = jsample_ray(jscene.sensor, blk[..., :2], blk[..., 2:4])
    ts = trng.make_sampler_v(torch.arange(N), 0, SEED)
    ts, tb = trng.next_block4_v(ts)
    to, td, _ = sample_ray_v(tscene.sensor, tb[0], tb[1], tb[2], tb[3])
    return (js, o, d), (ts, to, td)


def _a(x) -> np.ndarray:
    """A port V3 as (N, 3), any other value as numpy."""
    if isinstance(x, tv.V3):
        return np.stack([npy(c) for c in x], -1)
    return npy(x)


def _walks(jscene, tscene, depth):
    """(reference, port) eye and light subpaths, each as (vertices, light
    origin or None), of N lanes."""
    (js, o, d), (ts, to, td) = _camera(jscene, tscene)
    has_media = tscene.media.any
    with jax.disable_jit():
        m0 = (jnp.full((N,), jscene.camera_medium, jnp.int32)
              if has_media else None)
        jeye, js, _, _ = jbd.random_walk(
            jscene, js, o, d, jnp.ones((N, 3)), jbd.camera_pdf_dir(jscene, d),
            depth, o, d, medium0=m0)
        js, lb = jrng.next_block4(js)
        js, lb2 = jrng.next_block4(js)
        jl0 = jbd.sample_light_origin(jscene, lb[..., 0], lb[..., 1:3],
                                      lb2[..., 0:2])
        cos0 = jnp.where(jl0["delta"], 1.0,
                         jnp.abs(jnp.sum(jl0["ns"] * jl0["d"], -1)))
        jbeta = jl0["le"] * (cos0 / jnp.maximum(
            jl0["pdf_fwd"] * jl0["pdf_dir"], 1e-20))[..., None]
        jlight, _, _, _ = jbd.random_walk(
            jscene, js, jl0["p"], jl0["d"], jbeta, jl0["pdf_dir"], depth - 1,
            jl0["p"], jl0["ns"], adjoint=True, infinite0=jl0["infinite"],
            medium0=m0)
    m0 = (torch.full((N,), tscene.camera_medium, dtype=torch.int32)
          if has_media else None)
    teye, ts, _, _ = tbd.random_walk(
        tscene, ts, to, td, tv.ones((N,), "cpu"),
        tbd.camera_pdf_dir(tscene, td), depth, to, td, medium0=m0)
    ts, lb = trng.next_block4_v(ts)
    ts, lb2 = trng.next_block4_v(ts)
    tl0 = tbd.sample_light_origin(tscene, lb[0], lb[1], lb[2], lb2[0],
                                  lb2[1])
    cos0 = torch.where(tl0["delta"], 1.0, torch.abs(tl0["ns"].dot(tl0["d"])))
    tbeta = tl0["le"] * (cos0 / torch.clamp_min(
        tl0["pdf_fwd"] * tl0["pdf_dir"], 1e-20))
    tlight, _, _, _ = tbd.random_walk(
        tscene, ts, tl0["p"], tl0["d"], tbeta, tl0["pdf_dir"], depth - 1,
        tl0["p"], tl0["ns"], adjoint=True, infinite0=tl0["infinite"],
        medium0=m0)
    return (jeye, jl0, jlight), (teye, tl0, tlight)


@pytest.fixture(scope="module")
def cornell_walks(cornell):
    jscene, tscene, _ = cornell
    return _walks(jscene, tscene, 4)


VERTEX_KEYS = ("p", "ns", "beta", "pdf_fwd", "pdf_rev")


@pytest.mark.parametrize("side", ["eye", "light"])
def test_random_walk_matches_reference(cornell_walks, side):
    (jeye, jl0, jlight), (teye, tl0, tlight) = cornell_walks
    ref, out = (jeye, teye) if side == "eye" else (jlight, tlight)
    assert len(out) == len(ref) == (4 if side == "eye" else 3)
    for k in ("p", "ns", "le", "pdf_fwd", "pdf_dir", "d"):
        np.testing.assert_allclose(_a(tl0[k]), npy(jl0[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for i, (r, o) in enumerate(zip(ref, out)):
        for k in ("valid", "delta", "emitter"):
            np.testing.assert_array_equal(npy(o[k]), npy(r[k]),
                                          err_msg=f"{k} {i}")
        ok = npy(r["valid"])
        assert ok.any()
        for k in VERTEX_KEYS:
            # a density divides by a cosine, which magnifies its rounding
            # at grazing lanes (one lane in 149 at 1.6e-4 here); positions
            # in the box of side 2 carry 6e-6 after three bounces
            np.testing.assert_allclose(
                _a(o[k])[ok], npy(r[k])[ok],
                rtol=1e-3 if k.startswith("pdf") else 1e-4,
                atol=2e-5 if k == "p" else ATOL, err_msg=f"{k} {i}")


def test_mis_weight_every_strategy(cornell, cornell_walks):
    """mis_weight of every (s, t) with s + t - 1 <= 4 edges on the walks,
    with the connection's overrides taken as both packages' (seeded)
    densities."""
    jscene, tscene, _ = cornell
    (jeye, jl0, jlight), (teye, tl0, tlight) = cornell_walks
    rng = np.random.default_rng(5)
    jcam = dict(p=jnp.zeros((N, 3)), pdf_fwd=jnp.ones(N),
                pdf_rev=jnp.zeros(N))
    tcam = dict(p=tv.zeros((N,), "cpu"), pdf_fwd=torch.ones(N),
                pdf_rev=torch.zeros(N))
    jl0 = dict(jl0, pdf_rev=jnp.asarray(rng.random(N, dtype=np.float32)))
    tl0 = dict(tl0, pdf_rev=torch.from_numpy(npy(jl0["pdf_rev"]).copy()))
    jlv, tlv = [jl0] + list(jlight), [tl0] + list(tlight)
    count = 0
    for s in range(0, 5):
        for t in range(1, 6):
            if s + t < 2 or s + t - 1 > 4 or s > len(jlv) or t - 1 > len(jeye):
                continue
            ov = rng.random((2, N), dtype=np.float32) + 0.05
            jov, tov = {}, {}
            if t >= 2:
                jov[("eye", t - 1)] = jnp.asarray(ov[0])
                tov[("eye", t - 1)] = torch.from_numpy(ov[0])
            if s >= 1:
                jov[("light", s - 1)] = jnp.asarray(ov[1])
                tov[("light", s - 1)] = torch.from_numpy(ov[1])
            with jax.disable_jit():
                ref = jbd.mis_weight(jscene, jlv[:s], [jcam] + list(
                    jeye[:t - 1]), s, t, jov)
            out = tbd.mis_weight(tscene, tlv[:s], [tcam] + teye[:t - 1], s,
                                 t, tov)
            ref = np.broadcast_to(npy(ref), (N,))
            np.testing.assert_allclose(npy(out), ref, rtol=1e-4, atol=1e-7,
                                       err_msg=f"s {s} t {t}")
            assert (npy(out) > 0).all() and (npy(out) <= 1.0).all()
            count += 1
    assert count == 14


def _bdpt_sample_both(jscene, tscene, depth, hide):
    (js, o, d), (ts, to, td) = _camera(jscene, tscene)
    with jax.disable_jit():
        jli, juv, jval = jbd.bdpt_sample(jscene, js, o, d, depth, hide)
    tli, splats = tbd.bdpt_sample(tscene, ts, to, td, depth, hide)
    return (npy(jli), npy(juv), npy(jval)), (_a(tli), splats)


def _check_sample(ref, out):
    (jli, juv, jval), (tli, splats) = ref, out
    np.testing.assert_allclose(tli, jli, rtol=1e-4, atol=1e-6)
    assert len(splats) == jval.shape[0]
    for k, (u, w, val) in enumerate(splats):
        val = _a(val)
        np.testing.assert_allclose(val, jval[k], rtol=1e-4, atol=1e-7)
        ok = (jval[k] != 0).any(-1)
        np.testing.assert_array_equal((val != 0).any(-1), ok)
        uv = np.stack([npy(u), npy(w)], -1)
        np.testing.assert_allclose(uv[ok], juv[k][ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth,hide", [(2, True), (4, False)])
def test_bdpt_sample_matches_reference(cornell, depth, hide):
    jscene, tscene, _ = cornell
    ref, out = _bdpt_sample_both(jscene, tscene, depth, hide)
    _check_sample(ref, out)
    assert ref[0].mean() > 0


def test_bdpt_sample_homogeneous_media_match_reference(medium_cornell):
    jscene, tscene, _ = medium_cornell
    ref, out = _bdpt_sample_both(jscene, tscene, 3, False)
    _check_sample(ref, out)
    assert ref[0].mean() > 0


@pytest.mark.parametrize("light_image", [True, False])
def test_render_bdpt_matches_reference(cornell, light_image):
    """16^2, depth 2, one pass through the render loops, under the gate."""
    jscene, tscene, jsettings = cornell
    settings = dataclasses.replace(
        jsettings, width=RES, height=RES, integrator="bdpt",
        integrator_props=dict(max_depth=2, light_image=light_image))
    with jax.disable_jit():
        ref = npy(jjob.render(jscene, settings, spp=1))
    img = npy(tjob.render(tscene, settings, spp=1))
    assert np.isfinite(img).all() and (img >= 0).all()
    st = parity_gate(img.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


def _medium_vertex(tscene, mid: int, rng):
    """A vertex dict of N medium vertices in medium ``mid`` with seeded
    arrival directions, and seeded outgoing directions."""
    from test_torch_helpers import unit_vectors

    p = tv3(rng.uniform(-0.3, 0.3, (N, 3)) + np.array([0.0, 0.45, 0.1]))
    wi, wo = tv3(unit_vectors(rng, N)), tv3(unit_vectors(rng, N))
    mids = torch.full((N,), mid, dtype=torch.int32)
    fr = tv.frame_from_normal(wi)
    zeros = tv.zeros((N,), "cpu")
    bp = tscene.bsdf_at_v(tscene.interaction_v(
        p, -wi, tscene.ray_intersect_v(p, -wi)))
    vx = dict(p=p, ns=wi, ng=wi, ss=fr[0], ts=fr[1], wi_local=zeros, bp=bp,
              is_med=torch.ones(N, dtype=torch.bool), mid=mids, wi_world=wi,
              ctx=tmed.phase_ctx_v(tscene.media, mids, p))
    return vx, wi, wo


def test_medium_vertex_phase_c16():
    """A Kajiya-Kay medium vertex's f and densities are the port's phase
    functions (ROADMAP C16: the reference's phase_eval gives it an
    isotropic lobe); an HG vertex's equal the reference's phase_eval."""
    from mitsuba_im_tpu.media import medium as jmed

    kkay = dict(kind="homogeneous", sigma_s=np.full(3, 1.2),
                sigma_a=np.full(3, 0.3), scale=1.0,
                phase=dict(type=tmed.PH_KKAY, g=0.0, kd=0.2, ks=0.4,
                           exponent=4.0))
    jscene, _ = jax_medium_cornell(kkay)
    tscene = bridged(jscene)
    rng = np.random.default_rng(9)
    vx, wi, wo = _medium_vertex(tscene, 1, rng)
    ctx, media = vx["ctx"], tscene.media
    f = _a(tbd._vertex_f(tscene, vx, wo, True))
    ph = npy(tmed.phase_eval_ctx_v(media, ctx, wi, wo))
    np.testing.assert_array_equal(f, np.stack([ph] * 3, -1))
    np.testing.assert_array_equal(
        npy(tbd._vertex_pdf(tscene, vx, wo, True)),
        npy(tmed.phase_pdf_ctx_v(media, ctx, wi, wo)))
    np.testing.assert_array_equal(
        npy(tbd._vertex_pdf(tscene, vx, wo, True, reverse=True)),
        npy(tmed.phase_pdf_ctx_v(media, ctx, wo, wi)))
    # the lobe is not the isotropic stand-in
    assert np.abs(ph - 1.0 / (4.0 * np.pi)).max() > 1e-2

    vx, wi, wo = _medium_vertex(tscene, 0, rng)  # the HG fog
    jpt, jg = jnp.full(N, tmed.PH_HG), jnp.full(N, 0.5, jnp.float32)
    ref = npy(jmed.phase_eval(jpt, jg, jnp.asarray(_a(wi)),
                              jnp.asarray(_a(wo))))
    for out in (_a(tbd._vertex_f(tscene, vx, wo, True))[:, 0],
                npy(tbd._vertex_pdf(tscene, vx, wo, True)),
                npy(tbd._vertex_pdf(tscene, vx, wo, True, reverse=True))):
        np.testing.assert_allclose(out, ref, rtol=2e-6, atol=0)


@pytest.mark.parametrize("case", ["eye", "light", "medium_eye",
                                  "medium_light"])
def test_verify_walk(cornell, medium_cornell, case):
    """The cached densities and throughputs of the port's subpaths derive
    again from their vertices within 1e-3 (verification.cpp's check)."""
    _, tscene, _ = medium_cornell if case.startswith("medium") else cornell
    (ts, to, td) = _camera(*(medium_cornell if case.startswith("medium")
                             else cornell)[:2])[1]
    m0 = (torch.full((N,), tscene.camera_medium, dtype=torch.int32)
          if tscene.media.any else None)
    if case.endswith("eye"):
        verts = tbd.random_walk(tscene, ts, to, td, tv.ones((N,), "cpu"),
                                tbd.camera_pdf_dir(tscene, td), 4, to, td,
                                medium0=m0)[0]
    else:
        ts, lb = trng.next_block4_v(ts)
        ts, lb2 = trng.next_block4_v(ts)
        l0 = tbd.sample_light_origin(tscene, lb[0], lb[1], lb[2], lb2[0],
                                     lb2[1])
        beta = l0["le"] * (torch.abs(l0["ns"].dot(l0["d"])) / torch.clamp_min(
            l0["pdf_fwd"] * l0["pdf_dir"], 1e-20))
        verts = tbd.random_walk(tscene, ts, l0["p"], l0["d"], beta,
                                l0["pdf_dir"], 4, l0["p"], l0["ns"],
                                adjoint=True, infinite0=l0["infinite"],
                                medium0=m0)[0]
    rep = verify_walk(verts, tscene, adjoint=case.endswith("light"))
    assert rep["checked"] > 200, rep
    assert rep["pdf_err"] < 1e-3, rep
    assert rep["beta_err"] < 1e-3, rep
    if case.startswith("medium"):
        assert any(bool(vx["is_med"].any()) for vx in verts)


def test_bdpt_command_line_matches_render(tmp_path):
    path = str(tmp_path / "bdpt.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth=3, spp=2, res=RES).replace(
            '<integrator type="path">', '<integrator type="bdpt">'))
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _ = read_exr(out)
    scene, settings = tload(path, device="cpu")
    assert settings.integrator == "bdpt"
    assert settings.integrator_props["light_image"] is True
    ref = npy(tjob.render(scene, settings))
    assert ref.mean() > 0
    np.testing.assert_array_equal(
        img, ref.astype(np.float16).astype(np.float32))
