"""Port vs reference: reverse-mode scene gradients (path replay through
``torch.utils.checkpoint``) and ``diff/optimize.py``.

Every gradient of ``path_li_v`` is held against the JAX package's on the
CPU, with the same seeds and inputs and the parameters carried across by
``scene/bridge.py``: max |g_port - g_jax| / max |g_jax| < GRAD_TOL.  The
measured differences are 1e-7 to 2e-6 (float32 sums in another order), so
the tolerance is the requested 1e-4, not loosened.

The rough conductor's ``bsdf.alpha`` moves ray directions.  There the
reference's ``jax.grad`` is NaN on the CPU (ROADMAP C6): its bounce loop
is a scan, whose transpose multiplies every carried value's local
derivative by its (zero) cotangent, and the carry holds masked lanes'
infinities and 0/0s (the sphere uv's atan2(0, 0), the pad sphere's
inf - inf discriminant).  Its forward mode follows only live dependencies
and is finite, so the alpha reference is ``jax.jacfwd`` of the same
function: the same derivative, taken the other way.

Also here: the port's own gradient invariants (the remat modes agree, no
graph without a tensor that requires grad, the kernels' wrappers never
see one and run again in the replay, sphere and disk ``t`` live and
triangle ``t`` detached), and ``diff/optimize.py`` against the reference
module (Adam against optax, autodiff against finite differences).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, jax_shapes_scene, npy

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.types import Float
from mitsuba_im_tpu.diff import optimize as jopt
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.sensor.table import sample_ray_v as j_sample_ray_v
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import cuda_intersect as ci
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.core.transform import Transform
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.diff import optimize as topt
from mitsuba_im_tpu_torch.integrators import path as tpath
from mitsuba_im_tpu_torch.render.job import RenderSettings, render_film
from mitsuba_im_tpu_torch.scene.geometry import KIND_SPHERE, KIND_TRI
from mitsuba_im_tpu_torch.scenes import tiny_cornell
from mitsuba_im_tpu_torch.sensor.table import (S_PERSPECTIVE, make_sensor,
                                                sample_ray_v as t_sample_ray_v)

torch.set_num_threads(2)

GRAD_TOL = 1e-4
SAMPLE = 7  # parity_check._grad_cornell's sample index


def rel_err(a, b) -> float:
    a, b = npy(a), npy(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# sum(Li) of one sample per pixel, in both packages (parity_check's loss)
# ---------------------------------------------------------------------------

def jax_sum_li(jscene, cfg, W):
    """params dict -> sum of Li over a W x W image (the reference)."""
    n = W * W

    def f(params):
        sc = jopt.set_params(jscene, params)
        pix = jnp.arange(n, dtype=jnp.uint32)
        s = jrng.make_sampler_v(pix, jnp.uint32(SAMPLE), jnp.uint32(0))
        s, blk = jrng.next_block4_v(s)
        uu = ((pix % W).astype(Float) + blk[0]) / W
        vv = ((pix // W).astype(Float) + blk[1]) / W
        o, d, _ = j_sample_ray_v(sc.sensor, uu, vv, blk[2], blk[3])
        li, _ = jpath.path_li_v(sc, s, o, d, cfg)
        return li.sum().sum()

    return f


def jax_grads(jscene, cfg, W, labels, forward_mode=False):
    params = jopt.get_params(jscene, labels)
    diff = jax.jacfwd if forward_mode else jax.grad
    g = jax.jit(diff(jax_sum_li(jscene, cfg, W)))(params)
    return {k: np.asarray(v) for k, v in g.items()}


def torch_sum_li(tscene, cfg, W, params):
    sc = topt.set_params(tscene, params)
    pix = torch.arange(W * W)
    s = trng.make_sampler_v(pix, SAMPLE, 0)
    s, blk = trng.next_block4_v(s)
    uu = ((pix % W).float() + blk[0]) / W
    vv = ((pix // W).float() + blk[1]) / W
    o, d, _ = t_sample_ray_v(sc.sensor, uu, vv, blk[2], blk[3])
    li, _ = tpath.path_li_v(sc, s, o, d, cfg)
    return li.x.sum() + li.y.sum() + li.z.sum()


def torch_grads(tscene, cfg, W, labels):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in topt.get_params(tscene, labels).items()}
    torch_sum_li(tscene, cfg, W, params).backward()
    return {k: p.grad for k, p in params.items()}


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def jax_mesh_scene(n_tris, bsdf_props):
    """bench_scenes' displaced sphere (``n_tris`` triangles or a few more)
    with one BSDF under the unit constant environment, the large scene's
    camera."""
    from bench_scenes import _displaced_sphere
    from mitsuba_im_tpu.core.properties import Properties
    from mitsuba_im_tpu.core.registry import create
    from mitsuba_im_tpu.core.transform import Transform
    from mitsuba_im_tpu.scene.build import SceneBuilder
    from mitsuba_im_tpu.scene.mesh import TriMesh
    from mitsuba_im_tpu.sensor.table import S_PERSPECTIVE, make_sensor

    b = SceneBuilder()
    props = Properties(bsdf_props.pop("type"))
    for k, v in bsdf_props.items():
        props.set(k, v)
    bid = b.add_bsdf(create("bsdf", props, b))
    pos, idx = _displaced_sphere(n_tris)
    b.add_trimesh(TriMesh(pos, idx).compute_normals(), b.new_shape(bid))
    b.add_emitter(create("emitter", Properties("constant"), b))
    b.sensor = make_sensor(S_PERSPECTIVE, Transform.look_at(
        [0.0, 0.05, 0.3], [0, 0, 0], [0, 1, 0]), fov_deg=40.0)
    return b.build()[0]


@pytest.fixture(scope="module")
def cornell():
    jscene = jax_cornell()[0]
    return jscene, bridged(jscene)


@pytest.fixture(scope="module")
def rough_mesh():
    """420 triangles (brute force), GGX rough conductor of alpha 0.2."""
    jscene = jax_mesh_scene(400, dict(type="roughconductor",
                                      distribution="ggx", alpha=0.2))
    assert jscene.geom.n_tris <= 512
    return jscene, bridged(jscene)


@pytest.fixture(scope="module")
def diffuse_hier():
    """612 triangles (the hierarchy), diffuse."""
    jscene = jax_mesh_scene(600, dict(type="diffuse",
                                      reflectance=[0.6, 0.4, 0.3]))
    tscene = bridged(jscene)
    assert jscene.geom.n_tris > 512 and tscene.clusters is not None
    return jscene, tscene


# ---------------------------------------------------------------------------
# gradients against the reference
# ---------------------------------------------------------------------------

CASES = {
    # name: (scene fixture, W, PathConfig keywords, labels)
    "cornell": ("cornell", 16, dict(max_depth=3),
                ("bsdf.refl", "emitter.radiance")),
    "skip_direct": ("cornell", 16, dict(max_depth=3, skip_direct=True),
                    ("bsdf.refl",)),
    "rough_alpha_depth2": ("rough_mesh", 16, dict(max_depth=2),
                           ("bsdf.alpha",)),
    "hierarchy_refl": ("diffuse_hier", 8, dict(max_depth=2),
                       ("bsdf.refl",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(case, request):
    """d sum(Li)/d params of the port (per-bounce path replay) against the
    reference's (no remat: the same gradient).  On the rough mesh at depth
    2 only escaped rays carry light, so the reference's differentiated
    triangle ``t`` (C6) cannot enter; the reference is taken in forward
    mode there (see the module note)."""
    fixture, W, kw, labels = CASES[case]
    jscene, tscene = request.getfixturevalue(fixture)
    alpha = "bsdf.alpha" in labels
    ref = jax_grads(jscene, jpath.PathConfig(remat=False, **kw), W, labels,
                    forward_mode=alpha)
    got = torch_grads(tscene, tpath.PathConfig(**kw), W, labels)
    for k in labels:
        g = npy(got[k])
        assert np.isfinite(g).all(), k
        assert np.abs(ref[k]).max() > 0, k
        assert rel_err(g, ref[k]) < GRAD_TOL, (k, g, ref[k])


def test_remat_modes_agree(cornell):
    """remat=False, per-bounce replay and remat_group=4 (the bench's
    fwd+bwd configuration: depth 5, one group of 4 bounces) give the same
    gradient, bit for bit on the CPU."""
    _, tscene = cornell
    labels = ("bsdf.refl", "emitter.radiance")
    grads = [torch_grads(tscene, tpath.PathConfig(max_depth=5, **kw), 16,
                         labels)
             for kw in (dict(remat=False), dict(remat=True),
                        dict(remat=True, remat_group=4),
                        dict(remat=True, remat_group=3))]
    for g in grads[1:]:
        for k in labels:
            torch.testing.assert_close(g[k], grads[0][k], rtol=1e-6, atol=0)
            assert torch.equal(g[k], grads[0][k]), k


def test_no_graph_without_grad(cornell):
    """With no tensor requiring grad, or under no_grad, path_li_v records
    nothing; render_film never does."""
    _, tscene = cornell
    labels = ("bsdf.refl",)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in topt.get_params(tscene, labels).items()}
    cfg = tpath.PathConfig(max_depth=3)
    assert torch_sum_li(tscene, cfg, 8, {}).grad_fn is None
    with torch.no_grad():
        assert torch_sum_li(tscene, cfg, 8, params).grad_fn is None
    assert torch_sum_li(tscene, cfg, 8, params).grad_fn is not None
    settings = RenderSettings(width=8, height=8, spp=1,
                              integrator_props=dict(max_depth=3))
    film = render_film(topt.set_params(tscene, params), settings)
    assert not any(t.requires_grad for t in _tensors(film))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _spy(monkeypatch, calls):
    """Count the triangle queries and check that no input requires grad."""
    for mod, name in ((ci, "closest_hit_v"), (ci, "closest_tris_v"),
                      (ci, "anyhit_tris_v"), (ch, "hier_closest"),
                      (ch, "hier_anyhit")):
        orig = getattr(mod, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            grads = [t for t in _tensors((args, list(kw.values())))
                     if t.requires_grad]
            assert not grads, f"{_name} got a tensor that requires grad"
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("which", ["brute_force", "spheres", "hierarchy"])
def test_wrappers_get_no_grad_and_replay(which, rough_mesh, monkeypatch):
    """The triangle queries never see a tensor that requires grad, though
    the rays do (alpha moves them), and the replay runs them again: per
    bounce at depth 3, 3 closest + 2 any-hit queries forward and 2 + 2 in
    the backward pass; the gradient is finite and non-zero."""
    rough = dict(type="roughconductor", distribution="ggx", alpha=0.2)
    if which == "brute_force":
        tscene = rough_mesh[1]
        closest, anyhit = "closest_hit_v", "anyhit_tris_v"
    elif which == "spheres":
        from mitsuba_im_tpu.bsdf import common as jbc

        rec = jbc.default_record()
        rec.update(type=jbc.ROUGHCONDUCTOR, dist=1, alpha_u=0.2,
                   alpha_v=0.2)
        tscene = dataclasses.replace(
            bridged(jax_shapes_scene(rec, environment=True)),
            sensor=make_sensor(
                S_PERSPECTIVE, Transform.look_at([0.3, 0.4, 2.0], [0, 0, 0],
                                                 [0, 1, 0]),
                fov_deg=40.0, device="cpu"))
        closest, anyhit = "closest_tris_v", "anyhit_tris_v"
    else:
        tscene = bridged(jax_mesh_scene(600, rough))
        closest, anyhit = "hier_closest", "hier_anyhit"
    calls = {}
    _spy(monkeypatch, calls)
    params = {"bsdf.alpha": topt.get_params(tscene, ["bsdf.alpha"])[
        "bsdf.alpha"].detach().clone().requires_grad_(True)}
    loss = torch_sum_li(tscene, tpath.PathConfig(max_depth=3), 8, params)
    assert (calls.get(closest), calls.get(anyhit)) == (3, 2)
    loss.backward()
    assert (calls.get(closest), calls.get(anyhit)) == (5, 4)
    assert sum(calls.values()) == 9
    g = params["bsdf.alpha"].grad
    assert torch.isfinite(g).all() and (g != 0).any()


def test_sphere_t_live_triangle_t_detached():
    """Rays reflected by a rough-conductor sphere: d p/d alpha of their
    next hit flows through the sphere's t where they hit a sphere, as in
    every reference branch; a triangle's t has a zero derivative (the
    reference's accelerated paths), unlike the reference's CPU branch.
    The reference derivative is forward mode (see the module note)."""
    from mitsuba_im_tpu.bsdf import common as jbc
    from mitsuba_im_tpu.bsdf import eval as jev
    from mitsuba_im_tpu.core import v3 as jv

    rec = jbc.default_record()
    rec.update(type=jbc.ROUGHCONDUCTOR, dist=1, alpha_u=0.3, alpha_v=0.3)
    jscene = jax_shapes_scene(rec)
    tscene = bridged(jscene)
    rng = np.random.default_rng(90)
    n = 1024
    tgt = rng.normal(size=(n, 3)) * 0.3
    o = np.tile(np.float32([0.3, 0.4, 2.0]), (n, 1))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    u = rng.random((3, n), dtype=np.float32)

    def second_hit(scene, V, where, wrap, alpha, bsdf_at, sample, to_world):
        """(second hit's p, kind, t) of rays reflected at the first hit."""
        ro = V(*(wrap(o[:, k]) for k in range(3)))
        rd = V(*(wrap(d[:, k]) for k in range(3)))
        it = scene.interaction_v(ro, rd, scene.ray_intersect_v(ro, rd))
        p = bsdf_at(scene, it, alpha)
        bs = sample(p, it.wi_local, *(wrap(a) for a in u))
        wo = to_world((it.ss, it.ts_, it.ns), bs.wo)
        hit2 = scene.ray_intersect_v(it.p, wo)
        return scene.interaction_v(it.p, wo, hit2).p, hit2.kind, hit2.t

    def t_bsdf(scene, it, alpha):
        sc = topt.set_params(scene, {"bsdf.alpha": alpha})
        return sc.bsdf_at_v(it)

    def j_bsdf(scene, it, alpha):
        return jopt.set_params(scene, {"bsdf.alpha": alpha}).bsdf_at_v(it)

    from mitsuba_im_tpu_torch.core import v3 as tv

    def t_run(alpha):
        return second_hit(tscene, V3, torch.where, torch.from_numpy, alpha,
                          t_bsdf, tev.bsdf_sample_v, tv.to_world)

    def j_run(alpha):
        return second_hit(jscene, jv.V3, jnp.where, jnp.asarray, alpha,
                          j_bsdf, jev.bsdf_sample_v, jv.to_world)

    a0 = npy(jopt.get_params(jscene, ["bsdf.alpha"])["bsdf.alpha"])
    alpha = torch.from_numpy(a0.copy()).requires_grad_(True)
    p2, kind, t2 = t_run(alpha)
    kind = npy(kind)
    on_sph = torch.from_numpy(kind == KIND_SPHERE)
    on_tri = torch.from_numpy(kind == KIND_TRI)
    assert on_sph.sum() > 50 and on_tri.sum() > 50
    ps = sum((c * on_sph).sum() for c in p2)
    g_sph, = torch.autograd.grad(ps, alpha, retain_graph=True)
    g_tri_t, = torch.autograd.grad((t2 * on_tri).sum(), alpha,
                                   allow_unused=True, retain_graph=True)
    assert g_tri_t is None or not g_tri_t.any()
    g_t, = torch.autograd.grad((t2 * on_sph).sum(), alpha)
    assert g_t.abs().sum() > 0  # the sphere's t itself carries it

    m_sph, m_tri = npy(on_sph), npy(on_tri)

    def j_sums(a):
        p, _, t = j_run(a)
        return sum((c * m_sph).sum() for c in p), (t * m_tri).sum()

    ref, ref_tri_t = jax.jit(jax.jacfwd(j_sums))(jnp.asarray(a0))
    assert rel_err(g_sph, ref) < GRAD_TOL, (npy(g_sph), ref)
    # the reference's CPU branch differentiates the triangle t (C6)
    assert np.abs(np.asarray(ref_tri_t)).sum() > 0


# ---------------------------------------------------------------------------
# diff/optimize.py
# ---------------------------------------------------------------------------

def test_train_steps_match_optax(cornell):
    """Five Adam steps on the wall albedos at 8^2, depth 3, from a uniform
    0.35 grey towards a reference render: torch.optim.Adam against the
    reference's optax loop, parameters within 1e-4."""
    jscene, tscene = cornell
    js = copy.copy(jax_cornell()[1])
    js.width = js.height = 8
    ts = RenderSettings(width=8, height=8, spp=js.spp)
    cfg_kw = dict(max_depth=3, depth_budget=3)
    with torch.no_grad():
        target = np.mean([npy(topt.render_rays(
            tscene, ts, tpath.PathConfig(**cfg_kw), torch.arange(64),
            1000 + s, 0)) for s in range(4)], axis=0).reshape(8, 8, 3)

    jgrey = jscene.replace(bsdfs=jscene.bsdfs.replace(
        refl=jnp.full_like(jscene.bsdfs.refl, 0.35)))
    tgrey = topt.set_params(tscene, {"bsdf.refl": torch.full_like(
        tscene.bsdfs.refl, 0.35)})
    jinit, jstep = jopt.make_train_step(  # no remat: compiles faster
        jgrey, js, jpath.PathConfig(remat=False, **cfg_kw),
        jnp.asarray(target),
        ("bsdf.refl",), lr=5e-2)
    tinit, tstep = topt.make_train_step(
        tgrey, ts, tpath.PathConfig(**cfg_kw), torch.from_numpy(target),
        ("bsdf.refl",), lr=5e-2)
    jst, tst = jinit(), tinit()
    for _ in range(5):
        jst, jloss = jstep(jst, jnp.uint32(0))
        tst, tloss = tstep(tst, 0)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
    got = npy(tst.params["bsdf.refl"])
    ref = np.asarray(jst.params["bsdf.refl"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(got - 0.35).max() > 0.1  # the steps moved the albedo


@pytest.mark.parametrize("label,index,eps", [
    ("bsdf.refl", (0, 0), 0.05),  # the white walls' red albedo
    ("emitter.radiance", (0, 1), 1.0),  # the light's green radiance
])
def test_autodiff_matches_finite_differences(label, index, eps):
    """The port's reverse-mode image gradient against its central finite
    difference on the same samples (tests/test_diff.py::TestGradParity's
    harness: 12^2, depth 3, rtol 0.08), with 24 samples instead of 48."""
    scene, _ = tiny_cornell("cpu")
    settings = RenderSettings(width=12, height=12, spp=1)
    cfg = tpath.PathConfig(max_depth=3, depth_budget=3)
    fd = float(topt.finite_difference_grad(scene, settings, cfg, label,
                                           index, eps, n_samples=24).sum())
    ad = topt.autodiff_image_grad(scene, settings, cfg, label, index,
                                  n_samples=24)
    assert np.isfinite(ad) and fd > 0
    np.testing.assert_allclose(ad, fd, rtol=0.08)


def test_texture_atlas_and_other_samplers_raise(cornell):
    _, tscene = cornell
    with pytest.raises(NotImplementedError):
        topt.get_params(tscene, ["texture.atlas"])
    with pytest.raises(NotImplementedError):
        topt.set_params(tscene, {"texture.atlas": torch.zeros(1)})
    settings = RenderSettings(width=4, height=4, sampler="stratified")
    with pytest.raises(NotImplementedError):
        topt.render_rays(tscene, settings, tpath.PathConfig(max_depth=2),
                         torch.arange(16), 0, 0)


# ---------------------------------------------------------------------------
# the BSDF stage on its own: d/d every column the rough conductor reads
# ---------------------------------------------------------------------------

def test_bsdf_gradients_match_reference():
    """d/d (refl, spec, eta, k, alpha_u, alpha_v) of a random combination of
    bsdf_eval_v, bsdf_pdf_v and bsdf_sample_v (weight, pdf, direction) over
    GGX rough conductors and a diffuse row, gathered by resolve_v, against
    the reference's (forward mode: masked lanes' infinities make its
    reverse mode NaN, C6).  Directions keep away from grazing, where the
    two libraries' transcendentals differ in the last bits and 1/cos
    amplifies it (test_torch_large_scene::test_roughconductor)."""
    from test_torch_large_scene import _conductor_records
    from mitsuba_im_tpu.bsdf import common as jbc
    from mitsuba_im_tpu.bsdf import eval as jev
    from mitsuba_im_tpu.texture.texture import TextureBuilder
    from mitsuba_im_tpu_torch.bsdf import common as tbc
    from test_torch_helpers import jv3, tv3, unit_vectors

    cols = ("refl", "spec", "eta", "k", "alpha_u", "alpha_v")
    jrecs, trecs = _conductor_records("ggx")
    jt = jbc.build_table(jrecs[:3] + jrecs[4:])
    tt = tbc.build_table(trecs[:3] + trecs[4:], "cpu")
    rng = np.random.default_rng(91)
    n = 2048
    ids = rng.integers(0, 4, n).astype(np.int32)
    uv = rng.random((2, n), dtype=np.float32)
    wi, wo = unit_vectors(rng, n), unit_vectors(rng, n)
    wi[:, 2] = np.abs(wi[:, 2]) + 0.3
    wo[:, 2] = np.abs(wo[:, 2]) + 0.3
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u = rng.random((3, n), dtype=np.float32) * 0.9
    c = rng.normal(size=(10, n)).astype(np.float32)

    def combine(V, ev, pdf, bs):
        parts = [*ev, pdf, *bs.weight, bs.pdf, *bs.wo]
        return sum((p * w).sum() for p, w in zip(parts, V(c)))

    def j_loss(params):
        p = jbc.resolve_v(jt.replace(**params), TextureBuilder().build(),
                          jnp.asarray(ids), *(jnp.asarray(a) for a in uv))
        return combine(jnp.asarray, jev.bsdf_eval_v(p, jv3(wi), jv3(wo)),
                       jev.bsdf_pdf_v(p, jv3(wi), jv3(wo)),
                       jev.bsdf_sample_v(p, jv3(wi),
                                         *(jnp.asarray(a) for a in u)))

    params = {k: torch.from_numpy(npy(getattr(tt, k)).copy())
              .requires_grad_(True) for k in cols}
    p = tbc.resolve_v(dataclasses.replace(tt, **params),
                      torch.from_numpy(ids))
    combine(torch.from_numpy, tev.bsdf_eval_v(p, tv3(wi), tv3(wo)),
            tev.bsdf_pdf_v(p, tv3(wi), tv3(wo)),
            tev.bsdf_sample_v(p, tv3(wi), *(torch.from_numpy(a) for a in u))
            ).backward()
    ref = jax.jacfwd(j_loss)({k: getattr(jt, k) for k in cols})
    for k in cols:
        g = npy(params[k].grad)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        assert rel_err(g, ref[k]) < GRAD_TOL, (k, g, np.asarray(ref[k]))
