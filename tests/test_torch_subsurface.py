"""Port vs reference: subsurface scattering
(``mitsuba_im_tpu_torch/subsurface/__init__.py``) and its place in the path
integrator, on the CPU.

Exact: ``sample_surface_points`` (the numpy draws of ``default_rng(11)``),
the table's points, areas, records, coefficients, cell and hash grid
(order and buckets) built by both packages from one scene description,
the bridge's round trip of the reference's table, and the factories'
records from a scene file.  At f32 tolerance (rtol 1e-5 for the host
coefficients' device forms, 1e-4 for everything summed over points or
traced, atol 1e-6): ``rd_profile``, ``_fresnel_t``,
``compute_irradiance``, ``eval_lo`` on both branches (the dense sum of
``subsurface_cornell``'s 512 points, the 27-cell scan of
``subsurface_grid``'s 1,536), ``eval_lo_single``, and ``path_li_v`` over
a 16^2 image of the scene with both records, the sampler's dimension
equal; that image also passes the parity gate.  Shapes run 256 lanes so
that the reference's eager primitives compile once each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy, parity_gate

from mitsuba_im_tpu import subsurface as jss
from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.v3 import V3 as JV3
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.integrators import sppm as jsp
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch import subsurface as tss
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.integrators import path as tpath
from mitsuba_im_tpu_torch.scene.bridge import export_tables, scene_from_numpy
from mitsuba_im_tpu_torch.scene.build import SceneBuilder
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.sensor.table import sample_ray_v

torch.set_num_threads(2)

RES = 16
N = RES * RES
RTOL, ATOL = 1e-4, 1e-6


def _a(x) -> np.ndarray:
    if isinstance(x, V3) or isinstance(x, JV3):
        return np.stack([npy(c) for c in x], -1)
    return npy(x)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_a(a), _a(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def _both(grid: bool):
    """(JAX scene, the port's own build) of ``fill_subsurface_cornell``,
    the reference's Cornell camera on both."""
    jb, tb = JBuilder(), SceneBuilder()
    for b in (jb, tb):
        scenes.fill_subsurface_cornell(b, grid=grid)
    jb.sensor = jax_cornell()[0].sensor
    tb.sensor = bridged(jax_cornell()[0]).sensor
    return jb.build()[0], tb.build("cpu")[0]


@pytest.fixture(scope="module")
def cornell():
    jscene, tscene = _both(False)
    return jscene, tscene, bridged(jscene)


@pytest.fixture(scope="module")
def grid():
    jscene, tscene = _both(True)
    return jscene, tscene, bridged(jscene)


def test_coefficients_profile_and_fresnel():
    rng = np.random.default_rng(3)
    for _ in range(4):
        s, a = rng.uniform(0.5, 50, 3), rng.uniform(0.01, 5, 3)
        g, eta = rng.uniform(-0.5, 0.8), rng.uniform(1.05, 1.8)
        jc, tc = jss.dipole_coeffs(s, a, g, eta), tss.dipole_coeffs(s, a, g,
                                                                    eta)
        for k in jc:
            np.testing.assert_array_equal(np.asarray(tc[k]), np.asarray(jc[k]))
        A = (1 + jc["fdr"]) / (1 - jc["fdr"])
        np.testing.assert_array_equal(
            tss.total_diffuse_reflectance(jc["alpha_p"], A),
            jss.total_diffuse_reflectance(jc["alpha_p"], A))
    co = [np.asarray(jc[k], np.float32)
          for k in ("sigma_tr", "zr", "zv", "alpha_p")]
    r2 = (rng.uniform(0, 1.5, N) ** 2).astype(np.float32)
    ref = jss.rd_profile(jnp.asarray(r2), *(jnp.asarray(c) for c in co))
    got = tss.rd_profile(torch.from_numpy(r2),
                         *(torch.from_numpy(c) for c in co))
    _close(got, ref, rtol=1e-5)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    for e in (1.33, 1 / 1.33, 1.0):
        _close(tss._fresnel_t(torch.tensor(e, dtype=torch.float32),
                              torch.from_numpy(cos)),
               jss._fresnel_t(jnp.float32(e), jnp.asarray(cos)), rtol=1e-5)


def test_sample_surface_points_bit_for_bit():
    jb, tb = JBuilder(), SceneBuilder()
    for b in (jb, tb):
        scenes.fill_subsurface_cornell(b, grid=True)
    for ids, n in (([6], 512), ([6, 7, 8], 100), ([0], 7), ([99], 5)):
        ref = jss.sample_surface_points(jb._tri, ids, n,
                                        np.random.default_rng(11))
        got = tss.sample_surface_points(tb._tri, ids, n,
                                        np.random.default_rng(11))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["cornell", "grid"])
def test_table_matches_reference(case, request):
    """The port's own table against the reference's: every leaf bit for
    bit (the grid's order and buckets included) but the irradiance, which
    each package's ``compute_irradiance`` traces on the same points (rtol
    1e-4); the statics equal."""
    jscene, tscene, _ = request.getfixturevalue(case)
    j, t = jscene.subsurface, tscene.subsurface
    for k in tss.SUBSURFACE_STATICS:
        assert getattr(t, k) == getattr(j, k), k
    assert t.n_points == (512 if case == "cornell" else 1536)
    assert t.has_single == (case == "cornell")
    for k in tss.SUBSURFACE_LEAVES:
        a, b = npy(getattr(t, k)), np.asarray(getattr(j, k))
        if k == "irr":
            assert (b > 0).any()
            _close(a, b)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
    np.testing.assert_array_equal(npy(tscene.shape_subsurface),
                                  np.asarray(jscene.shape_subsurface))


def test_bridge_round_trip(grid):
    jscene, _, tscene = grid
    arrays, statics = export_tables(jscene)
    back = scene_from_numpy(arrays, statics, "cpu").subsurface
    for k in tss.SUBSURFACE_LEAVES:
        a, b = npy(getattr(back, k)), np.asarray(getattr(jscene.subsurface,
                                                         k))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
        assert getattr(back, k).dtype == getattr(tscene.subsurface, k).dtype
    for k in tss.SUBSURFACE_STATICS:
        assert getattr(back, k) == getattr(jscene.subsurface, k)


def _surface_lanes(jscene, rng, n=N):
    """(x (n, 3), wo_cos, rec) near the table's points: each lane one
    point moved by up to 0.15, every third lane without a record."""
    tab = jscene.subsurface
    P = int((np.asarray(tab.pt_rec) >= 0).sum())
    pick = rng.integers(0, P, n)
    x = (np.asarray(tab.pts)[pick]
         + rng.uniform(-0.15, 0.15, (n, 3))).astype(np.float32)
    rec = np.asarray(tab.pt_rec)[pick].astype(np.int32)
    rec[::3] = -1
    wo = rng.uniform(0, 1, n).astype(np.float32)
    return x, wo, rec


@pytest.mark.parametrize("case", ["cornell", "grid"])
def test_eval_lo_matches_reference(case, request):
    """Both branches on the same points (the bridged reference table):
    dense at 512 points, the 27-cell scan at 1,536 (rtol 1e-4)."""
    jscene, _, tscene = request.getfixturevalue(case)
    x, wo, rec = _surface_lanes(jscene, np.random.default_rng(9))
    ref = jss.eval_lo(jscene.subsurface, jnp.asarray(x), jnp.asarray(wo),
                      jnp.asarray(rec))
    tss.reset_subsurface_stats()
    got = tss.eval_lo(tscene.subsurface, V3(*(torch.from_numpy(
        x[:, k].copy()) for k in range(3))), torch.from_numpy(wo),
        torch.from_numpy(rec))
    assert (np.asarray(ref) > 0).mean() > 0.3
    _close(got, ref)
    st = tss.SUBSURFACE_STATS
    key = "dense_pairs" if case == "cornell" else "grid_pairs"
    # every lane with a record is a dipole lane here
    assert st[key] > 0 and st["lanes"] == int((rec >= 0).sum())


def _camera(tscene, jscene, seed=3):
    """16^2 camera rays of the Cornell pinhole (both packages' forms)."""
    rng = np.random.default_rng(seed)
    pix = np.arange(N)
    u = ((pix % RES) + rng.random(N)) / RES
    vv = ((pix // RES) + rng.random(N)) / RES
    o, d, _ = sample_ray_v(tscene.sensor, *(torch.from_numpy(
        a.astype(np.float32)) for a in (u, vv, u, vv)))
    return o, d


def test_eval_lo_single_matches_reference(cornell):
    """The refracted-ray estimator at the camera rays' first hits on the
    scene with both records (rtol 1e-4), with a lane count that reaches
    the short block."""
    jscene, _, tscene = cornell
    o, d = _camera(tscene, jscene)
    hit = tscene.ray_intersect_v(o, d)
    it = tscene.interaction_v(o, d, hit)
    rec = tscene.subsurface_at(it.shape, it.valid)
    assert int((npy(rec) == 1).sum()) > 8
    rng = np.random.default_rng(4)
    blk = rng.random((4, N)).astype(np.float32)
    got = tss.eval_lo_single(tscene.subsurface, tscene, it.p, it.ns, d, rec,
                             tuple(torch.from_numpy(b) for b in blk))
    with jax.disable_jit():
        ref = jss.eval_lo_single(
            jscene.subsurface, jscene,
            *(JV3(*(jnp.asarray(npy(c)) for c in vv))
              for vv in (it.p, it.ns, d)),
            jnp.asarray(npy(rec)), tuple(jnp.asarray(b) for b in blk))
    assert (_a(ref).sum(1) > 0).sum() > 4
    _close(got, ref)


def test_path_image_matches_reference(cornell):
    """``path_li_v`` over a 16^2 image of the scene with both records
    (depth 4): radiance per lane (rtol 1e-4), the sampler's dimension
    equal, the image under the parity gate; and d sum(Li)/d ``bsdf.refl``
    through the scene against the reference's reverse mode (ROADMAP C1),
    the same under every remat mode.  The reference's radiance and its
    gradient come from one eager ``jax.vjp`` of the same rays (its
    primitives compile once): the gradient over all 256 rays at depth 4,
    a superset of the 64 rays at depth 3 of ROADMAP C1's check."""
    from mitsuba_im_tpu.diff import optimize as jopt

    jscene, _, tscene = cornell
    o, d = _camera(tscene, jscene)
    cfg = tpath.PathConfig(max_depth=4, remat=False)
    s = trng.make_sampler_v(torch.arange(N), 0, 5)
    li, s2 = tpath.path_li_v(tscene, s, o, d, cfg)
    js = jrng.make_sampler_v(jnp.arange(N, dtype=jnp.uint32),
                             jnp.uint32(0), jnp.uint32(5))
    jo, jd = (JV3(*(jnp.asarray(npy(c)) for c in vv)) for vv in (o, d))

    def j_li(params):
        out, js2 = jpath.path_li_v(jopt.set_params(jscene, params), js, jo,
                                   jd, jpath.PathConfig(max_depth=4,
                                                        remat=False))
        return out, js2.dim

    with jax.disable_jit():
        jli, j_vjp, jdim = jax.vjp(
            j_li, jopt.get_params(jscene, ["bsdf.refl"]), has_aux=True)
    jgrad = jax.jit(j_vjp)(JV3(*(jnp.ones(N, jnp.float32),) * 3))[0]
    np.testing.assert_array_equal(npy(s2.dim), np.asarray(jdim))
    _close(li, jli)
    gate = parity_gate(_a(li), _a(jli))
    assert gate["ok"], gate
    no_sub = dataclasses.replace(tscene, subsurface=None)
    li0, _ = tpath.path_li_v(no_sub, trng.make_sampler_v(torch.arange(N), 0,
                                                         5), o, d, cfg)
    assert _a(li).sum() > _a(li0).sum()
    _subsurface_gradient(tscene, o, d, _a(jli).sum(),
                         np.asarray(jgrad["bsdf.refl"]))


def _subsurface_gradient(tscene, o, d, jval, ref):
    """C1: the table is a constant of the differentiated function in both
    packages; the gradient reaches the LoSub terms through the throughput
    of the lanes on each block."""
    from mitsuba_im_tpu_torch.diff import optimize as topt

    hit = tscene.interaction_v(o, d, tscene.ray_intersect_v(o, d))
    rec = npy(tscene.subsurface_at(hit.shape, hit.valid))
    assert (rec == 0).sum() > 8 and (rec == 1).sum() > 8, rec
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    grads = []
    for kw in (dict(remat=False), dict(), dict(remat_group=2)):
        refl = tscene.bsdfs.refl.detach().clone().requires_grad_(True)
        sc = topt.set_params(tscene, {"bsdf.refl": refl})
        li, _ = tpath.path_li_v(
            sc, trng.make_sampler_v(torch.arange(N), 0, 5), o, d,
            tpath.PathConfig(max_depth=4, **kw))
        loss = li.x.sum() + li.y.sum() + li.z.sum()
        loss.backward()
        np.testing.assert_allclose(loss.item(), jval, rtol=RTOL)
        grads.append(npy(refl.grad))
    for g in grads[1:]:
        np.testing.assert_array_equal(g, grads[0])
    err = np.abs(grads[0] - ref).max() / np.abs(ref).max()
    assert err < 1e-4, (err, grads[0], ref)


XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="40"/>
    <transform name="toWorld"><lookat origin="0, 0.6, 3" target="0, 0.4, 0"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="16"/>
      <integer name="height" value="16"/></film></sensor>
  <subsurface type="singlescatter" id="single">
    <rgb name="sigmaS" value="2 2 2"/><float name="scale" value="3"/>
  </subsurface>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/><scale value="4"/>
    </transform><bsdf type="diffuse"/></shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.4"/><translate y="0.4"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.1 0.1 0.1"/></bsdf>
    <subsurface type="dipole"><rgb name="sigmaS" value="6 6 6"/>
      <rgb name="sigmaA" value="0.05 0.2 0.4"/></subsurface>
  </shape>
  <shape type="sphere"><float name="radius" value="0.2"/>
    <point name="center" x="0.7" y="0.2" z="0"/><ref id="single"/></shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="90"/><scale value="0.5"/>
      <translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="12 12 12"/></emitter>
  </shape>
</scene>
"""


def test_scene_file_with_subsurface(tmp_path):
    """A nested ``dipole`` under a cube and a ``singlescatter`` by
    ``<ref>`` under a sphere: the port's loader gives the reference's
    records, shape columns and table; the command line renders it."""
    from mitsuba_im_tpu.scene.xml import load_scene as jload
    from mitsuba_im_tpu_torch.cli.main import main
    from mitsuba_im_tpu_torch.io.exr import read_exr

    path = str(tmp_path / "sss.xml")
    with open(path, "w") as f:
        f.write(XML)
    port, _ = tload(path, device="cpu")
    ref, _ = jload(path)
    np.testing.assert_array_equal(npy(port.shape_subsurface),
                                  np.asarray(ref.shape_subsurface))
    assert port.subsurface.has_single and port.subsurface.n_points == 512
    for k in tss.SUBSURFACE_LEAVES:
        if k != "irr":
            a = npy(getattr(port.subsurface, k))
            np.testing.assert_array_equal(
                a, np.asarray(getattr(ref.subsurface, k)).astype(a.dtype))
    _close(port.subsurface.irr, ref.subsurface.irr)
    out = str(tmp_path / "sss.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu", "-s", "2"]) == 0
    img, _ = read_exr(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img[6:12, 6:10].mean() > 0
