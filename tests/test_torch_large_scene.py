"""Port vs reference: the large-scene slice (``mitsuba_im_tpu_torch``'s
rough conductor, constant environment emitter, smooth normals, bounding
sphere, bridge of the hierarchy, and ``scenes.large_scene`` rendered end to
end), and the device defaults of the port's entry points.

The slice test renders a ~5k-triangle version of the large scene with both
packages on the CPU: the port through its plain hierarchy traversal, the
JAX package through its flat BVH (its CPU path for large scenes), and gates
the images as ``parity_check.py`` gates the TPU against the CPU.
Tolerances are those of test_torch_helpers unless a case states its own.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, close_v3, jv3, npy,
                                parity_gate, tv3, unit_vectors)

from mitsuba_im_tpu.bsdf import common as jbc
from mitsuba_im_tpu.bsdf import eval as jev
from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.core.registry import create as jcreate
from mitsuba_im_tpu.emitter import table as jem
from mitsuba_im_tpu.film import film as jfilm
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene import mesh as jmesh
from mitsuba_im_tpu.texture.texture import TextureBuilder
from mitsuba_im_tpu_torch import scenes as tscenes
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.film import film as tfilm
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene import bridge
from mitsuba_im_tpu_torch.scene import mesh as tmesh
from mitsuba_im_tpu_torch.scene.build import SceneBuilder

torch.set_num_threads(2)

N_TRIS = 5000  # -> 2 * 50 * 51 = 5100 triangles
RES = 24


def _props(name, **kw):
    p = Properties(name)
    for k, v in kw.items():
        p.set(k, v)
    return p


def _jax_large_scene(res=RES, n_tris=N_TRIS, extra_light=False):
    """``bench_scenes.build_large_scene``'s fallback branch at a small
    triangle count, built by the JAX package."""
    from bench_scenes import _displaced_sphere
    from mitsuba_im_tpu.core.transform import Transform
    from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
    from mitsuba_im_tpu.sensor.table import make_sensor, S_PERSPECTIVE

    b = JBuilder()
    pos, idx = _displaced_sphere(n_tris)
    bid = b.add_bsdf(jcreate("bsdf", _props("roughconductor",
                                            distribution="ggx", alpha=0.2),
                             b))
    b.add_trimesh(jmesh.TriMesh(pos, idx).compute_normals(), b.new_shape(bid))
    b.add_emitter(jcreate("emitter", Properties("constant"), b))
    if extra_light:
        quad = jmesh.TriMesh(
            np.array([[-.05, .15, -.05], [.05, .15, -.05], [.05, .15, .05],
                      [-.05, .15, .05]], float), np.array([[0, 2, 1],
                                                          [0, 3, 2]]))
        lsid = b.new_shape(bid)
        b.add_trimesh(quad, lsid)
        b.add_emitter(dict(type=jem.EM_AREA, radiance=np.full(3, 3.0),
                           shape=lsid, weight=2.0))
        b.shape_emitter[lsid] = 1
    b.sensor = make_sensor(S_PERSPECTIVE,
                           Transform.look_at([0.0, 0.05, 0.3], [0, 0, 0],
                                             [0, 1, 0]), fov_deg=40.0)
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = jfilm.F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=3)
    return b.build()


def _scene_leaves(scene):
    out = {}
    for part in ("geom", "bsdfs", "emitters", "sensor", "clusters"):
        obj = getattr(scene, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = getattr(obj, f.name)
    for k in ("shape_bsdf", "shape_emitter"):
        out[f"scene.{k}"] = getattr(scene, k)
    return out


def test_scene_tables_match_reference():
    """displaced_sphere and compute_normals equal the reference's; the
    port's large_scene equals the bridged JAX scene leaf for leaf (the
    bounding sphere, the new BSDF and emitter columns and the hierarchy
    included), and the bridge round-trips every exported array."""
    from bench_scenes import _displaced_sphere

    pos, idx = tscenes.displaced_sphere(N_TRIS)
    rpos, ridx = _displaced_sphere(N_TRIS)
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(idx, ridx)
    tn = tmesh.TriMesh(pos, idx).compute_normals().normals
    jn = jmesh.TriMesh(rpos, ridx).compute_normals().normals
    np.testing.assert_array_equal(tn, jn)

    jscene, jsettings = _jax_large_scene()
    arrays, statics = bridge.export_tables(jscene)
    ref = bridged(jscene)
    port, settings = tscenes.large_scene("cpu", res=RES, n_tris_target=N_TRIS)
    assert port.clusters is not None and port.geom.n_tris == 5100
    ref_leaves, port_leaves = _scene_leaves(ref), _scene_leaves(port)
    assert ref_leaves.keys() == port_leaves.keys()
    for key, a in ref_leaves.items():
        b = port_leaves[key]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a, b), key
            if key in arrays:
                np.testing.assert_array_equal(npy(a), arrays[key],
                                              err_msg=key)
        else:
            assert a == b, key
    np.testing.assert_array_equal(npy(port.emitters.bsphere_center),
                                  npy(jscene.emitters.bsphere_center))
    assert float(port.emitters.bsphere_radius) == float(
        jscene.emitters.bsphere_radius)
    assert {k for k in arrays if k.startswith("clusters.")} == {
        f"clusters.{k}" for k in ("swp_lo", "swp_hi", "sup_inst", "childs",
                                  "blocks", "inst_inv", "inst_fwd",
                                  "sup_blas")}
    for k in ("width", "height", "spp", "integrator", "integrator_props",
              "rfilter"):
        assert getattr(settings, k) == getattr(jsettings, k), k


def _conductor_records(dist):
    """(reference records, port records): rough conductors of one
    distribution, isotropic and anisotropic, a smooth conductor and a
    diffuse row."""
    kw = [dict(distribution=dist, alpha=0.2),
          dict(distribution=dist, alphaU=0.08, alphaV=0.35, material="Au"),
          dict(distribution=dist, alpha=0.5, material="Al", extEta=1.3)]
    ref = [jcreate("bsdf", _props("roughconductor", **k)) for k in kw]
    ref.append(jcreate("bsdf", _props("conductor", material="Ag")))
    ref.append(jbc.default_record())
    port = [tbc.conductor_record(rough=True, alpha=0.2, distribution=dist),
            tbc.conductor_record("Au", rough=True, alpha_u=0.08,
                                 alpha_v=0.35, distribution=dist),
            tbc.conductor_record("Al", rough=True, alpha=0.5,
                                 distribution=dist, ext_eta=1.3),
            tbc.conductor_record("Ag"), tbc.default_record()]
    return ref, port


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_roughconductor(dist):
    """The conductor records equal the reference factories'; ROUGHCONDUCTOR
    eval, pdf and sample (beside a diffuse row) match the reference's."""
    rng = np.random.default_rng(70)
    n = 4096
    jrecs, trecs = _conductor_records(dist)
    for a, b in zip(jrecs, trecs):
        for k in tbc.BSDF_LEAVES:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    jt = jbc.build_table(jrecs[:3] + jrecs[4:])
    tt = tbc.build_table(trecs[:3] + trecs[4:], "cpu")
    assert tt.used_types == (tbc.DIFFUSE, tbc.ROUGHCONDUCTOR)
    ids = rng.integers(0, 4, n).astype(np.int32)
    uv = rng.random((2, n), dtype=np.float32)
    jp = jbc.resolve_v(jt, TextureBuilder().build(), jnp.asarray(ids),
                       *(jnp.asarray(a) for a in uv))
    tp = tbc.resolve_v(tt, None, torch.from_numpy(ids))
    for k in ("alpha_u", "alpha_v", "dist"):
        np.testing.assert_array_equal(npy(getattr(tp, k)),
                                      npy(getattr(jp, k)), err_msg=k)

    wi, wo = unit_vectors(rng, n), unit_vectors(rng, n)
    wi[:, 2] = np.abs(wi[:, 2])  # mostly the upper hemisphere
    wi[: n // 8, 2] *= -1.0
    close_v3(tev.bsdf_eval_v(tp, tv3(wi), tv3(wo)),
             jev.bsdf_eval_v(jp, jv3(wi), jv3(wo)))
    close(tev.bsdf_pdf_v(tp, tv3(wi), tv3(wo)),
          jev.bsdf_pdf_v(jp, jv3(wi), jv3(wo)))
    u = rng.random((3, n), dtype=np.float32)
    jb = jev.bsdf_sample_v(jp, jv3(wi), *(jnp.asarray(a) for a in u))
    tb = tev.bsdf_sample_v(tp, tv3(wi), *(torch.from_numpy(a) for a in u))
    rough = npy(tp.type) == tbc.ROUGHCONDUCTOR
    assert rough.sum() > n // 2 and (npy(tb.pdf)[rough] > 1e-3).mean() > 0.5
    # the sampled half vector passes through sin/cos/sqrt (and atan2/log for
    # Beckmann): last-bit differences of the two libraries' transcendentals
    # grow by ~1/cos near grazing (Beckmann's log(1 - u) also near u = 1),
    # so directions agree to 1e-4 absolute and the weight and pdf to rel 3e-4
    close_v3(tb.wo, jb.wo, atol=1e-4)
    close_v3(tb.weight, jb.weight, rtol=3e-4, atol=1e-5)
    close(tb.pdf, jb.pdf, rtol=3e-4)
    for k in ("delta", "eta", "null_passthrough"):
        np.testing.assert_array_equal(npy(getattr(tb, k)),
                                      npy(getattr(jb, k)))


def test_constant_emitter():
    """sample_direct_v, eval_environment_v, pdf_direct_env_v and the area
    queries on a scene with a constant environment and an area light."""
    rng = np.random.default_rng(71)
    jscene = _jax_large_scene(n_tris=600, extra_light=True)[0]
    tscene = bridged(jscene)
    je, te = jscene.emitters, tscene.emitters
    assert te.used_types == (tem.EM_AREA, tem.EM_CONSTANT)
    assert te.env_index == je.env_index == 0
    n = 4096
    ref = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    u = rng.random((3, n), dtype=np.float32)
    js = jem.sample_direct_v(je, jscene.geom, jv3(ref),
                             *(jnp.asarray(a) for a in u))
    ts = tem.sample_direct_v(te, tscene.geom, tv3(ref),
                             *(torch.from_numpy(a) for a in u))
    np.testing.assert_array_equal(npy(ts.emitter), npy(js.emitter))
    assert set(np.unique(npy(ts.emitter))) == {0, 1}
    np.testing.assert_array_equal(npy(ts.delta), npy(js.delta))
    # uniform-sphere directions go through cos/sin of 2 pi u: a few ulps
    for k in ("d", "value", "n"):
        close_v3(getattr(ts, k), getattr(js, k), atol=4e-6)
    close(ts.dist, js.dist)
    close(ts.pdf, js.pdf)

    d = unit_vectors(rng, n)
    close_v3(tem.eval_environment_v(te, tv3(d)),
             jem.eval_environment_v(je, jv3(d)))
    close(tem.pdf_direct_env_v(te, tv3(d)), jem.pdf_direct_env_v(je, jv3(d)))
    assert float(tem.pdf_direct_env_v(te, tv3(d))[0]) == pytest.approx(
        float(npy(je.select.pmf)[0]) / (4 * np.pi), rel=1e-6)
    eid = rng.integers(-1, 2, n).astype(np.int32)
    nrm, p_emit = unit_vectors(rng, n), rng.uniform(-1, 1, (n, 3))
    close_v3(tem.emitted_radiance_v(te, torch.from_numpy(eid), tv3(nrm),
                                    tv3(d)),
             jem.emitted_radiance_v(je, jnp.asarray(eid), jv3(nrm), jv3(d)))
    # r2 / cos of random emitter normals: the libraries' rsqrt differ in
    # the last bits and a small cos amplifies them
    close(tem.pdf_direct_area_v(te, torch.from_numpy(eid), tv3(ref),
                                tv3(p_emit), tv3(nrm)),
          jem.pdf_direct_area_v(je, jnp.asarray(eid), jv3(ref), jv3(p_emit),
                                jv3(nrm)), rtol=1e-4)


def test_large_scene_render_parity_gate():
    """The slice end to end: the same ~5k-triangle scene rendered at 24^2,
    depth 3, 1 spp by both packages on the CPU."""
    jscene, jsettings = _jax_large_scene()
    assert jscene.use_bvh and jscene.geom.n_tris == 5100
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings, spp=1)))
    tscene, tsettings = tscenes.large_scene("cpu", res=RES,
                                            n_tris_target=N_TRIS)
    out = npy(tfilm.develop(tjob.render_film(tscene, tsettings)))
    assert out.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(out).all() and (out >= 0).all()
    # the mesh fills the centre; the corners see the unit environment
    assert out[0, 0].tolist() == [1.0, 1.0, 1.0]
    assert abs(out[10:14, 10:14].mean() - 1.0) > 0.05
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


@pytest.mark.parametrize("entry", ["tiny_cornell", "large_scene", "build",
                                   "scene_from_numpy"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The public entry points run on the card unless the CPU is asked for,
    and raise (no fallback) when CUDA is absent."""
    fn = {"tiny_cornell": tscenes.tiny_cornell,
          "large_scene": tscenes.large_scene,
          "build": SceneBuilder.build,
          "scene_from_numpy": bridge.scene_from_numpy}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "build":
            SceneBuilder().build()
        elif entry == "scene_from_numpy":
            from test_torch_helpers import jax_cornell

            bridge.scene_from_numpy(*bridge.export_tables(jax_cornell()[0]))
        else:
            fn()
