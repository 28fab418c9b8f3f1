"""Port vs reference: scene bridge and ``scene/build.py`` tables, surface
interactions, BSDF resolve and the diffuse BSDF, area emitters
(``mitsuba_im_tpu_torch/scene``, ``bsdf``, ``emitter``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, close_v3, jax_cornell,
                                jax_shapes_scene, jv3, npy, tv3,
                                unit_vectors)

from mitsuba_im_tpu.accel import intersect as jisect
from mitsuba_im_tpu.bsdf import common as jbc
from mitsuba_im_tpu.bsdf import eval as jev
from mitsuba_im_tpu.emitter import table as jem
from mitsuba_im_tpu.scene import geometry as jgeo
from mitsuba_im_tpu.texture.texture import TextureBuilder
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.scene import geometry as tgeo
from mitsuba_im_tpu_torch.bsdf import irawan as tir
from mitsuba_im_tpu_torch.scene.bridge import export_tables, scene_from_numpy
from mitsuba_im_tpu_torch.scenes import tiny_cornell

torch.set_num_threads(2)


def _leaves(scene):
    """{name: tensor or static} of a port Scene."""
    out = {}
    for part in ("geom", "bsdfs", "textures", "emitters", "sensor",
                 "media"):
        obj = getattr(scene, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = getattr(obj, f.name)
    for k in ("shape_bsdf", "shape_emitter", "shape_interior",
              "shape_exterior", "shape_subsurface"):
        out[f"scene.{k}"] = getattr(scene, k)
    if scene.subsurface is not None:
        for f in dataclasses.fields(scene.subsurface):
            out[f"subsurface.{f.name}"] = getattr(scene.subsurface, f.name)
    return out


@pytest.mark.parametrize("which", ["cornell", "shapes"])
def test_bridge_leaves_bit_exact(which):
    jscene = jax_cornell()[0] if which == "cornell" else jax_shapes_scene()
    arrays, statics = export_tables(jscene)
    tscene = scene_from_numpy(arrays, statics, "cpu")
    leaves = {k: t for k, t in _leaves(tscene).items()
              if isinstance(t, torch.Tensor)}
    # every exported table is a leaf of the port's scene
    assert set(arrays) == set(leaves)
    assert not tscene.bsdfs.tex_columns
    for key, t in leaves.items():
        a = arrays[key]
        assert t.shape == a.shape, key
        assert npy(t).dtype == a.dtype or (a.dtype == np.uint32), key
        np.testing.assert_array_equal(npy(t), a, err_msg=key)
    assert tscene.geom.n_tris == jscene.geom.n_tris
    assert tscene.geom.n_spheres == jscene.geom.n_spheres
    assert tscene.bsdfs.used_types == jscene.bsdfs.used_types
    assert tscene.emitters.n_emitters == jscene.emitters.n_emitters


def test_tiny_cornell_matches_bridged_reference():
    ref = _leaves(bridged(jax_cornell()[0]))
    port = _leaves(tiny_cornell("cpu")[0])
    assert ref.keys() == port.keys()
    for key, a in ref.items():
        b = port[key]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a, b), key
        else:
            assert a == b, key
    settings = tiny_cornell("cpu")[1]
    ref_settings = jax_cornell()[1]
    for k in ("width", "height", "spp", "seed", "integrator",
              "integrator_props", "rfilter"):
        assert getattr(settings, k) == getattr(ref_settings, k)


@pytest.mark.parametrize("which", ["cornell", "shapes"])
def test_compute_interaction_v(which):
    """The same Hit records through both packages' interaction code."""
    rng = np.random.default_rng(20)
    jscene = jax_cornell()[0] if which == "cornell" else jax_shapes_scene()
    tscene = bridged(jscene)
    n = 6000
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[: n // 2] = [0.0, 1.0, 3.9]
    d = unit_vectors(rng, n)
    jh = jisect.intersect_v(jscene.geom, jv3(o), jv3(d), 1e-4, 1e30)
    th = tgeo.Hit(**{k: torch.tensor(npy(getattr(jh, k)))
                     for k in ("t", "kind", "prim", "shape", "u", "v")})
    ji = jgeo.compute_interaction_v(jscene.geom, jv3(o), jv3(d), jh)
    ti = tgeo.compute_interaction_v(tscene.geom, tv3(o), tv3(d), th)
    valid = npy(ji.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(npy(ti.valid), valid)
    np.testing.assert_array_equal(npy(ti.shape), npy(ji.shape))
    for k in ("p", "ng", "ns", "ss", "ts_", "wi_local"):
        for a, b in zip(getattr(ti, k), getattr(ji, k)):
            close(npy(a)[valid], npy(b)[valid])
    for k in ("t", "uv_u", "uv_v"):
        close(npy(getattr(ti, k))[valid], npy(getattr(ji, k))[valid])


def _bsdf_records():
    recs = [jbc.default_record() for _ in range(4)]
    recs[0]["refl"] = np.array([0.63, 0.065, 0.05])
    recs[1]["flags"] = jbc.FLAG_TWOSIDED
    recs[2]["alpha_u"] = 1e-6
    recs[3]["refl"] = np.full(3, 0.72)
    return recs


def _lane_params(rng, n):
    recs = _bsdf_records()
    ids = rng.integers(-1, len(recs), n).astype(np.int32)
    uv = rng.random((2, n), dtype=np.float32)
    jt = jbc.build_table(recs)
    tt = tbc.build_table(recs, "cpu")
    jp = jbc.resolve_v(jt, TextureBuilder().build(), jnp.asarray(ids),
                       *(jnp.asarray(a) for a in uv))
    tp = tbc.resolve_v(tt, None, torch.from_numpy(ids))
    return jt, tt, jp, tp


def test_build_table_and_resolve_v_exact():
    rng = np.random.default_rng(21)
    jt, tt, jp, tp = _lane_params(rng, 4096)
    for k in tbc.BSDF_LEAVES:
        np.testing.assert_array_equal(npy(getattr(tt, k)),
                                      npy(getattr(jt, k)), err_msg=k)
    assert tt.used_types == jt.used_types and not tt.tex_columns
    for k in ("type", "flags"):
        np.testing.assert_array_equal(npy(getattr(tp, k)),
                                      npy(getattr(jp, k)), err_msg=k)
    for a, b in zip(tp.refl, jp.refl):
        np.testing.assert_array_equal(npy(a), npy(b))
    # no texture or mask: the reference's opacity is 1, which the port drops
    np.testing.assert_array_equal(npy(jp.opacity), 1.0)
    assert tp.opacity is None


def test_diffuse_bsdf():
    rng = np.random.default_rng(22)
    n = 4096
    _, _, jp, tp = _lane_params(rng, n)
    wi, wo = unit_vectors(rng, n), unit_vectors(rng, n)
    close_v3(tev.bsdf_eval_v(tp, tv3(wi), tv3(wo)),
             jev.bsdf_eval_v(jp, jv3(wi), jv3(wo)))
    close(tev.bsdf_pdf_v(tp, tv3(wi), tv3(wo)),
          jev.bsdf_pdf_v(jp, jv3(wi), jv3(wo)))
    u = rng.random((3, n), dtype=np.float32)
    jb = jev.bsdf_sample_v(jp, jv3(wi), *(jnp.asarray(a) for a in u))
    tb = tev.bsdf_sample_v(tp, tv3(wi), *(torch.from_numpy(a) for a in u))
    # wo.z = sqrt(1 - x^2 - y^2) scales the last-bit cos/sin differences of
    # the two libraries by 1/z near the rim: a few ulps of 1 in absolute terms
    close_v3(tb.wo, jb.wo, atol=4e-6)
    close_v3(tb.weight, jb.weight)
    close(tb.pdf, jb.pdf)
    for k in ("delta", "eta", "null_passthrough"):
        np.testing.assert_array_equal(npy(getattr(tb, k)),
                                      npy(getattr(jb, k)))


def _two_light_scene():
    from mitsuba_im_tpu.scene.build import SceneBuilder
    from mitsuba_im_tpu.scene.mesh import TriMesh

    b = SceneBuilder()
    bid = b.add_bsdf(jbc.default_record())
    floor = TriMesh(np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                             float), np.array([[0, 2, 1], [2, 0, 3]]))
    b.add_trimesh(floor, b.new_shape(bid))
    for k, (x, w) in enumerate(((-1.0, 1.0), (1.0, 3.0))):
        quad = TriMesh(np.array([[x - .3, 2, -.3], [x + .3, 2, -.3],
                                 [x + .3, 2, .5], [x - .3, 2, .5]], float),
                       np.array([[0, 1, 2], [2, 3, 0]]))
        sid = b.new_shape(bid)
        b.add_trimesh(quad, sid)
        b.add_emitter(dict(type=jem.EM_AREA, radiance=np.full(3, 4.0 + k),
                           shape=sid, weight=w))
        b.shape_emitter[sid] = k
    return b.build()[0]


@pytest.mark.parametrize("which", ["cornell", "two_lights"])
def test_area_emitters(which):
    rng = np.random.default_rng(23)
    jscene = jax_cornell()[0] if which == "cornell" else _two_light_scene()
    tscene = bridged(jscene)
    jem_t, tem_t = jscene.emitters, tscene.emitters
    n = 4096
    ref = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (n, 3))
    ref = ref.astype(np.float32)
    u = rng.random((3, n), dtype=np.float32)
    js = jem.sample_direct_v(jem_t, jscene.geom, jv3(ref),
                             *(jnp.asarray(a) for a in u))
    ts = tem.sample_direct_v(tem_t, tscene.geom, tv3(ref),
                             *(torch.from_numpy(a) for a in u))
    np.testing.assert_array_equal(npy(ts.emitter), npy(js.emitter))
    if which == "two_lights":
        assert set(np.unique(npy(ts.emitter))) == {0, 1}
    np.testing.assert_array_equal(npy(ts.delta), npy(js.delta))
    for k in ("d", "value", "n"):
        close_v3(getattr(ts, k), getattr(js, k))
    close(ts.dist, js.dist)
    close(ts.pdf, js.pdf)

    eid = rng.integers(-1, tem_t.n_emitters, n).astype(np.int32)
    nrm, wo = unit_vectors(rng, n), unit_vectors(rng, n)
    close_v3(tem.emitted_radiance_v(tem_t, torch.from_numpy(eid), tv3(nrm),
                                    tv3(wo)),
             jem.emitted_radiance_v(jem_t, jnp.asarray(eid), jv3(nrm),
                                    jv3(wo)))
    p_emit = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    close(tem.pdf_direct_area_v(tem_t, torch.from_numpy(eid), tv3(ref),
                                tv3(p_emit), tv3(nrm)),
          jem.pdf_direct_area_v(jem_t, jnp.asarray(eid), jv3(ref),
                                jv3(p_emit), jv3(nrm)))
    close_v3(tem.eval_environment_v(tem_t, tv3(wo)),
             jem.eval_environment_v(jem_t, jv3(wo)))
    close(tem.pdf_direct_env_v(tem_t, tv3(wo)),
          jem.pdf_direct_env_v(jem_t, jv3(wo)))


@pytest.mark.parametrize("case", ["env_emitter", "point_emitter",
                                  "textured_bsdf", "other_bsdf_type"])
def test_unported_features_raise(case):
    """BSDFs the port has not reached raise where they are evaluated:
    BUMPMAP_WRAP's type code (``other_bsdf_type``), which no record
    takes.  A bridged scene with an IRAWAN weave (``textured_bsdf``), the
    sun (a directional record) beside a map and a point light, which
    raised before they were ported (the names are kept), build the
    reference's tables bit for bit."""
    if case in ("env_emitter", "point_emitter"):
        recs = ([tem.envmap_record(np.ones((2, 4, 3))),
                 dict(type=tem.EM_DIRECTIONAL, intensity=np.ones(3),
                      direction=np.array([0.0, -1.0, 0.0]))]
                if case == "env_emitter"
                else [dict(type=tem.EM_POINT, intensity=np.ones(3))])
        bs = (np.array([0.5, 1.0, -0.5]), 2.0)
        out = tem.build_emitters(recs, {}, bs, "cpu")
        ref = jem.build_emitters(recs, {}, bs)
        assert out.used_types == ref.used_types
        for k in ("type", "radiance", "intensity", "position", "direction",
                  "cos_cutoff", "cos_falloff", "area_kind", "prim",
                  "bsphere_center", "bsphere_radius"):
            np.testing.assert_array_equal(npy(getattr(out, k)),
                                          npy(getattr(ref, k)), err_msg=k)
        return
    rec = tbc.default_record()
    if case == "textured_bsdf":
        from mitsuba_im_tpu.core.properties import Properties
        from mitsuba_im_tpu.core.registry import create
        from mitsuba_im_tpu.scene.build import SceneBuilder
        from mitsuba_im_tpu.scene.mesh import TriMesh

        b = SceneBuilder()
        quad = TriMesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1],
                                 [-1, 0, 1]], float),
                       np.array([[0, 1, 2], [2, 3, 0]]))
        b.add_trimesh(quad, b.new_shape(b.add_bsdf(
            create("bsdf", Properties("irawan")))))
        jscene = b.build()[0]
        arrays, statics = export_tables(jscene)
        assert len(statics["bsdfs.weaves"]) == 1
        out = scene_from_numpy(arrays, statics, "cpu").bsdfs
        assert out.weaves[0] == tir.WeavePattern.from_dict(
            dataclasses.asdict(jscene.bsdfs.weaves[0]))
        assert out.weaves[0].normalization == \
            jscene.bsdfs.weaves[0].normalization
        np.testing.assert_array_equal(npy(out.weave_id), [0])
        return
    rec["type"] = tbc.BUMPMAP_WRAP
    p = tbc.resolve_v(tbc.build_table([rec], "cpu"), None,
                      torch.zeros(4, dtype=torch.int32))
    w = tv3(np.tile([[0.0, 0.0, 1.0]], (4, 1)))
    with pytest.raises(NotImplementedError):
        tev.bsdf_eval_v(p, w, w)
