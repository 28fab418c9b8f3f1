"""Port vs reference: the delta and analytic area emitters
(``emitter/table.py``), the emitter factories (``emitter/__init__.py``),
the sun and the Preetham sky (``emitter/sunsky.py``), analytic spheres and
disks in the builder (``scene/build.py``, ``scene/shapes.py``) and the
bridge's new leaves, and the slice end to end: ``scenes.lights_cornell``
and a mesh under ``sunsky`` through both packages' ``render_film``.  The
reference's side of ``lights_cornell`` is built by its own shape, emitter
and BSDF plugins and its own ``Transform``; the port's spheres, disks and
transforms are also held case by case against those plugins.

Host code (tables, records, the sunsky functions) is held bit for bit;
the Hosek bake's XYZ-to-RGB product is XLA's matrix product in the
reference, so its pixels are held to rel 1e-5 / abs 1e-6
(test_torch_envmap.py).  Device stages agree to rel 1e-5 / abs 1e-6, the
sphere's and disk's sampled points to abs 4e-6 (sin and cos of the
sample), a sample's pdf to rel 1e-5 plus its cosine's rounding over the
cosine; the renders pass ``parity_check.py:137``'s gate.
"""
import dataclasses
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, close_v3, jv3, npy,
                                parity_gate, tv3, unit_vectors)

from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.core.registry import create
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.emitter import sunsky as jsunsky
from mitsuba_im_tpu.emitter import table as jem
from mitsuba_im_tpu.film import film as jfilm
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu_torch import emitter as temf
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.core.transform import Transform as TTransform
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.film import film as tfilm
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene import shapes as tshapes
from mitsuba_im_tpu_torch.scene.bridge import export_tables
from mitsuba_im_tpu_torch.scene.build import SceneBuilder as TBuilder
from mitsuba_im_tpu_torch.sensor import table as tsensor

torch.set_num_threads(2)
# the module (the package's ``sunsky`` attribute is the factory)
tsunsky = importlib.import_module("mitsuba_im_tpu_torch.emitter.sunsky")


def _props(name, **kw):
    p = Properties(name)
    for k, v in kw.items():
        p.set(k, v)
    return p


def _reference_shape(b, name, bsdf, emitter=None, **kw):
    """The reference's ``name`` shape plugin into its builder ``b``, with
    the BSDF id ``bsdf`` and, given an area emitter's properties, that
    emitter."""
    props = _props(name, **kw)
    props.children["bsdf"] = bsdf
    if emitter is not None:
        props.children["emitter"] = create("emitter", _props("area", **emitter))
    return create("shape", props, b)


def fill_reference_lights_cornell(b):
    """lights_cornell's content into the reference's builder ``b`` through
    the reference's own plugins and ``Transform``: the shared Cornell box
    (``_tiny_cornell``'s walls and light, held by test_torch_scene.py),
    then the sphere, the disk, the point, spot and collimated lights, as
    :func:`scenes.fill_lights_cornell` places them."""
    scenes._cornell_box(b)
    white = b.add_bsdf(create("bsdf", _props("diffuse", reflectance=0.72)))
    _reference_shape(b, "sphere", white, dict(radiance=[2.0, 4.0, 9.0]),
                     center=[-0.45, 0.3, 0.25], radius=0.18)
    _reference_shape(b, "disk", white, dict(radiance=[9.0, 6.0, 2.0]),
                     toWorld=(JTransform.translate([0.45, 1.55, -0.35])
                              @ JTransform.rotate([1, 0, 0], 90.0)
                              @ JTransform.scale(0.16)))
    b.add_emitter(create("emitter", _props(
        "point", intensity=[1.2, 1.2, 1.0], position=[0.55, 0.9, 0.5])))
    b.add_emitter(create("emitter", _props(
        "spot", intensity=[6.0, 3.0, 3.0], cutoffAngle=25.0,
        toWorld=JTransform.look_at([-0.6, 1.8, -0.5], [-0.2, 0.0, 0.3],
                                   [0, 1, 0]))))
    b.add_emitter(create("emitter", _props(
        "collimated", power=[5.0, 5.0, 5.0],
        toWorld=JTransform.look_at([0.1, 1.8, 0.6], [0.1, 0.0, 0.4],
                                   [0, 0, 1]))))


@functools.lru_cache(maxsize=None)
def jax_lights_cornell(res=16, spp=2, depth=3):
    """lights_cornell built by the JAX package's plugins (its thin lens,
    ldsampler, the Gaussian filter), once."""
    b = JBuilder()
    fill_reference_lights_cornell(b)
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(tsensor.S_THINLENS, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"],
        **scenes.LIGHTS_LENS)
    b.settings.width = b.settings.height = res
    b.settings.spp = spp
    b.settings.sampler = "ldsampler"
    b.settings.integrator_props = dict(max_depth=depth)
    return b.build()


def _leaves(scene):
    out = {}
    for part in ("geom", "emitters", "sensor"):
        obj = getattr(scene, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = getattr(obj, f.name)
    for k in ("shape_bsdf", "shape_emitter"):
        out[f"scene.{k}"] = getattr(scene, k)
    return out


def test_lights_cornell_tables_bit_exact():
    """The port's build of lights_cornell equals the bridged reference
    leaf for leaf (spheres, disks, the new emitter columns, the thin lens),
    and its settings are hdrfilm's defaults with ldsampler."""
    jscene, _ = jax_lights_cornell()
    arrays, statics = export_tables(jscene)
    assert statics["emitters.used_types"] == (
        tem.EM_AREA, tem.EM_POINT, tem.EM_SPOT, tem.EM_COLLIMATED)
    assert statics["emitters.used_area_kinds"] == (
        tem.AK_TRIMESH, tem.AK_SPHERE, tem.AK_DISK)
    port, settings = scenes.lights_cornell("cpu")
    assert (port.geom.n_tris, port.geom.n_spheres, port.geom.n_disks) == (
        12, 1, 1)
    assert port.emitters.used_area_kinds == statics[
        "emitters.used_area_kinds"]
    ref, out = _leaves(bridged(jscene)), _leaves(port)
    assert ref.keys() == out.keys()
    for key, a in ref.items():
        b = out[key]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        else:
            assert a == b, key
    assert (settings.width, settings.spp, settings.sampler,
            settings.rfilter, settings.rfilter_radius) == (
        1024, 4, "ldsampler", tfilm.F_GAUSSIAN, 2.0)


# each transform as a list of (constructor, argument) factors, composed
# left to right with ``@``
XFORMS = {
    "identity": [],
    "translate": [("translate", [0.3, -1.2, 2.5])],
    "scale": [("scale", 0.16)],
    "scale3": [("scale", [0.3, 0.5, 2.0])],
    "rotate": [("rotate", ([1, 1, 0], 37.0))],
    "look_at": [("look_at", ([0.2, 1.8, 0.4], [-0.1, 0.0, 0.2], [0, 0, 1]))],
    "disk": [("translate", [0.45, 1.55, -0.35]),
             ("rotate", ([1, 0, 0], 90.0)), ("scale", 0.16)],
    "mixed": [("translate", [-0.2, 0.7, 0.1]), ("rotate", ([0.2, 1, -0.4],
                                                           -115.0)),
              ("scale", [1.5, 0.5, 0.8]), ("rotate", ([0, 0, 1], 12.5))],
}


def _xform(cls, name):
    out = cls()
    for ctor, arg in XFORMS[name]:
        args = arg if ctor in ("rotate", "look_at") else (arg,)
        out = out @ getattr(cls, ctor)(*args)
    return out


@pytest.mark.parametrize("name", sorted(XFORMS))
def test_transform_matches_reference(name):
    """The port's Transform constructors, composition (matrix and cached
    inverse) and point/vector application equal the reference's bit for
    bit."""
    ref, out = _xform(JTransform, name), _xform(TTransform, name)
    np.testing.assert_array_equal(out.m, ref.m)
    np.testing.assert_array_equal(out.inv, ref.inv)
    pts = np.random.default_rng(81).normal(size=(64, 3))
    np.testing.assert_array_equal(out.apply_point(pts), ref.apply_point(pts))
    np.testing.assert_array_equal(out.apply_vector(pts),
                                  ref.apply_vector(pts))
    for p in pts[:4]:
        np.testing.assert_array_equal(out.apply_point(p), ref.apply_point(p))
        np.testing.assert_array_equal(out.apply_vector(list(p)),
                                      ref.apply_vector(list(p)))


# (plugin, transform, reference properties, port keywords, emits)
SHAPES = [
    ("sphere", "identity", {}, {}, False),
    ("sphere", "mixed", dict(center=[0.1, -0.3, 0.6], radius=0.4),
     dict(center=[0.1, -0.3, 0.6], radius=0.4), True),
    ("sphere", "scale3", dict(radius=2.0), dict(radius=2.0), True),
    ("disk", "identity", {}, {}, False),
    ("disk", "disk", {}, {}, True),
    ("disk", "mixed", dict(flipNormals=True), dict(flip_normals=True), True),
    ("disk", "look_at", dict(flipNormals=True), dict(flip_normals=True),
     False),
]


@pytest.mark.parametrize("case", range(len(SHAPES)),
                         ids=[f"{c[0]}-{c[1]}" + ("-emit" if c[4] else "")
                              for c in SHAPES])
def test_shapes_match_reference_plugins(case):
    """``shapes.sphere``/``shapes.disk`` fill the port's builder with the
    rows, shape links and area-emitter records (kind, primitive, surface
    area) that the reference's ``sphere``/``disk`` plugins give its
    builder, bit for bit."""
    name, xf, props_kw, port_kw, emits = SHAPES[case]
    radiance = [3.0, 2.0, 0.5]
    jb, tb = JBuilder(), TBuilder()
    for b in (jb, tb):  # a shape before, so ids and rows are not all 0
        b.add_bsdf({})
        b.add_bsdf({})
        b.new_shape(0)
        b.add_emitter({})
    _reference_shape(jb, name, 1, dict(radiance=radiance) if emits else None,
                     toWorld=_xform(JTransform, xf), **props_kw)
    getattr(tshapes, name)(tb, 1, to_world=_xform(TTransform, xf),
                           emitter=temf.area(radiance) if emits else None,
                           **port_kw)
    rows = "_sph" if name == "sphere" else "_disk"
    ref_rows, out_rows = getattr(jb, rows), getattr(tb, rows)
    assert ref_rows.keys() == out_rows.keys()
    for k, a in ref_rows.items():
        ra = np.concatenate([np.reshape(x, (1, -1)) for x in a])
        oa = np.concatenate([np.reshape(x, (1, -1)) for x in out_rows[k]])
        assert ra.dtype == oa.dtype, k
        np.testing.assert_array_equal(oa, ra, err_msg=k)
    assert tb.shape_bsdf == jb.shape_bsdf
    assert tb.shape_emitter == jb.shape_emitter
    assert len(tb.emitter_records) == len(jb.emitter_records) == 1 + emits
    if emits:
        _same_record(tb.emitter_records[-1], jb.emitter_records[-1], name)
        assert tb.emitter_records[-1]["surface_area"] > 0


LOOK = ([0.2, 1.8, 0.4], [-0.1, 0.0, 0.2], [0, 0, 1])
# (plugin, reference properties, port factory, port keywords)
FACTORIES = [
    ("area", dict(radiance=[3.0, 2.0, 1.0], samplingWeight=2.0), "area",
     dict(radiance=[3.0, 2.0, 1.0], sampling_weight=2.0)),
    ("point", dict(intensity=[5.0, 4.0, 3.0], position=[0.1, 1.2, 0.3]),
     "point", dict(intensity=[5.0, 4.0, 3.0], position=[0.1, 1.2, 0.3])),
    ("point", dict(toWorld="look"), "point", dict(to_world="look")),
    ("spot", dict(intensity=7.0, cutoffAngle=30.0, toWorld="look"), "spot",
     dict(intensity=7.0, cutoff_angle=30.0, to_world="look")),
    ("spot", dict(beamWidth=10.0, toWorld="look"), "spot",
     dict(beam_width=10.0, to_world="look")),
    ("directional", dict(irradiance=[2.0, 2.0, 1.0],
                         direction=[0.3, -1.0, 0.2]), "directional",
     dict(irradiance=[2.0, 2.0, 1.0], direction=[0.3, -1.0, 0.2])),
    ("directional", dict(toWorld="look"), "directional",
     dict(to_world="look")),
    ("collimated", dict(power=4.0, toWorld="look"), "collimated",
     dict(power=4.0, to_world="look")),
    ("constant", dict(radiance=0.5), "constant", dict(radiance=0.5)),
    ("sun", {}, "sun", {}),
    ("sun", dict(sunDirection=[0.2, 0.9, -0.3], turbidity=5.0,
                 sunRadiusScale=2.0, scale=0.5), "sun",
     dict(sun_direction=[0.2, 0.9, -0.3], turbidity=5.0,
          sun_radius_scale=2.0, scale=0.5)),
    ("sun", dict(year=2021, month=12, day=21, hour=9.5, latitude=48.1,
                 longitude=11.6, timezone=1.0, toWorld="look"), "sun",
     dict(year=2021, month=12, day=21, hour=9.5, latitude=48.1,
          longitude=11.6, timezone=1.0, to_world="look")),
    ("sky", dict(skyModel="preetham", resolution=64, turbidity=4.0,
                 stretch=1.2), "sky",
     dict(sky_model="preetham", resolution=64, turbidity=4.0, stretch=1.2)),
    ("sky", dict(resolution=32, groundAlbedo=[0.1, 0.2, 0.3]), "sky",
     dict(resolution=32, ground_albedo=[0.1, 0.2, 0.3])),
    ("sunsky", dict(skyModel="preetham", resolution=64, extend=False),
     "sunsky", dict(sky_model="preetham", resolution=64, extend=False)),
]


def _same_record(out, ref, what):
    assert out.keys() == ref.keys(), what
    for k, a in ref.items():
        if k == "pixels" and "hosek" in what:
            np.testing.assert_allclose(out[k], a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(a),
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", range(len(FACTORIES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(FACTORIES)])
def test_emitter_factories_bit_exact(case):
    name, props_kw, factory, port_kw = FACTORIES[case]
    props_kw = {k: JTransform.look_at(*LOOK) if v == "look" else v
                for k, v in props_kw.items()}
    port_kw = {k: TTransform.look_at(*LOOK) if v == "look" else v
               for k, v in port_kw.items()}
    ref = create("emitter", _props(name, **props_kw))
    out = getattr(temf, factory)(**port_kw)
    what = name + ("" if port_kw.get("sky_model") == "preetham"
                   else " hosek")
    if isinstance(ref, list):
        assert len(out) == len(ref) == 2
        for o, r in zip(out, ref):
            _same_record(o, r, what)
    else:
        _same_record(out, ref, what)


def test_sunsky_host_functions_bit_exact():
    for when in ((2010, 7, 10, 15.0, 0.0, 0.0, 35.6894, 139.6917, 9.0),
                 (2021, 12, 21, 9.5, 30.0, 10.0, 48.1, 11.6, 1.0),
                 (1999, 2, 28, 18.0, 0.0, 0.0, -33.9, 18.4, 2.0)):
        np.testing.assert_array_equal(
            tsunsky.sun_direction_from_time(*when),
            jsunsky.sun_direction_from_time(*when))
    for d in ([0.3, 0.8, -0.2], [0.0, 1.0, 0.0], [0.9, 0.05, 0.1],
              [0.2, -0.5, 0.3]):
        for kw in (dict(), dict(turbidity=6.0, scale=2.0)):
            np.testing.assert_array_equal(
                tsunsky.sun_radiance_rgb(d, **kw),
                jsunsky.sun_radiance_rgb(d, **kw))
        for kw in (dict(), dict(turbidity=7.0, stretch=1.5, extend=False)):
            np.testing.assert_array_equal(
                tsunsky.preetham_sky_pixels(48, d, **kw),
                jsunsky.preetham_sky_pixels(48, d, **kw))
    for s in (1.0, 3.0):
        assert tsunsky.sun_solid_angle(s) == jsunsky.sun_solid_angle(s)


def test_direct_sampling_every_kind():
    """sample_direct_v over lights_cornell's six emitters (three area
    kinds, point, spot, collimated), pdf_direct_area_v and
    emitted_radiance_v on seeded points, emitter ids and normals."""
    jscene, _ = jax_lights_cornell()
    tscene = bridged(jscene)
    je, te = jscene.emitters, tscene.emitters
    rng = np.random.default_rng(80)
    n = 4096
    ref = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (n, 3))
    ref = ref.astype(np.float32)
    u = rng.random((3, n), dtype=np.float32)
    js = jem.sample_direct_v(je, jscene.geom, jv3(ref),
                             *(jnp.asarray(a) for a in u))
    ts = tem.sample_direct_v(te, tscene.geom, tv3(ref),
                             *(torch.from_numpy(a) for a in u))
    np.testing.assert_array_equal(npy(ts.emitter), npy(js.emitter))
    assert set(np.unique(npy(ts.emitter))) == set(range(6))
    np.testing.assert_array_equal(npy(ts.delta), npy(js.delta))
    assert npy(ts.delta).any() and not npy(ts.delta).all()
    for k in ("d", "n"):
        close_v3(getattr(ts, k), getattr(js, k), atol=4e-6)
    close_v3(ts.value, js.value)
    close(ts.dist, js.dist)
    # the solid-angle pdf divides by the emitter cosine: its rounding
    # (1e-7 absolute) weighs 1e-7 / cos relative, which grows at grazing
    # samples on the sphere (one lane here has cos 7e-4)
    cos = -sum(npy(a) * npy(b) for a, b in zip(js.d, js.n))
    err = np.abs(npy(ts.pdf) - npy(js.pdf))
    tol = (1e-5 + 1e-7 / np.maximum(np.abs(cos), 1e-12)) * np.abs(
        npy(js.pdf)) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())
    # the collimated beam is never sampled
    beam = npy(ts.emitter) == 5
    assert (npy(ts.pdf)[beam] == 0).all()

    eid = rng.integers(-1, te.n_emitters, n).astype(np.int32)
    nrm, wo = unit_vectors(rng, n), unit_vectors(rng, n)
    close_v3(tem.emitted_radiance_v(te, torch.from_numpy(eid), tv3(nrm),
                                    tv3(wo)),
             jem.emitted_radiance_v(je, jnp.asarray(eid), jv3(nrm),
                                    jv3(wo)))
    p_emit = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    close(tem.pdf_direct_area_v(te, torch.from_numpy(eid), tv3(ref),
                                tv3(p_emit), tv3(nrm)),
          jem.pdf_direct_area_v(je, jnp.asarray(eid), jv3(ref),
                                jv3(p_emit), jv3(nrm)))


def test_each_light_alone():
    """Each of lights_cornell's emitters lights the image alone; the
    collimated beam alone leaves it black, as in the reference."""
    for light in scenes.LIGHTS:
        scene, settings = scenes.lights_cornell("cpu", lights=(light,))
        assert scene.emitters.n_emitters == 1
        settings.width = settings.height = 12
        settings.integrator_props = dict(max_depth=3)
        img = npy(tfilm.develop(tjob.render_film(scene, settings, spp=1)))
        assert np.isfinite(img).all() and (img >= 0).all(), light
        assert (img.sum() == 0) == (light == "collimated"), light


def test_lights_cornell_render_parity_gate():
    """16^2, depth 3, 2 spp of ldsampler through a thin lens with the
    Gaussian filter, against the JAX package's render_film."""
    jscene, jsettings = jax_lights_cornell()
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings)))
    port, settings = scenes.lights_cornell("cpu")
    settings.width = settings.height = 16
    settings.spp = 2
    settings.integrator_props = dict(max_depth=3)
    out = npy(tfilm.develop(tjob.render_film(port, settings)))
    assert out.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(out).all() and (out >= 0).all()
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


def test_sunsky_mesh_render_parity_gate():
    """large_scene(env="sunsky")'s content at a 600-triangle target (612
    triangles: the hierarchy in the port, the BVH in the reference), 16^2,
    depth 2, 2 spp of sobol with the Mitchell filter, against the JAX
    package's render_film."""
    b = JBuilder()
    scenes.fill_large_scene(b, 600, env="sunsky")
    c = scenes.LARGE_CAMERA
    b.sensor = jmake_sensor(tsensor.S_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    b.settings.width = b.settings.height = 16
    b.settings.spp = 2
    b.settings.sampler = "sobol"
    b.settings.rfilter = jfilm.F_MITCHELL
    b.settings.integrator_props = dict(max_depth=2)
    jscene, jsettings = b.build()
    assert jscene.use_bvh and jscene.geom.n_tris == 612
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings)))
    port, settings = scenes.large_scene("cpu", res=16, n_tris_target=600,
                                        env="sunsky")
    assert port.clusters is not None
    assert port.emitters.used_types == (tem.EM_DIRECTIONAL, tem.EM_ENVMAP)
    assert (settings.sampler, settings.spp, settings.rfilter) == (
        "sobol", 2, tfilm.F_MITCHELL)
    ref_leaves, out_leaves = _leaves(bridged(jscene)), _leaves(port)
    for key in ("emitters.intensity", "emitters.direction",
                "emitters.env_rows", "emitters.bsphere_radius"):
        assert torch.equal(ref_leaves[key], out_leaves[key]), key
    settings.integrator_props = dict(max_depth=2)
    out = npy(tfilm.develop(tjob.render_film(port, settings)))
    # finite; the Mitchell filter's negative lobes may make pixels negative
    assert np.isfinite(out).all()
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st
