"""Port vs reference: the slice end to end.  ``scenes.material_cornell``
(the thirteen families' icosahedra in the Cornell box under the area light
and a Hosek sky, brute force) and a 2,000-triangle displaced sphere under a
synthetic 32 x 64 map (the hierarchy branch), rendered by both packages on
the CPU and gated as ``parity_check.py`` gates the card against the CPU.

Both packages build the scene from the same records (the port's
``fill_material_cornell`` feeds the JAX package's builder too), and the
port's own build equals the bridged reference leaf for leaf.  The
gradients of the same scene are in test_torch_material_grads.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, npy, parity_gate

from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.film import film as jfilm
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu.sensor.table import S_PERSPECTIVE as JS_PERSPECTIVE
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.core.transform import Transform as TTransform
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.film import film as tfilm
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.build import SceneBuilder as TBuilder
from mitsuba_im_tpu_torch.scene.mesh import TriMesh as TTriMesh
from mitsuba_im_tpu_torch.sensor.table import make_sensor as tmake_sensor
from mitsuba_im_tpu_torch.sensor.table import S_PERSPECTIVE as TS_PERSPECTIVE

torch.set_num_threads(2)


def jax_material_cornell(res=32, depth=4):
    """material_cornell built by the JAX package (box filter, 1 spp)."""
    b = JBuilder()
    scenes.fill_material_cornell(b)
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    b.settings.width = b.settings.height = res
    b.settings.spp = 1
    b.settings.rfilter = jfilm.F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=depth)
    return b.build()


def _leaves(scene):
    out = {}
    for part in ("geom", "bsdfs", "emitters", "sensor"):
        obj = getattr(scene, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = getattr(obj, f.name)
    for k in ("shape_bsdf", "shape_emitter"):
        out[f"scene.{k}"] = getattr(scene, k)
    return out


def test_material_cornell_render_parity_gate():
    """The scene: 272 triangles (brute force on both sides), the thirteen
    families, two emitters; the port's tables equal the bridged reference's
    leaf for leaf; the 32^2 depth-4 renders pass the gate."""
    jscene, jsettings = jax_material_cornell()
    port, settings = scenes.material_cornell("cpu")
    assert port.geom.n_tris == jscene.geom.n_tris == 272
    assert port.clusters is None and not jscene.use_bvh
    assert set(port.bsdfs.used_types) == {tbc.DIFFUSE} | {
        int(r["type"]) for r, _ in scenes._material_records()}
    assert len(port.bsdfs.used_types) == 14
    assert port.emitters.used_types == (tem.EM_AREA, tem.EM_ENVMAP)
    assert (settings.width, settings.spp, settings.integrator_props) == (
        1024, 4, dict(max_depth=5))
    ref_leaves, port_leaves = _leaves(bridged(jscene)), _leaves(port)
    assert ref_leaves.keys() == port_leaves.keys()
    for key, a in ref_leaves.items():
        b = port_leaves[key]
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        else:
            assert a == b, key

    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings, spp=1)))
    settings.width = settings.height = 32
    settings.spp = 1
    settings.integrator_props = dict(max_depth=4)
    out = npy(tfilm.develop(tjob.render_film(port, settings)))
    assert out.shape == ref.shape == (32, 32, 3)
    assert np.isfinite(out).all() and (out >= 0).all()
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


def _synthetic_map():
    """32 x 64 texels: a warm bright patch over a blue gradient."""
    rng = np.random.default_rng(90)
    v = (np.arange(32) + 0.5) / 32
    pix = np.stack([0.2 + 0.3 * v, 0.3 + 0.2 * v, 0.9 - 0.4 * v], -1)
    pix = np.repeat(pix[:, None], 64, 1) * (1 + 0.2 * rng.random((32, 64, 1)))
    pix[8:11, 40:44] = [30.0, 24.0, 12.0]
    return pix.astype(np.float32)


def test_mesh_under_envmap_render_parity_gate():
    """The hierarchy branch under a map: large_scene's displaced sphere at
    a 2,000-triangle target (1,984 triangles) under a synthetic map, 32^2,
    depth 3, 1 spp, against the JAX package's (flat BVH on the CPU)."""
    from bench_scenes import _displaced_sphere
    from mitsuba_im_tpu.core.properties import Properties
    from mitsuba_im_tpu.core.registry import create as jcreate
    from mitsuba_im_tpu.scene.mesh import TriMesh as JTriMesh

    pix = _synthetic_map()
    b = JBuilder()
    props = Properties("roughconductor")
    props.set("distribution", "ggx")
    props.set("alpha", 0.2)
    bid = b.add_bsdf(jcreate("bsdf", props, b))
    pos, idx = _displaced_sphere(2000)
    b.add_trimesh(JTriMesh(pos, idx).compute_normals(), b.new_shape(bid))
    b.add_emitter(tem.envmap_record(pix))
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        [0.0, 0.05, 0.3], [0, 0, 0], [0, 1, 0]), fov_deg=40.0)
    b.settings.width = b.settings.height = 32
    b.settings.spp = 1
    b.settings.rfilter = jfilm.F_BOX
    b.settings.integrator = "path"
    b.settings.integrator_props = dict(max_depth=3)
    jscene, jsettings = b.build()
    assert jscene.use_bvh

    tb = TBuilder()
    bid = tb.add_bsdf(tbc.conductor_record(rough=True, alpha=0.2,
                                           distribution="ggx"))
    pos, idx = scenes.displaced_sphere(2000)
    tb.add_trimesh(TTriMesh(pos, idx).compute_normals(), tb.new_shape(bid))
    tb.add_emitter(tem.envmap_record(pix))
    tb.sensor = tmake_sensor(TS_PERSPECTIVE, TTransform.look_at(
        [0.0, 0.05, 0.3], [0, 0, 0], [0, 1, 0]), fov_deg=40.0, device="cpu")
    tb.settings.width = tb.settings.height = 32
    tb.settings.spp = 1
    tb.settings.rfilter = tfilm.F_BOX
    tb.settings.integrator = "path"
    tb.settings.integrator_props = dict(max_depth=3)
    port, settings = tb.build("cpu")
    assert port.clusters is not None and port.geom.n_tris == 1984
    assert port.emitters.env_is_map
    ref = npy(jfilm.develop(jjob.render_film(jscene, jsettings, spp=1)))
    out = npy(tfilm.develop(tjob.render_film(port, settings)))
    assert np.isfinite(out).all() and (out >= 0).all()
    # the corners see the map, not a constant
    assert len({tuple(out[i, j]) for i, j in ((0, 0), (0, -1), (-1, 0),
                                               (-1, -1))}) == 4
    st = parity_gate(out.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


def test_large_scene_env_options():
    """``env`` takes "constant" or "sky"; anything else raises."""
    with pytest.raises(ValueError):
        scenes.large_scene("cpu", res=8, n_tris_target=600, env="sun")
    sc, _ = scenes.large_scene("cpu", res=8, n_tris_target=600, env="sky")
    assert sc.emitters.env_is_map
    assert tuple(sc.emitters.env_rows.shape) == (256, 512, 3)
    assert float(sc.emitters.env_rows.max()) > 1.0
