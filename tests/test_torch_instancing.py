"""Port vs reference: shared-BLAS instancing (``scene/shapes.py``'s
``shapegroup`` and ``instance``, the scene loader's group capture,
``SceneBuilder``'s groups, instances and instanced hierarchy, the
instances' normal rotations in ``scene/geometry.py`` and the hit's
instance id in ``accel/intersect.py``).

A scene file with a group of a mesh, a cube and an analytic sphere,
instanced three times (rotations and uniform scales), beside ordinary
shapes, loads in both packages to the same tables bit for bit (the
instanced hierarchy, ``geom.inst_rot``, the transformed sphere copies, the
bounding sphere over the instances' corners); its interactions agree, and
it renders through both packages under parity_check.py's image gate.  The
same scene with the group expanded into world-space copies renders the
same image.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_same_scene, bridged, close, close_v3,
                                npy, parity_gate, tv3, unit_vectors)

from mitsuba_im_tpu.film.film import develop as jdevelop
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.core.registry import create
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene import mesh as tmesh
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.scenes import displaced_sphere

torch.set_num_threads(2)

INSTANCES = [
    '<translate x="-0.7" y="0.3"/>',
    '<scale value="1.3"/><rotate y="1" angle="35"/><translate x="0.6" y="0.4"/>',
    '<rotate x="1" angle="-60"/><scale value="0.8"/>'
    '<translate y="1.2" z="-0.4"/>',
]


def _write(td, res=16, spp=2, expanded=False):
    pos, idx = displaced_sphere(600)
    tmesh.save_serialized(os.path.join(td, "blob.serialized"),
                          tmesh.TriMesh(pos * 3.0, idx).compute_normals())
    members = ('<shape type="serialized"><string name="filename" '
               'value="blob.serialized"/><bsdf type="roughconductor"/>'
               '</shape><shape type="cube"><transform name="toWorld">'
               '<scale value="0.1"/><translate y="0.3"/></transform>'
               '<bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.5 '
               '0.8"/></bsdf></shape><shape type="sphere"><point '
               'name="center" x="0.3" y="0" z="0"/><float name="radius" '
               'value="0.08"/></shape>')
    if expanded:
        # world-space copies: each member under the instance's transform
        body = ""
        for xf in INSTANCES:
            for m in members.split("</shape>")[:-1]:
                m += "</shape>"
                if "<transform" in m:
                    m = m.replace("</transform>", xf + "</transform>")
                elif 'type="sphere"' in m:
                    m = m.replace("<point", f'<transform name="toWorld">{xf}'
                                  '</transform><point')
                else:
                    m = m.replace("/><bsdf", f'/><transform name="toWorld">'
                                  f'{xf}</transform><bsdf', 1)
                body += m
    else:
        body = f'<shape type="shapegroup" id="grp">{members}</shape>'
        body += "".join(f'<shape type="instance"><ref id="grp"/><transform '
                        f'name="toWorld">{xf}</transform></shape>'
                        for xf in INSTANCES)
    xml = f"""<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="50"/>
    <transform name="toWorld">
      <lookat origin="0, 0.6, 3" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/><rfilter type="box"/></film>
  </sensor>
  {body}
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="-90"/><scale value="3"/><translate y="-0.3"/></transform></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="90"/><scale value="0.3"/><translate y="2.5"/></transform>
    <emitter type="area"><rgb name="radiance" value="10 9 8"/></emitter>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.3 0.3 0.3"/>
  </emitter>
</scene>
"""
    path = os.path.join(td, "expanded.xml" if expanded else "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def test_tables_match_reference(tmp_path):
    path = _write(str(tmp_path))
    jscene, _ = jload(path)
    tscene, _ = tload(path, device="cpu")
    assert_same_scene(tscene, bridged(jscene))
    assert tscene.geom.instanced and tscene.clusters.indirect
    assert tscene.geom.inst_rot.shape[0] == 4  # identity and three
    assert tscene.geom.n_spheres == 3  # one transformed copy an instance
    assert not tscene.clusters.has_motion


def test_interactions_match_reference(tmp_path):
    """The instanced hit (t, prim, instance) and its world-space normals."""
    path = _write(str(tmp_path))
    jscene, _ = jload(path)
    tscene, _ = tload(path, device="cpu")
    rng = np.random.default_rng(3)
    n = 4096
    o = np.tile(np.float32([[0.0, 0.6, 3.0]]), (n, 1))
    o[n // 2:] = rng.uniform(-1.5, 1.5, (n // 2, 3))
    d = unit_vectors(rng, n)
    d[: n // 2] = (rng.uniform([-0.8, -0.6, -0.5], [0.8, 0.6, -0.5],
                               (n // 2, 3)) - [0, 0.1, 0])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jh = jscene.ray_intersect(jnp.asarray(o), jnp.asarray(d))
    th = tscene.ray_intersect_v(tv3(o), tv3(d))
    for k in ("kind", "shape", "inst"):
        np.testing.assert_array_equal(npy(getattr(th, k)),
                                      npy(getattr(jh, k)), err_msg=k)
    inst = npy(th.inst)
    assert len(set(inst[npy(th.kind) == 1].tolist())) == 4
    close(npy(th.t), npy(jh.t))
    ji = jscene.interaction(jnp.asarray(o), jnp.asarray(d), jh)
    ti = tscene.interaction_v(tv3(o), tv3(d), th)
    ok = npy(ji.valid)
    for k in ("ng", "ns", "p"):
        a = np.stack([npy(c) for c in getattr(ti, k)], 1)[ok]
        close(a, npy(getattr(ji, k))[ok], atol=1e-5)


def test_render_matches_reference_and_expansion(tmp_path):
    path = _write(str(tmp_path))
    jscene, jset = jload(path)
    tscene, tset = tload(path, device="cpu")
    ref = np.asarray(jdevelop(jjob.render_film(jscene, jset)))
    port = develop(tjob.render_film(tscene, tset)).numpy()
    st = parity_gate(port, ref)
    assert st["ok"], st
    # the group expanded into world-space copies: the same picture
    escene, eset = tload(_write(str(tmp_path), expanded=True), device="cpu")
    assert not escene.geom.instanced
    group_tris = tscene.geom.n_tris - 4  # stored once; two rectangles
    assert escene.geom.n_tris == 3 * group_tris + 4
    exp = develop(tjob.render_film(escene, eset)).numpy()
    st = parity_gate(exp, port)
    assert st["ok"], st


def test_instance_without_loader_capture():
    """``instance`` of a group given as child Properties (no loader) is
    captured at its first instance and shared by the next."""
    from mitsuba_im_tpu_torch.core.properties import Properties
    from mitsuba_im_tpu_torch.core.transform import Transform
    from mitsuba_im_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    cube = Properties("cube")
    group = [cube]
    for x in (-1.0, 1.0):
        p = Properties("instance")
        p.children["shapegroup"] = group
        p.set("toWorld", Transform.translate([x, 0.0, 0.0]))
        create("shape", p, b)
    assert len(b.blas_groups) == 1 and len(b.instances) == 2
    scene, _ = b.build("cpu")
    assert scene.geom.n_tris == 12 and scene.geom.instanced
