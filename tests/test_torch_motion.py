"""Port vs reference: deformable motion blur (``scene/shapes.py``'s
``deformable``, ``SceneBuilder.add_trimesh_motion``, ``Scene.with_time``,
the shutter time of a pass in ``render/job.py``, and the motion hierarchy
``accel/hierarchy.py::build_hierarchy_motion`` with its lerp in
``intersect_hierarchy_plain``, the plain version of ``csrc/
hier_traverse.cu``'s motion mode).

Tables, the frame-1 mirror and the lerped tables at three shutter times
equal the reference's bit for bit (its ``with_time`` run eagerly, one
rounding per operation).  The motion hierarchy's tables equal the
reference's; its traversal at three times agrees with the reference's XLA
driver on found, prim and inst exactly and on t, u, v to the tolerances of
tests/test_torch_hierarchy.py (XLA contracts the reference's lerp and
Moeller-Trumbore into fused multiply-adds on the CPU), while the port's
own t, u, v equal a float32 numpy lerp and Moeller-Trumbore, one rounding
per operation, bit for bit.  A deformable quad (brute force) and a
deformable 1,300-triangle sphere (the motion hierarchy) render from scene
files through both packages under parity_check.py's image gate.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_same_scene, bridged, close, npy,
                                parity_gate, tv3, unit_vectors)
from test_torch_hierarchy import UV_ATOL, _mt_numpy

from mitsuba_im_tpu.accel import hierarchy as jhy
from mitsuba_im_tpu.film.film import develop as jdevelop
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.accel import cuda_hierarchy as ch
from mitsuba_im_tpu_torch.accel import hierarchy as thy
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene import mesh as tmesh
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.scenes import displaced_sphere

torch.set_num_threads(2)

TIMES = (0.0, 0.37, 1.0)


def _quad(dx):
    return tmesh.TriMesh(
        np.array([[-0.3 + dx, 0, 0], [0.3 + dx, 0, 0], [0.3 + dx, 0.6, 0],
                  [-0.3 + dx, 0.6, 0]], np.float64),
        np.array([[0, 1, 2], [0, 2, 3]], np.int64))


def _sphere(dx):
    pos, idx = displaced_sphere(1300)
    pos = pos * 6.0 + [dx, 0.3, 0.0]
    return tmesh.TriMesh(pos, idx)


def _write(td, frames, res=16, spp=4):
    tmesh.save_serialized(os.path.join(td, "frames.serialized"), frames)
    xml = f"""<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
  <sensor type="perspective"><float name="fov" value="45"/>
    <float name="shutterOpen" value="0"/>
    <float name="shutterClose" value="1"/>
    <transform name="toWorld">
      <lookat origin="0, 0.3, 2.5" target="0, 0.3, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/><rfilter type="box"/></film>
  </sensor>
  <shape type="deformable"><string name="filename" value="frames.serialized"/>
    <bsdf type="diffuse"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="-90"/><translate y="-0.2"/></transform></shape>
  <emitter type="constant"><rgb name="radiance" value="1 1 1"/></emitter>
</scene>
"""
    path = os.path.join(td, "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


@pytest.mark.parametrize("case", ["quad", "sphere"])
def test_scene_tables_and_lerp_match_reference(case, tmp_path):
    frames = ([_quad(-0.6), _quad(0.6)] if case == "quad"
              else [_sphere(-0.3), _sphere(0.3)])
    path = _write(str(tmp_path), frames)
    jscene, _ = jload(path)
    tscene, _ = tload(path, device="cpu")
    assert_same_scene(tscene, bridged(jscene))
    assert tscene.motion is not None
    assert (tscene.clusters is not None) == (case == "sphere")
    if case == "sphere":
        assert tscene.clusters.has_motion and jscene.clusters.has_motion
    for t in TIMES:
        jt = jscene.with_time(jnp.float32(t))
        tt = tscene.with_time(t)
        for k in ("tri_p0", "tri_e1", "tri_e2", "tri_shad"):
            np.testing.assert_array_equal(npy(getattr(tt.geom, k)),
                                          npy(getattr(jt.geom, k)),
                                          err_msg=f"{k} at {t}")
        if case == "sphere":
            assert tt.clusters.time == float(np.float32(t))
            assert float(jt.clusters.time) == tt.clusters.time
    # the bridge carries a reference scene at a shutter time across
    assert_same_scene(tscene.with_time(0.37),
                      bridged(jscene.with_time(jnp.float32(0.37))))


def test_shutter_time_matches_reference(tmp_path):
    """shutter_open + shutter_time * u in float32, u from the pass index's
    golden-ratio word, as the reference's render pass computes it, from the
    shutter the scene's build read from its sensor to the host."""
    path = _write(str(tmp_path), [_quad(-0.6), _quad(0.6)])
    with open(path) as f:
        xml = f.read()
    with open(path, "w") as f:
        f.write(xml.replace('"shutterOpen" value="0"',
                            '"shutterOpen" value="0.25"').replace(
            '"shutterClose" value="1"', '"shutterClose" value="0.95"'))
    tscene, _ = tload(path, device="cpu")
    jscene, _ = jload(path)
    t_open = jnp.float32(jscene.sensor.shutter_open)
    t_len = jnp.float32(jscene.sensor.shutter_time)
    assert tscene.shutter == (float(t_open), float(t_len))
    assert bridged(jscene).shutter == tscene.shutter
    for idx in (0, 1, 2, 3, 17, 1000, 2 ** 31 + 5):
        u_t = ((jnp.uint32(idx) * jnp.uint32(2654435769)).astype(jnp.float32)
               / 4294967296.0)
        ref = t_open + t_len * u_t
        assert tjob.shutter_time(tscene, idx) == float(ref), idx


def _motion_pair():
    rng = np.random.default_rng(60)
    n = 3000
    p0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    q0 = (p0 + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    f1 = (e1 * np.float32(1.1)).astype(np.float32)
    frames = (p0, e1, e2, q0, f1, e2)
    return (frames, jhy.build_hierarchy_motion(*frames),
            thy.build_hierarchy_motion(*frames, device="cpu"))


@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_traversal_vs_reference(any_hit):
    frames, jh, th = _motion_pair()
    for k in thy.HIERARCHY_LEAVES + ("blocks1",):
        np.testing.assert_array_equal(npy(getattr(th, k)),
                                      npy(getattr(jh, k)), err_msg=k)
    assert th.has_motion and th.n_supers == jh.n_supers
    rng = np.random.default_rng(63)
    n = 1024
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = unit_vectors(rng, n)
    tmax = (rng.uniform(0.0, 4.0, n).astype(np.float32) if any_hit
            else np.full(n, 1e30, np.float32))
    for t in TIMES:
        ref = jhy.intersect_hierarchy(
            jh.replace(time=jnp.float32(t)), jnp.asarray(o), jnp.asarray(d),
            1e-4, jnp.asarray(tmax), any_hit=any_hit)
        ref = {k: npy(a) for k, a in ref.items()}
        hits, _ = thy.intersect_hierarchy_plain(
            th.at_time(t), tv3(o), tv3(d), 1e-4, torch.from_numpy(tmax),
            any_hit=any_hit)
        out = {k: npy(getattr(hits, k)) for k in hits._fields}
        found = ref["found"]
        assert found.any() and not found.all()
        np.testing.assert_array_equal(out["found"], found)
        # the wrapper's plain branch is this traversal
        np.testing.assert_array_equal(
            npy((ch.hier_anyhit if any_hit else
                 lambda *a: ch.hier_closest(*a)[5])(
                th.at_time(t), tv3(o), tv3(d), 1e-4,
                torch.from_numpy(tmax))), found)
        if any_hit:
            continue
        tie = found & (out["prim"] != ref["prim"])
        assert tie.mean() < 1e-3
        same = found & ~tie
        for k in ("t", "u", "v"):
            close(out[k][same], ref[k][same],
                  atol=UV_ATOL if k in ("u", "v") else 1e-6)
        # the port's own arithmetic: (1 - t) a + t b, then Moeller-Trumbore
        w0, w1 = np.float32(1.0) - np.float32(t), np.float32(t)
        pid = out["prim"][found]
        lerped = [w0 * a[pid] + w1 * b[pid]
                  for a, b in zip(frames[:3], frames[3:])]
        exact = _mt_numpy(o[found], d[found], *lerped)
        for k, a in zip(("t", "u", "v"), exact):
            np.testing.assert_array_equal(out[k][found], a, err_msg=k)


def test_motion_at_time_zero_is_the_static_traversal():
    """At t = 0 the motion traversal is the static traversal of frame 0
    (the lerp's (1 - 0) a + 0 b is a), bit for bit."""
    frames, _, th = _motion_pair()
    static = thy.build_hierarchy(*frames[:3], device="cpu")
    rng = np.random.default_rng(64)
    o = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    d = unit_vectors(rng, 1024)
    a = thy.intersect_hierarchy_plain(th.at_time(0.0), tv3(o), tv3(d), 1e-4,
                                      1e30)[0]
    b = thy.intersect_hierarchy_plain(static, tv3(o), tv3(d), 1e-4, 1e30)[0]
    # same triangles, another grouping: the same closest hits
    for k in ("found", "t", "u", "v", "prim"):
        np.testing.assert_array_equal(npy(getattr(a, k)), npy(getattr(b, k)),
                                      err_msg=k)


@pytest.mark.parametrize("case", ["quad", "sphere"])
def test_deformable_render_matches_reference(case, tmp_path):
    frames = ([_quad(-0.6), _quad(0.6)] if case == "quad"
              else [_sphere(-0.3), _sphere(0.3)])
    path = _write(str(tmp_path), frames, res=16 if case == "quad" else 12,
                  spp=4 if case == "quad" else 2)
    jscene, jset = jload(path)
    tscene, tset = tload(path, device="cpu")
    ref = np.asarray(jdevelop(jjob.render_film(jscene, jset)))
    port = develop(tjob.render_film(tscene, tset)).numpy()
    st = parity_gate(port, ref)
    assert st["ok"], st
    # the shutter moved the mesh: not the frame-0 image
    still = develop(tjob.render_film(dataclasses.replace(
        tscene.with_time(0.0), motion=None), tset)).numpy()
    assert np.abs(still - port).max() > 0.05
