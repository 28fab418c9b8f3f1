"""Port vs reference: the volumetric path tracer
(``mitsuba_im_tpu_torch/integrators/volpath.py``) and its scenes.

Each scene file is loaded by both packages; ``volpath_li_v`` runs on the
same camera rays (pixel centres, 16^2, depth <= 4) with the same per-lane
sampler, and the radiance is held to the reference's under
parity_check.py's image gate, the sampler's dimension afterwards equal
(every tracking loop ran as many iterations as the reference's): a scene
without media, a homogeneous HG sphere behind a ``null`` boundary, a
``dielectric`` boundary, a constant-density grid, a 16^3 grid with an
albedo grid, the camera in fog with ``exterior`` transitions, and a
Kajiya-Kay grid medium along an orientation grid.  Microflake follows the
port's one phase convention (ROADMAP C4), the reference's mirrored, and
is held to the white furnace instead.

The port alone, by expectation: ``volpath`` without media against the
port's ``path`` (means within 5%), the constant-density grid against the
equivalent homogeneous medium (within 3%), the volumetric white furnace
(homogeneous, grid, Kajiya-Kay about the default +z fibre axis, and
microflake along an orientation grid: 1 within 0.02), the Beer-Lambert absorber (within 3%); and the small
``volume_cornell`` from its scene file (an OBJ icosahedron, ``.vol`` files
written here) through ``python -m mitsuba_im_tpu_torch`` against
``render_film``, its media bit for bit ``scenes.volume_cornell``'s.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (assert_same_scene, bridged, jv3, npy,
                                parity_gate, tv3)
from test_render import CORNELL_XML

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.integrators import volpath as jvp
from mitsuba_im_tpu.integrators.path import PathConfig as JPathConfig
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.integrators.path import PathConfig, path_li_v
from mitsuba_im_tpu_torch.integrators.volpath import volpath_li_v
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.media import medium as tmed
from mitsuba_im_tpu_torch.media.volume import write_vol
from mitsuba_im_tpu_torch.render.job import render_film
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch import scenes

torch.set_num_threads(2)

RES = 16
DEPTH = 4

HEAD = """<scene version="0.6.0">
  <integrator type="volpath"><integer name="maxDepth" value="{depth}"/>
  </integrator>
  {media}
  <sensor type="perspective">{camera_medium}
    <float name="fov" value="50"/>
    <transform name="toWorld"><lookat origin="0, 0.3, 3.2" target="0, 0, 0"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/><rfilter type="box"/></film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="{env}"/></emitter>
  {light}{body}
</scene>
"""

LIGHT = """<shape type="rectangle"><bsdf type="diffuse"/>
    <transform name="toWorld"><rotate x="1" angle="90"/>
      <scale value="0.4"/><translate y="1.6"/></transform>
    <emitter type="area"><rgb name="radiance" value="6, 5, 4"/></emitter>
  </shape>
  """
HOMOG = """<medium type="homogeneous" id="{id}">
  <rgb name="sigmaS" value="{ss}"/><rgb name="sigmaA" value="{sa}"/>
  {phase}</medium>"""
GRID = """<medium type="heterogeneous" id="{id}">
  <float name="scale" value="{scale}"/>
  <volume name="density" type="gridvolume">
    <string name="filename" value="{density}"/></volume>
  {albedo}{orientation}{phase}</medium>"""
HG = '<phase type="hg"><float name="g" value="{}"/></phase>'
SPHERE = """<shape type="sphere"><float name="radius" value="{r}"/>
  {bsdf}<ref name="interior" id="{interior}"/>{exterior}</shape>"""
NULL = '<bsdf type="null"/>'
KKAY = ('<phase type="kkay"><float name="ks" value="0.6"/><float '
        'name="kd" value="0.1"/><float name="exponent" value="8"/></phase>')


def _cases(d):
    """Scene files of each case by name (the .vol files written into
    ``d``); those in REFERENCE are held to the reference."""
    vol = lambda n: os.path.join(d, n)  # noqa: E731
    grid_alb = ('<volume name="albedo" type="gridvolume"><string '
                f'name="filename" value="{vol("albedo.vol")}"/></volume>')
    const_alb = ('<volume name="albedo" type="constvolume"><float '
                 'name="value" value="{}"/></volume>')
    ori = ('<volume name="orientation" type="gridvolume"><string '
           f'name="filename" value="{vol("orientation.vol")}"/></volume>')
    homog = lambda ss, sa, ph, i="m": HOMOG.format(  # noqa: E731
        id=i, ss=ss, sa=sa, phase=ph)
    sphere = lambda i="m", bsdf=NULL, ext="", r=1.0: SPHERE.format(  # noqa
        r=r, bsdf=bsdf, interior=i, exterior=ext)

    def scene(media, body, env=1.0, camera="", depth=DEPTH):
        # the furnaces (depth -1) see the unit environment alone
        return HEAD.format(depth=depth, media=media, camera_medium=camera,
                           res=RES, env=env, body=body,
                           light=LIGHT if depth > 0 else "")

    fog_ext = '<ref name="exterior" id="fog"/>'
    return {
        "null_hg": scene(homog("1.2, 1.0, 0.8", 0.2, HG.format(0.6)),
                         sphere()),
        "dielectric": scene(
            homog("1.2", "0.3", HG.format(0.3)),
            sphere(bsdf='<bsdf type="dielectric"><float name="intIOR" '
                   'value="1.33"/></bsdf>')),
        "const_grid": scene(GRID.format(
            id="m", scale=1.5, density=vol("ones.vol"),
            albedo=const_alb.format(0.8), orientation="",
            phase='<phase type="isotropic"/>'), sphere()),
        "const_homog": scene(homog(1.2, 0.3, '<phase type="isotropic"/>'),
                             sphere()),
        "grid_albedo": scene(GRID.format(
            id="m", scale=4.0, density=vol("cloud.vol"), albedo=grid_alb,
            orientation="", phase=HG.format(0.4)), sphere()),
        "fog": scene(
            homog(0.08, 0.04, HG.format(0.5), "fog")
            + homog(1.5, 0.2, '<phase type="rayleigh"/>'),
            sphere(ext=fog_ext, r=0.6)
            + '<shape type="cube"><bsdf type="diffuse"/><transform '
            'name="toWorld"><scale value="0.3"/><translate x="0.9" '
            f'y="-0.5"/></transform>{fog_ext}</shape>',
            camera='<ref name="exterior" id="fog"/>'),
        "kkay": scene(GRID.format(
            id="m", scale=2.0, density=vol("ones.vol"),
            albedo=const_alb.format(0.9), orientation=ori,
            phase=KKAY), sphere()),
        "furnace_homog": scene(homog(1.2, 0.0, HG.format(0.3)), sphere(),
                               depth=-1),
        "furnace_grid": scene(GRID.format(
            id="m", scale=1.2, density=vol("ones.vol"),
            albedo=const_alb.format(1.0), orientation="",
            phase=HG.format(-0.3)), sphere(), depth=-1),
        "furnace_kkay": scene(homog(1.2, 0.0, '<phase type="kkay"/>'),
                              sphere(), depth=-1),
        "furnace_microflake": scene(GRID.format(
            id="m", scale=1.2, density=vol("ones.vol"),
            albedo=const_alb.format(1.0), orientation=ori,
            phase='<phase type="microflake"><float name="stddev" '
                  'value="0.2"/></phase>'), sphere(), depth=-1),
    }


REFERENCE = ("null_hg", "dielectric", "const_grid", "grid_albedo", "fog",
             "kkay")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("volpath")
    r = np.random.default_rng(7)
    box = ([-1.05] * 3, [1.05] * 3)
    write_vol(str(d / "ones.vol"), np.ones((16, 16, 16), np.float32), *box)
    write_vol(str(d / "cloud.vol"), scenes.cloud_density(16, seed=3), *box)
    write_vol(str(d / "albedo.vol"),
              (0.4 + 0.6 * r.random((16, 16, 16, 3))).astype(np.float32),
              *box)
    write_vol(str(d / "orientation.vol"), scenes.swirl_orientation(4), *box)
    for name, xml in _cases(str(d)).items():
        with open(d / f"{name}.xml", "w") as f:
            f.write(xml)
    return d


def _camera_rays(tscene):
    """Pixel-centre camera rays (numpy) and both packages' samplers of
    pass 0 after the camera block."""
    from mitsuba_im_tpu_torch.sensor.table import sample_ray_v

    n = RES * RES
    pix = np.arange(n)
    u = ((pix % RES) + 0.5).astype(np.float32) / RES
    v = ((pix // RES) + 0.5).astype(np.float32) / RES
    z = torch.zeros(n)
    o, d, _ = sample_ray_v(tscene.sensor, torch.from_numpy(u),
                           torch.from_numpy(v), z, z)
    o = np.stack([npy(c) for c in o], 1)
    d = np.stack([npy(c) for c in d], 1)
    js = jrng.next_block4_v(jrng.make_sampler_v(
        jnp.asarray(pix, jnp.uint32), 0, 3))[0]
    ts = trng.next_block4_v(trng.make_sampler_v(torch.from_numpy(pix), 0,
                                                3))[0]
    return o, d, js, ts


def _port_li(tscene, o, d, ts, cfg):
    li, ts2 = volpath_li_v(tscene, ts, tv3(o), tv3(d), cfg)
    return np.stack([npy(c) for c in li], 1), ts2


def _reference_li(jscene, js, o, d, depth):
    """The reference's volpath_li_v, run eagerly: under ``jax.jit`` XLA
    contracts multiply-adds, which moves a lane's segment hit or medium
    transition by a last bit, and one lane that enters a tracking loop in
    one package and not the other changes the batch's iteration count,
    and so every later draw of every lane."""
    with jax.disable_jit():
        li, js2 = jvp.volpath_li_v(jscene, js, jv3(o), jv3(d),
                                   JPathConfig(max_depth=depth, remat=False))
    return np.stack([npy(c) for c in li], 1), js2


@pytest.mark.parametrize("case", REFERENCE)
def test_volpath_matches_reference(case, scene_dir):
    path = str(scene_dir / f"{case}.xml")
    tscene, _ = tload(path, device="cpu")
    jscene, _ = jload(path)
    o, d, js, ts = _camera_rays(tscene)
    tmed.reset_track_stats()
    port, ts2 = _port_li(tscene, o, d, ts, PathConfig(max_depth=DEPTH))
    ref, js2 = _reference_li(jscene, js, o, d, DEPTH)
    np.testing.assert_array_equal(npy(ts2.dim).astype(np.uint64),
                                  npy(js2.dim).astype(np.uint64))
    st = parity_gate(port.reshape(RES, RES, 3), ref.reshape(RES, RES, 3))
    assert st["ok"], st
    assert ref.mean() > 0.05 and np.isfinite(port).all()
    if "grid" in case:
        assert tmed.TRACK_STATS["iterations"] > 0


def _mean(tscene, cfg, n=2048, spp=4, origin=(0.0, 0.0, -3.0),
          direction=(0.0, 0.0, 1.0), li=volpath_li_v):
    o = np.tile(np.asarray(origin, np.float32), (n, 1))
    d = np.tile(np.asarray(direction, np.float32)
                / np.linalg.norm(direction), (n, 1))
    acc = 0.0
    for s in range(spp):
        smp = trng.make_sampler_v(torch.arange(n), s, 0)
        out = li(tscene, smp, tv3(o), tv3(d), cfg)[0]
        acc = acc + np.stack([npy(c) for c in out], 1)
    return acc / spp


def test_volpath_without_media_matches_path(tmp_path):
    path = str(tmp_path / "cornell.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth=3, spp=1, res=8).replace(
            '"path"', '"volpath"'))
    tscene, tset = tload(path, device="cpu")
    assert tset.integrator == "volpath" and not tscene.media.any
    cfg = PathConfig(max_depth=3, remat=False)
    kw = dict(n=2048, spp=6, origin=(0, 1, 3.5), direction=(0, 0, -1))
    a = _mean(tscene, cfg, li=path_li_v, **kw)
    b = _mean(tscene, cfg, **kw)
    np.testing.assert_allclose(a.mean(0), b.mean(0), rtol=0.05, atol=2e-3)
    # and against the reference's volpath on the same rays
    jscene, _ = jload(path)
    o, d, js, ts = _camera_rays(tscene)
    port, _ = _port_li(tscene, o, d, ts, cfg)
    ref, _ = _reference_li(jscene, js, o, d, 3)
    st = parity_gate(port.reshape(RES, RES, 3), ref.reshape(RES, RES, 3))
    assert st["ok"], st


def test_constant_grid_matches_homogeneous(scene_dir):
    """Delta tracking through a constant grid samples the same free flights
    as the closed form."""
    cfg = PathConfig(max_depth=DEPTH, remat=False)
    kw = dict(n=2048, spp=4, origin=(0.0, 0.3, 3.2),
              direction=(0.0, -0.3, -3.2))
    grid = _mean(tload(str(scene_dir / "const_grid.xml"), device="cpu")[0],
                 cfg, **kw)
    homog = _mean(tload(str(scene_dir / "const_homog.xml"),
                        device="cpu")[0], cfg, **kw)
    np.testing.assert_allclose(grid.mean(0), homog.mean(0), rtol=0.03)


@pytest.mark.parametrize("case", ["furnace_homog", "furnace_grid",
                                  "furnace_kkay", "furnace_microflake"])
def test_volumetric_white_furnace(case, scene_dir):
    """An albedo-1 medium behind a null boundary in the unit environment
    returns the environment's radiance.  Kajiya-Kay samples the uniform
    sphere, so its weights spread: it takes 16,384 lanes a pass where the
    others take 4,096."""
    tscene, _ = tload(str(scene_dir / f"{case}.xml"), device="cpu")
    assert tscene.emitters.n_emitters == 1
    cfg = PathConfig(max_depth=-1, rr_depth=64, depth_budget=24,
                     remat=False)
    n = 16384 if case == "furnace_kkay" else 4096
    img = _mean(tscene, cfg, n=n, spp=2, origin=(0.0, 0.0, -3.0),
                direction=(0.0, 0.0, 1.0))
    np.testing.assert_allclose(img.mean(), 1.0, atol=0.02)


def test_beer_lambert_absorber(tmp_path):
    sa = 0.7
    path = str(tmp_path / "absorber.xml")
    with open(path, "w") as f:
        f.write(HEAD.format(
            depth=-1, camera_medium="", res=4, env=1.0, light="",
            media=HOMOG.format(id="m", ss=0.0, sa=sa,
                               phase='<phase type="isotropic"/>'),
            body=SPHERE.format(r=1.0, bsdf=NULL, interior="m",
                               exterior="")))
    tscene = tload(path, device="cpu")[0]
    img = _mean(tscene, PathConfig(max_depth=-1, depth_budget=8,
                                   remat=False), n=4096, spp=4)
    # the central ray crosses the unit sphere along a diameter
    np.testing.assert_allclose(img.mean(0), np.exp(-sa * 2.0), rtol=0.03)


VOLUME_CORNELL_XML = """<scene version="0.6.0">
  <integrator type="volpath"><integer name="maxDepth" value="4"/>
  </integrator>
  <medium type="homogeneous" id="fog">
    <rgb name="sigmaS" value="0.04"/><rgb name="sigmaA" value="0.01"/>
    <phase type="mixturephase"><string name="weights" value="0.6, 0.4"/>
      <phase type="hg"><float name="g" value="0.7"/></phase>
      <phase type="rayleigh"/></phase></medium>
  <medium type="homogeneous" id="homog">
    <rgb name="sigmaS" value="2.0, 1.6, 1.2"/><rgb name="sigmaA" value="0.1"/>
    <phase type="hg"><float name="g" value="0.6"/></phase></medium>
  <medium type="heterogeneous" id="cloud"><float name="scale" value="6"/>
    <volume name="density" type="gridvolume">
      <string name="filename" value="cloud.vol"/></volume>
    <volume name="albedo" type="constvolume">
      <float name="value" value="0.9"/></volume>
    <volume name="orientation" type="gridvolume">
      <string name="filename" value="swirl.vol"/></volume>
    <phase type="microflake"><float name="stddev" value="0.3"/></phase>
  </medium>
  <medium type="homogeneous" id="kkay">
    <rgb name="sigmaT" value="1.5"/><rgb name="albedo" value="0.8"/>
    <phase type="kkay"/></medium>
  <sensor type="perspective"><ref name="exterior" id="fog"/>
    <float name="fov" value="39.3"/>
    <transform name="toWorld"><lookat origin="0, 1, 3.9" target="0, 1, 0"
      up="0, 1, 0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="2"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="16"/>
      <integer name="height" value="16"/><rfilter type="box"/></film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.72"/>
  </bsdf>
  <shape type="rectangle"><ref id="white"/><transform name="toWorld">
    <rotate x="1" angle="-90"/></transform></shape>
  <shape type="rectangle"><ref id="white"/><transform name="toWorld">
    <translate z="-1"/><translate y="1"/></transform></shape>
  <shape type="rectangle"><ref id="white"/><transform name="toWorld">
    <rotate x="1" angle="90"/><scale value="0.25"/><translate y="1.99"/>
    </transform><emitter type="area"><rgb name="radiance" value="17 12 4"/>
    </emitter></shape>
  {shapes}
</scene>
"""


def test_volume_cornell_scene_file_cli(tmp_path):
    """The small volume_cornell from its scene file (the icosahedra from an
    OBJ file, the grids from .vol files) through the command line against
    ``render_film``; its media are ``scenes.volume_cornell``'s."""
    recs = scenes.volume_records(grid_res=16, ori_res=4)
    grid = recs[2]
    write_vol(str(tmp_path / "cloud.vol"), grid["density"]["data"],
              grid["density"]["bmin"], grid["density"]["bmax"])
    write_vol(str(tmp_path / "swirl.vol"), grid["orientation"]["data"],
              grid["orientation"]["bmin"], grid["orientation"]["bmax"])
    ico = scenes.icosahedron((0.0, 0.0, 0.0), 1.0)
    with open(tmp_path / "ico.obj", "w") as f:
        f.write("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                        ico.positions))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in
                        ico.indices))
    shapes = ""
    for c, bsdf, mid in zip(scenes.VOLUME_CENTRES,
                            ('<bsdf type="null"/>', '<bsdf type="null"/>',
                             '<bsdf type="dielectric"><float name="intIOR" '
                             'value="1.33"/></bsdf>'),
                            ("homog", "cloud", "kkay")):
        shapes += (
            '<shape type="obj"><string name="filename" value="ico.obj"/>'
            '<boolean name="faceNormals" value="true"/><transform '
            f'name="toWorld"><scale value="{scenes.VOLUME_RADIUS}"/>'
            f'<translate x="{c[0]}" y="{c[1]}" z="{c[2]}"/></transform>'
            f'{bsdf}<ref name="interior" id="{mid}"/>'
            '<ref name="exterior" id="fog"/></shape>')
    path = str(tmp_path / "volume_cornell.xml")
    with open(path, "w") as f:
        f.write(VOLUME_CORNELL_XML.format(shapes=shapes))
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _ = read_exr(out)
    scene, settings = tload(path, device="cpu")
    ref = develop(render_film(scene, settings)).numpy()
    np.testing.assert_array_equal(img,
                                  ref.astype(np.float16).astype(np.float32))
    assert np.isfinite(img).all() and img.mean() > 0.02
    # the tables of both loaders, and the media of scenes.volume_cornell
    assert_same_scene(scene, bridged(jload(path)[0]))
    port = scenes.volume_cornell("cpu", grid_res=16, ori_res=4)[0]
    for k in tmed.MEDIUM_LEAVES:
        assert torch.equal(getattr(scene.media, k), getattr(port.media, k)), k
    assert scene.camera_medium == port.camera_medium == 0
    assert torch.equal(scene.shape_interior[-3:], port.shape_interior[-3:])
