"""Port vs reference: the particle tracer
(``mitsuba_im_tpu_torch/integrators/ptracer.py``) and its render loop
(``render/job.py::render_ptracer``), on the CPU.

The same emitter uniforms go through ``sample_emitter_ray_v`` and the
reference's ``sample_emitter_ray`` for each of the seven emitter types
(256 lanes, f32 tolerance, ``delta_pos`` exact).  ``ptracer_splats_v``
runs the Cornell box's particles with the reference's per-lane sampler
(16^2 lanes, max_depth 3 and 5): film positions and values to f32
tolerance, the nonzero splats exactly the reference's.  The rendered
image is held to the reference's ``render_ptracer`` under parity_check.py's
gate on the Cornell box and on its 12 triangles under a constant
environment; ``python -m mitsuba_im_tpu_torch`` with ``<integrator
type="ptracer"/>`` writes ``render()``'s image.  The reference runs
eagerly (``jax.disable_jit``): its compiles would cost more than the runs
at these sizes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy, parity_gate
from test_render import CORNELL_XML

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu_torch.core.transform import Transform as TTransform
from mitsuba_im_tpu.integrators import ptracer as jpt
from mitsuba_im_tpu.integrators.path import PathConfig as JPathConfig
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu_torch import emitter as temf
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.integrators import ptracer as tpt
from mitsuba_im_tpu_torch.integrators.path import PathConfig
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload
from mitsuba_im_tpu_torch.sensor.table import S_PERSPECTIVE

torch.set_num_threads(2)

RES = 16
SEED = 7


def _env_pixels():
    rng = np.random.default_rng(12)
    return (rng.random((8, 16, 3)) * 2.0 + 0.1).astype(np.float32)


# the second emitter of each case, beside the Cornell box's area light
EMITTERS = {
    "area": None,
    "point": lambda: temf.point([1.2, 1.1, 1.0], position=[0.3, 1.6, 0.2]),
    "spot": lambda: temf.spot([6.0, 3.0, 3.0], cutoff_angle=25.0,
                              to_world=TTransform.look_at(
                                  [-0.6, 1.8, -0.5], [-0.2, 0.0, 0.3],
                                  [0, 1, 0])),
    "directional": lambda: temf.directional([2.0, 1.5, 1.0],
                                            direction=[0.3, -1.0, -0.2]),
    "constant": lambda: temf.constant([0.4, 0.5, 0.6]),
    "envmap": lambda: tem.envmap_record(_env_pixels(), 1.5),
    "collimated": lambda: temf.collimated([5.0, 5.0, 5.0], to_world=(
        TTransform.look_at([0.1, 1.8, 0.6], [0.1, 0.0, 0.4], [0, 0, 1]))),
}


def jax_emitter_scene(case: str, res: int = RES):
    """The Cornell box with its area light and the case's emitter, through
    the Cornell pinhole, built by the JAX package."""
    b = JBuilder()
    scenes._cornell_box(b)
    if EMITTERS[case] is not None:
        b.add_emitter(EMITTERS[case]())
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(S_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    b.settings.width = b.settings.height = res
    b.settings.integrator = "ptracer"
    b.settings.integrator_props = dict(max_depth=3)
    from mitsuba_im_tpu.film.film import F_BOX

    b.settings.rfilter = F_BOX
    return b.build()


@pytest.mark.parametrize("case", list(EMITTERS))
def test_sample_emitter_ray_matches_reference(case):
    jscene, _ = jax_emitter_scene(case)
    tscene = bridged(jscene)
    n = RES * RES
    u = np.random.default_rng(3).random((5, n), dtype=np.float32)
    with jax.disable_jit():
        ref = jpt.sample_emitter_ray(jscene, jnp.asarray(u[0]),
                                     jnp.asarray(u[1:3].T),
                                     jnp.asarray(u[3:5].T))
    out = tpt.sample_emitter_ray_v(tscene, *(torch.from_numpy(a) for a in u))
    np.testing.assert_array_equal(npy(out.delta_pos), npy(ref.delta_pos))
    if case != "area":
        assert npy(out.delta_pos).any() and not npy(out.delta_pos).all()
    for k in ("p", "d", "n", "weight"):
        np.testing.assert_allclose(
            np.stack([npy(c) for c in getattr(out, k)], -1),
            npy(getattr(ref, k)), rtol=1e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("depth", [3, 5])
def test_ptracer_splats_match_reference(depth):
    jscene, _ = jax_cornell()
    tscene = bridged(jscene)
    n = RES * RES
    with jax.disable_jit():
        js = jrng.make_sampler(jnp.arange(n, dtype=jnp.uint32), 0, SEED)
        juv, jval = jpt.ptracer_splats(jscene, js, n,
                                       JPathConfig(max_depth=depth))
    splats = tpt.ptracer_splats_v(
        tscene, trng.make_sampler_v(torch.arange(n), 0, SEED),
        PathConfig(max_depth=depth))
    juv, jval = npy(juv), npy(jval)
    assert len(splats) == juv.shape[0] == depth  # depth 0 + max_depth - 1
    for k, sp in enumerate(splats):
        val = np.stack([npy(c) for c in sp.value], -1)
        ok = npy(sp.valid)
        np.testing.assert_array_equal(ok, (jval[k] != 0).any(-1))
        assert ok.any()
        np.testing.assert_allclose(val, jval[k], rtol=1e-5, atol=1e-7)
        uv = np.stack([npy(sp.u), npy(sp.v)], -1)
        np.testing.assert_allclose(uv[ok], juv[k][ok], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def reference_images():
    """The reference's render_ptracer of the Cornell box and of the box
    under a constant environment, 16^2, depth 3, 2 spp, once."""
    out = {}
    for case in ("area", "constant"):
        jscene, jsettings = jax_emitter_scene(case)
        with jax.disable_jit():
            out[case] = (jjob.render(jscene, jsettings, spp=2), jscene,
                         jsettings)
    return out


@pytest.mark.parametrize("case", ["area", "constant"])
def test_render_ptracer_matches_reference(case, reference_images):
    ref, jscene, jsettings = reference_images[case]
    img = npy(tjob.render(bridged(jscene), jsettings, spp=2))
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0
    st = parity_gate(img.sum(-1).ravel(), ref.sum(-1).ravel())
    assert st["ok"], st


def test_ptracer_command_line_matches_render(tmp_path):
    path = str(tmp_path / "ptracer.xml")
    with open(path, "w") as f:
        f.write(CORNELL_XML.format(max_depth=3, spp=2, res=RES).replace(
            '<integrator type="path">', '<integrator type="ptracer">'))
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, meta = read_exr(out)
    scene, settings = tload(path, device="cpu")
    assert settings.integrator == "ptracer"
    assert settings.integrator_props["granularity"] == 200000
    ref = npy(tjob.render(scene, settings))
    assert ref.mean() > 0
    np.testing.assert_array_equal(
        img, ref.astype(np.float16).astype(np.float32))
    # the box's walls: red on the left, green on the right
    assert img[:, :4, 0].mean() > img[:, :4, 1].mean()
    assert img[:, -4:, 1].mean() > img[:, -4:, 0].mean()


def test_ptracer_mean_matches_path():
    """The light-traced Cornell box against the port's path tracer: the
    means within 5% (the reference's test_ptracer checks 15%)."""
    scene, settings = scenes.tiny_cornell("cpu")
    settings = dataclasses.replace(settings, width=RES, height=RES,
                                   integrator_props=dict(max_depth=3))
    path = npy(tjob.render(scene, settings, spp=32))
    pt = npy(tjob.render(scene, dataclasses.replace(
        settings, integrator="ptracer"), spp=64))
    assert abs(pt.mean() - path.mean()) / path.mean() < 0.05
