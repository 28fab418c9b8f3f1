"""Port vs reference: adaptive sampling, multichannel output and the new
integrators' factories (``mitsuba_im_tpu_torch/integrators/{adaptive,
multichannel}.py``, ``integrators/__init__.py``), on the CPU.

The quantiles are the reference's host code, equal to the last bit.
``render_irrcache`` (its records' E and R and the image) is here too, and
the sppm and vpl means against the path tracer and the photon names'
command line: the adaptive render's nested path tracer compiles the same
eager primitives of the reference as the irradiance estimate.  The
adaptive render is held to the reference's (run eagerly) on every pixel
but pixel 0 once it stops (ROADMAP C17: the reference's pad lanes go on
sampling it), at rtol 1e-4; which pixels stop in which round is the
reference's.  The multichannel stack's path layer passes the image gate
against the reference's, its field layer is equal, and the layered EXR
reads back with the reference's channel names.  Every new integrator
name loads from a scene file into the reference's settings, and the
queue A 7.7/7.8 names raise naming their item.
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
from mitsuba_im_tpu.integrators import adaptive as jad
from mitsuba_im_tpu.integrators import irrcache as jirr
from mitsuba_im_tpu.integrators import multichannel as jmc
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.integrators import adaptive as tad
from mitsuba_im_tpu_torch.integrators import irrcache as tirr
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

RES = 16
N = RES * RES
RTOL, ATOL = 1e-4, 1e-6


def _a(x) -> np.ndarray:
    """A port V3 as (n, 3), any other value as numpy."""
    if isinstance(x, tuple):
        return np.stack([npy(c) for c in x], -1)
    return npy(x)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_a(a), npy(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_quantiles_match_reference():
    for p in (1e-6, 0.001, 0.02425, 0.025, 0.05, 0.3, 0.5, 0.7, 0.975,
              0.99, 1 - 1e-7):
        assert tad._norm_quantile(p) == jad._norm_quantile(p), p
    for p in (0.01, 0.05, 0.2):
        for dof in (1.0, 3.0, 7.0, 31.0, 127.0, 1e6):
            assert (tad._student_t_quantile(p, dof)
                    == jad._student_t_quantile(p, dof)), (p, dof)


@pytest.fixture(scope="module")
def cornell():
    jscene, jsettings = jax_cornell()
    return jscene, bridged(jscene), jsettings


def test_render_adaptive_matches_reference(cornell):
    """16^2, 2 samples a round, at most 3 rounds, maxError 0.2: the mean
    image on every pixel the reference's pad lanes leave alone."""
    jscene, tscene, jsettings = cornell
    s = dataclasses.replace(
        jsettings, width=RES, height=RES, integrator="adaptive",
        integrator_props=dict(max_error=0.2, p_value=0.05, max_spp=3,
                              nested=dict(name="path", max_depth=3)))
    with jax.disable_jit():
        ref = np.asarray(jad.render_adaptive(jscene, s, spp=2))
    rounds = []
    img = npy(tad.render_adaptive(tscene, s, spp=2,
                                  round_cb=lambda r, pix: rounds.append(
                                      pix.copy())))
    # pixels stop in every round, and pixel 0 is sampled to the end or not
    assert len(rounds) == 3 and len(rounds[0]) == RES * RES
    assert len(rounds[0]) > len(rounds[1]) > len(rounds[2]) > 0
    flat, rflat = img.reshape(-1, 3), ref.reshape(-1, 3)
    keep = np.ones(RES * RES, bool)
    if 0 not in rounds[-1]:
        keep[0] = False  # C17: the reference's pads sample it on
    np.testing.assert_allclose(flat[keep], rflat[keep], rtol=1e-4,
                               atol=1e-6)
    assert np.isfinite(img).all() and img.mean() > 0.02


def _scene_file(tmp_path, integrator_xml, res=RES, spp=2):
    xml = CORNELL_XML.format(max_depth=3, spp=spp, res=res)
    start = xml.index('<integrator type="path">')
    end = xml.index("</integrator>", start) + len("</integrator>")
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(xml[:start] + integrator_xml + xml[end:])
    return path


MULTI = ('<integrator type="multichannel"><integrator type="path">'
         '<integer name="maxDepth" value="3"/></integrator>'
         '<integrator type="field"><string name="field" '
         'value="shapeIndex"/></integrator></integrator>')


def test_multichannel_matches_reference(cornell, tmp_path):
    """The channel stack of path + field shapeIndex against the
    reference's, and its layered EXR through the command line."""
    jscene, tscene, jsettings = cornell
    children = [dict(name="path", max_depth=3),
                dict(name="field", field="shapeIndex")]
    s = dataclasses.replace(jsettings, width=RES, height=RES,
                            integrator="multichannel",
                            integrator_props=dict(children=children))
    js = dataclasses.replace(s)
    with jax.disable_jit():
        jmc.render_multichannel(jscene, js, spp=2)
    img = npy(tjob.render(tscene, s, spp=2))
    names, stack = s.aux_channels
    assert names == js.aux_channels[0] == [
        "R", "G", "B", "field.R", "field.G", "field.B"]
    ref = np.asarray(js.aux_channels[1])
    assert stack.shape == ref.shape == (RES, RES, 6)
    np.testing.assert_array_equal(img, stack[..., :3])
    st = parity_gate(stack[..., :3].ravel(), ref[..., :3].ravel())
    assert st["ok"], st
    np.testing.assert_array_equal(stack[..., 3:], ref[..., 3:])

    path = _scene_file(tmp_path, MULTI)
    out = str(tmp_path / "multi.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    data, meta = read_exr(out, all_channels=True)
    assert data.shape == (RES, RES, 6)
    read_names = meta["channels"].split(",")
    assert sorted(read_names) == sorted(names)
    scene, settings = tload(path, device="cpu")
    tjob.render(scene, settings)
    want = settings.aux_channels[1].astype(np.float16).astype(np.float32)
    for k, name in enumerate(names):
        np.testing.assert_array_equal(
            data[..., read_names.index(name)], want[..., k])


FACTORIES = {
    "adaptive": '<integrator type="adaptive"><float name="maxError" '
                'value="0.1"/><float name="pValue" value="0.01"/><integer '
                'name="maxSampleFactor" value="8"/><integrator type="path">'
                '<integer name="maxDepth" value="3"/></integrator>'
                '</integrator>',
    "multichannel": MULTI,
    "irrcache": '<integrator type="irrcache"><float name="quality" '
                'value="1.5"/><integer name="stride" value="3"/><integer '
                'name="resolution" value="10"/><integrator type="path"/>'
                '</integrator>',
    "sppm": '<integrator type="sppm"><integer name="photonCount" '
            'value="1000"/><float name="alpha" value="0.5"/></integrator>',
    "ppm": '<integrator type="ppm"><float name="initialRadius" '
           'value="0.1"/><integer name="maxPasses" value="3"/></integrator>',
    "photonmapper": '<integrator type="photonmapper"><integer '
                    'name="globalPhotons" value="5000"/><float name='
                    '"globalLookupRadiusRelative" value="0.02"/>'
                    '</integrator>',
    "vpl": '<integrator type="vpl"><integer name="maxDepth" value="4"/>'
           '<integer name="shadowMapResolution" value="64"/><float '
           'name="clamping" value="0.2"/></integrator>',
    "vpl_default": '<integrator type="vpl"/>',
}


@pytest.mark.parametrize("case", list(FACTORIES))
def test_factories_match_reference(case, tmp_path):
    path = _scene_file(tmp_path, FACTORIES[case])
    _scene, pset = tload(path, device="cpu")
    _jscene, rset = jload(path)
    assert pset.integrator == rset.integrator
    assert pset.integrator_props == rset.integrator_props


@pytest.mark.parametrize("name,item", [("pssmlt", "7.8"), ("mlt", "7.8"),
                                       ("erpt", "7.8"),
                                       ("singlescatter", "7.7")])
def test_later_items_still_raise(name, item, tmp_path):
    category = "subsurface" if name == "singlescatter" else "integrator"
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(f'<scene version="0.6.0"><{category} type="{name}"/>'
                '</scene>')
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue A item {item}\)"):
        tload(path, device="cpu")


def test_adaptive_command_line(tmp_path):
    path = _scene_file(tmp_path, FACTORIES["adaptive"].replace(
        'value="8"', 'value="2"'))
    out = str(tmp_path / "adaptive.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _meta = read_exr(out)
    scene, settings = tload(path, device="cpu")
    ref = npy(tjob.render(scene, settings))
    assert ref.mean() > 0.02
    np.testing.assert_array_equal(
        img, ref.astype(np.float16).astype(np.float32))
    assert img[:, :4, 0].mean() > img[:, :4, 1].mean()


def _ref_estimate(scene, p, ns, ss, ts, valid, seed, *, n_samples,
                  max_depth):
    """The reference's ``_estimate_irradiance`` (irrcache.py:47) run
    eagerly: its loop body from its own building blocks, the sample index
    a uint32 array (under ``jax.disable_jit`` its ``fori_loop`` hands the
    body a Python int, which the body cannot take).  Jitted, XLA's fused
    multiply-adds move a few hemisphere paths off the eager ones (C15)."""
    from mitsuba_im_tpu.core import math as jm

    # without remat, which changes no value of a forward pass and would
    # trace the bounces anew at every call
    cfg = jpath.PathConfig(max_depth=max_depth, depth_budget=max_depth,
                           hide_emitters=True, coherent=False, remat=False)
    o = p + ns * 1e-4
    m = p.shape[0]
    e_sum = jnp.zeros((m, 3), jnp.float32)
    inv_d = jnp.zeros((m,), jnp.float32)
    for i in range(n_samples):
        sampler = jrng.make_sampler(jnp.arange(m, dtype=jnp.uint32),
                                    jnp.uint32(i), seed)
        sampler, blk = jrng.next_block4(sampler)
        d_local = jnp.stack(
            [jnp.sqrt(blk[..., 0]) * jnp.cos(2 * jnp.pi * blk[..., 1]),
             jnp.sqrt(blk[..., 0]) * jnp.sin(2 * jnp.pi * blk[..., 1]),
             jnp.sqrt(jnp.maximum(1.0 - blk[..., 0], 0.0))], axis=-1)
        d_world = jm.Frame.to_world((ss, ts, ns), d_local)
        li, _ = jpath.path_li(scene, sampler, o, d_world, cfg)
        e_sum = e_sum + jnp.where(valid[..., None], li, 0.0)
        hit = scene.ray_intersect(o, d_world)
        inv_d = inv_d + jnp.where(valid & hit.valid,
                                  1.0 / jnp.maximum(hit.t, 1e-3), 0.0)
    e_sum = e_sum * (jnp.pi / n_samples)
    r = jnp.where(inv_d > 0, n_samples / jnp.maximum(inv_d, 1e-6), 1e6)
    r_scene = jnp.maximum(scene.emitters.bsphere_radius, 1e-3)
    return e_sum, jnp.clip(r, 1e-4, r_scene)




def test_render_irrcache_matches_reference(cornell, monkeypatch):
    """The whole render at 32 x 8, a record at every pixel (stride 1), 4
    hemisphere samples of the nested path at depth 3, the reference eager
    (``_ref_estimate`` for its estimate): the records' E and R at f32
    tolerance (three samples a wavefront in the port, then one), the image
    under the gate.  Not square: the records sit at pixel centres, and on
    a square image those of the diagonal lie exactly on the box's edge
    between the floor and the green wall, where the last bit of the
    intersection's arithmetic decides hit or miss (the reference's CPU
    intersector computes it in another order than the kernels, whose
    order the port's plain version keeps)."""
    jscene, tscene, jsettings = cornell
    s = dataclasses.replace(
        jsettings, width=2 * RES, height=RES // 2, integrator="irrcache",
        integrator_props=dict(quality=1.0, resolution=1, irr_samples=4,
                              nested=dict(name="path", max_depth=3)))
    seen = {}
    gather = jirr._gather_cache

    def spy(*args, **kw):
        seen["records"] = args[2:7]
        return gather(*args, **kw)

    monkeypatch.setattr(jirr, "_estimate_irradiance", _ref_estimate)
    monkeypatch.setattr(jirr, "_gather_cache", spy)
    monkeypatch.setattr(tirr, "IRR_LANES", N * 3)
    with jax.disable_jit():
        ref = np.asarray(jirr.render_irrcache(jscene, s, spp=2))
    rec, grid = tirr.cache_records(tscene, s, s.seed)
    assert grid is None and rec["R"].shape == (N,)
    _p, _n, jE, jR, jv = (np.asarray(x) for x in seen["records"])
    np.testing.assert_array_equal(npy(rec["valid"]), jv)
    assert jE[jv].mean() > 0
    _close(rec["E"], jE, 1e-4, 1e-6, "E")
    _close(rec["R"], jR, 1e-5, 0.0, "R")
    img = npy(tjob.render(tscene, s, spp=2))
    assert img.shape == ref.shape == (RES // 2, 2 * RES, 3)
    assert ref.mean() > 0
    st = parity_gate(img.ravel(), ref.ravel())
    assert st["ok"], st


def _mean_of(settings_kw, spp):
    scene, settings = scenes.tiny_cornell("cpu")
    settings = dataclasses.replace(settings, width=24, height=24,
                                   **settings_kw)
    return float(npy(tjob.render(scene, settings, spp=spp)).mean())


def test_sppm_and_vpl_means_match_path():
    """tests/test_photon.py's floors and settings on the port (24^2; the
    path tracer at 32 spp): sppm within 12% of the path tracer at depth 6,
    vpl within 10% at depth 3."""
    ref6 = _mean_of(dict(integrator="path",
                         integrator_props=dict(max_depth=6)), 32)
    sp = _mean_of(dict(integrator="sppm", integrator_props=dict(
        max_depth=6, photon_count=32768, lookup_radius_rel=0.08,
        cell_cap=32)), 8)
    assert abs(sp - ref6) / ref6 < 0.12, (sp, ref6)
    ref3 = _mean_of(dict(integrator="path",
                         integrator_props=dict(max_depth=3)), 32)
    vp = _mean_of(dict(integrator="vpl", integrator_props=dict(
        max_depth=3, vpl_count=128, clamping=0.02)), 4)
    assert abs(vp - ref3) / ref3 < 0.10, (vp, ref3)


INTEGRATOR_XML = {
    "sppm": '<integrator type="sppm"><integer name="maxDepth" value="4"/>'
            '<integer name="photonCount" value="2048"/></integrator>',
    "photonmapper": '<integrator type="photonmapper">'
                    '<integer name="globalPhotons" value="2048"/>'
                    '<integer name="maxDepth" value="4"/></integrator>',
    "ppm": '<integrator type="ppm"><integer name="photonCount" '
           'value="2048"/><integer name="maxDepth" value="4"/></integrator>',
    "vpl": '<integrator type="vpl"><integer name="maxDepth" value="4"/>'
           '<integer name="vplSamples" value="16"/></integrator>',
    "irrcache": '<integrator type="irrcache"><integer name="resolution" '
                'value="2"/><integrator type="path"><integer '
                'name="maxDepth" value="3"/></integrator></integrator>',
}


@pytest.mark.parametrize("name", list(INTEGRATOR_XML))
def test_command_line_renders(name, tmp_path):
    xml = CORNELL_XML.format(max_depth=4, spp=2, res=RES)
    start = xml.index('<integrator type="path">')
    end = xml.index("</integrator>", start) + len("</integrator>")
    path = str(tmp_path / f"{name}.xml")
    with open(path, "w") as f:
        f.write(xml[:start] + INTEGRATOR_XML[name] + xml[end:])
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _meta = read_exr(out)
    scene, settings = tload(path, device="cpu")
    assert settings.integrator == ("sppm" if name == "photonmapper"
                                   else name)
    ref = npy(tjob.render(scene, settings))
    assert ref.mean() > 0 and np.isfinite(ref).all()
    np.testing.assert_array_equal(
        img, ref.astype(np.float16).astype(np.float32))
