"""Port vs reference: the Irawan & Marschner woven-cloth BSDF
(``mitsuba_im_tpu_torch/bsdf/irawan.py``, its factory, its table columns
``weave_id``/``weaves`` and its eval/pdf/sample in ``bsdf/eval.py``).

The parser's patterns equal the reference's field for field; the TEA hash
and the Perlin noise are bit for bit; ``eval_pattern`` (filament and
staple yarns, with and without the inclination noise and the fiber
intensity variation) agrees within rel 1e-5, and so does the specular
normalization (10,000 float32 samples summed in another order).  A scene
file with the built-in plain weave and a twill from a file renders
through both packages under parity_check.py's image gate; the reference
runs eagerly (``jax.disable_jit``), as its compiled IRAWAN path would take
minutes to build.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_same_scene, bridged, close, npy,
                                parity_gate, tv3, unit_vectors)
from test_irawan import TWILL

from mitsuba_im_tpu.bsdf import irawan as jir
from mitsuba_im_tpu.core.properties import Properties as JProperties
from mitsuba_im_tpu.core.v3 import V3 as JV3
from mitsuba_im_tpu.film.film import develop as jdevelop
from mitsuba_im_tpu.render import job as jjob
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.bsdf import irawan as tir
from mitsuba_im_tpu_torch.core.properties import Properties
from mitsuba_im_tpu_torch.film.film import develop
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

# TWILL with the inclination noise and the fiber intensity variation on
NOISY = (TWILL.replace("fineness = 0.0, period = 0.0",
                       "fineness = 3.0, period = 2.5, "
                       "dWarpUmaxOverDWarp = 20, dWarpUmaxOverDWeft = 10, "
                       "dWeftUmaxOverDWarp = 5, dWeftUmaxOverDWeft = 15")
         .replace('"test twill"', '"noisy twill"'))


def _both(text, **kw):
    jp, tp = JProperties(), Properties()
    jp["alpha_var"] = 0.25
    tp["alpha_var"] = 0.25
    return (jir.parse_weave(text, jp, **kw), tir.parse_weave(text, tp, **kw))


@pytest.mark.parametrize("which", ["plain", "twill", "noisy"])
def test_parser_fields_equal(which):
    text = {"plain": tir.PLAIN_WEAVE, "twill": TWILL, "noisy": NOISY}[which]
    ref, port = _both(text, repeatU=3.0, repeatV=2.0)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tir.WeavePattern.from_dict(dataclasses.asdict(ref)) == port
    hash(port)


def test_tea_and_perlin_bit_exact():
    rng = np.random.default_rng(0)
    v0 = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
    v1 = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
    v0[:3] = [0, 2 ** 32 - 1, 12345]
    ref = npy(jir.sample_tea_float(jnp.asarray(v0.astype(np.uint32)),
                                   jnp.asarray(v1.astype(np.uint32))))
    port = npy(tir.sample_tea_float(torch.from_numpy(v0.astype(np.int64)),
                                    torch.from_numpy(v1.astype(np.int64))))
    np.testing.assert_array_equal(port, ref)
    assert 0.0 <= port.min() and port.max() < 1.0
    x = np.concatenate([rng.uniform(-300, 300, 5000),
                        np.arange(-4, 5, 0.25)]).astype(np.float32)
    np.testing.assert_array_equal(
        npy(tir.perlin_noise_1d(torch.from_numpy(x))),
        npy(jir.perlin_noise_1d(jnp.asarray(x))))


def _lanes(rng, n):
    uv = rng.uniform(0.0, 1.0, (2, n)).astype(np.float32)
    wi = unit_vectors(rng, n)
    wo = unit_vectors(rng, n)
    wi[:, 2] = np.abs(wi[:, 2])
    wo[: n * 3 // 4, 2] = np.abs(wo[: n * 3 // 4, 2])
    return uv, wi, wo


@pytest.mark.parametrize("which", ["plain", "twill", "noisy"])
def test_eval_pattern_and_normalization(which):
    text = {"plain": tir.PLAIN_WEAVE, "twill": TWILL, "noisy": NOISY}[which]
    ref, port = _both(text, repeatU=2.0, repeatV=3.0)
    ref = jir.compute_normalization(ref)
    port_n = tir.compute_normalization(port)
    close(np.float64(port_n.normalization), np.float64(ref.normalization))
    assert ref.normalization > 0.0
    rng = np.random.default_rng(1)
    uv, wi, wo = _lanes(rng, 4096)
    for init in (True, False):
        jv = jir.eval_pattern(ref, jnp.asarray(uv[0]), jnp.asarray(uv[1]),
                              JV3(*map(jnp.asarray, wi.T)),
                              JV3(*map(jnp.asarray, wo.T)), init)
        tv = tir.eval_pattern(dataclasses.replace(
            port, normalization=ref.normalization), torch.from_numpy(uv[0]),
            torch.from_numpy(uv[1]), tv3(wi), tv3(wo), init)
        if init:
            a, b = npy(tv), npy(jv)
        else:
            a = np.stack([npy(c) for c in tv], 1)
            b = np.stack([npy(c) for c in jv], 1)
        close(a, b, atol=1e-5 * max(float(np.abs(b).max()), 1.0))
        assert (b > 0).mean() > 0.02


def test_bsdf_eval_pdf_sample():
    """The IRAWAN row through ``resolve_v`` and the BSDF entry points: the
    reference's eval, pdf and sample on the same lanes."""
    from mitsuba_im_tpu.bsdf import common as jbc
    from mitsuba_im_tpu.bsdf import eval as jev

    ref, port = _both(TWILL)
    ref = jir.compute_normalization(ref)
    port = dataclasses.replace(port, normalization=ref.normalization)
    jrec, trec = jbc.default_record(), tbc.default_record()
    jrec.update(type=jbc.IRAWAN, weave=ref)
    trec.update(type=tbc.IRAWAN, weave=port)
    jt = jbc.build_table([jbc.default_record(), jrec])
    tt = tbc.build_table([tbc.default_record(), trec], "cpu")
    np.testing.assert_array_equal(npy(tt.weave_id), npy(jt.weave_id))
    assert tt.weaves == (port,)
    rng = np.random.default_rng(2)
    n = 2048
    uv, wi, wo = _lanes(rng, n)
    ids = rng.integers(0, 2, n).astype(np.int32)
    from mitsuba_im_tpu.texture.texture import TextureBuilder

    jp = jbc.resolve_v(jt, TextureBuilder().build(), jnp.asarray(ids),
                       jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    tp = tbc.resolve_v(tt, None, torch.from_numpy(ids),
                       torch.from_numpy(uv[0]), torch.from_numpy(uv[1]))
    jwi, jwo = JV3(*map(jnp.asarray, wi.T)), JV3(*map(jnp.asarray, wo.T))
    f_t = tev.bsdf_eval_v(tp, tv3(wi), tv3(wo))
    f_j = jev.bsdf_eval_v(jp, jwi, jwo)
    for a, b in zip(f_t, f_j):
        close(npy(a), npy(b), atol=1e-5)
    close(npy(tev.bsdf_pdf_v(tp, tv3(wi), tv3(wo))),
          npy(jev.bsdf_pdf_v(jp, jwi, jwo)))
    u = rng.random((4, n)).astype(np.float32)
    bs_t = tev.bsdf_sample_v(tp, tv3(wi), *map(torch.from_numpy, u))
    bs_j = jev.bsdf_sample_v(jp, jwi, *map(jnp.asarray, u))
    for a, b in zip(bs_t.weight, bs_j.weight):
        close(npy(a), npy(b), atol=1e-5)
    for a, b in zip(bs_t.wo, bs_j.wo):
        close(npy(a), npy(b))
    assert (npy(f_t[0])[ids == 1] > 0).mean() > 0.3


def test_render_matches_reference(tmp_path):
    """The plain weave on the floor and the twill (a file, with ``$var``)
    on the back wall, 8^2, depth 2, against the reference run eagerly."""
    with open(tmp_path / "twill.wv", "w") as f:
        f.write(TWILL)
    xml = """<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
  <sensor type="perspective"><float name="fov" value="50"/>
    <transform name="toWorld">
      <lookat origin="0, 1, 2.5" target="0, 0.4, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="1"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="8"/><rfilter type="box"/></film>
  </sensor>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="-90"/></transform><bsdf type="irawan"><float name="repeatU"
    value="6"/><float name="repeatV" value="6"/></bsdf></shape>
  <shape type="rectangle"><transform name="toWorld"><translate z="-1"
    y="1"/></transform><bsdf type="irawan"><string name="filename"
    value="twill.wv"/><float name="alpha_var" value="0.25"/>
    <float name="repeatU" value="4"/></bsdf></shape>
  <emitter type="constant"><rgb name="radiance" value="1 1 1"/></emitter>
  <emitter type="directional"><vector name="direction" x="0.3" y="-1"
    z="-0.4"/><rgb name="irradiance" value="3 3 3"/></emitter>
</scene>
"""
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    jscene, jset = jload(path)
    tscene, tset = tload(path, device="cpu")
    assert len(tscene.bsdfs.weaves) == 2
    # the port normalizes with its own sum; the tables agree when the
    # bridge carries the reference's across
    own = tscene.bsdfs.weaves
    for a, b in zip(own, jscene.bsdfs.weaves):
        close(np.float64(a.normalization), np.float64(b.normalization))
    tscene = dataclasses.replace(tscene, bsdfs=dataclasses.replace(
        tscene.bsdfs, weaves=bridged(jscene).bsdfs.weaves))
    assert_same_scene(tscene, bridged(jscene))
    with jax.disable_jit():
        ref = np.asarray(jdevelop(jjob.render_film(jscene, jset)))
    port = develop(tjob.render_film(tscene, tset)).numpy()
    st = parity_gate(port, ref)
    assert st["ok"], st
    assert ref.mean() > 0.05
