"""Port vs reference: the textured slice end to end.  A small
``textured_cornell`` (64^2 bitmap, 32^2 bump maps; every texture type, MIP
filtering with ray differentials, MASK, BLEND, height and normal maps,
``alpha_tex``) rendered by both packages on the CPU and gated as
``parity_check.py`` gates the card against the CPU; d sum(Li)/d
``texture.atlas`` against the reference's to 1e-4 of the largest entry
(test_torch_diff's GRAD_TOL), and through the bump and normal maps in
forward mode; the MASK wrapper's pass-through.

The reference runs eagerly (``jax.disable_jit``): its compiled textured
path takes far longer to build than to run at 16^2.

The MASK pass-through (the suspected reference fault C8, refuted): the
reference's ``integrators/path.py:169-170`` passes the BSDF block's fourth
uniform to ``bsdf_sample_v`` as its sixth positional argument,
``u_mask``, so a lane goes straight through a MASK with probability
1 - opacity, as ``mask.cpp`` and the reference's ``volpath`` do.  The
port does the same.  ``test_mask_passes_rays_through`` shows it: a light
seen only through a mask of opacity 0 renders at full radiance in both
packages, and the sampled stage agrees lane for lane.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import SAMPLE, jax_sum_li, rel_err, torch_grads
from test_torch_helpers import (bridged, close, close_v3, jv3, npy,
                                parity_gate, tv3)
from test_torch_texture import jax_textured_cornell

from mitsuba_im_tpu.bsdf import common as jbc
from mitsuba_im_tpu.bsdf import eval as jev
from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.core.types import Float
from mitsuba_im_tpu.diff import optimize as jopt
from mitsuba_im_tpu.integrators import path as jpath
from mitsuba_im_tpu.render import raydiff as jrd
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu.sensor.table import sample_ray_v as j_sample_ray_v
from mitsuba_im_tpu.sensor.table import S_PERSPECTIVE as JS_PERSPECTIVE
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch import texture as ttex
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf import eval as tev
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.diff import optimize as topt
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.integrators import path as tpath
from mitsuba_im_tpu_torch.render import raydiff as trd
from mitsuba_im_tpu_torch.scene.mesh import TriMesh
from mitsuba_im_tpu_torch.sensor.table import sample_ray_v as t_sample_ray_v

torch.set_num_threads(2)

W = 16
DEPTH = 2  # the peeled (filtered) bounce; the eager reference pays per op
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def textured():
    jscene = jax_textured_cornell()
    return jscene, bridged(jscene)


def _jax_li(jscene, cfg, W, filtered):
    """The reference's per-pixel Li sum of one sample (test_torch_diff's
    rays), with the primary rays' differentials when ``filtered``."""
    n = W * W
    pix = jnp.arange(n, dtype=jnp.uint32)
    s = jrng.make_sampler_v(pix, jnp.uint32(SAMPLE), jnp.uint32(0))
    s, blk = jrng.next_block4_v(s)
    uu = ((pix % W).astype(Float) + blk[0]) / W
    vv = ((pix // W).astype(Float) + blk[1]) / W
    o, d, _ = j_sample_ray_v(jscene.sensor, uu, vv, blk[2], blk[3])
    kw = {}
    if filtered:
        dx, dy = jrd.camera_ray_differentials(jscene.sensor, uu, vv, blk[2],
                                              blk[3], 1.0 / W, 1.0 / W)
        kw = dict(dddx=dx, dddy=dy)
    with jax.disable_jit():
        li, _ = jpath.path_li_v(jscene, s, o, d, cfg, **kw)
    return np.asarray(li.x + li.y + li.z)


def _port_li(tscene, cfg, W, filtered):
    pix = torch.arange(W * W)
    s = trng.make_sampler_v(pix, SAMPLE, 0)
    s, blk = trng.next_block4_v(s)
    uu = ((pix % W).float() + blk[0]) / W
    vv = ((pix // W).float() + blk[1]) / W
    o, d, _ = t_sample_ray_v(tscene.sensor, uu, vv, blk[2], blk[3])
    kw = {}
    if filtered:
        dx, dy = trd.camera_ray_differentials(tscene.sensor, uu, vv, blk[2],
                                              blk[3], 1.0 / W, 1.0 / W)
        kw = dict(dddx=dx, dddy=dy)
    li, _ = tpath.path_li_v(tscene, s, o, d, cfg, **kw)
    return npy(li.x + li.y + li.z)


def test_textured_cornell_render_parity_gate(textured):
    """16^2, depth 2, every texture and wrapper, bitmaps filtered through
    their pyramids at the primary hit: the port's render passes the gate
    against the reference's, and filtering changes it."""
    jscene, tscene = textured
    assert tscene.textures.has_mip and tscene.bsdfs.has_bump
    assert {tbc.MASK, tbc.BLEND} <= set(tscene.bsdfs.used_types)
    cfg_t = tpath.PathConfig(max_depth=DEPTH, remat=False)
    out = _port_li(tscene, cfg_t, W, True)
    ref = _jax_li(jscene, jpath.PathConfig(max_depth=DEPTH, remat=False), W,
                  True)
    assert np.isfinite(out).all() and (out >= 0).all() and out.sum() > 0
    st = parity_gate(out, ref)
    assert st["ok"], st
    assert not np.array_equal(out, _port_li(tscene, cfg_t, W, False))


def _jax_atlas_cornell():
    """The Cornell box with a 64^2 noise bitmap on the back wall and a
    scale of it on the left wall (the reference's eager gradient of the
    whole textured_cornell would take minutes)."""
    b = JBuilder()
    gen = np.random.default_rng(71)
    bmp = ttex.bitmap(b.textures, gen.random((64, 64, 3), np.float32),
                      uscale=2.0)
    scaled = ttex.scale(b.textures, bmp, scale=[0.9, 0.4, 0.3])

    def diffuse(rgb, tex=None):
        rec = tbc.diffuse_record(rgb)
        if tex is not None:
            rec["refl_tex"] = tex
        return rec

    recs = [diffuse(0.72), diffuse(0.72), diffuse(0.72, bmp),
            diffuse(0.5, scaled), diffuse([0.14, 0.45, 0.09])]
    for (pts, n), rec in zip(scenes._CORNELL_WALLS, recs):
        b.add_trimesh(scenes._quad(pts, n, uvs=True),
                      b.new_shape(b.add_bsdf(rec)))
    scenes._cornell_light(b)
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    return b.build()[0]


def test_atlas_gradient_matches_reference():
    """d sum(Li)/d texture.atlas (16^2, depth 2, no ray differentials, as
    the reference's render_rays traces) against the reference's reverse
    mode, to 1e-4 of the largest entry; non-zero on the bitmap's texels.
    The reference's reverse mode is NaN at the few texels that lanes with
    a non-finite uv (misses) look up: a zero cotangent times an infinite
    bilinear weight (C6's mechanism); the port looks those lanes up at uv
    0 under grad, and is compared on the other texels."""
    jscene = _jax_atlas_cornell()
    tscene = bridged(jscene)
    f = jax_sum_li(jscene, jpath.PathConfig(max_depth=DEPTH, remat=False), W)
    with jax.disable_jit():
        want = np.asarray(jax.grad(f)(jopt.get_params(
            jscene, ["texture.atlas"]))["texture.atlas"])
    got = npy(torch_grads(tscene, tpath.PathConfig(max_depth=DEPTH), W,
                          ["texture.atlas"])["texture.atlas"])
    assert np.isfinite(got).all()
    nan = ~np.isfinite(want).all(1)
    # the NaN texels: the base level's edge columns, where the wrapped
    # floor of an infinite u lands
    idx = np.flatnonzero(nan)
    assert len(idx) < 64 and (idx < 64 * 64).all()
    assert set(idx % 64) <= {0, 63}
    assert rel_err(got[~nan], want[~nan]) < GRAD_TOL
    # the back wall's bitmap (texture 0, base level 64^2) gets gradient
    assert (got[:64 * 64] != 0).sum() > 20


def test_bump_map_gradient_matches_forward_mode():
    """d sum(Li)/d texture.atlas through the bump and normal maps
    (``_perturb_frame_v``: the height map's finite differences, the
    normalisations, the flip into ng's side) on the small textured_cornell
    at 8^2, depth 2.  The reference's reverse mode has no finite non-zero
    entry on the two maps' texels (every texel a lane reads is NaN), so
    the port's gradient is held to ``jax.jvp`` along one direction v over
    both maps' atlas ranges whose entries are ±1 / |g_i| (±1 where g_i is
    0), as test_torch_material_grads does for alpha: |g . v - jvp(v)|
    within GRAD_TOL of sum |g_i v_i|, a sum of ones (~350 here)."""
    w = 8
    jscene = jax_textured_cornell(64, 32)
    tscene = bridged(jscene)
    got = npy(torch_grads(tscene, tpath.PathConfig(max_depth=DEPTH), w,
                          ["texture.atlas"])["texture.atlas"])
    tex = tscene.textures
    kinds = npy(tscene.bsdfs.bump_kind)
    ids = {int(t) for t, k in zip(npy(tscene.bsdfs.bump_tex), kinds) if k}
    assert len(ids) == 2
    mip = npy(tex.mip_offset)
    rng = np.random.default_rng(92)
    v = np.zeros_like(got)
    for t in ids:
        lo, hi = mip[t, 0], mip[t, npy(tex.n_levels)[t] - 1] + 1
        g = np.abs(got[lo:hi])
        # both maps are read, at their base levels only (unfiltered)
        assert g[:npy(tex.width)[t] * npy(tex.height)[t]].max() > 0
        assert (g[npy(tex.width)[t] * npy(tex.height)[t]:] == 0).all()
        sign = rng.choice([-1.0, 1.0], size=g.shape)
        v[lo:hi] = np.where(g > 0, sign / np.where(g > 0, g, 1.0), sign)
    f = jax_sum_li(jscene, jpath.PathConfig(max_depth=DEPTH, remat=False), w)
    with jax.disable_jit():
        _, jvp = jax.jvp(f, (jopt.get_params(jscene, ["texture.atlas"]),),
                         ({"texture.atlas": jnp.asarray(
                             v.astype(np.float32))},))
    terms = got * v
    assert np.isfinite(terms).all() and np.abs(terms).sum() > 100
    assert abs(terms.sum() - float(jvp)) < GRAD_TOL * np.abs(terms).sum()


def test_filtered_gradient_remat_modes_bit_exact(textured):
    """The filtered first bounce (ray differentials) is peeled off the loop
    and replays as its own unit: the atlas gradient (which reaches the
    MIP levels through the filter) is bit for bit the same per bounce, in
    groups of 2 and without remat."""
    _, tscene = textured

    def grad(**kw):
        params = {"texture.atlas": tscene.textures.atlas.detach().clone()
                  .requires_grad_(True)}
        sc = topt.set_params(tscene, params)
        li = _port_li_t(sc, tpath.PathConfig(max_depth=4, **kw))
        li.backward()
        return params["texture.atlas"].grad

    g = grad(remat=False)
    # the bitmap's MIP levels above its 64^2 base (the atlas's first 5,461
    # texels) get gradient through the filter
    assert g[64 * 64:5461].abs().sum() > 0
    for kw in (dict(remat=True), dict(remat=True, remat_group=2)):
        assert torch.equal(grad(**kw), g), kw


def _port_li_t(sc, cfg):
    pix = torch.arange(W * W)
    s = trng.make_sampler_v(pix, SAMPLE, 0)
    s, blk = trng.next_block4_v(s)
    uu = ((pix % W).float() + blk[0]) / W
    vv = ((pix // W).float() + blk[1]) / W
    o, d, _ = t_sample_ray_v(sc.sensor, uu, vv, blk[2], blk[3])
    dx, dy = trd.camera_ray_differentials(sc.sensor, uu, vv, blk[2], blk[3],
                                          1.0 / W, 1.0 / W)
    li, _ = tpath.path_li_v(sc, s, o, d, cfg, dddx=dx, dddy=dy)
    return li.x.sum() + li.y.sum() + li.z.sum()


def _mask_scene(builder, opacity, opacity_tex=None):
    """A MASK quad (over a white diffuse) between the camera and an area
    light facing the camera; nothing else.  The light is seen only through
    the mask."""
    b = builder
    inner = b.add_bsdf(tbc.diffuse_record(0.8))
    mask = tbc.mask_record(inner, opacity=opacity)
    if opacity_tex is not None:
        mask["opacity_tex"] = opacity_tex(b.textures)
    quad = TriMesh(np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                            float), np.array([[0, 1, 2], [2, 3, 0]]),
                   uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float))
    b.add_trimesh(quad, b.new_shape(b.add_bsdf(mask)))
    light = TriMesh(np.array([[-2, -2, -1], [2, -2, -1], [2, 2, -1],
                              [-2, 2, -1]], float),
                    np.array([[0, 1, 2], [2, 3, 0]]))
    lsid = b.new_shape(b.add_bsdf(tbc.default_record()))
    b.add_trimesh(light, lsid)
    b.add_emitter(dict(type=tem.EM_AREA, radiance=np.array([3.0, 2.0, 1.0]),
                       shape=lsid))
    b.shape_emitter[lsid] = 0
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        [0, 0, 2.0], [0, 0, 0], [0, 1, 0]), fov_deg=40.0)
    return b.build()[0]


@pytest.mark.parametrize("opacity", ["transparent", "textured"])
def test_mask_passes_rays_through(opacity):
    """C8, refuted: behind a MASK of opacity 0 the reference renders the
    light at its full radiance (6 = 3 + 2 + 1), so its path samples the
    pass-through (``u_mask`` is the BSDF block's fourth uniform); the port
    renders the same.  With a checkerboard opacity of 1 and 0.25 the two
    agree under the gate, and the stage (``bsdf_sample_v`` with
    ``u_mask``) agrees lane for lane."""
    if opacity == "transparent":
        jscene = _mask_scene(JBuilder(), 0.0)
    else:
        jscene = _mask_scene(JBuilder(), 1.0, lambda tb: ttex.checkerboard(
            tb, 1.0, 0.25, uscale=2.0, vscale=2.0))
    tscene = bridged(jscene)
    cfg = dict(max_depth=DEPTH, remat=False)  # the bounce at the mask
    ref = _jax_li(jscene, jpath.PathConfig(**cfg), W, False)
    out = _port_li(tscene, tpath.PathConfig(**cfg), W, False)
    if opacity == "transparent":
        np.testing.assert_allclose(ref, 6.0, rtol=1e-5)
        np.testing.assert_allclose(out, 6.0, rtol=1e-5)
    else:
        assert 0 < ref.mean() < 6.0
        st = parity_gate(out, ref)
        assert st["ok"], st

    # the stage: resolve the mask row and sample with u_mask
    gen = np.random.default_rng(70)
    n = 4096
    bid = np.zeros(n, np.int32) + 1
    uv = gen.random((2, n)).astype(np.float32)
    u = gen.random((5, n)).astype(np.float32)
    wi = np.stack([0.3 * u[4], 0.2 * u[3], np.ones(n)], -1)
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    jp = jbc.resolve_v(jscene.bsdfs, jscene.textures, jnp.asarray(bid),
                       *(jnp.asarray(a) for a in uv), jnp.asarray(u[0]))
    tp = tbc.resolve_v(tscene.bsdfs, tscene.textures, torch.from_numpy(bid),
                       *(torch.from_numpy(a) for a in uv),
                       torch.from_numpy(u[0]))
    close(tp.opacity, jp.opacity)
    jb = jev.bsdf_sample_v(jp, jv3(wi), *(jnp.asarray(a) for a in u[:4]))
    tb = tev.bsdf_sample_v(tp, tv3(wi), *(torch.from_numpy(a)
                                          for a in u[:4]))
    for k in ("delta", "null_passthrough"):
        np.testing.assert_array_equal(npy(getattr(tb, k)),
                                      npy(getattr(jb, k)), err_msg=k)
    through = npy(tb.null_passthrough)
    assert 0.1 < through.mean() < 0.9 if opacity == "textured" \
        else through.all()
    close_v3(tb.wo, jb.wo, atol=4e-6)
    close_v3(tb.weight, jb.weight)
    close(tb.pdf, jb.pdf)
