"""Port vs reference: the texture stage (``mitsuba_im_tpu_torch/texture/``),
the textured and wrapped BSDF resolve (``bsdf/common.py::resolve_v``), bump
and normal maps (``scene/scene.py::_perturb_frame_v``), ray differentials
(``render/raydiff.py``) and the bridge of their tables.

Held bit for bit: the MIP pyramid and the atlas, every texture record and
bridged leaf, the vertexcolors bake, ``hash_u32``, the integer helpers
(texel wrapping, level sizes) and BLEND's picks.

Float tolerances, each with its reason (XLA on the CPU fuses multiply-adds
and its transcendentals differ from PyTorch's in the last bits):
- texture values abs 2e-5: ``u * scale + offset`` and ``u * w - 0.5`` are
  fused in XLA, so a bilinear fraction differs by up to ~1e-7 times the
  texel coordinate (up to ~200 here); values are continuous across texel
  edges and MIP levels, so the edge lanes stay inside the bound;
- the piecewise textures (checker, grid) jump at their edges: a lane
  whose coordinate lies within an ulp of an edge may take the other
  colour, at most 2 of 8,192 lanes (none were seen);
- the bilinear corner index x0 = floor(u w - 0.5): equal on all but lanes
  within an ulp of a texel edge, at most 1 in 1,000;
- uv differentials rel 1e-4 of the largest (a 2x2 solve over edges of
  ~1e-1 and offsets of ~1e-3 that cancel);
- resolved parameters abs 2e-5 (texture values, above);
- bump frames abs 2e-3: the height map's one-sided difference divides a
  float32 difference of texture values (~1e-7 apart) by eps 5e-4, so its
  last-bit noise is ~2e-4 of the slope before the scale; normal maps abs
  2e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, close, close_v3, jv3, npy, tv3

from mitsuba_im_tpu.bsdf import common as jbc
from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.transform import Transform as JTransform
from mitsuba_im_tpu.render import raydiff as jrd
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.sensor.table import make_sensor as jmake_sensor
from mitsuba_im_tpu.sensor.table import S_PERSPECTIVE as JS_PERSPECTIVE
from mitsuba_im_tpu.texture import texture as jtx
from mitsuba_im_tpu.texture import bake_vertex_colors as j_bake
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch import texture as ttex
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.render import raydiff as trd
from mitsuba_im_tpu_torch.scene import bridge
from mitsuba_im_tpu_torch.scene.build import SceneBuilder
from mitsuba_im_tpu_torch.scene.mesh import TriMesh
from mitsuba_im_tpu_torch.texture import texture as ttx

torch.set_num_threads(2)

N = 8192
VALUE_ATOL = 2e-5


def _fill(tb, wrap="repeat"):
    """The same records into either package's TextureBuilder: a constant,
    three bitmaps (odd 37 x 53 sides, 64^2, a 1 x 5 strip), a checker, a
    grid and a scale of the first bitmap."""
    gen = np.random.default_rng(60)
    ids = [
        tb.add_constant([0.3, 0.6, 0.9]),
        ttex.bitmap(tb, gen.random((37, 53, 3), np.float32), uscale=1.7,
                    vscale=2.3, uoffset=0.1, voffset=-0.2, wrap=wrap),
        ttex.checkerboard(tb, [0.9, 0.1, 0.2], [0.1, 0.8, 0.3], uscale=3.0,
                          vscale=2.0),
        ttex.gridtexture(tb, 0.05, 0.7, line_width=0.08, uscale=2.5),
        ttex.bitmap(tb, gen.random((64, 64, 3), np.float32), uscale=3.0,
                    vscale=3.0, wrap=wrap),
        ttex.bitmap(tb, gen.random((1, 5, 3), np.float32), wrap=wrap),
    ]
    ids.append(ttex.scale(tb, ids[1], scale=[0.5, 2.0, 1.0]))
    return ids


def _tables(wrap="repeat"):
    jb, tb = jtx.TextureBuilder(), ttx.TextureBuilder()
    _fill(jb, wrap)
    _fill(tb, wrap)
    return jb.build(), tb.build("cpu")


def _lanes(gen, n, n_tex):
    ids = gen.integers(-1, n_tex, n).astype(np.int32)
    uv = gen.uniform(-1.5, 2.5, (2, n)).astype(np.float32)
    # footprints from a tenth of a texel to most of the texture,
    # anisotropic, in random directions
    mag = np.exp(gen.uniform(np.log(1e-4), np.log(0.3), (2, n)))
    ang = gen.uniform(0, 2 * np.pi, (2, n))
    duv = np.stack([mag[0] * np.cos(ang[0]), mag[0] * np.sin(ang[0]),
                    mag[1] * np.cos(ang[1]), mag[1] * np.sin(ang[1])])
    const = gen.random((n, 3)).astype(np.float32)
    return ids, uv, duv.astype(np.float32), const


def test_pyramid_and_atlas_bit_exact():
    """Every leaf (the atlas with its pyramids, offsets, level counts) and
    static of the table equals the reference's, and the factories make the
    reference's records."""
    from mitsuba_im_tpu.core.properties import Properties
    from mitsuba_im_tpu.core.registry import create

    jt, tt = _tables()
    for k in ttx.TEXTURE_LEAVES:
        a, b = npy(getattr(jt, k)), npy(getattr(tt, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tt.used_types == jt.used_types and tt.has_mip == jt.has_mip
    # 37 x 53: 53 27 14 7 4 2 1 wide, 37 19 10 5 3 2 1 high
    assert int(tt.n_levels[1]) == 7 and int(tt.n_levels[5]) == 4
    assert tt.atlas.shape[0] == sum(
        w * h for w, h in zip([53, 27, 14, 7, 4, 2, 1],
                              [37, 19, 10, 5, 3, 2, 1])) + 5461 + 5 + 3 + 2 + 1

    class Ctx:
        def __init__(self):
            self.textures = jtx.TextureBuilder()

    props = Properties("checkerboard")
    props.set("uscale", 3.0)
    ctx = Ctx()
    create("texture", props, ctx)
    props = Properties("gridtexture")
    props.set("lineWidth", 0.05)
    create("texture", props, ctx)
    create("texture", Properties("wireframe"), ctx)
    props = Properties("scale")
    props.set("scale", 2.5)
    props.children["texture"] = 0
    create("texture", props, ctx)
    tb = ttx.TextureBuilder()
    ttex.checkerboard(tb, uscale=3.0)
    ttex.gridtexture(tb, line_width=0.05)
    ttex.wireframe(tb)
    ttex.scale(tb, 0, scale=2.5)
    for a, b in zip(ctx.textures.records, tb.records):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    with pytest.raises(NotImplementedError):
        ttex.curvature(tb)


def test_integer_helpers_exact():
    """Texel wrapping (negative coordinates round toward -inf) and level
    sizes equal the reference's everywhere."""
    gen = np.random.default_rng(61)
    x = gen.integers(-300, 300, N).astype(np.int32)
    n = gen.integers(0, 70, N).astype(np.int32)
    mode = gen.integers(0, 3, N).astype(np.int32)
    np.testing.assert_array_equal(
        npy(ttx._wrap_coord(*(torch.from_numpy(a) for a in (x, n, mode)))),
        npy(jtx._wrap_coord(*(jnp.asarray(a) for a in (x, n, mode)))))
    w = gen.integers(1, 5000, N).astype(np.int32)
    h = gen.integers(1, 5000, N).astype(np.int32)
    lvl = gen.integers(0, 13, N).astype(np.int32)
    for a, b in zip(ttx._level_dims(*(torch.from_numpy(a)
                                      for a in (w, h, lvl))),
                    jtx._level_dims(*(jnp.asarray(a) for a in (w, h, lvl)))):
        np.testing.assert_array_equal(npy(a), npy(b))


@pytest.mark.parametrize("wrap", ["repeat", "clamp", "mirror"])
@pytest.mark.parametrize("filtered", [False, True])
def test_eval_texture_v(wrap, filtered):
    """Every type (constant, bitmap, checker, grid, scale) and INVALID ids
    (const_rgb), unfiltered and through the MIP filter."""
    jt, tt = _tables(wrap)
    gen = np.random.default_rng(62)
    ids, uv, duv, const = _lanes(gen, N, tt.type.shape[0])
    got = ttx.eval_texture_v(tt, torch.from_numpy(ids),
                             *(torch.from_numpy(a) for a in uv), tv3(const),
                             tuple(torch.from_numpy(a) for a in duv)
                             if filtered else None)
    want = jtx.eval_texture_v(jt, jnp.asarray(ids),
                              *(jnp.asarray(a) for a in uv), jv3(const),
                              tuple(jnp.asarray(a) for a in duv)
                              if filtered else None)
    diff = np.abs(np.stack([npy(a) - npy(b) for a, b in zip(got, want)]))
    piecewise = np.isin(ids, [2, 3])
    assert (diff.max(0)[piecewise] > VALUE_ATOL).sum() <= 2
    assert diff[:, ~piecewise].max() < VALUE_ATOL, diff[:, ~piecewise].max()
    # the lookups do something: bitmaps vary, filtering smooths them
    bm = npy(got.x)[ids == 4]
    assert bm.std() > (0.02 if filtered else 0.1)


def test_bilinear_corner_index():
    """x0 = floor(u w - 0.5) of the port against the reference's formula on
    the same inputs: equal but on lanes within an ulp of a texel edge."""
    gen = np.random.default_rng(63)
    us = gen.uniform(-2, 3, N).astype(np.float32)
    w = gen.integers(1, 4096, N).astype(np.int32)
    wrap = np.zeros(N, np.int32)
    k, dx, _ = ttx._bilinear_taps(1 << 30, torch.zeros(N, dtype=torch.int32),
                                  torch.from_numpy(w), torch.ones(N, dtype=
                                  torch.int32), torch.from_numpy(wrap),
                                  torch.from_numpy(us), torch.zeros(N))
    ref = jtx._wrap_coord(jnp.floor(jnp.asarray(us) * jnp.asarray(w).astype(
        jnp.float32) - 0.5).astype(jnp.int32), jnp.asarray(w),
        jnp.asarray(wrap))
    assert (npy(k[0]) != npy(ref)).sum() <= N // 1000


def test_vertexcolors_bake():
    """The bake's atlas block and corner uvs equal the reference's, and a
    lookup at a barycentric point is the barycentric blend of the corner
    colours (the fourth texel cancels the bilinear cross term)."""
    gen = np.random.default_rng(64)
    pos = gen.random((6, 3))
    idx = np.array([[0, 1, 2], [3, 4, 5], [1, 3, 5]])
    mesh = TriMesh(pos, idx, colors=gen.random((6, 3)).astype(np.float32))

    class Ctx:
        def __init__(self):
            self.textures = jtx.TextureBuilder()

    ctx = Ctx()
    jid = ctx.textures.add_constant(np.full(3, 0.5))
    juv = j_bake(ctx, mesh, [jid])
    b = SceneBuilder()
    tid = ttex.vertexcolors(b)
    b.add_trimesh(mesh, b.new_shape(b.add_bsdf(tbc.default_record())))
    assert not b.pending_vertexcolors
    tuv = np.stack(b._tri["uv0"] + b._tri["uv1"] + b._tri["uv2"], 1)
    np.testing.assert_array_equal(tuv, juv)
    tt, jt = b.textures.build("cpu"), ctx.textures.build()
    for k in ttx.TEXTURE_LEAVES:
        np.testing.assert_array_equal(npy(getattr(tt, k)),
                                      npy(getattr(jt, k)), err_msg=k)
    bary = gen.dirichlet(np.ones(3), 3)
    uv = np.einsum("tk,tkc->tc", bary, juv).astype(np.float32)
    got = ttx.eval_texture_v(tt, torch.full((3,), tid, dtype=torch.int32),
                             torch.from_numpy(uv[:, 0]),
                             torch.from_numpy(uv[:, 1]))
    want = np.einsum("tk,tkc->tc", bary, mesh.colors[idx])
    close_v3(got, tv3(want), rtol=1e-5, atol=1e-6)
    b2 = SceneBuilder()
    ttex.vertexcolors(b2)
    with pytest.warns(UserWarning, match="no per-vertex colors"):
        b2.add_trimesh(TriMesh(pos, idx), 0)


def test_hash_uniform_exact():
    gen = np.random.default_rng(65)
    uv = gen.uniform(-3, 3, (2, N)).astype(np.float32)
    uv[0, :4] = [0.0, -0.0, np.inf, 1e-40]
    a = gen.integers(0, 2**32, N, dtype=np.uint64)
    np.testing.assert_array_equal(
        npy(trng.hash_u32(torch.from_numpy(a.astype(np.int64)), 7)),
        npy(jrng.hash_u32(jnp.asarray(a.astype(np.uint32)), 7)))
    np.testing.assert_array_equal(
        npy(tbc._hash_uniform(*(torch.from_numpy(x) for x in uv))),
        npy(jbc._hash_uniform(jnp.asarray(uv.T))))


# ---------------------------------------------------------------------------
# resolve_v: textured parameters, MASK and nested BLEND
# ---------------------------------------------------------------------------

def _wrapper_records(ids):
    """Rows over the textures of ``_fill``: 0 diffuse (textured refl), 1
    rough conductor (textured alpha and spec), 2 rough dielectric
    (textured trans), 3 MASK over 0 (textured opacity), 4 BLEND of 1 and 2
    (textured weight), 5 BLEND of 3 and 4 (weight 0.3), 6 a MASK over 5
    (constant opacity)."""
    diff = tbc.diffuse_record(0.4)
    diff["refl_tex"] = ids[1]
    metal = tbc.conductor_record(rough=True, alpha=0.3)
    metal["alpha_tex"] = ids[2]
    metal["spec_tex"] = ids[6]
    glass = tbc.dielectric_record(kind=tbc.ROUGHDIELECTRIC, alpha=0.2)
    glass["trans_tex"] = ids[4]
    return [diff, metal, glass,
            tbc.mask_record(0, opacity_tex=ids[3]),
            tbc.blend_record(1, 2, 0.5, weight_tex=ids[4]),
            tbc.blend_record(3, 4, 0.3),
            tbc.mask_record(5, opacity=[0.2, 0.5, 0.8])]


@pytest.mark.parametrize("u_sel", ["sampler", "hash"])
def test_resolve_v_textures_and_wrappers(u_sel):
    """Types (BLEND's picks) exact; opacity, refl, spec, trans and alpha
    within the texture tolerance, filtered (duv) and not (with the
    sampler's uniform; unfiltered with the uv hash)."""
    ids = _fill(jtx.TextureBuilder())
    recs = _wrapper_records(ids)
    jt, tt = jbc.build_table(recs), tbc.build_table(recs, "cpu")
    assert tt.unwrap_depth == jt.unwrap_depth == 4
    assert set(tt.tex_columns) == {"refl_tex", "spec_tex", "trans_tex",
                                   "alpha_tex", "opacity_tex", "weight_tex"}
    jtex, ttex_ = _tables()
    gen = np.random.default_rng(66)
    n = N
    bid = gen.integers(-1, len(recs), n).astype(np.int32)
    uv = gen.uniform(-1, 2, (2, n)).astype(np.float32)
    u = gen.random(n).astype(np.float32) if u_sel == "sampler" else None
    duv = _lanes(gen, n, 1)[2]
    for filt in (None, duv) if u_sel == "sampler" else (None,):
        tp = tbc.resolve_v(tt, ttex_, torch.from_numpy(bid),
                           *(torch.from_numpy(a) for a in uv),
                           None if u is None else torch.from_numpy(u),
                           None if filt is None else
                           tuple(torch.from_numpy(a) for a in filt))
        jp = jbc.resolve_v(jt, jtex, jnp.asarray(bid),
                           *(jnp.asarray(a) for a in uv),
                           None if u is None else jnp.asarray(u),
                           None if filt is None else
                           tuple(jnp.asarray(a) for a in filt))
        np.testing.assert_array_equal(npy(tp.type), npy(jp.type))
        assert len(np.unique(npy(tp.type))) == 3
        for k in ("refl", "spec", "trans"):
            close_v3(getattr(tp, k), getattr(jp, k), rtol=0, atol=VALUE_ATOL)
        for k in ("alpha_u", "alpha_v", "opacity", "eta_s", "flags"):
            close(getattr(tp, k), getattr(jp, k), rtol=0, atol=VALUE_ATOL)
        op = npy(tp.opacity)
        assert (op < 1).any() and (op == 1).any()


def _lane_params_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "used_types":
            assert x == y
        elif isinstance(x, torch.Tensor) or x is None:
            assert (x is None and y is None) or torch.equal(x, y), f.name
        else:  # V3
            for cx, cy in zip(x, y):
                assert torch.equal(cx, cy), f.name


@pytest.mark.parametrize("filtered", [False, True])
def test_column_texture_types(filtered):
    """Each textured column looks its textures up with only the types its
    ids reach (a SCALE's nested texture's included; a nested SCALE and
    INVALID ids reach nothing): the resolved parameters are bit for bit
    those of lookups over every type."""
    T = ttx
    types = np.array([T.TEX_SCALE, T.TEX_SCALE, T.TEX_GRID])
    nested = np.array([1, 2, -1])
    assert T.reached_types(types, nested, np.array([0, -1])) == (
        T.TEX_SCALE,)
    assert T.reached_types(types, nested, np.array([1])) == (
        T.TEX_GRID, T.TEX_SCALE)
    assert T.reached_types(np.array([T.TEX_CHECKER, T.TEX_SCALE]),
                           np.array([-1, -1]), np.array([1, 1])) == (
        T.TEX_CHECKER, T.TEX_SCALE)
    assert T.reached_types(np.array([T.TEX_CONST]), np.array([-1]),
                           np.array([-1])) == ()
    tb = ttx.TextureBuilder()
    recs = _wrapper_records(_fill(tb))
    tex = tb.build("cpu")
    narrow = tbc.build_table(recs, "cpu", tb.type_arrays())
    wide = tbc.build_table(recs, "cpu")
    assert not wide.tex_types
    assert dict(narrow.tex_types) == {
        "refl_tex": (T.TEX_BITMAP,), "spec_tex": (T.TEX_BITMAP, T.TEX_SCALE),
        "trans_tex": (T.TEX_BITMAP,), "alpha_tex": (T.TEX_CHECKER,),
        "opacity_tex": (T.TEX_GRID,), "weight_tex": (T.TEX_BITMAP,)}
    gen = np.random.default_rng(67)
    bid = torch.from_numpy(gen.integers(-1, len(recs), N).astype(np.int32))
    uv = [torch.from_numpy(a) for a in
          gen.uniform(-1, 2, (2, N)).astype(np.float32)]
    u = torch.from_numpy(gen.random(N).astype(np.float32))
    duv = (tuple(torch.from_numpy(a) for a in _lanes(gen, N, 1)[2])
           if filtered else None)
    _lane_params_equal(tbc.resolve_v(narrow, tex, bid, *uv, u, duv),
                       tbc.resolve_v(wide, tex, bid, *uv, u, duv))


# ---------------------------------------------------------------------------
# scenes: bump frames, uv differentials, the bridge
# ---------------------------------------------------------------------------

def jax_textured_cornell(bitmap_res=64, bump_res=32):
    """textured_cornell's content at small texture sizes, built by the JAX
    package."""
    b = JBuilder()
    scenes.fill_textured_cornell(b, bitmap_res=bitmap_res, bump_res=bump_res)
    c = scenes.CORNELL_CAMERA
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        c["origin"], c["target"], c["up"]), fov_deg=c["fov_deg"])
    return b.build()[0]


@pytest.fixture(scope="module")
def textured():
    jscene = jax_textured_cornell()
    return jscene, bridged(jscene)


@pytest.fixture(scope="module")
def bumped(textured):
    """Both packages' interactions of camera rays in the textured scene
    (the reference's computed once: its eager ops compile on first use)."""
    jscene, tscene = textured
    (jo, jd, jh), (to, td, th), _ = _camera_hits(jscene, tscene)
    return (jscene.interaction_v(jo, jd, jh),
            tscene.interaction_v(to, td, th), th)


def _camera_hits(jscene, tscene, n_side=48):
    """Camera rays through the pixel grid (V3 pairs of both packages), the
    port's hits on them given to both (the reference's intersection is
    held elsewhere; its compile would dominate this file), and the pixel
    coordinates."""
    from mitsuba_im_tpu.scene.geometry import Hit as JHit
    from mitsuba_im_tpu.sensor.table import sample_ray_v as jsr
    from mitsuba_im_tpu_torch.sensor.table import sample_ray_v as tsr

    g = (np.arange(n_side, dtype=np.float32) + 0.5) / n_side
    uu, vv = (a.ravel() for a in np.meshgrid(g, g))
    z = np.zeros_like(uu)
    jo, jd, _ = jsr(jscene.sensor, *(jnp.asarray(a) for a in (uu, vv, z, z)))
    to, td, _ = tsr(tscene.sensor, *(torch.from_numpy(a)
                                     for a in (uu, vv, z, z)))
    th = tscene.ray_intersect_v(to, td)
    jh = JHit(**{k: jnp.asarray(npy(getattr(th, k)))
                 for k in ("t", "kind", "prim", "shape", "u", "v")})
    return (jo, jd, jh), (to, td, th), (uu, vv)


def test_bridge_round_trip(textured):
    """The textured scene's every leaf (the texture table, the wrapper and
    texture columns) and static comes through the bridge bit for bit, and
    the port's own builder makes the same tables."""
    jscene, tscene = textured
    arrays, statics = bridge.export_tables(jscene)
    assert statics["textures.has_mip"] and statics["bsdfs.has_bump"]
    for k in ttx.TEXTURE_LEAVES:
        a = arrays[f"textures.{k}"]
        assert npy(getattr(tscene.textures, k)).dtype == np.dtype(
            np.int32 if k in ttx._INT_LEAVES else np.float32), k
        np.testing.assert_array_equal(npy(getattr(tscene.textures, k)), a)
    for k in tbc.BSDF_LEAVES:
        np.testing.assert_array_equal(npy(getattr(tscene.bsdfs, k)),
                                      arrays[f"bsdfs.{k}"], err_msg=k)
    assert tscene.textures.used_types == jscene.textures.used_types
    assert tscene.bsdfs.unwrap_depth == jscene.bsdfs.unwrap_depth
    assert tscene.bsdfs.has_bump == jscene.bsdfs.has_bump
    assert tscene.bsdfs.bump_kinds == (tbc.BUMP_HEIGHT, tbc.BUMP_NORMAL)
    b = SceneBuilder()
    scenes.fill_textured_cornell(b, bitmap_res=64, bump_res=32)
    b.sensor = tscene.sensor
    own = b.build("cpu")[0]
    for part, leaves in (("textures", ttx.TEXTURE_LEAVES),
                         ("bsdfs", tbc.BSDF_LEAVES)):
        for k in leaves:
            assert torch.equal(getattr(getattr(own, part), k),
                               getattr(getattr(tscene, part), k)), k
    assert own.bsdfs.tex_columns == tscene.bsdfs.tex_columns
    # the lookups each column makes: the walls' refl reaches the bitmap
    # (the back wall, and the left wall's scale of it), the checker and
    # the grid; opacity and alpha only checkers; the bump maps bitmaps
    assert own.bsdfs.tex_types == tscene.bsdfs.tex_types
    assert dict(own.bsdfs.tex_types) == {
        "refl_tex": (ttx.TEX_BITMAP, ttx.TEX_CHECKER, ttx.TEX_GRID,
                     ttx.TEX_SCALE),
        "alpha_tex": (ttx.TEX_CHECKER,), "opacity_tex": (ttx.TEX_CHECKER,),
        "bump_tex": (ttx.TEX_BITMAP,)}


@pytest.mark.parametrize("kind", ["height", "normal"])
def test_perturb_frame(bumped, kind):
    """Bumped interactions on the floor (height map) or the back wall
    (normal map): ns, ss, ts and wi_local against the reference's."""
    ji, ti, th = bumped
    shape = 0 if kind == "height" else 2
    lanes = npy(th.shape) == shape
    assert lanes.sum() > 100
    atol = 2e-3 if kind == "height" else VALUE_ATOL
    for k in ("ns", "ss", "ts_", "wi_local"):
        for a, b in zip(getattr(ti, k), getattr(ji, k)):
            np.testing.assert_allclose(npy(a)[lanes], npy(b)[lanes], rtol=0,
                                       atol=atol, err_msg=k)
    # the map tilts the frame away from the geometric normal
    tilt = 1 - np.abs(npy(ti.ns.dot(ti.ng)))[lanes]
    assert tilt.max() > 1e-3
    # elsewhere the frame is the unbumped one (flipped into ng's side)
    other = (npy(th.shape) >= 3) & npy(th.valid)
    for a, b in zip(ti.ns, ji.ns):
        close(npy(a)[other], npy(b)[other])


def _mesh_scene(n_tris):
    """A displaced-sphere mesh with spherical corner uvs, brute force at
    <= 64 triangles in the reference's per-leaf branch and above it in its
    packed-row branch."""
    pos, idx = scenes.displaced_sphere(n_tris)
    n = int(np.sqrt(n_tris / 2)) + 1
    uvs = scenes._sphere_corner_uvs(idx, n)
    b = JBuilder()
    b.add_trimesh(TriMesh(pos * 10, idx), b.new_shape(b.add_bsdf(
        jbc.default_record())), corner_uvs=uvs)
    b.sensor = jmake_sensor(JS_PERSPECTIVE, JTransform.look_at(
        [0.4, 0.6, 3.0], [0, 0, 0], [0, 1, 0]), fov_deg=40.0)
    return b.build()[0]


@pytest.mark.parametrize("n_tris", [40, 300])
def test_uv_differentials(n_tris):
    """uv derivatives of camera rays at their hits (the reference's two
    branches), and the camera's direction differentials."""
    from mitsuba_im_tpu.sensor.table import sample_ray_v as jsr

    jscene = _mesh_scene(n_tris)
    assert (jscene.geom.n_tris <= 64) == (n_tris < 64)
    tscene = bridged(jscene)
    (jo, jd, jh), (to, td, th), (uu, vv) = _camera_hits(jscene, tscene, 64)
    z = np.zeros_like(uu)
    tdx, tdy = trd.camera_ray_differentials(
        tscene.sensor, *(torch.from_numpy(a) for a in (uu, vv, z, z)),
        1.0 / 64, 1.0 / 64)
    jdx, jdy = jrd.camera_ray_differentials(
        jscene.sensor, *(jnp.asarray(a) for a in (uu, vv, z, z)),
        1.0 / 64, 1.0 / 64)
    for a, b in ((tdx, jdx), (tdy, jdy)):
        close_v3(a, b, rtol=1e-4, atol=1e-6)
    got = trd.uv_differentials(tscene.geom, th, to, td, tdx, tdy)
    want = jrd.uv_differentials(jscene.geom, jh, jo, jd, jdx, jdy)
    hit = npy(th.valid)
    assert 200 < hit.sum() < hit.size
    for a, b in zip(got, want):
        a, b = npy(a), npy(b)
        assert (a[~hit] == 0).all()
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
