"""Port vs reference: the participating media (``mitsuba_im_tpu_torch/media``).

- ``media/volume.py`` (a numpy copy) against the original on files the
  test writes: ``.vol`` grids in float32, float16 and uint8, an
  ``hgridvolume`` dictionary with its blocks, ``const_grid`` and
  ``grid_world_to_voxel``, exactly;
- ``build_media``'s leaves bit for bit, from records and from a scene file
  through both loaders and the bridge;
- the grid lookups on 4,096 seeded points (rel 1e-6), and the delta and
  ratio tracking loops on a 16^3 grid: the sampler's dimension equal (the
  loops run as many iterations as the reference's), t and T within rel
  1e-5;
- isotropic, HG, Rayleigh, the mixture and Kajiya-Kay against the
  reference within rel 1e-5; Rayleigh's sampled directions within 2e-5
  absolute and its pdf within rel 1e-4 (``pow(x, 1/3)`` against XLA's
  ``cbrt`` differs in the last bits of cos(theta), which sqrt(1 - cos^2)
  amplifies near the poles);
- microflake in the port's one convention (``wi`` toward the previous
  vertex): port(wi, wo) = reference(wi, -wo) for eval and pdf (rel 1e-5),
  its sampled wo the negation of the reference's (within 1e-5:
  ``torch.erfinv`` against XLA's);
- the Kajiya-Kay lobe's maximum on the fibre's mirror cone wo.a = -wi.a;
- Kajiya-Kay and microflake against a float64 numpy transcription of the
  formulas (rel 1e-4); normalization to 1 over the sphere, sample against
  pdf by chi^2 and E[weight] = 1, as ``tests/test_phase.py`` checks the
  reference's.
"""
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import (assert_same_scene, bridged, close, jv3, npy,
                                tv3, unit_vectors)

from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.chisquare import chi2_test
from mitsuba_im_tpu.media import medium as jmed
from mitsuba_im_tpu.media import volume as jvol
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.media import medium as tmed
from mitsuba_im_tpu_torch.media import volume as tvol
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

N = 4096


def _rng(seed):
    return np.random.default_rng(seed)


def _raw_vol(path, data, enc, bmin, bmax):
    """A version-3 .vol of (Z, Y, X, C) ``data`` in encoding ``enc``."""
    zres, yres, xres, ch = data.shape
    if enc == jvol.ENC_FLOAT16:
        body = data.astype("<f2").tobytes()
    elif enc == jvol.ENC_UINT8:
        body = np.clip(np.round(data * 255), 0, 255).astype(np.uint8).tobytes()
    else:
        body = data.astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", enc, xres, yres, zres, ch))
        f.write(struct.pack("<6f", *bmin, *bmax))
        f.write(body)


def _same_record(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("case", ["float32", "float16", "uint8", "hgrid",
                                  "const", "world_to_voxel"])
def test_volume_matches_reference(case, tmp_path):
    r = _rng(1)
    data = r.random((5, 4, 6, 3)).astype(np.float32)
    bmin, bmax = [-1.0, -0.5, 0.0], [1.0, 0.5, 2.0]
    if case in ("float32", "float16", "uint8"):
        enc = {"float32": jvol.ENC_FLOAT32, "float16": jvol.ENC_FLOAT16,
               "uint8": jvol.ENC_UINT8}[case]
        path = str(tmp_path / "g.vol")
        _raw_vol(path, data, enc, bmin, bmax)
        _same_record(tvol.read_vol(path), jvol.read_vol(path))
        out_t, out_j = str(tmp_path / "t.vol"), str(tmp_path / "j.vol")
        tvol.write_vol(out_t, data, bmin, bmax)
        jvol.write_vol(out_j, data, bmin, bmax)
        assert open(out_t, "rb").read() == open(out_j, "rb").read()
    elif case == "hgrid":
        # a 2 x 1 x 2 cell dictionary, one cell absent, one block coarser
        with open(tmp_path / "dict.hgrid", "wb") as f:
            f.write(struct.pack("<6f", -1, -1, -1, 1, 1, 1))
            f.write(struct.pack("<3i", 2, 1, 2))
            for c in ((0, 0, 0), (1, 0, 0), (1, 0, 1)):
                f.write(struct.pack("<3i", *c))
        for c, shape in (((0, 0, 0), (4, 4, 4, 1)), ((1, 0, 0), (2, 2, 2, 1)),
                         ((1, 0, 1), (4, 4, 4, 1))):
            tvol.write_vol(str(tmp_path / "b{:03d}_{:03d}_{:03d}.vol".format(
                *c)), r.random(shape).astype(np.float32), [0, 0, 0],
                [1, 1, 1])
        path = str(tmp_path / "dict.hgrid")
        _same_record(tvol.read_hgrid(path, "b", ".vol"),
                     jvol.read_hgrid(path, "b", ".vol"))
    elif case == "const":
        for val in (0.7, [0.2, 0.4, 0.9]):
            _same_record(tvol.const_grid(val), jvol.const_grid(val))
    else:
        ang = np.radians(30.0)
        w2v = np.array([[np.cos(ang), 0, np.sin(ang), 0.3],
                        [0, 1, 0, -0.2], [-np.sin(ang), 0, np.cos(ang), 1.1],
                        [0, 0, 0, 1]])
        for rec in (dict(data=data, bmin=np.asarray(bmin),
                         bmax=np.asarray(bmax)),
                    dict(data=data[:1], bmin=np.asarray(bmin),
                         bmax=np.asarray(bmax), world_to_volume=w2v)):
            np.testing.assert_array_equal(tvol.grid_world_to_voxel(rec),
                                          jvol.grid_world_to_voxel(rec))


def _grid_records():
    """Medium records: a homogeneous HG fog, a 16^3 grid medium with an
    albedo grid and an orientation grid under a rotation (microflake), a
    kkay grid medium with a constant albedo, a Rayleigh and a mixture
    homogeneous medium."""
    r = _rng(2)
    ang = np.radians(25.0)
    to_world = np.array([[np.cos(ang), -np.sin(ang), 0, 0.1],
                         [np.sin(ang), np.cos(ang), 0, -0.05],
                         [0, 0, 1, 0.2], [0, 0, 0, 1]])
    box = dict(bmin=np.full(3, -0.5), bmax=np.full(3, 0.5),
               world_to_volume=np.linalg.inv(to_world))
    dens = dict(box, data=r.random((16, 16, 16, 1)).astype(np.float32))
    alb = dict(box, data=(0.3 + 0.7 * r.random((16, 16, 16, 3))).astype(
        np.float32))
    ori = dict(box, data=r.normal(size=(8, 8, 8, 3)).astype(np.float32))
    return [
        dict(kind="homogeneous", sigma_s=np.array([0.5, 0.4, 0.3]),
             sigma_a=np.full(3, 0.1), scale=1.0,
             phase=dict(type=jmed.PH_HG, g=0.6)),
        dict(kind="heterogeneous", scale=4.0, density=dens, albedo=alb,
             orientation=ori,
             phase=dict(type=jmed.PH_MICROFLAKE, g=0.0, stddev=0.3)),
        dict(kind="heterogeneous", scale=2.0, density=dens,
             albedo=jvol.const_grid(0.9),
             phase=dict(type=jmed.PH_KKAY, g=0.0, kd=0.2, ks=0.4,
                        exponent=4.0)),
        dict(kind="homogeneous", sigma_s=np.full(3, 0.3),
             sigma_a=np.full(3, 0.05), scale=2.0,
             phase=dict(type=jmed.PH_RAYLEIGH, g=0.0)),
        dict(kind="homogeneous", sigma_s=np.full(3, 0.3),
             sigma_a=np.full(3, 0.05), scale=1.0,
             phase=dict(type=jmed.PH_MIX, g=0.0, components=[
                 (0.6, dict(type=jmed.PH_HG, g=0.7)),
                 (0.4, dict(type=jmed.PH_RAYLEIGH, g=0.0))])),
    ]


def _assert_same_media(port, ref):
    for k in tmed.MEDIUM_LEAVES:
        a, b = getattr(port, k), np.asarray(getattr(ref, k))
        assert npy(a).dtype == b.dtype and npy(a).shape == b.shape, k
        np.testing.assert_array_equal(npy(a), b, err_msg=k)
    for k in ("n_media", "used_phase", "has_hetero", "has_fancy_phase"):
        assert getattr(port, k) == getattr(ref, k), k


SCENE_XML = """<scene version="0.6.0">
  <integrator type="volpath"><integer name="maxDepth" value="3"/></integrator>
  <medium type="homogeneous" id="fog">
    <rgb name="sigmaS" value="0.04"/><rgb name="sigmaA" value="0.01"/>
    <phase type="mixturephase"><string name="weights" value="0.6, 0.4"/>
      <phase type="hg"><float name="g" value="0.7"/></phase>
      <phase type="rayleigh"/></phase>
  </medium>
  <medium type="heterogeneous" id="smoke">
    <float name="scale" value="6"/>
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
      <transform name="toWorld"><translate x="0.1"/></transform></volume>
    <volume name="albedo" type="constvolume">
      <float name="value" value="0.9"/></volume>
    <volume name="orientation" type="gridvolume">
      <string name="filename" value="orientation.vol"/></volume>
    <phase type="microflake"><float name="stddev" value="0.3"/></phase>
  </medium>
  <sensor type="perspective"><ref name="exterior" id="fog"/>
    <transform name="toWorld"><lookat origin="0, 0, 4" target="0, 0, 0"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="8"/></film></sensor>
  <shape type="sphere"><float name="radius" value="0.5"/>
    <bsdf type="null"/><ref name="interior" id="smoke"/>
    <ref name="exterior" id="fog"/></shape>
  <shape type="cube"><bsdf type="dielectric"/>
    <transform name="toWorld"><scale value="0.3"/>
      <translate x="1"/></transform>
    <medium type="homogeneous" name="interior">
      <rgb name="sigmaT" value="1.5"/><rgb name="albedo" value="0.8"/>
      <phase type="kkay"/></medium>
    <ref name="exterior" id="fog"/></shape>
  <shape type="sphere"><float name="radius" value="0.2"/>
    <point name="center" x="-1" y="0" z="0"/>
    <medium type="heterogeneous" name="interior">
      <volume type="hgridvolume"><string name="filename" value="d.hgrid"/>
        <string name="prefix" value="blk"/>
        <string name="postfix" value=".vol"/></volume>
      <volume type="volcache"><volume type="constvolume">
        <rgb name="value" value="0.5, 0.6, 0.7"/></volume></volume>
      <phase type="isotropic"/></medium></shape>
  <emitter type="constant"/>
</scene>
"""


def _write_scene_files(tmp_path, res=16):
    r = _rng(3)
    tvol.write_vol(str(tmp_path / "density.vol"),
                   r.random((res, res, res)).astype(np.float32),
                   [-0.5] * 3, [0.5] * 3)
    tvol.write_vol(str(tmp_path / "orientation.vol"),
                   r.normal(size=(4, 4, 4, 3)).astype(np.float32),
                   [-0.5] * 3, [0.5] * 3)
    with open(tmp_path / "d.hgrid", "wb") as f:
        f.write(struct.pack("<6f", -1.2, -0.2, -0.2, -0.8, 0.2, 0.2))
        f.write(struct.pack("<3i", 1, 1, 1))
        f.write(struct.pack("<3i", 0, 0, 0))
    tvol.write_vol(str(tmp_path / "blk000_000_000.vol"),
                   r.random((4, 4, 4)).astype(np.float32), [0] * 3, [1] * 3)


@pytest.mark.parametrize("case", ["records", "vacuum", "scene_file"])
def test_media_tables_match_reference(case, tmp_path):
    if case == "records":
        recs = _grid_records()
        _assert_same_media(tmed.build_media(recs, "cpu"),
                           jmed.build_media(recs))
    elif case == "vacuum":
        port = tmed.build_media([], "cpu")
        _assert_same_media(port, jmed.build_media([]))
        assert not port.any and port.sigma_t.shape == (1, 3)
    else:
        _write_scene_files(tmp_path)
        path = str(tmp_path / "scene.xml")
        with open(path, "w") as f:
            f.write(SCENE_XML)
        port, pset = tload(path, device="cpu")
        ref, rset = jload(path)
        assert_same_scene(port, bridged(ref))
        _assert_same_media(port.media, ref.media)
        assert port.camera_medium == ref.camera_medium == 0
        assert (npy(port.shape_interior) >= 0).sum() == 3
        assert (npy(port.shape_exterior) == 0).sum() == 2
        assert pset.integrator == rset.integrator == "volpath"
        assert port.media.has_hetero and port.media.has_fancy_phase


def _points(r, n=N):
    return r.uniform(-0.6, 0.7, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("fn", ["trilinear", "sigma_t", "albedo",
                                "orientation"])
def test_grid_lookups_match_reference(fn):
    recs = _grid_records()
    jm, tm = jmed.build_media(recs), tmed.build_media(recs, "cpu")
    r = _rng(4)
    p = _points(r)
    mid = r.choice([-1, 0, 1, 2], N, p=[0.05, 0.05, 0.45, 0.45]).astype(
        np.int32)
    jmid, tmid = jnp.asarray(mid), torch.from_numpy(mid)
    jrows, trows = jmed.hetero_rows_v(jm, jmid), tmed.hetero_rows_v(tm, tmid)
    for k in ("hetero", "majorant", "grid_offset", "alb_offset", "is_het"):
        np.testing.assert_array_equal(npy(trows[k]), npy(jrows[k]))
    if fn == "trilinear":
        got = tmed._trilinear_v(tm.density_atlas, trows["grid_offset"],
                                trows["grid_res"], trows["w2g"], tv3(p),
                                vec_out=False)
        want = jmed._trilinear_v(jm.density_atlas, jrows["grid_offset"],
                                 jrows["grid_res"], jrows["w2g"], jv3(p),
                                 vec_out=False)
        got, want = [got], [want]
    elif fn == "sigma_t":
        got = [tmed.sigma_t_at_v(tm, trows, tv3(p))]
        want = [jmed.sigma_t_at_v(jm, jrows, jv3(p))]
    elif fn == "albedo":
        got = tmed.albedo_at_v(tm, trows, tv3(p))
        want = jmed.albedo_at_v(jm, jrows, jv3(p))
    else:
        got = tmed.orientation_at_v(tm, tmid, tv3(p))
        want = jmed.orientation_at_v(jm, jmid, jv3(p))
    for a, b in zip(got, want):
        close(a, b, rtol=1e-6, atol=1e-6)
    # lanes inside a grid: a value other than the outside one (0; the
    # orientation's +z fallback)
    inside = (npy(got[2]) != 1.0 if fn == "orientation"
              else npy(got[0]) != 0.0)
    assert 0.1 < inside.mean() < 0.95


@pytest.mark.parametrize("loop", ["distance", "transmittance",
                                  "distance_to_cap", "transmittance_to_cap"])
def test_tracking_matches_reference(loop):
    """``*_to_cap``: a tenth of the lanes have no surface ahead (t_max or
    dist 1e30); those that leave the grid unscattered (delta tracking) or
    with some transmittance left (ratio tracking, opaque at the cap) hold
    the reference's loop to MAX_TRACK_STEPS, which the port reaches by
    skipping the iterations of lanes beyond reach."""
    recs = _grid_records()
    jm, tm = jmed.build_media(recs), tmed.build_media(recs, "cpu")
    r = _rng(5)
    to_cap = loop.endswith("_to_cap")
    n = 512 if to_cap else N
    o = _points(r, n) * 0.8
    d = unit_vectors(r, n)
    t_max = r.uniform(0.05, 1.5, n).astype(np.float32)
    if to_cap:
        t_max[r.random(n) < 0.1] = 1e30
    active = r.random(n) < 0.8
    mid = np.where(r.random(n) < 0.7, 1, 2).astype(np.int32)
    mid[r.random(n) < 0.1] = 0  # homogeneous lanes do not track
    jrows = jmed.hetero_rows_v(jm, jnp.asarray(mid))
    trows = tmed.hetero_rows_v(tm, torch.from_numpy(mid))
    pix = np.arange(n)
    js = jrng.make_sampler_v(jnp.asarray(pix, jnp.uint32), 0, 5)
    ts = trng.make_sampler_v(torch.from_numpy(pix), 0, 5)
    tmed.reset_track_stats()
    if loop.startswith("distance"):
        js, jt, jsc = jmed.track_distance_v(
            jm, jrows, jv3(o), jv3(d), jnp.asarray(t_max), js,
            jnp.asarray(active))
        ts, tt, tsc = tmed.track_distance_v(
            tm, trows, tv3(o), tv3(d), torch.from_numpy(t_max), ts,
            torch.from_numpy(active))
        np.testing.assert_array_equal(npy(tsc), npy(jsc))
        assert 0.05 < npy(tsc).mean() < 0.95
    else:
        js, jt = jmed.track_transmittance_v(
            jm, jrows, jv3(o), jv3(d), jnp.asarray(t_max), js,
            jnp.asarray(active))
        ts, tt = tmed.track_transmittance_v(
            tm, trows, tv3(o), tv3(d), torch.from_numpy(t_max), ts,
            torch.from_numpy(active))
        assert 0.05 < (npy(tt) < 1).mean() < 0.95
    np.testing.assert_array_equal(npy(ts.dim).astype(np.uint64),
                                  npy(js.dim).astype(np.uint64))
    iters = tmed.TRACK_STATS["iterations"]
    assert iters == int(npy(ts.dim)[0]) // 4 > 2
    if loop == "distance_to_cap":
        # the stuck lanes' t stays where the port stopped tracking them
        stuck = (t_max == np.float32(1e30)) & ~npy(tsc) & active & (mid > 0)
        assert stuck.any() and iters == tmed.MAX_TRACK_STEPS
        assert tmed.TRACK_STATS["executed"] < 100
        close(npy(tt)[~stuck], npy(jt)[~stuck], rtol=1e-5, atol=1e-6)
    elif loop == "transmittance_to_cap":
        # the lanes live at the cap are opaque in both
        assert iters == tmed.MAX_TRACK_STEPS
        assert tmed.TRACK_STATS["executed"] < 100
        assert ((t_max == np.float32(1e30)) & (npy(tt) == 0)).any()
        close(tt, jt, rtol=1e-5, atol=1e-6)
    else:
        close(tt, jt, rtol=1e-5, atol=1e-6)
        assert tmed.TRACK_STATS["executed"] == iters
        # a live.any() a loop test, and one a beyond-reach check (at the
        # iterations 4, 8, 16, ... that the loop reaches)
        checks = sum(1 for k in range(2, 12) if 2 ** k < iters)
        assert tmed.TRACK_STATS["syncs"] == iters + 1 + checks


def _wiwo(seed, n=N):
    r = _rng(seed)
    return unit_vectors(r, n), unit_vectors(r, n), r


@pytest.mark.parametrize("ptype", [jmed.PH_ISOTROPIC, jmed.PH_HG,
                                   jmed.PH_RAYLEIGH])
def test_simple_phases_match_reference(ptype):
    wi, wo, r = _wiwo(6 + ptype)
    g = r.uniform(-0.9, 0.9, N).astype(np.float32)
    g[:64] = 0.0  # the HG isotropic limit
    pt = np.full(N, ptype, np.int32)
    jpt, tpt = jnp.asarray(pt), torch.from_numpy(pt)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    close(tmed.phase_eval_v(tpt, tg, tv3(wi), tv3(wo)),
          jmed.phase_eval_v(jpt, jg, jv3(wi), jv3(wo)))
    u = r.random((2, N)).astype(np.float32)
    two, tpdf = tmed.phase_sample_v(tpt, tg, tv3(wi), *map(torch.from_numpy,
                                                          u))
    jwo, jpdf = jmed.phase_sample_v(jpt, jg, jv3(wi), *map(jnp.asarray, u))
    wtol = 2e-5 if ptype == jmed.PH_RAYLEIGH else 1e-6
    for a, b in zip(two, jwo):
        close(a, b, rtol=1e-5, atol=wtol)
    close(tpdf, jpdf, rtol=1e-4 if ptype == jmed.PH_RAYLEIGH else 1e-5)


def _fancy_media(phase, axis=(0.6, -0.3, 0.74)):
    """One grid medium (constant density) with the phase record ``phase``
    and a constant orientation grid along ``axis``."""
    big = 1e3
    ax = np.asarray(axis, np.float32) / np.linalg.norm(axis)
    rec = dict(kind="heterogeneous", scale=1.0, phase=phase,
               density=dict(data=np.ones((2, 2, 2, 1), np.float32),
                            bmin=np.full(3, -big), bmax=np.full(3, big)),
               albedo=None,
               orientation=dict(data=np.tile(ax, (2, 2, 2, 1)),
                                bmin=np.full(3, -big), bmax=np.full(3, big)))
    return jmed.build_media([rec]), tmed.build_media([rec], "cpu"), ax


def _ctxs(jm, tm, n):
    z = np.zeros((n, 3), np.float32)
    jc = jmed.phase_ctx_v(jm, jnp.zeros((n,), jnp.int32), jv3(z))
    tc = tmed.phase_ctx_v(tm, torch.zeros((n,), dtype=torch.int32), tv3(z))
    return jc, tc


PHASES = {
    "kkay": dict(type=jmed.PH_KKAY, g=0.0, kd=0.2, ks=0.4, exponent=4.0),
    "microflake": dict(type=jmed.PH_MICROFLAKE, g=0.0, stddev=0.3),
    "mixture": dict(type=jmed.PH_MIX, g=0.0, components=[
        (0.6, dict(type=jmed.PH_HG, g=0.7)),
        (0.4, dict(type=jmed.PH_RAYLEIGH, g=0.0))]),
}


@pytest.mark.parametrize("name", ["kkay", "mixture"])
def test_structured_phase_matches_reference(name):
    jm, tm, _ = _fancy_media(PHASES[name])
    wi, wo, r = _wiwo(10)
    jc, tc = _ctxs(jm, tm, N)
    close(tmed.phase_eval_ctx_v(tm, tc, tv3(wi), tv3(wo)),
          jmed.phase_eval_ctx_v(jm, jc, jv3(wi), jv3(wo)))
    close(tmed.phase_pdf_ctx_v(tm, tc, tv3(wi), tv3(wo)),
          jmed.phase_pdf_ctx_v(jm, jc, jv3(wi), jv3(wo)))
    u = r.random((3, N)).astype(np.float32)
    two, tpdf, tw = tmed.phase_sample_ctx_v(tm, tc, tv3(wi),
                                            *map(torch.from_numpy, u))
    jwo, jpdf, jw = jmed.phase_sample_ctx_v(jm, jc, jv3(wi),
                                            *map(jnp.asarray, u))
    for a, b in zip(two, jwo):
        close(a, b, rtol=1e-5, atol=2e-6)
    close(tpdf, jpdf, rtol=1e-4)
    close(tw, jw)


def test_microflake_is_reference_mirrored():
    """port(wi, wo) = reference(wi, -wo), and the port samples -wo_ref."""
    jm, tm, _ = _fancy_media(PHASES["microflake"])
    wi, wo, r = _wiwo(11)
    jc, tc = _ctxs(jm, tm, N)
    close(tmed.phase_eval_ctx_v(tm, tc, tv3(wi), tv3(wo)),
          jmed.phase_eval_ctx_v(jm, jc, jv3(wi), jv3(-wo)))
    close(tmed.phase_pdf_ctx_v(tm, tc, tv3(wi), tv3(wo)),
          jmed.phase_pdf_ctx_v(jm, jc, jv3(wi), jv3(-wo)))
    u = r.random((3, N)).astype(np.float32)
    two, tpdf, tw = tmed.phase_sample_ctx_v(tm, tc, tv3(wi),
                                            *map(torch.from_numpy, u))
    jwo, jpdf, jw = jmed.phase_sample_ctx_v(jm, jc, jv3(wi),
                                            *map(jnp.asarray, u))
    two = np.stack([npy(c) for c in two], 1)
    jwo = np.stack([npy(c) for c in jwo], 1)
    close(two, -jwo, rtol=1e-5, atol=1e-5)
    ok = npy(jpdf) < 1e3  # away from the flakes' grazing poles
    assert ok.mean() > 0.99
    # weight = |wi.h| / sigma(wi): where wi.m is tiny, h = (wi + wo) /
    # |wi + wo| cancels in both packages
    close(npy(tw)[ok], npy(jw)[ok], rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("check", ["mirror_cone", "argmax"])
def test_kkay_lobe_peaks_on_mirror_cone(check):
    """A fibre mirrors the direction of travel -wi about its axis a: the
    Kajiya-Kay lobe is largest, (kd + ks) / norm, on the cone
    wo.a = -wi.a, and smaller on the cone wo.a = wi.a."""
    ph = PHASES["kkay"]
    _, tm, ax = _fancy_media(ph)
    wi, _, _ = _wiwo(13)
    c = wi @ ax
    if check == "mirror_cone":
        tc = _ctxs_port(tm, N)
        mirror = wi - 2.0 * c[:, None] * ax
        back = 2.0 * c[:, None] * ax - wi
        top = npy(tmed.phase_eval_ctx_v(tm, tc, tv3(wi), tv3(mirror)))
        other = npy(tmed.phase_eval_ctx_v(tm, tc, tv3(wi), tv3(back)))
        tab = tmed._kkay_norm_table(ph["kd"], ph["ks"], ph["exponent"])
        np.testing.assert_allclose(
            top, (ph["kd"] + ph["ks"]) / _np_table(tab, c), rtol=1e-4)
        off = np.abs(c) > 0.2
        assert off.mean() > 0.5
        assert (other[off] < 0.99 * top[off]).all()
        return
    dirs, _ = _sphere_quadrature()
    for k in np.flatnonzero(np.abs(c) > 0.3)[:8]:
        n = len(dirs)
        val = npy(tmed.phase_eval_ctx_v(
            tm, _ctxs_port(tm, n), tv3(np.tile(wi[k], (n, 1))), tv3(dirs)))
        assert float(dirs[np.argmax(val)] @ ax) == pytest.approx(-c[k],
                                                                 abs=0.02)


def _np_table(tab, c):
    cc = np.clip(np.abs(c), 0, 1) * (tmed.PHASE_TAB - 1)
    j0 = np.minimum(np.floor(cc).astype(int), tmed.PHASE_TAB - 2)
    f = cc - j0
    return tab[j0] + (tab[j0 + 1] - tab[j0]) * f


@pytest.mark.parametrize("name", ["kkay", "microflake"])
def test_structured_phase_formula(name):
    """Eval and pdf against a float64 numpy transcription: Kajiya-Kay
    (kd + ks max(cos(theta_i - theta_o), 0)^e) / norm(|wi.a|) with
    cos(theta_i) = -wi.a; microflake D(h) / (2 sigma(|wi.a|)) and
    D(h) / (2 |wi.h|) with h = (wi + wo) / |wi + wo|."""
    ph = PHASES[name]
    _, tm, ax = _fancy_media(ph)
    wi, wo, _ = _wiwo(12)
    tc = _ctxs_port(tm, N)
    val = npy(tmed.phase_eval_ctx_v(tm, tc, tv3(wi), tv3(wo)))
    pdf = npy(tmed.phase_pdf_ctx_v(tm, tc, tv3(wi), tv3(wo)))
    wi64, wo64, a = wi.astype(np.float64), wo.astype(np.float64), \
        ax.astype(np.float64)
    ci, co = wi64 @ a, wo64 @ a
    if name == "kkay":
        ci = -ci  # the direction of travel's angle to the fibre
        tab = tmed._kkay_norm_table(ph["kd"], ph["ks"], ph["exponent"])
        si = np.sqrt(np.maximum(1 - ci * ci, 0))
        so = np.sqrt(np.maximum(1 - co * co, 0))
        spec = np.maximum(ci * co + si * so, 0.0)
        want = (ph["kd"] + ph["ks"] * spec ** ph["exponent"]) / _np_table(
            tab, ci)
        want_pdf = np.full(N, 1.0 / (4 * np.pi))
    else:
        tab = tmed._flake_sigma_table(ph["stddev"])
        c = tmed._flake_norm_const(ph["stddev"])
        h = wi64 + wo64
        h /= np.linalg.norm(h, axis=1, keepdims=True)
        D = c * np.exp(-(h @ a) ** 2 / (2 * ph["stddev"] ** 2))
        want = D / (2 * _np_table(tab, ci))
        want_pdf = D / (2 * np.abs((wi64 * h).sum(1)))
    np.testing.assert_allclose(val, want, rtol=1e-4, atol=1e-7)
    ok = want_pdf < 1e4  # wi + wo near 0: h is ill-conditioned
    np.testing.assert_allclose(pdf[ok], want_pdf[ok], rtol=1e-4, atol=1e-7)


def _ctxs_port(tm, n):
    z = np.zeros((n, 3), np.float32)
    return tmed.phase_ctx_v(tm, torch.zeros((n,), dtype=torch.int32), tv3(z))


def _sphere_quadrature(n_theta=256, n_phi=128):
    t, wt = np.polynomial.legendre.leggauss(n_theta)
    phi = (np.arange(n_phi) + 0.5) * (2 * np.pi / n_phi)
    st = np.sqrt(np.maximum(1 - t * t, 0))
    dirs = np.stack([np.repeat(st, n_phi) * np.cos(np.tile(phi, n_theta)),
                     np.repeat(st, n_phi) * np.sin(np.tile(phi, n_theta)),
                     np.repeat(t, n_phi)], -1)
    return dirs.astype(np.float32), np.repeat(wt, n_phi) * (2 * np.pi / n_phi)


@pytest.mark.parametrize("name", list(PHASES))
@pytest.mark.parametrize("check", ["normalized", "chi2", "weight"])
def test_structured_phase_sampling(name, check):
    """Eval integrates to 1 over the sphere, samples follow the pdf (chi^2
    as tests/test_phase.py runs it), E[weight] = 1."""
    _, tm, _ = _fancy_media(PHASES[name])
    wi_np = np.array([0.1, 0.4, -0.91])
    wi_np /= np.linalg.norm(wi_np)

    def wi_of(n):
        return tv3(np.tile(wi_np.astype(np.float32), (n, 1)))

    if check == "normalized":
        dirs, w = _sphere_quadrature()
        val = npy(tmed.phase_eval_ctx_v(tm, _ctxs_port(tm, len(dirs)),
                                        wi_of(len(dirs)), tv3(dirs)))
        assert float((val * w).sum()) == pytest.approx(1.0, abs=0.01)
        return

    def sample(n):
        s = trng.make_sampler_v(torch.arange(n), 0, 31)
        _, blk = trng.next_block4_v(s)
        return tmed.phase_sample_ctx_v(tm, _ctxs_port(tm, n), wi_of(n),
                                       blk[0], blk[1], blk[2])

    if check == "weight":
        _, _, wgt = sample(1 << 16)
        assert float(wgt.mean()) == pytest.approx(1.0, abs=0.02)
        return

    def sample_fn(n):
        wo = sample(n)[0]
        return np.stack([npy(c) for c in wo], -1)

    def pdf_fn(dirs):
        n = len(dirs)
        return npy(tmed.phase_pdf_ctx_v(tm, _ctxs_port(tm, n), wi_of(n),
                                        tv3(dirs.astype(np.float32))))

    ok, _, info = chi2_test(sample_fn, pdf_fn, n_samples=1 << 16,
                            sub=32 if name == "microflake" else 4)
    assert ok, f"{name}: {info}"
