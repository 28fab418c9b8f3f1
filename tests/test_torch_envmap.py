"""Port vs reference: the environment map emitter (``EM_ENVMAP``), its
alias-table ``Distribution2D``, the Hosek-Wilkie sky bake and the bridge of
their tables (``mitsuba_im_tpu_torch/core/distribution.py``,
``emitter/table.py``, ``emitter/hosek.py``, ``scene/bridge.py``).

The alias tables, the sampled cells and every bridged leaf are held bit for
bit.  Float outputs are held to test_torch_helpers' rel 1e-5 / abs 1e-6,
except where a case states its own: directions from (u, v) go through sin
and cos, whose last bits differ between XLA and PyTorch on the CPU.
"""
import dataclasses
import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (bridged, close, close_v3, jv3, npy, tv3,
                                unit_vectors)

from mitsuba_im_tpu.accel.native import load_native
from mitsuba_im_tpu.core.distribution import Distribution2D as JDist
from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.emitter import _sky_record as j_sky_record
from mitsuba_im_tpu.emitter import hosek as jhosek
from mitsuba_im_tpu.emitter import table as jem
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.core.distribution import Distribution2D
from mitsuba_im_tpu_torch.core.v3 import V3
from mitsuba_im_tpu_torch.emitter import hosek as thosek
from mitsuba_im_tpu_torch.emitter import table as tem
from mitsuba_im_tpu_torch.scene import bridge
from mitsuba_im_tpu_torch.scene.build import SceneBuilder
from mitsuba_im_tpu_torch.scene.mesh import TriMesh

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N = 1 << 16


def _synthetic_map(h=16, w=32, seed=80):
    """A lat-long map with a bright spot, a dark band and texel noise."""
    rng = np.random.default_rng(seed)
    pix = rng.random((h, w, 3)).astype(np.float32) * 0.5
    pix[h // 4, w // 3] = [40.0, 30.0, 20.0]
    pix[h // 2:h // 2 + 2] *= 0.01
    return pix


def _weights(pix):
    """build_emitters' sampling weights (luminance x sin(theta))."""
    H = pix.shape[0]
    lum = (pix[..., 0] * 0.212671 + pix[..., 1] * 0.715160
           + pix[..., 2] * 0.072169)
    sin_t = np.sin((np.arange(H) + 0.5) / H * np.pi)[:, None]
    return (lum * sin_t + 1e-12).astype(np.float32)


def _sun():
    return np.asarray(scenes.SUN_DIR)


@pytest.fixture(scope="module")
def maps():
    """{name: the reference's pixels}: the synthetic map and the reference's
    own Hosek sky at resolution 64."""
    return {"synthetic": _synthetic_map(),
            "hosek64": jhosek.hosek_sky_pixels(64, _sun())}


@pytest.mark.parametrize("which", ["synthetic", "hosek64"])
def test_alias_tables_bit_for_bit(maps, which):
    """Distribution2D tables from the same weights equal the reference's,
    which used its native builder (not its Python fallback)."""
    lib = load_native()
    assert lib is not None and hasattr(lib, "mitpu_build_alias_rows")
    w = _weights(maps[which])
    ref = JDist.from_weights(jnp.asarray(w))
    got = Distribution2D.arrays_from_weights(w)
    for k, a in got.items():
        b = np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("which", ["synthetic", "hosek64"])
def test_sample_and_pdf_continuous(maps, which):
    """Sampled cells equal the reference's exactly, (u, v) and the pdf to
    float32 tolerance; pdf_continuous at the samples equals their pdf."""
    rng = np.random.default_rng(81)
    w = _weights(maps[which])
    jd = JDist.from_weights(jnp.asarray(w))
    td = Distribution2D.from_arrays(Distribution2D.arrays_from_weights(w),
                                    "cpu")
    H, W = w.shape
    s = rng.random((N, 2), dtype=np.float32)
    s[:64] = [[0.0, 0.0], [1.0, 1.0]] * 32  # the ends of the unit square
    juv, jpdf = jd.sample_continuous(jnp.asarray(s))
    uu, vv, pdf = td.sample_continuous(*(torch.from_numpy(s[:, k].copy())
                                         for k in range(2)))
    juv = np.asarray(juv)
    for k, (a, n) in enumerate(((uu, W), (vv, H))):
        np.testing.assert_array_equal(np.floor(npy(a) * n),
                                      np.floor(juv[:, k] * n))
        close(a, juv[:, k])
    close(pdf, jpdf)
    close(td.pdf_continuous(uu, vv), pdf)
    q = rng.random((2, N), dtype=np.float32)
    close(td.pdf_continuous(*(torch.from_numpy(a) for a in q)),
          jd.pdf_continuous(jnp.asarray(q.T)))
    # the samples follow the table: the bright texel's share
    bright = (np.floor(npy(vv) * H) == H // 4) & (np.floor(npy(uu) * W)
                                                 == W // 3)
    if which == "synthetic":
        p = float(npy(td.marg_pmf)[H // 4] * npy(td.cond_pmf)[H // 4, W // 3])
        assert abs(bright.mean() - p) < 5 * np.sqrt(p / N)


def _jax_env_scene(pixels, rot=None, weight=1.5, scale=2.0):
    """An area light and a map (rotated by ``rot``) on a small quad scene."""
    b = JBuilder()
    quad = TriMesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                            float), np.array([[0, 2, 1], [0, 3, 2]]))
    b.add_trimesh(quad, b.new_shape(b.add_bsdf(
        __import__("mitsuba_im_tpu.bsdf.common",
                   fromlist=["x"]).default_record())))
    light = TriMesh(np.array([[-.2, 1, -.2], [.2, 1, -.2], [.2, 1, .2],
                              [-.2, 1, .2]], float),
                    np.array([[0, 1, 2], [0, 2, 3]]))
    lsid = b.new_shape(0)
    b.add_trimesh(light, lsid)
    b.add_emitter(dict(type=jem.EM_AREA, radiance=np.full(3, 5.0),
                       shape=lsid))
    b.shape_emitter[lsid] = 0
    b.add_emitter(tem.envmap_record(pixels, scale, rot, weight))
    return b.build()[0]


def _rotation():
    a = np.radians(40.0)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    ry = np.array([[np.cos(1.1), 0, np.sin(1.1)], [0, 1, 0],
                   [-np.sin(1.1), 0, np.cos(1.1)]])
    return ry @ rz


@pytest.mark.parametrize("rotated", [False, True])
def test_env_queries_match_reference(maps, rotated):
    """eval_environment_v, env_pdf_sa_v, pdf_direct_env_v and
    sample_direct_v's map arm (beside the area light) on random
    directions, the seam (u -> 0 and 1) and the poles included."""
    rng = np.random.default_rng(82)
    rot = _rotation() if rotated else None
    jscene = _jax_env_scene(maps["synthetic"], rot)
    tscene = bridged(jscene)
    je, te = jscene.emitters, tscene.emitters
    assert te.env_is_map and te.env_index == je.env_index == 1
    assert te.used_types == (tem.EM_AREA, tem.EM_ENVMAP)

    d = unit_vectors(rng, 4096)
    # the seam in the map's frame: x = +-0, z < 0 (u = 0.5 +- 0 ... and the
    # wrap at u -> 1: x -> 0-, z > 0); the poles
    local = np.array([[1e-7, 0.3, 0.9], [-1e-7, 0.3, 0.9], [0.0, 0.2, 0.9],
                      [1e-7, -0.5, -0.8], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                      [1e-4, 0.99999, 0.0], [-2e-4, -0.9999, 1e-4]])
    local /= np.linalg.norm(local, axis=1, keepdims=True)
    d[:len(local)] = local @ (np.eye(3) if rot is None else rot).T
    # the bilinear lookup scales the last bits of atan2 and acos by W (H)
    # times the texel contrast (a 40x spot): rel 1e-4
    close_v3(tem.eval_environment_v(te, tv3(d)),
             jem.eval_environment_v(je, jv3(d)), rtol=1e-4)
    close(tem.env_pdf_sa_v(te, tv3(d)), jem.env_pdf_sa_v(je, jv3(d)))
    close(tem.pdf_direct_env_v(te, tv3(d)), jem.pdf_direct_env_v(je, jv3(d)))

    ref = rng.uniform(-0.3, 0.3, (4096, 3)).astype(np.float32)
    ref[:, 1] = 0.5
    u = rng.random((3, 4096), dtype=np.float32)
    js = jem.sample_direct_v(je, jscene.geom, jv3(ref),
                             *(jnp.asarray(a) for a in u))
    ts = tem.sample_direct_v(te, tscene.geom, tv3(ref),
                             *(torch.from_numpy(a) for a in u))
    np.testing.assert_array_equal(npy(ts.emitter), npy(js.emitter))
    np.testing.assert_array_equal(npy(ts.delta), npy(js.delta))
    assert set(np.unique(npy(ts.emitter))) == {0, 1}
    # directions from (u, v) through sin/cos: a few ulps
    for k in ("d", "n"):
        close_v3(getattr(ts, k), getattr(js, k), atol=4e-6)
    close_v3(ts.value, js.value)
    close(ts.dist, js.dist)
    close(ts.pdf, js.pdf)
    # a map sample's pdf is the pdf of its direction (but where the round
    # trip u -> direction -> u crosses a texel edge)
    env = npy(ts.emitter) == 1
    back = npy(tem.pdf_direct_env_v(te, ts.d))[env]
    assert (np.abs(back / npy(ts.pdf)[env] - 1) < 1e-4).mean() > 0.99


@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled")
def test_env_gradient_has_no_nan_at_the_poles(maps):
    """Directions on the map's pole axis (atan2(0, 0), acos(+-1)) whose
    result is masked send no NaN backward; live lanes get the reference's
    derivative (finite differences of eval_environment_v)."""
    jscene = _jax_env_scene(maps["hosek64"])
    te = bridged(jscene).emitters
    d = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.3, 0.5, 0.81],
                  [0.0, 0.0, 0.0]], np.float32)
    d[2] /= np.linalg.norm(d[2])
    dt = torch.from_numpy(d).requires_grad_(True)
    rad = te.radiance.clone().requires_grad_(True)
    with torch.autograd.detect_anomaly():
        val = tem.eval_environment_v(dataclasses.replace(te, radiance=rad),
                                     V3(*dt.unbind(1)))
        live = torch.tensor([False, False, True, False])
        torch.where(live, val.x + val.y + val.z, 0.0).sum().backward()
    g = npy(dt.grad)
    assert np.isfinite(g).all() and np.isfinite(npy(rad.grad)).all()
    assert (g[[0, 1, 3]] == 0).all() and np.abs(g[2]).max() > 0
    eps = 1e-3
    for k in range(3):
        e = np.zeros((1, 3), np.float32)
        e[0, k] = eps
        f = [float(tem.eval_environment_v(te, tv3(d[2:3] + s * e)).sum()
                   [0]) for s in (1, -1)]
        assert g[2, k] == pytest.approx((f[0] - f[1]) / (2 * eps), rel=0.05,
                                        abs=1e-2)


def test_hosek_sky_matches_reference():
    """The blended coefficients equal the reference's; the pixels agree to
    float32 tolerance (the XYZ-to-RGB product is XLA's matrix product in
    the reference, numpy's here: last bits); the sky records agree."""
    sun = _sun()
    elev = float(np.arcsin(sun[1]))
    for a, b in zip(thosek.hosek_coeffs(3.0, 0.15, elev),
                    jhosek.hosek_coeffs(3.0, 0.15, elev)):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(resolution=64), dict(resolution=32, turbidity=7.5,
                                         albedo=0.6, extend=False,
                                         scale=2.0)):
        got = thosek.hosek_sky_pixels(sun_dir=sun, **kw)
        want = jhosek.hosek_sky_pixels(sun_dir=sun, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert (got > 0).any() and np.isfinite(got).all()
    props = Properties("sky")
    props.set("sunDirection", list(sun))
    props.set("resolution", 64)
    ref = j_sky_record(props)
    rec = thosek.sky_record(sun, resolution=64)
    for k in ("type", "radiance", "to_world_rot", "weight"):
        np.testing.assert_array_equal(np.asarray(rec[k]), np.asarray(ref[k]))
    np.testing.assert_allclose(rec["pixels"], ref["pixels"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["hosek_sky.npz", "rtrans.npz"])
def test_data_files_are_copies(name):
    assert filecmp.cmp(REPO / "mitsuba_im_tpu" / "data" / name,
                       REPO / "mitsuba_im_tpu_torch" / "data" / name,
                       shallow=False)


def test_bridge_round_trip_and_port_build(maps):
    """Every exported leaf of a scene with a rotated map round-trips bit for
    bit; the port's own build of the same records equals the bridged
    reference leaf for leaf (the alias tables included)."""
    rot = _rotation()
    jscene = _jax_env_scene(maps["synthetic"], rot)
    arrays, statics = bridge.export_tables(jscene)
    tscene = bridge.scene_from_numpy(arrays, statics, "cpu")
    env_keys = [k for k in arrays if k.startswith("emitters.env_")]
    assert len(env_keys) == 9
    for key, a in arrays.items():
        part, leaf = key.split(".")
        obj = tscene if part == "scene" else getattr(tscene, part)
        t = getattr(obj, leaf, None)
        if t is None:  # the texture columns only decide ``textured``
            assert part == "bsdfs"
            continue
        assert t.shape == a.shape, key
        np.testing.assert_array_equal(npy(t), a, err_msg=key)

    from mitsuba_im_tpu.bsdf import common as jbc
    b = SceneBuilder()
    quad = TriMesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                            float), np.array([[0, 2, 1], [0, 3, 2]]))
    b.add_trimesh(quad, b.new_shape(b.add_bsdf(jbc.default_record())))
    light = TriMesh(np.array([[-.2, 1, -.2], [.2, 1, -.2], [.2, 1, .2],
                              [-.2, 1, .2]], float),
                    np.array([[0, 1, 2], [0, 2, 3]]))
    lsid = b.new_shape(0)
    b.add_trimesh(light, lsid)
    b.add_emitter(dict(type=tem.EM_AREA, radiance=np.full(3, 5.0),
                       shape=lsid))
    b.shape_emitter[lsid] = 0
    b.add_emitter(tem.envmap_record(maps["synthetic"], 2.0, rot, 1.5))
    port = b.build("cpu")[0].emitters
    for f in dataclasses.fields(port):
        a, c = getattr(port, f.name), getattr(tscene.emitters, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == c.dtype and torch.equal(a, c), f.name
        else:
            assert a == c, f.name
