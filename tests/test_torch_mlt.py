"""Port vs reference: Veach-style MLT and the specular manifold walk
(``mitsuba_im_tpu_torch/integrators/mlt.py``, ``bidir/manifold.py``,
``core/v3.py::uniform_disk_concentric_to_square``), on the CPU.

- The concentric inverse round-trips through the port's warp (1e-5 away
  from the wedges' edges and the centre), directions through the diffuse
  sample of both halves of the two-sided flip; the reference's polar
  inverse does not (ROADMAP C3).
- The manifold functions on seeded chains within rel 1e-4 of the
  reference's; ``manifold_walk`` on ``tests/test_manifold.py``'s three
  chains (the same ``converged``, positions within 1e-4); a singular
  lane comes out non-finite without raising; the re-projection's
  ``Scene.point_normal_v`` is the interaction record's point and normal
  bit for bit.
- ``mlt_step_tables`` without the manifold, both layouts and with media
  blocks: the mixture's picks and ``is_large`` equal, every kept block
  equal, the lens step within 2 ulp, the small step's blocks within 1e-6
  on the circle [0, 1) (``_mutate_small``'s exp, as in
  ``tests/test_torch_mcmc.py``).
- ``_manifold_tables`` on ``scenes.fill_caustic_cornell`` (1,024 chains,
  depth 4, the patterns (0, 1) and (0, 2); the card holds (2, 1) at depth
  5 against the CPU, ``chip_smoke.py`` phase 57; the reference jitted: its
  eye walk is ``random_walk``, not the bidirectional sampler): the
  pattern masks equal, ``moved`` alike on at
  least 99% of the lanes, ``corr`` within rel 1e-3 where both moved; the
  edit is the port's concentric inverse, the replay of a moved lane
  reaches the solved first specular vertex within a tenth of the step
  (the reference's polar edit misses by far more, C3), and a subset of
  the lanes gives the full batch's values on them within rel 1e-6.
- One ``mlt_run`` step with ``p_manifold`` 0 on the 16^2 Cornell box at
  256 chains, depth 2, the unidirectional replay, against the reference
  (jitted), at pssmlt's step tolerance.

The reference's functions here run jitted (one compile each): none of
them goes through the bidirectional sampler, whose eager primitives
would take the file past its minute.
- The ``mlt`` factory's properties are the reference's; the pattern
  shares ``scenes.caustic_cornell`` states.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, jax_shapes_scene, npy
from test_manifold import _plane_scene
from test_torch_adaptive import _scene_file

from mitsuba_im_tpu.bidir import manifold as jmf
from mitsuba_im_tpu.integrators import mlt as jmlt
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch import scenes
from mitsuba_im_tpu_torch.bidir import manifold as tmf
from mitsuba_im_tpu_torch.bsdf import common as tbc
from mitsuba_im_tpu_torch.bsdf.eval import bsdf_sample_v
from mitsuba_im_tpu_torch.core import v3
from mitsuba_im_tpu_torch.integrators import mlt as tmlt
from mitsuba_im_tpu_torch.integrators import pssmlt as tps
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
SEED = 11


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _j(x) -> jnp.ndarray:
    return jnp.asarray(npy(x))


# ---------------------------------------------------------------------------
# the concentric inverse (ROADMAP C3)
# ---------------------------------------------------------------------------

def _off_edges(u1, u2, margin=1e-3):
    """Lanes away from the forward map's wedge edges (|r1| = |r2|) and its
    centre, where the inverse's atan and the tie rule are ill-conditioned."""
    r1, r2 = 2 * u1 - 1, 2 * u2 - 1
    return (np.abs(np.abs(r1) - np.abs(r2)) > margin) & \
        (np.maximum(np.abs(r1), np.abs(r2)) > margin)


def test_concentric_inverse_round_trip():
    """u -> warp -> inverse -> u, and the ties and the centre stay in
    [0, 1) and map back to their disk points."""
    rng = np.random.default_rng(1)
    u = rng.random((2, 1 << 16), dtype=np.float32)
    keep = _off_edges(*u)
    x, y = v3.square_to_uniform_disk_concentric(_t(u[0]), _t(u[1]))
    b1, b2 = v3.uniform_disk_concentric_to_square(x, y)
    assert keep.mean() > 0.99
    np.testing.assert_allclose(npy(b1)[keep], u[0][keep], atol=1e-5)
    np.testing.assert_allclose(npy(b2)[keep], u[1][keep], atol=1e-5)
    edge = np.array([[0.5, 0.5], [0.0, 0.0], [0.75, 0.25], [1 - 2 ** -24,
                     1 - 2 ** -24], [0.25, 0.75]], np.float32).T
    ex, ey = v3.square_to_uniform_disk_concentric(_t(edge[0]), _t(edge[1]))
    e1, e2 = v3.uniform_disk_concentric_to_square(ex, ey)
    assert ((npy(e1) >= 0) & (npy(e1) < 1) & (npy(e2) >= 0)
            & (npy(e2) < 1)).all()
    fx, fy = v3.square_to_uniform_disk_concentric(e1, e2)
    np.testing.assert_allclose(npy(fx), npy(ex), atol=1e-5)
    np.testing.assert_allclose(npy(fy), npy(ey), atol=1e-5)


@pytest.mark.parametrize("back_face", [False, True])
def test_concentric_inverse_replays_diffuse_sample(back_face):
    """A direction of a diffuse lane's sampled hemisphere -> the inverse of
    its local x, y -> ``bsdf_sample_v`` -> the direction, on a front face
    and on the back face of a two-sided record (``_maybe_flip``'s
    mirrored hemisphere)."""
    rng = np.random.default_rng(2 + back_face)
    n = 4096
    rec = tbc.diffuse_record(0.5)
    rec["flags"] = tbc.FLAG_TWOSIDED
    p = tbc.resolve_v(tbc.build_table([rec], "cpu"), None,
                      torch.zeros(n, dtype=torch.int32))
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi[:, 2] = np.abs(wi[:, 2]) * (-1 if back_face else 1)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo[:, 2] = np.maximum(np.abs(wo[:, 2]), 0.05) * (-1 if back_face else 1)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u1, u2 = v3.uniform_disk_concentric_to_square(_t(wo[:, 0]), _t(wo[:, 1]))
    keep = _off_edges(npy(u1), npy(u2))
    bs = bsdf_sample_v(p, v3.V3(*(_t(wi[:, k]) for k in range(3))),
                       torch.full((n,), 0.5), u1, u2)
    got = np.stack([npy(c) for c in bs.wo], -1)
    np.testing.assert_allclose(got[keep], wo[keep], atol=1e-5)


def test_polar_inverse_misses_c3():
    """The reference's write-back (``mitsuba_im_tpu/integrators/mlt.py:
    259-261``: u1 = x^2 + y^2, u2 = atan2(y, x) / 2 pi) replayed through
    the concentric warp does not give the direction back."""
    rng = np.random.default_rng(4)
    u = rng.random((2, 4096), dtype=np.float32)
    x, y = (npy(c) for c in v3.square_to_uniform_disk_concentric(
        _t(u[0]), _t(u[1])))
    ph = np.arctan2(y, x) / (2 * np.pi)
    p1 = np.clip(x * x + y * y, 0.0, 0.999999).astype(np.float32)
    p2 = (ph - np.floor(ph)).astype(np.float32)
    rx, ry = (npy(c) for c in v3.square_to_uniform_disk_concentric(
        _t(p1), _t(p2)))
    miss = np.hypot(rx - x, ry - y)
    assert np.median(miss) > 0.1 and (miss > 1e-3).mean() > 0.95


# ---------------------------------------------------------------------------
# the manifold functions
# ---------------------------------------------------------------------------

def _chains(rng, B, K):
    """Seeded chains near a specular configuration: K vertices on
    alternating sheets (y = 0 facing up, y = 2 facing down, the normals
    tilted by ~0.1 rad) between a start and a target at y ~ 1, relative
    indices 1 (mirror) or 1.5 / (1 / 1.5)."""
    start = rng.normal([-1.0, 1.0, 0.0], 0.2, (B, 3))
    target = rng.normal([1.4, 1.0, 0.2], 0.2, (B, 3))
    pos = rng.normal(0, 0.3, (B, K, 3))
    pos[..., 0] += np.linspace(-0.4, 0.6, K)
    pos[..., 1] = rng.normal(0, 0.05, (B, K)) + 2.0 * (np.arange(K) % 2)
    up = np.where(np.arange(K) % 2 == 0, 1.0, -1.0)[:, None]
    nrm = rng.normal(0, 0.1, (B, K, 3)) + up * np.array([0.0, 1.0, 0.0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    eta = rng.choice([1.0, 1.5, 1 / 1.5], (B, K))
    return tuple(a.astype(np.float32) for a in (start, pos, target, nrm,
                                                eta))


def _lane_rel(a, b):
    """Each lane's largest difference over its largest reference value
    (the normwise relative error of a lane's vector or matrix)."""
    a, b = npy(a), npy(b)
    ax = tuple(range(1, b.ndim))
    return np.abs(a - b).max(axis=ax) / np.abs(b).max(axis=ax)


FUNCTIONS = ("tangent_frame", "chain_constraints", "newton_step",
             "map_jacobian", "map_det")


def _ref_functions(start, pos, target, nrm, eta, tf):
    """The reference's five functions over the lanes, in one jitted call."""
    lanes = (0,) * 5
    return dict(
        tangent_frame=jmf._tangent_frame(nrm[:, 0]),
        chain_constraints=(jax.vmap(jmf.chain_constraints)(
            start, pos, target, nrm, eta),),
        newton_step=jax.vmap(jmf._newton_step, in_axes=lanes + (None,))(
            start, pos, target, nrm, eta, 0.0),
        map_jacobian=jax.vmap(jmf.manifold_map_jacobian,
                              in_axes=lanes + ((0, 0),))(
            start, pos, target, nrm, eta, tf),
        map_det=(jax.vmap(jmf.manifold_map_det, in_axes=lanes + ((0, 0),))(
            start, pos, target, nrm, eta, tf),))


@pytest.fixture(scope="module")
def functions():
    """{K: (the port's five results, the reference's)} on seeded chains."""
    out = {}
    for K in (1, 2):
        args = _chains(np.random.default_rng(10 + K), 256, K)
        targs = [_t(a) for a in args]
        tf = tmf._tangent_frame(_t(args[3][:, 0]))
        got = dict(
            tangent_frame=tf,
            chain_constraints=(tmf.chain_constraints(*targs),),
            newton_step=tmf._newton_step(*targs, 0.0),
            map_jacobian=tmf.manifold_map_jacobian(*targs, target_frame=tf),
            map_det=(tmf.manifold_map_det(*targs, tf),))
        ref = jax.jit(_ref_functions)(*(jnp.asarray(a) for a in args),
                                      tuple(_j(x) for x in tf))
        out[K] = got, ref
    return out


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("K", [1, 2])
def test_manifold_functions_match_reference(functions, fn, K):
    """Each lane within rel 1e-4 of the reference's (normwise)."""
    got, ref = (r[fn] for r in functions[K])
    for g, r in zip(got, ref):
        assert npy(g).shape == npy(r).shape
        assert np.isfinite(npy(r)).all()
        if npy(r).ndim == 1:
            rel = np.abs(npy(g) - npy(r)) / np.abs(npy(r))
        else:
            rel = _lane_rel(g, r)
        assert rel.max() < 1e-4, fn


def _two_mirrors():
    b = _plane_scene(y=0.0, ny=1.0)
    from mitsuba_im_tpu.scene.mesh import TriMesh
    sid = b.new_shape(b.default_bsdf())
    half = 50.0
    m = TriMesh(np.array([[-half, 2.0, -half], [half, 2.0, -half],
                          [half, 2.0, half], [-half, 2.0, half]]),
                np.array([[0, 2, 1], [2, 0, 3]]))
    m.normals = np.tile([[0.0, -1.0, 0.0]], (4, 1))
    m.uvs = np.zeros((4, 2))
    b.add_trimesh(m, sid)
    return b


# tests/test_manifold.py's chains: (start, init, target, eta); the mirror
# and Snell chains (K = 1) on its plane walk together, 30 iterations
WALKS = {
    "mirror": ([[-0.5, 1.0, 0.0]] * 3, [[[-0.3, 0.0, 0.2]]] * 3,
               [[0.7, 1.0, 0.0], [0.7, 2.0, 0.3], [-0.5, 1.0, 0.4]],
               np.ones((3, 1))),
    "snell": ([[0.0, 1.0, 0.0]] * 2, [[[0.6, 0.0, 0.0]], [[0.05, 0.0, 0.05]]],
              [[0.8, -1.0, 0.0], [0.5, -2.0, 0.1]], np.full((2, 1), 1.5)),
    "two_bounce": ([[-1.0, 1.2, 0.0]], [[[-0.4, 0.0, 0.1], [0.6, 2.0, -0.1]]],
                   [[1.4, 1.0, 0.0]], np.ones((1, 2))),
}


def _walk_both(jscene, arrays):
    arrays = [np.asarray(a, np.float32) for a in arrays]
    ref = jax.jit(lambda sc, *a: jmf.manifold_walk(sc, *a, n_iter=30))(
        jscene, *map(jnp.asarray, arrays))
    got = tmf.manifold_walk(bridged(jscene), *map(_t, arrays), n_iter=30)
    return arrays, got, ref


@pytest.fixture(scope="module")
def walks():
    """{case: (inputs, the port's walk, the reference's)}."""
    plane = [np.concatenate([np.asarray(WALKS[c][k], np.float32)
                             for c in ("mirror", "snell")])
             for k in range(4)]
    arrays, got, ref = _walk_both(_plane_scene().build()[0], plane)
    out = {c: ([a[sl] for a in arrays], [g[sl] for g in got],
               [npy(r)[sl] for r in ref])
           for c, sl in (("mirror", slice(0, 3)), ("snell", slice(3, 5)))}
    out["two_bounce"] = _walk_both(_two_mirrors().build()[0],
                                   WALKS["two_bounce"])
    return out


@pytest.mark.parametrize("case", list(WALKS))
def test_manifold_walk_matches_reference(walks, case):
    (start, _init, target, eta), got, ref = walks[case]
    np.testing.assert_array_equal(npy(got[3]), npy(ref[3]))
    assert npy(got[3]).all()
    np.testing.assert_allclose(npy(got[0]), npy(ref[0]), atol=1e-4)
    np.testing.assert_allclose(npy(got[1]), npy(ref[1]), atol=1e-4)
    np.testing.assert_array_equal(npy(got[2]), npy(ref[2]))
    assert npy(tmf.reflection_constraint_ok(_t(start), got[0], _t(target),
                                            got[1], _t(eta))).all()


def test_point_normal_equals_interaction():
    """The walk's re-projection reads ``Scene.point_normal_v``: the
    interaction record's point and shading normal, bit for bit, on a scene
    of triangles, spheres and a disk."""
    scene = bridged(jax_shapes_scene())
    rng = np.random.default_rng(6)
    o = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3, d3 = (v3.V3(*(_t(a[:, k]) for k in range(3))) for a in (o, d))
    hit = scene.ray_intersect_v(o3, d3)
    it = scene.interaction_v(o3, d3, hit)
    p, ns = scene.point_normal_v(o3, d3, hit)
    assert len(set(npy(hit.kind).tolist())) == 4
    for a, b in zip((*p, *ns), (*it.p, *it.ns)):
        assert torch.equal(a, b)


def test_singular_lane_is_non_finite():
    """A zero and a rank-one Jacobian solve to non-finite values without
    raising, the regular lane beside them exactly; a lane of non-finite
    vertices steps to non-finite positions beside a regular lane."""
    J = torch.zeros((3, 4, 4))
    J[1] = torch.eye(4)
    J[2] = 1.0
    out = tmf._solve(J, torch.ones((3, 4)))
    assert not torch.isfinite(out[0]).all()
    assert not torch.isfinite(out[2]).all()
    np.testing.assert_array_equal(npy(out[1]), np.ones(4))
    args = _chains(np.random.default_rng(5), 2, 1)
    start, pos, target, nrm, eta = (_t(a) for a in args)
    pos[0] = float("nan")
    tent, _ = tmf._newton_step(start, pos, target, nrm, eta, 0.0)
    assert not torch.isfinite(tent[0]).any() and torch.isfinite(tent[1]).all()


# ---------------------------------------------------------------------------
# the mutation mixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bidirectional", "replay", "media"])
def test_mlt_step_tables_match_reference(layout):
    """No manifold (no scene): each chain's pick, its proposal and
    is_large; the kept blocks bit for bit, the lens step within 2 ulp, the
    small-stepped blocks within 1e-6 on the circle."""
    kw = dict(max_depth=5, n_chains=512,
              bidirectional=layout != "replay", media_blocks=layout == "media")
    tc, jc = tmlt.MLTConfig(**kw), jmlt.MLTConfig(**kw)
    nb = tps._n_blocks(tmlt._pss_cfg(tc))
    chain = torch.arange(512)
    table = tps._draw_table(chain, 3, SEED, nb, 0)
    u_aux = tps._draw_table(chain, 9, SEED, 2, 4)[:, 0]
    prop, is_large, corr = tmlt.mlt_step_tables(table, u_aux, tc, chain, 9,
                                                SEED)
    jprop, jlarge, jcorr = jax.jit(jmlt.mlt_step_tables, static_argnums=2)(
        _j(table), _j(u_aux), jc, jnp.arange(512, dtype=jnp.uint32),
        jnp.uint32(9), jnp.uint32(SEED))
    np.testing.assert_array_equal(npy(is_large), npy(jlarge))
    np.testing.assert_array_equal(npy(corr), npy(jcorr))
    got, ref, old = npy(prop), npy(jprop), npy(table)
    kept = ref == old
    np.testing.assert_array_equal(got[kept], ref[kept])
    u = npy(u_aux)[:, 0]
    lens = npy(tmlt.mutation_masks(_t(u), tc, False)[1])
    ulp = np.spacing(np.maximum(np.abs(ref[lens, 0, :2]), 1e-30)
                     .astype(np.float32))
    assert (np.abs(got[lens, 0, :2] - ref[lens, 0, :2]) <= 2 * ulp).all()
    diff = np.abs(got - ref)
    assert np.minimum(diff, 1 - diff).max() < 1e-6
    for name, mask in zip(("large", "lens", "caustic", "mchain"),
                          tmlt.mutation_masks(_t(u), tc, False)):
        assert npy(mask).sum() > 10, name


# ---------------------------------------------------------------------------
# the manifold perturbation
# ---------------------------------------------------------------------------

MF_CHAINS = 1024
MF_DEPTH = 4


@pytest.fixture(scope="module")
def manifold():
    """The caustic Cornell box in both packages, seeded tables and
    Gaussian uniforms, the reference's _manifold_tables (jitted) and the
    port's with its per-pattern record."""
    jb = JBuilder()
    scenes.fill_caustic_cornell(jb)
    jb.sensor = jax_cornell()[0].sensor
    jscene = jb.build()[0]
    tscene = bridged(jscene)
    kw = dict(max_depth=MF_DEPTH, n_chains=MF_CHAINS)
    tc, jc = tmlt.MLTConfig(**kw), jmlt.MLTConfig(**kw)
    nb = tps._n_blocks(tmlt._pss_cfg(tc))
    chain = torch.arange(MF_CHAINS)
    table = tps._draw_table(chain, 5, SEED, nb, 0)
    ug = tps._draw_table(chain, 6, SEED, 1, 1)[:, 0, :2]
    info = {}
    got = tmlt._manifold_tables(tscene, table, tc, ug, info=info)
    ref, ref_eye = jax.jit(_ref_manifold, static_argnums=2)(
        jscene, _j(table), jc, _j(ug))
    return dict(tscene=tscene, cfg=tc, table=table, ug=ug, got=got,
                ref=tuple(npy(x) for x in ref),
                ref_eye={k: npy(m) for k, m in ref_eye.items()}, info=info)


def _ref_manifold(jscene, table, jc, ug):
    """The reference's _manifold_tables, and its pattern masks as it forms
    them (``mitsuba_im_tpu/integrators/mlt.py:177-225``) from its own eye
    walk, in one jitted call."""
    from mitsuba_im_tpu.bsdf import common as jbc
    from mitsuba_im_tpu.core import rng as jrng
    from mitsuba_im_tpu.integrators.bdpt import camera_pdf_dir, random_walk
    from mitsuba_im_tpu.sensor.table import sample_ray

    n = table.shape[0]
    s = jrng.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0),
                          jnp.uint32(0)).replace(table=table)
    s, blk0 = jrng.next_block4(s)
    o, d, _ = sample_ray(jscene.sensor, blk0[..., 0:2], blk0[..., 2:4])
    eye_vs = random_walk(jscene, s, o, d, jnp.ones((n, 3)),
                         camera_pdf_dir(jscene, d), jc.max_depth, o, d)[0]
    masks = {}
    for i0, K in tmlt.PATTERNS:
        if i0 + K + 1 >= len(eye_vs):
            continue
        a, b = eye_vs[i0], eye_vs[i0 + K + 1]
        pat = a["valid"] & ~a["delta"] & b["valid"] & ~b["delta"]
        for j in range(i0):
            pat = pat & eye_vs[j]["valid"] & eye_vs[j]["delta"]
        for c in eye_vs[i0 + 1:i0 + 1 + K]:
            pat = pat & c["valid"] & c["delta"]
        masks[(i0, K)] = pat & (a["bp"].type == jbc.DIFFUSE)
    return jmlt._manifold_tables(jscene, table, jc, ug), masks


def test_caustic_cornell_pattern_shares():
    """The share of 4,096 random tables (a 64^2 image's worth) whose eye
    path on ``caustic_cornell`` matches each manifold pattern at depth 5,
    as ``scenes.caustic_cornell`` states it: 276 (6.7%), 140 (3.4%) and
    18 (0.44%), each within 1% absolute (a path that grazes the sphere or
    the mirror's edge may take the other side on a last bit)."""
    scene, _ = scenes.caustic_cornell("cpu", 64)
    cfg = tmlt.MLTConfig(max_depth=5, n_chains=4096)
    table = tps._draw_table(torch.arange(4096), 0xFFFFFFFF, 0,
                            tps._n_blocks(tmlt._pss_cfg(cfg)), 0)
    eye = tmlt.eye_walk(scene, table, cfg)
    got = {k: float(tmlt.pattern_mask(eye, *k).float().mean())
           for k in tmlt.PATTERNS if sum(k) + 1 < len(eye)}
    want = {(0, 1): 276, (0, 2): 140, (2, 1): 18}
    assert set(got) == set(want)
    for k, m in want.items():
        assert abs(got[k] - m / 4096) <= 0.01, (k, got[k])


def test_manifold_patterns_and_ratios_match_reference(manifold):
    """The masks equal the reference's; moved alike on >= 99% of the
    lanes; corr within rel 1e-3 where both moved; some lanes move in the
    mirror and glass patterns."""
    info, ref_eye = manifold["info"], manifold["ref_eye"]
    assert set(info) == set(ref_eye) == {(0, 1), (0, 2)}
    for k, pat in ref_eye.items():
        np.testing.assert_array_equal(npy(info[k]["match"]), pat, str(k))
    _prop, corr, moved = (npy(x) for x in manifold["got"])
    _jprop, jcorr, jmoved = manifold["ref"]
    assert (moved == jmoved).mean() >= 0.99
    both = moved & jmoved
    assert npy(info[(0, 1)]["moved"]).sum() > 20
    assert npy(info[(0, 2)]["moved"]).sum() > 0
    np.testing.assert_allclose(corr[both], jcorr[both], rtol=1e-3)
    assert (corr[~moved] == 1).all() and np.isfinite(corr).all()


def test_manifold_edit_is_concentric_inverse_c3(manifold):
    """A moved lane's table changes in a's BSDF block's uniforms 1 and 2
    alone, to the concentric inverse of the new direction at a; the replay
    of the proposal reaches the solved first specular vertex within a
    tenth of the step sigma on >= 99% of the moved lanes; the reference's
    polar edit, replayed, misses by far more (ROADMAP C3)."""
    tscene, cfg, table = manifold["tscene"], manifold["cfg"], manifold["table"]
    prop, _corr, moved = manifold["got"]
    sigma = cfg.manifold_sigma * float(tscene.emitters.bsphere_radius)
    eye = tmlt.eye_walk(tscene, table, cfg)
    eye_p = tmlt.eye_walk(tscene, prop, cfg)
    eye_r = tmlt.eye_walk(tscene, _t(manifold["ref"][0]), cfg)
    miss_p, miss_r = [], []
    for (i0, K), rec in manifold["info"].items():
        lanes = npy(rec["moved"])
        if not lanes.any():
            continue
        blk = 1 + i0
        diff = npy(prop)[lanes] != npy(table)[lanes]
        diff[:, blk, 1:3] = False
        assert not diff.any()
        a = eye[i0]
        first = rec["first"]
        wo = tmlt._dir(a["p"], v3.V3.from_array(first))
        wol = v3.to_local((a["ss"], a["ts"], a["ns"]), wo)
        u1, u2 = v3.uniform_disk_concentric_to_square(wol.x, wol.y)
        np.testing.assert_array_equal(npy(prop)[lanes, blk, 1], npy(u1)[lanes])
        np.testing.assert_array_equal(npy(prop)[lanes, blk, 2], npy(u2)[lanes])
        for out, e in ((miss_p, eye_p), (miss_r, eye_r)):
            hit = np.stack([npy(c) for c in e[i0 + 1]["p"]], -1)
            out.append(np.linalg.norm(hit - npy(first), axis=-1)[lanes])
    miss_p, miss_r = np.concatenate(miss_p), np.concatenate(miss_r)
    assert len(miss_p) > 20
    assert (miss_p < 0.1 * sigma).mean() >= 0.99, np.sort(miss_p)[-5:]
    assert np.median(miss_r) > 100 * sigma


def test_manifold_subset_equals_full_batch(manifold):
    """Rule of the port's compaction: the lanes that select the manifold
    mutation, run alone with their chain indices, give the full batch's
    proposal, factor and moves on those lanes."""
    tscene, cfg, table, ug = (manifold[k] for k in ("tscene", "cfg", "table",
                                                    "ug"))
    idx = torch.arange(3, MF_CHAINS, 7)
    sub = tmlt._manifold_tables(tscene, table[idx], cfg, ug[idx], chain=idx)
    for s, f in zip(sub, manifold["got"]):
        f = f[idx]
        if f.dtype == torch.bool:
            np.testing.assert_array_equal(npy(s), npy(f))
        else:
            np.testing.assert_allclose(npy(s), npy(f), rtol=1e-6, atol=0)
    assert npy(sub[2]).sum() > 0


@pytest.mark.parametrize("lanes", ["some match", "none match"])
def test_manifold_walks_matching_lanes_alone(manifold, lanes):
    """A chain length walks only when some lane matches one of its
    patterns: the eye walk's MF_DEPTH traces, and K first re-projections
    and 20 K Newton ones for each such length; lanes that match nothing
    keep their table with factor 1 and trace the eye walk alone."""
    from mitsuba_im_tpu_torch.accel import intersect as isect

    tscene, cfg, table, ug = (manifold[k] for k in ("tscene", "cfg", "table",
                                                    "ug"))
    hit = torch.stack([r["match"] for r in manifold["info"].values()]).any(0)
    idx = torch.arange(3, MF_CHAINS, 7)
    if lanes == "none match":
        idx = torch.nonzero(~hit).squeeze(1)[:64]
    calls, orig = [0], isect.intersect_v

    def spy(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    info = {}
    isect.intersect_v = spy
    try:
        prop, corr, moved = tmlt._manifold_tables(
            tscene, table[idx], cfg, ug[idx], chain=idx, info=info)
    finally:
        isect.intersect_v = orig
    walked = {K for (_, K), r in info.items() if bool(r["match"].any())}
    assert calls[0] == MF_DEPTH + sum(21 * K for K in walked)
    if lanes == "none match":
        assert not walked and not moved.any() and (corr == 1).all()
        assert torch.equal(prop, table[idx])
    else:
        assert walked == {1, 2}


# ---------------------------------------------------------------------------
# a step and the factory
# ---------------------------------------------------------------------------

RUN_RES, RUN_CHAINS, RUN_DEPTH = 16, 256, 2


def test_mlt_run_step_matches_reference():
    """One accumulating step from the same state (the port's evaluation of
    fresh tables), p_manifold 0, the unidirectional replay at depth 2
    (separateDirect off, so that the direct light is the target; the
    bidirectional evaluation is held in ``tests/test_torch_mcmc.py``
    and its layout by ``test_mlt_step_tables_match_reference``; the
    reference's replay jitted, its bidirectional sampler never): the
    acceptance decisions equal, the new state and the image at pssmlt's
    step tolerance."""
    jscene, _ = jax_cornell()
    tscene = bridged(jscene)
    kw = dict(max_depth=RUN_DEPTH, n_chains=RUN_CHAINS, p_manifold=0.0,
              bidirectional=False, separate_direct=False)
    tc, jc = tmlt.MLTConfig(**kw), jmlt.MLTConfig(**kw)
    pss = tmlt._pss_cfg(tc)
    chain = torch.arange(RUN_CHAINS)
    table = tps._draw_table(chain, 0xFFFFFFFF, SEED, tps._n_blocks(pss), 0)
    pos, color, I = tps._eval(tscene, table, pss, RUN_RES, RUN_RES)
    state = (table, pos, color, I, I.sum(), torch.tensor(float(RUN_CHAINS)))
    timg, tst = tmlt.mlt_run(tscene, torch.zeros((RUN_RES, RUN_RES, 3)),
                             state, SEED, 1, cfg=tc, width=RUN_RES,
                             height=RUN_RES, n_steps=1, accumulate=True)
    jimg, jst = jmlt.mlt_run(
        jscene, jnp.zeros((RUN_RES, RUN_RES, 3)),
        tuple(_j(x) for x in state), jnp.uint32(SEED), jnp.uint32(1),
        cfg=jc, width=RUN_RES, height=RUN_RES, n_steps=1, accumulate=True)
    old = npy(table)
    acc_t = (npy(tst[0]) != old).any(axis=(1, 2))
    acc_j = (npy(jst[0]) != old).any(axis=(1, 2))
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_t.sum() < RUN_CHAINS
    diff = np.abs(npy(tst[0]) - npy(jst[0]))
    assert np.minimum(diff, 1 - diff).max() < 1e-6
    for a, b in zip(tst[1:], jst[1:]):
        np.testing.assert_allclose(npy(a), npy(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(timg), npy(jimg), rtol=RTOL, atol=1e-5)
    assert npy(timg).sum() > 0


MLT_FILES = {
    "defaults": '<integrator type="mlt"/>',
    "set": '<integrator type="mlt"><integer name="maxDepth" value="4"/>'
           '<float name="pLarge" value="0.2"/><integer name="chains" '
           'value="64"/><integer name="burnIn" value="3"/><float '
           'name="pLens" value="0.3"/><float name="pCaustic" value="0.1"/>'
           '<float name="pMultiChain" value="0.25"/><boolean '
           'name="bidirectional" value="false"/><float name="pManifold" '
           'value="0.5"/></integrator>',
}


@pytest.mark.parametrize("case", list(MLT_FILES))
def test_mlt_factory_matches_reference(case, tmp_path):
    """The properties are the reference's exactly: neither factory reads
    ``bidirectional`` or ``pManifold`` (ROADMAP C25)."""
    path = _scene_file(tmp_path, MLT_FILES[case])
    _scene, pset = tload(path, device="cpu")
    _jscene, rset = jload(path)
    assert pset.integrator == rset.integrator == "mlt"
    assert pset.integrator_props == rset.integrator_props
    assert "bidirectional" not in pset.integrator_props
    cfg = tmlt.mlt_config(_scene, pset)
    assert cfg.bidirectional and not cfg.separate_direct
    assert math.isclose(cfg.p_manifold, 0.05)
