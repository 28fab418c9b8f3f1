"""Port vs reference: the sampler's MCMC table mode, the splat sampler,
pssmlt and erpt (``mitsuba_im_tpu_torch/core/rng.py``,
``bidir/pathsampler.py``, ``integrators/{pssmlt,erpt}.py``), on the CPU.

Exact: ``next_block4_v`` in table mode against both reference forms (the
SoA and the (N, 4) one), draws past the table's end and over a QMC kind
included; ``_draw_table`` against the reference's loop of
``next_block4``; the block counts.  At f32 tolerance (rtol 1e-4, atol
1e-6): ``_mutate_small`` (atol 1e-6 on the circle [0, 1)), ``_eval``
unidirectional and bidirectional on the same tables, one ``pssmlt_run``
step from the reference's initial state (the acceptance decisions equal:
no |a - u| in these data is near the last bits), ``pssmlt_init`` (its
luminance rounds' b, the resampled chains), and one ``erpt_pass`` of 2
steps.  The reference's
jitted MCMC functions run eagerly (``jax.disable_jit``), a step or two,
never a whole render, with 64 chains on the 16^2 Cornell box at depth 3;
their ``fori_loop`` bodies get the int32 index that tracing gives them
(:func:`_eager`).
Scene files with ``pssmlt`` (bidirectional and not), ``mlt`` and ``erpt``
load into the reference's settings and render through the command line
and ``render``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import bridged, jax_cornell, npy
from test_torch_adaptive import _scene_file

from mitsuba_im_tpu.bidir import pathsampler as jpsm
from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.integrators import erpt as jerpt
from mitsuba_im_tpu.integrators import pssmlt as jps
from mitsuba_im_tpu.scene.xml import load_scene as jload
from mitsuba_im_tpu_torch.bidir import pathsampler as tpsm
from mitsuba_im_tpu_torch.cli.main import main
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.integrators import erpt as terpt
from mitsuba_im_tpu_torch.integrators import pssmlt as tps
from mitsuba_im_tpu_torch.io.exr import read_exr
from mitsuba_im_tpu_torch.render import job as tjob
from mitsuba_im_tpu_torch.scene.xml import load_scene as tload

torch.set_num_threads(2)

RES = 16
CHAINS = 64
DEPTH = 3
SEED = 7
RTOL, ATOL = 1e-4, 1e-6


@contextlib.contextmanager
def _eager():
    """``jax.disable_jit`` with ``lax.fori_loop`` as a Python loop whose
    body receives the index as an int32 array, as under ``jax.jit`` (the
    reference's MCMC bodies call ``i.astype``, which a Python int lacks)."""
    orig = jax.lax.fori_loop

    def loop(lo, hi, body, carry):
        for i in range(int(lo), int(hi)):
            carry = body(jnp.int32(i), carry)
        return carry

    jax.lax.fori_loop = loop
    try:
        with jax.disable_jit():
            yield
    finally:
        jax.lax.fori_loop = orig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _cfgs(bidirectional: bool):
    kw = dict(max_depth=DEPTH, n_chains=CHAINS, bidirectional=bidirectional)
    return jps.PSSMLTConfig(**kw), tps.PSSMLTConfig(**kw)


@pytest.fixture(scope="module")
def cornell():
    jscene, _ = jax_cornell()
    return jscene, bridged(jscene)


def test_table_mode_matches_reference():
    """Five blocks of a 3-block table: the table's rows, then the hash;
    the table takes precedence over a QMC kind, as in the reference."""
    rng = np.random.default_rng(1)
    n = 64
    table = rng.random((n, 3, 4), dtype=np.float32)
    pix = np.arange(n, dtype=np.uint32) * 7 + 3
    for kind in (trng.INDEPENDENT, trng.LDSAMPLER):
        ts = trng.make_sampler_v(_t(pix.astype(np.int64)), 5, 9,
                                 kind=kind).replace(table=_t(table))
        js = jrng.make_sampler_v(jnp.asarray(pix), jnp.uint32(5),
                                 jnp.uint32(9), kind=kind).replace(
            table=jnp.asarray(table))
        ja = jrng.make_sampler(jnp.asarray(pix), jnp.uint32(5),
                               jnp.uint32(9), kind=kind).replace(
            table=jnp.asarray(table))
        for blk in range(5):
            ts, tu = trng.next_block4_v(ts)
            js, ju = jrng.next_block4_v(js)
            ja, jua = jrng.next_block4(ja)
            got = np.stack([npy(u) for u in tu], -1)
            np.testing.assert_array_equal(got, np.stack(
                [np.asarray(u) for u in ju], -1))
            np.testing.assert_array_equal(got, np.asarray(jua))
            if blk < 3:
                np.testing.assert_array_equal(got, table[:, blk])
        np.testing.assert_array_equal(npy(ts.dim), np.asarray(js.dim))


@pytest.mark.parametrize("stream", [0, 1, 2, 3, 4])
def test_draw_table_matches_reference(stream):
    chain = np.arange(CHAINS, dtype=np.uint32)
    for step, seed, n_blocks in ((0, 0, 1), (17, SEED, 10),
                                 (0xFFFFFFFF, 0xDEADBEEF, 3)):
        ref = jps._draw_table(jnp.asarray(chain), jnp.uint32(step),
                              jnp.uint32(seed), n_blocks, stream)
        got = tps._draw_table(_t(chain.astype(np.int64)), step, seed,
                              n_blocks, stream)
        np.testing.assert_array_equal(npy(got), np.asarray(ref))


def test_block_counts_and_mutation():
    for md in range(0, 9):
        for media in (False, True):
            assert tpsm.n_blocks_bidir(md, media) == \
                jpsm.n_blocks_bidir(md, media)
        assert tpsm.n_light_splats(md) == jpsm.n_light_splats(md)
        for bid in (False, True):
            jc, tc = (type(c)(max_depth=md, bidirectional=bid)
                      for c in _cfgs(bid))
            assert tps._n_blocks(tc) == jps._n_blocks(jc)
    rng = np.random.default_rng(2)
    u, xi, sign = (rng.random((CHAINS, 5, 4), dtype=np.float32)
                   for _ in range(3))
    ref = np.asarray(jps._mutate_small(*(jnp.asarray(a)
                                         for a in (u, xi, sign)),
                                       1 / 1024, 1 / 64))
    got = npy(tps._mutate_small(*(_t(a) for a in (u, xi, sign)),
                                1 / 1024, 1 / 64))
    diff = np.abs(got - ref)
    assert np.minimum(diff, 1 - diff).max() < 1e-6
    assert ((got >= 0) & (got < 1)).all()


@pytest.fixture(scope="module")
def evals(cornell):
    """_eval of the same fresh tables by both packages, both samplers."""
    jscene, tscene = cornell
    out = {}
    for bid in (False, True):
        jc, tc = _cfgs(bid)
        B = tps._n_blocks(tc)
        table = tps._draw_table(torch.arange(CHAINS), 3, SEED, B, 1)
        got = tps._eval(tscene, table, tc, RES, RES)
        with _eager():
            ref = jps._eval(jscene, jnp.asarray(npy(table)), jc, RES, RES)
        out[bid] = got, ref
    return out


@pytest.mark.parametrize("bidirectional", [False, True])
def test_eval_matches_reference(evals, bidirectional):
    """Splat positions, colours and the Metropolis target per chain (S = 1
    splat a chain for the replay, 1 + (depth - 1) bidirectionally)."""
    got, ref = evals[bidirectional]
    S = 1 + (DEPTH - 1 if bidirectional else 0)
    assert npy(got[0]).shape == (CHAINS, S, 2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert (np.asarray(ref[2]) > 0).sum() > CHAINS // 8


@pytest.fixture(scope="module")
def inits(cornell):
    jscene, tscene = cornell
    out = {}
    for bid in (False, True):
        jc, tc = _cfgs(bid)
        with _eager():
            ref = jps.pssmlt_init(jscene, jnp.uint32(SEED), cfg=jc,
                                  width=RES, height=RES, lum_rounds=2)
        got = tps.pssmlt_init(tscene, SEED, cfg=tc, width=RES, height=RES,
                              lum_rounds=2)
        out[bid] = got, ref
    return out


@pytest.mark.parametrize("bidirectional", [False, True])
def test_pssmlt_init_matches_reference(inits, bidirectional):
    """The brightness b (both rounds' sums), and the resampled chains:
    every chain's table and target equal where the systematic resampling
    picked the same candidate (all but a tie's neighbours)."""
    got, ref = inits[bidirectional]
    np.testing.assert_allclose(npy(got[4]), np.asarray(ref[4]), rtol=1e-5)
    assert float(got[5]) == float(ref[5])
    same = (npy(got[0]) == np.asarray(ref[0])).all(axis=(1, 2))
    assert same.mean() > 0.95
    for a, b in zip(got[1:4], ref[1:4]):
        np.testing.assert_allclose(npy(a)[same], np.asarray(b)[same],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_pssmlt_run_step_matches_reference(cornell, inits, bidirectional):
    """One accumulating step from the reference's initial state: the image,
    the new state and b; the acceptance decisions equal."""
    jscene, tscene = cornell
    jc, tc = _cfgs(bidirectional)
    state = inits[bidirectional][1]
    with _eager():
        jimg, jst = jps.pssmlt_run(
            jscene, jnp.zeros((RES, RES, 3)), state, jnp.uint32(SEED),
            jnp.uint32(1), cfg=jc, width=RES, height=RES, n_steps=1,
            accumulate=True)
    timg, tst = tps.pssmlt_run(
        tscene, torch.zeros((RES, RES, 3)),
        tuple(_t(np.asarray(x)) for x in state), SEED, 1, cfg=tc,
        width=RES, height=RES, n_steps=1, accumulate=True)
    old = np.asarray(state[0])
    acc_t = (npy(tst[0]) != old).any(axis=(1, 2))
    acc_j = (np.asarray(jst[0]) != old).any(axis=(1, 2))
    # the small steps' uniforms agree to the last bits of exp (1e-6 on
    # the circle), the decisions exactly but at near ties
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_t.sum() < CHAINS
    diff = np.abs(npy(tst[0]) - np.asarray(jst[0]))
    assert np.minimum(diff, 1 - diff).max() < 1e-6
    for a, b in zip(tst[1:], jst[1:]):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(npy(timg), np.asarray(jimg), rtol=RTOL,
                               atol=1e-5)
    assert npy(timg).sum() > 0


def test_erpt_pass_matches_reference(cornell):
    """One pass of 64 seeds and 2 redistribution steps (unidirectional,
    erpt's default)."""
    jscene, tscene = cornell
    jc, tc = _cfgs(False)
    with _eager():
        ref = jerpt.erpt_pass(jscene, jnp.zeros((RES, RES, 3)),
                              jnp.uint32(1), jnp.uint32(SEED), cfg=jc,
                              width=RES, height=RES, chain_length=2)
    got = terpt.erpt_pass(tscene, torch.zeros((RES, RES, 3)), 1, SEED,
                          cfg=tc, width=RES, height=RES, chain_length=2)
    assert np.asarray(ref).sum() > 0
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)


FILES = {
    "pssmlt": '<integrator type="pssmlt"><integer name="maxDepth" '
              'value="3"/><integer name="chains" value="64"/><integer '
              'name="burnIn" value="4"/></integrator>',
    "pssmlt_unidirectional":
        '<integrator type="pssmlt"><integer name="maxDepth" value="3"/>'
        '<integer name="chains" value="64"/><boolean name="bidirectional" '
        'value="false"/></integrator>',
    "erpt": '<integrator type="erpt"><integer name="maxDepth" value="3"/>'
            '<integer name="chainLength" value="4"/><float name="numChains" '
            'value="2"/></integrator>',
    "mlt": '<integrator type="mlt"><integer name="maxDepth" value="3"/>'
           '<integer name="chains" value="64"/><integer name="burnIn" '
           'value="4"/></integrator>',
}


@pytest.mark.parametrize("case", list(FILES))
def test_scene_file_renders(case, tmp_path):
    """The factory's properties are the reference's (plus the
    ``bidirectional`` flag the reference's factory drops); the command
    line renders the file on the CPU."""
    path = _scene_file(tmp_path, FILES[case], res=8, spp=2)
    scene, pset = tload(path, device="cpu")
    _j, rset = jload(path)
    assert pset.integrator == rset.integrator == case.split("_")[0]
    extra = dict(pset.integrator_props)
    if case == "pssmlt_unidirectional":
        assert extra.pop("bidirectional") is False
    assert extra == rset.integrator_props
    out = str(tmp_path / "out.exr")
    assert main([path, "-o", out, "-q", "--device", "cpu"]) == 0
    img, _ = read_exr(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    np.testing.assert_allclose(img, npy(tjob.render(scene, pset)),
                               rtol=1e-3, atol=1e-4)

