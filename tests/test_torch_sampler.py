"""Port vs reference: the QMC point sets (``core/qmc.py``), every sampler
kind of ``core/rng.py`` and the sampler factories (``sampler/``).

Words are exact integer arithmetic and are held bit for bit, as are the
uniforms made from them.  The one float computation is the base-b radical
inverse (``inv + d * f`` in float32): the port rounds each multiply and
each add, as a numpy float32 loop does, and is held to that loop bit for
bit.  The JAX package's compiled loop may fuse the multiply-add on the
CPU, so its words are held where they agree with the port's, and the
share where they differ is printed (0 of 2^20 indices for base 3; 8.6% for
base 5 and 12.5% for base 7, which no sampler kind reads).  Likewise
HAMMERSLEY's first coordinate (i / spp + rot) mod 1, whose multiply-add
the reference's compiled code fuses where the sample index varies by
lane (a render pass shares it, and there the two agree).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import npy, words

import mitsuba_im_tpu.sampler as jsampler
from mitsuba_im_tpu.core import qmc as jq
from mitsuba_im_tpu.core import rng as jrng
from mitsuba_im_tpu.core.properties import Properties
from mitsuba_im_tpu.core.registry import create
from mitsuba_im_tpu.scene.build import SceneBuilder as JBuilder
from mitsuba_im_tpu_torch import sampler as tsampler
from mitsuba_im_tpu_torch.core import qmc as tq
from mitsuba_im_tpu_torch.core import rng as trng
from mitsuba_im_tpu_torch.render.job import RenderSettings

torch.set_num_threads(2)

KINDS = {"independent": trng.INDEPENDENT, "stratified": trng.STRATIFIED,
         "ldsampler": trng.LDSAMPLER, "sobol": trng.SOBOL,
         "halton": trng.HALTON, "hammersley": trng.HAMMERSLEY}


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64)
    w[:6] = [0, 1, 2**31, 2**32 - 1, 0x55555555, 0xAAAAAAAA]
    return w


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def test_direction_numbers_bit_exact():
    np.testing.assert_array_equal(tq._SOBOL_V, jq._SOBOL_V)


def test_qmc_words_bit_exact():
    rng = np.random.default_rng(60)
    w, seed = _words(rng, 4096), _words(rng, 4096)
    idx = rng.integers(0, 2**24, 4096, dtype=np.uint64)
    idx[:4] = [0, 1, 2**24 - 1, 12345]
    pairs = [
        (tq._reverse_bits(_t(w)), jq._reverse_bits(_j(w))),
        (tq.owen_scramble(_t(w), _t(seed)),
         jq.owen_scramble(_j(w), _j(seed))),
        (tq.radical_inverse_bits(_t(idx), 2),
         jq.radical_inverse_bits(_j(idx), 2)),
        *zip(tq.sobol02_bits(_t(idx)), jq.sobol02_bits(_j(idx))),
    ]
    pairs += [(tq.sobol_bits(_t(idx), dim), jq.sobol_bits(_j(idx), dim))
              for dim in (0, 1, 2, 7, 31, 63)]
    for a, b in pairs:
        np.testing.assert_array_equal(words(a), words(b))
    np.testing.assert_array_equal(npy(tq.bits_to_unit(_t(w))),
                                  npy(jq.bits_to_unit(_j(w))))
    for dim in (0, 5, 63):
        np.testing.assert_array_equal(
            npy(tq.sobol_owen(_t(idx), dim, _t(seed))),
            npy(jq.sobol_owen(_j(idx), dim, _j(seed))))
    # halton dimension 0 is base 2 (exact); the others below
    np.testing.assert_array_equal(
        npy(tq.halton_scrambled(_t(idx), 0, _t(seed))),
        npy(jq.halton_scrambled(_j(idx), 0, _j(seed))))


def _radical_inverse_f32(i: np.ndarray, base: int) -> np.ndarray:
    """The reference's radical inverse as a numpy float32 loop, every
    multiply and add rounded on its own (no fused multiply-add)."""
    n_digits = int(np.ceil(jq.MAX_INDEX_BITS / np.log2(base)))
    inv = np.zeros(i.shape, np.float32)
    step = np.float32(1.0 / base)
    f = step
    ii = i.astype(np.uint64)
    for _ in range(n_digits):
        d = (ii % base).astype(np.float32)
        ii //= base
        inv = np.float32(inv + np.float32(d * f))
        f = np.float32(f * step)
    inv = np.minimum(inv, np.float32(0.99999994))
    return (inv * np.float32(4294967296.0)).astype(np.uint64)


@pytest.mark.parametrize("base", [3, 5, 7])
def test_radical_inverse_float32_loop(base):
    """Bit for bit against the float32 loop; against the JAX package's
    compiled words where they agree (the share that differs printed), and
    then the scrambled Halton values too."""
    rng = np.random.default_rng(61)
    idx = np.concatenate([np.arange(1 << 16),
                          rng.integers(0, 2**24, 1 << 16)]).astype(np.uint64)
    port = words(tq.radical_inverse_bits(_t(idx), base))
    np.testing.assert_array_equal(port, _radical_inverse_f32(idx, base))
    ref = words(jax.jit(lambda x: jq.radical_inverse_bits(x, base))(
        _j(idx)))
    agree = port == ref
    print(f"base {base}: the JAX package's words differ on "
          f"{1 - agree.mean():.4f} of {len(idx)} indices")
    dim = jq._PRIMES.index(base)
    seed = _words(rng, len(idx))
    th = npy(tq.halton_scrambled(_t(idx), dim, _t(seed)))
    jh = npy(jax.jit(lambda i, s: jq.halton_scrambled(i, dim, s))(
        _j(idx), _j(seed)))
    np.testing.assert_array_equal(th[agree], jh[agree])
    if base == 3:  # the base the HALTON sampler reads
        assert agree.all()


@pytest.mark.parametrize("sample", ["shared", "per_lane"])
@pytest.mark.parametrize("name", list(KINDS))
def test_sampler_kinds_bit_exact(name, sample):
    """Six blocks of every kind, bit for bit against the reference's
    compiled sampler, with 9 spp (3 x 3 strata, a non-power-of-two
    divisor) and a sample index every lane shares (a render pass: the
    port computes the index-only words on the host) or one per lane."""
    kind = KINDS[name]
    n = 4096
    pix = np.arange(n, dtype=np.uint32) * 7 + 3
    if sample == "shared":
        js_, ts_ = jnp.uint32(5), 5
    else:
        idx = np.random.default_rng(62).integers(0, 40, n).astype(np.uint32)
        js_, ts_ = jnp.asarray(idx), _t(idx)

    @jax.jit
    def ref(p, smp):
        s = jrng.make_sampler_v(p, smp, jnp.uint32(77), kind=kind, spp=9)
        out = []
        for _ in range(6):
            s, u = jrng.next_block4_v(s)
            out += [*u, s.dim]
        return out

    want = [npy(a) for a in ref(jnp.asarray(pix), js_)]
    if name == "hammersley" and sample == "per_lane":
        # block 0's u0 = (i / spp + rot) mod 1: the reference's compiled
        # code fuses that multiply-add; held to numpy float32 without it
        # (the share of lanes where the reference differs printed)
        s2 = npy(jrng.pcg4d_words(*(jnp.asarray(a) for a in (
            pix, np.full(n, 77, np.uint32), np.zeros(n, np.uint32),
            np.full(n, 77, np.uint32))))[2])
        rot = (s2 >> 8).astype(np.float32) * np.float32(1.0 / 16777216.0)
        rec = np.float32(1.0) / np.float32(9.0)
        u0 = np.mod(np.float32(idx.astype(np.float32) * rec) + rot,
                    np.float32(1.0)).astype(np.float32)
        agree = u0 == want[0]
        print(f"hammersley per lane: the reference's fused u0 differs on "
              f"{1 - agree.mean():.4f} of {n} lanes")
        want[0] = u0
    s = trng.make_sampler_v(_t(pix), ts_, 77, kind=kind, spp=9)
    assert (s.sample_index is not None) == (sample == "shared")
    got = []
    for _ in range(6):
        s, u = trng.next_block4_v(s)
        got += [*u, s.dim]
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(npy(a), b.astype(npy(a).dtype),
                                      err_msg=f"block {k // 5} slot {k % 5}")


@pytest.mark.parametrize("name", list(KINDS))
def test_sampler_factories(name):
    """Each factory's record and the settings it writes equal the
    reference plugin's (sampleCount, scramble -> spp, seed)."""
    props = Properties(name)
    props.set("sampleCount", 9)
    props.set("scramble", 5)
    jb = JBuilder()
    ref = create("sampler", props, jb)
    settings = RenderSettings()
    factory = getattr(tsampler, name)
    assert factory(sample_count=9, scramble=5, settings=settings) == ref
    for k in ("spp", "sampler", "seed"):
        assert getattr(settings, k) == getattr(jb.settings, k), k
    assert factory() == create("sampler", Properties(name))
    assert tsampler.KIND_BY_NAME == jsampler.KIND_BY_NAME
    assert tsampler.KIND_BY_NAME[name] == KINDS[name]
