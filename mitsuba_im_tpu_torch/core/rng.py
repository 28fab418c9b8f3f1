"""Counter-based per-lane RNG (``mitsuba_im_tpu/core/rng.py``), bit for bit.

Every draw is a pure function of ``(seed, pixel, sample, dimension)``
through the PCG4D hash (Jarzynski & Olano, JCGT 2020).  PyTorch lacks
``add`` and ``>>`` for ``uint32`` on the CPU, so the 32-bit words ride in
int64 tensors holding values in [0, 2^32): every sum is masked back to 32
bits and every word-by-word product is split into 16-bit halves
(:func:`_mul32`) so no intermediate leaves the int64 range.  The words are
the reference's uint32 words exactly.

Every sampler kind is ported: INDEPENDENT hashes each block of four
dimensions; STRATIFIED jitters the image-plane pair over a near-square grid
of ``spp`` strata; LDSAMPLER and SOBOL draw every aligned pair from the
Owen-scrambled (0,2)-sequence, keyed per (pixel, seed, pair); HALTON and
HAMMERSLEY put their base-2/3 and i/N points on the image-plane pair
(:mod:`.qmc`).  When every lane of a pass shares its sample index (a
render pass, ``make_sampler_v`` given an int), the index-only QMC words
are computed once on the host (and kept for the pass's later blocks) and
the per-lane scramble takes them as numbers: the same words, without a
device operation per unrolled step.
A division by a sampler constant multiplies by its float32 reciprocal, as
XLA compiles the reference's (and as PyTorch's CUDA kernel divides by a
Python number), so the card, the CPU and the reference round alike.  The
MCMC ``table``
mode (pssmlt, erpt) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
U24 = 1.0 / 16777216.0

# Sampler kinds (static dispatch codes, as in the reference)
INDEPENDENT = 0
STRATIFIED = 1
LDSAMPLER = 2
SOBOL = 3
HALTON = 4
HAMMERSLEY = 5


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for words in [0, 2^32), with int64 intermediates
    below 2^49."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def pcg4d_words(x, y, z, w):
    """PCG4D over four word tensors (int64 holding uint32 values)."""
    x = ((x & MASK32) * 1664525 + 1013904223) & MASK32
    y = ((y & MASK32) * 1664525 + 1013904223) & MASK32
    z = ((z & MASK32) * 1664525 + 1013904223) & MASK32
    w = ((w & MASK32) * 1664525 + 1013904223) & MASK32
    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32
    return x, y, z, w


def hash_u32(*words) -> torch.Tensor:
    """Mix up to 4 integer words (integer tensors of one shape, or ints)
    into one uint32 word, in int64: word 0 of PCG4D over them, zeros after
    the last."""
    like = next(w for w in words if isinstance(w, torch.Tensor))
    ws = [_words(w, like) for w in words]
    ws += [torch.zeros_like(ws[0])] * (4 - len(ws))
    return pcg4d_words(*ws)[0]


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1) with 24-bit mantissa resolution."""
    return (bits >> 8).to(torch.float32) * U24


@dataclasses.dataclass(frozen=True)
class Sampler3:
    """SoA sampler state: (N,) int64 tensors holding uint32 words;
    ``sample_index`` is the sample index as a number when every lane
    shares it (``sample`` then broadcasts it)."""

    pixel: torch.Tensor
    sample: torch.Tensor
    b0: torch.Tensor  # hashed base words
    b1: torch.Tensor
    b2: torch.Tensor
    b3: torch.Tensor
    dim: torch.Tensor  # next dimension to consume
    seed: torch.Tensor  # () word
    table: torch.Tensor | None = None
    kind: int = INDEPENDENT
    spp: int = 1
    sample_index: int | None = None

    def replace(self, **kw) -> "Sampler3":
        return dataclasses.replace(self, **kw)


def _words(v, like: torch.Tensor) -> torch.Tensor:
    """An int or integer tensor -> int64 words broadcast to ``like``."""
    if isinstance(v, torch.Tensor):
        return (v.to(torch.int64) & MASK32).expand(like.shape)
    return torch.full(like.shape, int(v) & MASK32, dtype=torch.int64,
                      device=like.device)


def make_sampler_v(pixel: torch.Tensor, sample, seed, kind=INDEPENDENT,
                   spp=1) -> Sampler3:
    """The sampler of flat pixel indices at ``sample`` (an int shared by
    every lane, or an integer tensor) for the scramble ``seed``."""
    pixel = pixel.to(torch.int64) & MASK32
    shared = (int(sample) & MASK32
              if isinstance(sample, (int, np.integer)) else None)
    sample = _words(sample, pixel)
    seed = _words(seed, pixel.new_empty(()))
    b0, b1, b2, b3 = pcg4d_words(pixel, sample, seed.expand(pixel.shape),
                                 torch.full_like(pixel, 0x9E3779B9))
    return Sampler3(
        pixel=pixel, sample=sample, b0=b0, b1=b1, b2=b2, b3=b3,
        dim=torch.zeros_like(pixel), seed=seed, kind=kind, spp=spp,
        sample_index=shared,
    )


def _div_const(x, k: int):
    """x / k for a constant k, as x times the float32 reciprocal of k."""
    return x * float(np.float32(1.0) / np.float32(k))


def _strata(spp: int) -> tuple[int, int]:
    """(columns, rows) of STRATIFIED's near-square grid of ``spp``."""
    res_x = max(math.isqrt(spp), 1)
    return res_x, max(spp // res_x, 1)


def _index_words(i: torch.Tensor, kind: int, spp: int) -> list:
    """The parts of a block that depend on the sample index ``i`` alone:
    STRATIFIED's stratum (column, row); for the LDS kinds the Sobol' (0,2)
    words, bit-reversed for the scramble, then for HALTON the reversed
    base-2 and base-3 radical inverses, for HAMMERSLEY i / spp and the
    reversed base-2 radical inverse."""
    from . import qmc

    if kind == STRATIFIED:
        res_x, res_y = _strata(spp)
        idx = (i % (res_x * res_y)).to(torch.float32)
        return [torch.remainder(idx, float(res_x)),
                torch.floor(_div_const(idx, res_x))]
    rev = qmc._reverse_bits
    out = [rev(b) for b in qmc.sobol02_bits(i)]
    if kind == HALTON:
        out += [rev(qmc.radical_inverse_bits(i, 2)),
                rev(qmc.radical_inverse_bits(i, 3))]
    elif kind == HAMMERSLEY:
        out += [_div_const(i.to(torch.float32), max(spp, 1)),
                rev(qmc.radical_inverse_bits(i, 2))]
    return out


@functools.lru_cache(maxsize=256)
def _shared_index_words(sample_index: int, kind: int, spp: int) -> tuple:
    """:func:`_index_words` of a sample index every lane shares, computed
    once on the host, as Python numbers."""
    i = torch.tensor(sample_index, dtype=torch.int64)
    return tuple(t.item() for t in _index_words(i, kind, spp))


def _index_parts(s: Sampler3):
    """:func:`_index_words` of the sampler's lanes: numbers when they
    share their sample index, else (N,) tensors."""
    if s.sample_index is not None:
        return _shared_index_words(s.sample_index, s.kind, s.spp)
    return _index_words(s.sample, s.kind, s.spp)


def _lds_pair_v(s: Sampler3, dim0: torch.Tensor):
    """The low-discrepancy pair (u0, u1) of the aligned dimension pair at
    ``dim0`` (the reference's ``_lds_pair_v``): the padded Owen-scrambled
    Sobol' (0,2)-sequence, its scramble keyed by (pixel, seed, pair index);
    HALTON and HAMMERSLEY put their own points on the image-plane pair."""
    from . import qmc

    words = _index_parts(s)

    def scrambled(rev, key):
        return qmc.bits_to_unit(qmc.owen_scramble_reversed(rev, key))

    pair = dim0 >> 1
    s0, s1, s2, s3 = pcg4d_words(s.pixel, s.seed.expand(s.pixel.shape),
                                 pair, 77)
    u0 = scrambled(words[0], s0)
    u1 = scrambled(words[1], s1)
    if s.kind == HALTON:
        h0 = scrambled(words[2], s2)
    elif s.kind == HAMMERSLEY:
        h0 = torch.remainder(words[2] + to_unit_float(s2), 1.0)
    else:
        return u0, u1
    h1 = scrambled(words[3], s3)
    first = dim0 == 0
    return torch.where(first, h0, u0), torch.where(first, h1, u1)


def next_block4_v(s: Sampler3):
    """Draw 4 dimensions with ONE hash (or two LDS pairs); returns
    (sampler, (u0, u1, u2, u3))."""
    if s.table is not None:
        raise NotImplementedError(
            "next_block4_v: the MCMC table mode (pssmlt, erpt) is not ported")
    dim = ((s.dim + 3) & ~3) & MASK32
    s2 = s.replace(dim=(dim + 4) & MASK32)
    if s.kind in (LDSAMPLER, SOBOL, HALTON, HAMMERSLEY):
        return s2, (*_lds_pair_v(s, dim), *_lds_pair_v(s, dim + 2))
    x, y, z, w = pcg4d_words(s.b0, s.b1, s.b2 ^ dim, s.b3)
    u0, u1, u2, u3 = (to_unit_float(t) for t in (x, y, z, w))
    if s.kind == STRATIFIED:
        res_x, res_y = _strata(s.spp)
        sx, sy = _index_parts(s)
        first = dim == 0
        u0 = torch.where(first, _div_const(u0 + sx, res_x), u0)
        u1 = torch.where(first, _div_const(u1 + sy, res_y), u1)
    return s2, (u0, u1, u2, u3)
