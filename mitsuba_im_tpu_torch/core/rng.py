"""Counter-based per-lane RNG (``mitsuba_im_tpu/core/rng.py``), bit for bit.

Every draw is a pure function of ``(seed, pixel, sample, dimension)``
through the PCG4D hash (Jarzynski & Olano, JCGT 2020).  PyTorch lacks
``add`` and ``>>`` for ``uint32`` on the CPU, so the 32-bit words ride in
int64 tensors holding values in [0, 2^32): every sum is masked back to 32
bits and every word-by-word product is split into 16-bit halves
(:func:`_mul32`) so no intermediate leaves the int64 range.  The words are
the reference's uint32 words exactly.

Only the INDEPENDENT sampler is ported; other kinds and the MCMC ``table``
mode raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

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
    """SoA sampler state: (N,) int64 tensors holding uint32 words."""

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
    if kind != INDEPENDENT:
        raise NotImplementedError(
            f"sampler kind {kind}: only INDEPENDENT is ported")
    pixel = pixel.to(torch.int64) & MASK32
    sample = _words(sample, pixel)
    seed = _words(seed, pixel.new_empty(()))
    b0, b1, b2, b3 = pcg4d_words(pixel, sample, seed.expand(pixel.shape),
                                 torch.full_like(pixel, 0x9E3779B9))
    return Sampler3(
        pixel=pixel, sample=sample, b0=b0, b1=b1, b2=b2, b3=b3,
        dim=torch.zeros_like(pixel), seed=seed, kind=kind, spp=spp,
    )


def next_block4_v(s: Sampler3):
    """Draw 4 dimensions with ONE hash; returns (sampler, (u0, u1, u2, u3))."""
    if s.table is not None or s.kind != INDEPENDENT:
        raise NotImplementedError(
            "next_block4_v: only the INDEPENDENT hash stream is ported")
    dim = ((s.dim + 3) & ~3) & MASK32
    s2 = s.replace(dim=(dim + 4) & MASK32)
    x, y, z, w = pcg4d_words(s.b0, s.b1, s.b2 ^ dim, s.b3)
    return s2, tuple(to_unit_float(t) for t in (x, y, z, w))
