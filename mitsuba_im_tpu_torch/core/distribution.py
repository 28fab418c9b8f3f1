"""Discrete 2D distribution for importance sampling an environment map
(``mitsuba_im_tpu/core/distribution.py::Distribution2D``).

The rows' marginal and each row's conditional are Walker/Vose alias tables,
built on the host by ``csrc/alias_build.cpp`` (the reference's native
builder, copied; g++ at first use, no fallback: a failed build raises).  A
sample is O(1): two gathers and a compare per level, the uniform of each
level reused for the offset inside the texel.  The reference's CDF path
(its fallback for hosts without the native library) is not ported.

``from_weights`` computes the pmfs in float32 with the sums in XLA's CPU
order (windows of 32 summed in sequence), so the tables equal the JAX
package's bit for bit for maps whose width and height are multiples of 32
or at most 32 (every lat-long map the port bakes).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..accel.shared_lib import SharedLibrary, cxx
from .types import Float, Int, host_tensor

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
LD_FLAGS = ("-shared", "-lpthread")


def _bind(lib):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.mitpu_build_alias_rows.argtypes = [i64, i64, p, p, p]
    lib.mitpu_build_alias_rows.restype = None


LIBRARY = SharedLibrary("alias_build.cpp", cxx, CXX_FLAGS, _bind, LD_FLAGS)


def build_alias_rows(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Alias tables over the rows of an (H, W) weight matrix: (prob (H, W)
    float32 acceptance thresholds, alias (H, W) int32 donors)."""
    w = np.ascontiguousarray(w, np.float32)
    H, W = w.shape
    prob = np.empty((H, W), np.float32)
    alias = np.empty((H, W), np.int32)
    LIBRARY.load().mitpu_build_alias_rows(
        H, W, w.ctypes.data_as(ctypes.c_void_p),
        prob.ctypes.data_as(ctypes.c_void_p),
        alias.ctypes.data_as(ctypes.c_void_p))
    return prob, alias


def _row_sums(w: np.ndarray) -> np.ndarray:
    """float32 sums over the last axis of a 2D array, in XLA's CPU order:
    rows longer than 32 are cut into windows of 32 (the last one padded
    with zeros), each window is summed in sequence, and the window sums are
    summed the same way."""
    w = np.asarray(w, np.float32)
    while w.shape[1] > 32:
        n = -(-w.shape[1] // 32)
        pad = np.zeros((w.shape[0], n * 32), np.float32)
        pad[:, :w.shape[1]] = w
        w = _row_sums(pad.reshape(-1, 32)).reshape(w.shape[0], n)
    acc = np.zeros(w.shape[0], np.float32)
    for j in range(w.shape[1]):
        acc = acc + w[:, j]
    return acc


@dataclasses.dataclass(frozen=True)
class Distribution2D:
    """Row-major 2D sampling table: sample v from the marginal over rows,
    then u from the row's conditional; the continuous variant returns (u, v)
    in [0, 1)^2 and the density with respect to the unit square."""

    marg_pmf: torch.Tensor  # (H,)
    cond_pmf: torch.Tensor  # (H, W)
    marg_aprob: torch.Tensor  # (H,)
    marg_alias: torch.Tensor  # (H,) int32
    cond_aprob: torch.Tensor  # (H, W)
    cond_alias: torch.Tensor  # (H, W) int32

    @staticmethod
    def arrays_from_weights(w) -> dict:
        """The tables of an (H, W) weight matrix as numpy arrays (the
        reference's ``from_weights`` arithmetic)."""
        w = np.asarray(w, np.float32)
        H, W = w.shape
        row_sum = _row_sums(w)
        safe_rows = np.where(row_sum > 0, row_sum, np.float32(1.0))
        cond_pmf = np.where(row_sum[:, None] > 0, w / safe_rows[:, None],
                            np.float32(1.0 / W)).astype(np.float32)
        total = _row_sums(row_sum[None])[0]
        marg_pmf = ((row_sum / total) if total > 0
                    else np.full(H, 1.0 / H)).astype(np.float32)
        mprob, malias = build_alias_rows(
            (row_sum if total > 0 else np.ones(H, np.float32))[None])
        cprob, calias = build_alias_rows(w)
        return dict(marg_pmf=marg_pmf, cond_pmf=cond_pmf,
                    marg_aprob=mprob[0], marg_alias=malias[0],
                    cond_aprob=cprob, cond_alias=calias)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "Distribution2D":
        return Distribution2D(**{
            k: host_tensor(a, np.int32 if k.endswith("alias") else np.float32,
                           device) for k, a in arrays.items()})

    def sample_continuous(self, u1: torch.Tensor, u2: torch.Tensor):
        """Two-level alias sample (the reference's ``_sample_alias``): u2
        picks the row, u1 the column, and each is reused for the offset
        inside the texel.  Returns (u, v, pdf)."""
        H, W = self.cond_pmf.shape
        x2 = torch.clamp(u2, 0.0, 1.0 - 1e-7) * H
        j2 = torch.clamp(x2.to(Int), 0, H - 1)
        f2 = x2 - j2.to(Float)
        pj = self.marg_aprob[j2]
        keep2 = f2 < pj
        row = torch.where(keep2, j2, self.marg_alias[j2])
        dv = torch.where(keep2, f2 / torch.clamp_min(pj, 1e-20),
                         (f2 - pj) / torch.clamp_min(1.0 - pj, 1e-20))
        # an offset that rounds to 1.0 would land in the neighbouring texel,
        # whose pdf is not the one reported
        vv = (row.to(Float) + torch.clamp(dv, 0.0, 0.9995)) / H

        x1 = torch.clamp(u1, 0.0, 1.0 - 1e-7) * W
        j1 = torch.clamp(x1.to(Int), 0, W - 1)
        f1 = x1 - j1.to(Float)
        flat1 = row * W + j1
        pc = self.cond_aprob.reshape(-1)[flat1]
        keep1 = f1 < pc
        col = torch.where(keep1, j1, self.cond_alias.reshape(-1)[flat1])
        du = torch.where(keep1, f1 / torch.clamp_min(pc, 1e-20),
                         (f1 - pc) / torch.clamp_min(1.0 - pc, 1e-20))
        uu = (col.to(Float) + torch.clamp(du, 0.0, 0.9995)) / W
        pdf = (self.marg_pmf[row] * H
               * self.cond_pmf.reshape(-1)[row * W + col] * W)
        return uu, vv, pdf

    def pdf_continuous(self, uu: torch.Tensor, vv: torch.Tensor):
        """Density of ``sample_continuous`` at (u, v), per unit square."""
        H, W = self.cond_pmf.shape
        col = torch.clamp((uu * W).to(Int), 0, W - 1)
        row = torch.clamp((vv * H).to(Int), 0, H - 1)
        return self.marg_pmf[row] * H * self.cond_pmf[row, col] * W
