"""Image resampling with the reconstruction filters
(``mitsuba_im_tpu/film/resample.py``; the reference's ``Resampler``,
``rfilter.h:474``).

Separable filtered rescaling on the host: per output column and row a
dense weight table (the filter evaluated in float32 by
``film.filter_eval`` on the CPU, summed and normalised in float64), applied
as two matrix products.
"""
from __future__ import annotations

import numpy as np
import torch

from .film import DEFAULT_RADIUS, F_LANCZOS, filter_eval

BC_CLAMP = 0
BC_REPEAT = 1
BC_MIRROR = 2
BC_ZERO = 3


def _axis_weights(src: int, dst: int, ftype: int, radius: float | None,
                  bc: int):
    """(dst, src) dense weight matrix for one axis (rows sum to 1)."""
    if radius is None:
        radius = DEFAULT_RADIUS[ftype]
    scale = src / dst
    filt_scale = max(scale, 1.0)  # widen when minifying (rfilter.h:508)
    r = radius * filt_scale
    W = np.zeros((dst, src), np.float64)
    for o in range(dst):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - r))
        hi = int(np.ceil(center + r))
        idx = np.arange(lo, hi + 1)
        x = torch.from_numpy(((idx - center) / filt_scale).astype(np.float32))
        w = filter_eval(ftype, x, radius).numpy()
        if bc == BC_CLAMP:
            src_idx = np.clip(idx, 0, src - 1)
        elif bc == BC_REPEAT:
            src_idx = np.mod(idx, src)
        elif bc == BC_MIRROR:
            period = 2 * src
            m = np.mod(idx, period)
            src_idx = np.where(m >= src, period - 1 - m, m)
        else:  # BC_ZERO
            keep = (idx >= 0) & (idx < src)
            idx, w = idx[keep], w[keep]
            src_idx = idx
        np.add.at(W[o], src_idx, w)
        tot = W[o].sum()
        if tot > 0:
            W[o] /= tot
    return W.astype(np.float32)


def resample(img: np.ndarray, new_size: tuple[int, int],
             ftype: int = F_LANCZOS, radius: float | None = None,
             bc: int = BC_CLAMP, clamp_negative: bool = False) -> np.ndarray:
    """Rescale (H, W[, C]) to ``new_size`` = (new_w, new_h)."""
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    new_w, new_h = new_size
    Wx = _axis_weights(W, new_w, ftype, radius, bc)   # (new_w, W)
    Wy = _axis_weights(H, new_h, ftype, radius, bc)   # (new_h, H)
    out = np.einsum("ow,hwc->hoc", Wx, img)
    out = np.einsum("oh,hwc->owc", Wy, out)
    if clamp_negative:
        out = np.maximum(out, 0.0)
    return out[..., 0] if squeeze else out
