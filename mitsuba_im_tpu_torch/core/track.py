"""Keyframed animation tracks and the animated transform
(``mitsuba_im_tpu/core/track.py``, a copy: host numpy on the port's
``core/transform.py``).

Mitsuba's ``AnimatedTransform`` (``include/mitsuba/core/track.h``):
per-key translation, rotation (a quaternion, slerped) and scale, composed
into a rigid transform evaluated at a time.  The ``motion`` integrator
evaluates its sensor animation once a render, at ``-time_delta``, for the
previous pose (``render/job.py::integrator_fn``).
"""
from __future__ import annotations

import numpy as np

from .transform import Transform


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / max(np.linalg.norm(q), 1e-12)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


class AnimationTrack:
    """Scalar/vector keyframe track with linear interpolation
    (AbstractAnimationTrack, track.h)."""

    def __init__(self, times, values):
        self.times = np.asarray(times, np.float64)
        self.values = np.asarray(values, np.float64)
        assert len(self.times) == len(self.values)

    def eval(self, t: float) -> np.ndarray:
        ts = self.times
        if t <= ts[0]:
            return self.values[0]
        if t >= ts[-1]:
            return self.values[-1]
        i = int(np.searchsorted(ts, t, side="right") - 1)
        a = (t - ts[i]) / max(ts[i + 1] - ts[i], 1e-12)
        return (1 - a) * self.values[i] + a * self.values[i + 1]


class AnimatedTransform:
    """Keyframed rigid transform: per-key TRS decomposition, slerp-ed
    rotation + lerp-ed translation/scale (AnimatedTransform, track.h).

    Built either from explicit keyframe ``Transform``s or track triples.
    """

    def __init__(self, times, transforms):
        self.times = np.asarray(times, np.float64)
        self.translations = []
        self.rotations = []
        self.scales = []
        for tr in transforms:
            M = np.asarray(tr.m, np.float64)
            T = M[:3, 3].copy()
            R = M[:3, :3]
            # polar-ish decomposition: scale = column norms (axis-aligned
            # scale assumption, matching the reference's TRS tracks)
            s = np.linalg.norm(R, axis=0)
            s = np.where(s < 1e-12, 1.0, s)
            Rn = R / s
            self.translations.append(T)
            self.rotations.append(_quat_from_matrix(Rn))
            self.scales.append(s)
        self.translations = np.asarray(self.translations)
        self.rotations = np.asarray(self.rotations)
        self.scales = np.asarray(self.scales)

    @property
    def static(self) -> bool:
        return len(self.times) == 1

    def eval(self, t: float) -> Transform:
        ts = self.times
        if t <= ts[0] or self.static:
            i0 = i1 = 0
            a = 0.0
        elif t >= ts[-1]:
            i0 = i1 = len(ts) - 1
            a = 0.0
        else:
            i0 = int(np.searchsorted(ts, t, side="right") - 1)
            i1 = i0 + 1
            a = (t - ts[i0]) / max(ts[i1] - ts[i0], 1e-12)
        T = (1 - a) * self.translations[i0] + a * self.translations[i1]
        S = (1 - a) * self.scales[i0] + a * self.scales[i1]
        q = slerp(self.rotations[i0], self.rotations[i1], a)
        M = np.eye(4)
        M[:3, :3] = _quat_to_matrix(q) * S
        M[:3, 3] = T
        return Transform(M)
