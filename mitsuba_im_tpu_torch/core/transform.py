"""Host-side 4x4 transforms (the numpy part of
``mitsuba_im_tpu/core/transform.py``): the constructors, composition and
point/vector/normal application that sensors, emitters, shapes and the
scene loader need."""
from __future__ import annotations

import numpy as np


class Transform:
    """Immutable host-side 4x4 transform (float64) with cached inverse."""

    __slots__ = ("m", "inv")

    def __init__(self, m=None, inv=None):
        self.m = np.eye(4) if m is None else np.asarray(m, dtype=np.float64)
        self.inv = (np.linalg.inv(self.m) if inv is None
                    else np.asarray(inv, np.float64))

    @staticmethod
    def translate(v):
        m = np.eye(4)
        m[:3, 3] = v
        i = np.eye(4)
        i[:3, 3] = -np.asarray(v, np.float64)
        return Transform(m, i)

    @staticmethod
    def scale(v):
        v = np.broadcast_to(np.asarray(v, np.float64), (3,))
        m = np.diag(np.concatenate([v, [1.0]]))
        i = np.diag(np.concatenate([1.0 / v, [1.0]]))
        return Transform(m, i)

    @staticmethod
    def rotate(axis, angle_deg):
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R3 = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
        m = np.eye(4)
        m[:3, :3] = R3
        return Transform(m, m.T)

    @staticmethod
    def look_at(origin, target, up):
        """Camera-to-world: +z toward target, x = cross(up, dir) as in the
        reference ``transform.h`` lookAt."""
        origin = np.asarray(origin, np.float64)
        d = np.asarray(target, np.float64) - origin
        d = d / np.linalg.norm(d)
        left = np.cross(np.asarray(up, np.float64) / np.linalg.norm(up), d)
        left = left / np.linalg.norm(left)
        new_up = np.cross(d, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform(m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.inv @ self.inv)

    def apply_point(self, p):
        p = np.asarray(p, np.float64)
        return p @ self.m[:3, :3].T + self.m[:3, 3]

    def apply_vector(self, v):
        return np.asarray(v, np.float64) @ self.m[:3, :3].T

    def apply_normal(self, n):
        return np.asarray(n, np.float64) @ self.inv[:3, :3]

    def det3(self) -> float:
        return float(np.linalg.det(self.m[:3, :3]))
