"""Host-side 4x4 transforms (the numpy part of
``mitsuba_im_tpu/core/transform.py`` that the sensor needs: ``look_at``)."""
from __future__ import annotations

import numpy as np


class Transform:
    """Immutable host-side 4x4 transform (float64)."""

    __slots__ = ("m",)

    def __init__(self, m=None):
        self.m = np.eye(4) if m is None else np.asarray(m, dtype=np.float64)

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
