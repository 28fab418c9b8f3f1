"""Component-SoA 3-vectors over flat ``(N,)`` tensors
(``mitsuba_im_tpu/core/v3.py``).

Every 3-vector (and RGB spectrum) is a :class:`V3` of three flat tensors,
the JAX package's public layout.  The reference's select-chain table
lookups (``gather_col``/``gather_v3``, a TPU workaround) are plain indexing
here: see :func:`gather_v3`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .types import Float

PI = math.pi
INV_PI = 1.0 / math.pi


class V3(NamedTuple):
    """A batch of 3-vectors stored as three flat component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """(..., 3) -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    # -- arithmetic (component-wise; scalars broadcast) --------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- reductions --------------------------------------------------------
    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def sum(self) -> torch.Tensor:
        return self.x + self.y + self.z

    def max_c(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def squared_norm(self) -> torch.Tensor:
        return self.dot(self)

    # -- vector ops ---------------------------------------------------------
    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def normalized(self) -> "V3":
        return self * torch.rsqrt(torch.clamp_min(self.squared_norm(), 1e-30))


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def zeros(shape, device) -> V3:
    z = torch.zeros(shape, dtype=Float, device=device)
    return V3(z, z, z)


def ones(shape, device) -> V3:
    o = torch.ones(shape, dtype=Float, device=device)
    return V3(o, o, o)


def gather_v3(tab: torch.Tensor, idx: torch.Tensor) -> V3:
    """Row lookup of a (T, 3) table as a V3 (plain indexing)."""
    return V3.from_array(tab[idx])


# ---------------------------------------------------------------------------
# Frames (reference include/mitsuba/core/frame.h) — a frame is (s, t, n)
# ---------------------------------------------------------------------------

def coordinate_system(n: V3) -> tuple[V3, V3]:
    """Branchless Duff et al. orthonormal basis around unit ``n``."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    s = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    t = V3(b, sign + n.y * n.y * a, -n.y)
    return s, t


def to_local(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return V3(v.dot(s), v.dot(t), v.dot(n))


def to_world(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return s * v.x + t * v.y + n * v.z


def safe_div(a, b, fallback=0.0):
    zero = b == 0.0
    return torch.where(zero, fallback, a / torch.where(zero, 1.0, b))


# Local-frame trig (z = cos_theta)
def sin_theta2(v: V3) -> torch.Tensor:
    return torch.clamp_min(1.0 - v.z * v.z, 0.0)


def tan_theta2(v: V3) -> torch.Tensor:
    return safe_div(sin_theta2(v), v.z * v.z, fallback=math.inf)


def reflect(wi: V3) -> V3:
    """Mirror reflection about local +z."""
    return V3(-wi.x, -wi.y, wi.z)


def reflect_n(wi: V3, n: V3) -> V3:
    return n * (2.0 * wi.dot(n)) - wi


def spherical_coordinates(d: V3) -> tuple[torch.Tensor, torch.Tensor]:
    theta = torch.arccos(torch.clamp(d.z, -1.0, 1.0))
    phi = torch.atan2(d.y, d.x)
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    return theta, phi


# ---------------------------------------------------------------------------
# Sampling warps (reference src/libcore/warp.cpp)
# ---------------------------------------------------------------------------

def square_to_uniform_disk_concentric(u1: torch.Tensor, u2: torch.Tensor):
    """Shirley-Chiu concentric disk mapping."""
    r1 = 2.0 * u1 - 1.0
    r2 = 2.0 * u2 - 1.0
    zero = (r1 == 0.0) & (r2 == 0.0)
    use_r1 = torch.abs(r1) > torch.abs(r2)
    r = torch.where(use_r1, r1, r2)
    safe = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(
        use_r1,
        (PI / 4.0) * (r2 / safe),
        (PI / 2.0) - (r1 / safe) * (PI / 4.0),
    )
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def square_to_cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Concentric-disk lift."""
    px, py = square_to_uniform_disk_concentric(u1, u2)
    z = torch.sqrt(torch.clamp_min(1.0 - px * px - py * py, 0.0))
    return V3(px, py, z)


def square_to_cosine_hemisphere_pdf(d: V3) -> torch.Tensor:
    return torch.clamp_min(d.z, 0.0) * INV_PI


def square_to_uniform_sphere(u1: torch.Tensor, u2: torch.Tensor) -> V3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_triangle(u1: torch.Tensor, u2: torch.Tensor):
    a = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return 1.0 - a, a * u2
