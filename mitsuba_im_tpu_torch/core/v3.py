"""Component-SoA 3-vectors over flat ``(N,)`` tensors
(``mitsuba_im_tpu/core/v3.py``).

Every 3-vector (and RGB spectrum) is a :class:`V3` of three flat tensors,
the JAX package's public layout.  The reference's select-chain table
lookups (``gather_col``/``gather_v3``, a TPU workaround) are plain indexing
here, and every row lookup of the BSDF and emitter tables (whose entries
are the gradient slots) goes through one function, :func:`gather_row`.

Gradients are the reference's: ``jnp.maximum(x, c)`` becomes
``torch.clamp_min`` (or ``torch.maximum`` where both sides vary), which
differ only at a tie (torch passes the whole derivative, JAX half); no
helper on the path ties in practice except a square root at 0, where both
derivatives are infinite, so :func:`safe_sqrt` takes 0 there.  Masked
lanes divide through the double ``where`` of :func:`safe_div`.
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

    def mean(self) -> torch.Tensor:
        return (self.x + self.y + self.z) * (1.0 / 3.0)

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

    def exp(self) -> "V3":
        return V3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    def clamp_min(self, lo: float) -> "V3":
        return V3(torch.clamp_min(self.x, lo), torch.clamp_min(self.y, lo),
                  torch.clamp_min(self.z, lo))


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def zeros(shape, device) -> V3:
    z = torch.zeros(shape, dtype=Float, device=device)
    return V3(z, z, z)


def ones(shape, device) -> V3:
    o = torch.ones(shape, dtype=Float, device=device)
    return V3(o, o, o)


def gather_row(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a scene table (a column (T,) or a (T, 3) table):
    the one lookup that the BSDF and emitter rows go through, so its form
    (plain indexing, whose backward is an ``index_put_``) is decided in one
    place."""
    return tab[idx]


def gather_v3(tab: torch.Tensor, idx: torch.Tensor) -> V3:
    """Row lookup of a (T, 3) table as a V3."""
    return V3.from_array(gather_row(tab, idx))


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


def frame_from_normal(n: V3) -> tuple[V3, V3, V3]:
    s, t = coordinate_system(n)
    return s, t, n


def to_local(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return V3(v.dot(s), v.dot(t), v.dot(n))


def to_world(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return s * v.x + t * v.y + n * v.z


def safe_div(a, b, fallback=0.0):
    zero = b == 0.0
    return torch.where(zero, fallback, a / torch.where(zero, 1.0, b))


def where_live(f, ok, args, safe):
    """f(*args), differentiated only where ``ok`` (a mask, or a function
    that makes it, called only when an argument requires grad).  Lanes that
    are not ok take f of the detached arguments; their differentiated
    branch evaluates f at ``safe``, where its derivative is finite, so no
    NaN arises even in a lane whose cotangent is zero.  The values are
    f(*args) everywhere."""
    if not any(isinstance(a, torch.Tensor) and a.requires_grad
               for a in args):
        return f(*args)
    if callable(ok):
        ok = ok()
    live = f(*(torch.where(ok, a, s) for a, s in zip(args, safe)))
    return torch.where(ok, live, f(*(a.detach() for a in args)))


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative is 0 where the root is 0."""

    @staticmethod
    def forward(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        r, = ctx.saved_tensors
        return torch.where(r > 0.0, g / torch.where(r > 0.0, 2.0 * r, 1.0),
                           0.0)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))``, the reference's form, with the derivative 0 (not
    inf, or NaN from a zero cotangent) where the root is 0: a masked lane
    at or below 0 then adds nothing to a gradient.  Elsewhere the
    reference's derivative, 1 / (2 sqrt(x))."""
    if x.requires_grad:
        return _SafeSqrt.apply(x)
    return torch.sqrt(torch.clamp_min(x, 0.0))


# Local-frame trig (z = cos_theta)
def sin_theta2(v: V3) -> torch.Tensor:
    return torch.clamp_min(1.0 - v.z * v.z, 0.0)


def sin_theta(v: V3) -> torch.Tensor:
    return safe_sqrt(sin_theta2(v))


def tan_theta(v: V3) -> torch.Tensor:
    return safe_div(sin_theta(v), v.z)


def tan_theta2(v: V3) -> torch.Tensor:
    return safe_div(sin_theta2(v), v.z * v.z, fallback=math.inf)


def sin_phi(v: V3) -> torch.Tensor:
    s = sin_theta(v)
    return torch.where(s == 0.0, 0.0, torch.clamp(safe_div(v.y, s), -1.0, 1.0))


def cos_phi(v: V3) -> torch.Tensor:
    s = sin_theta(v)
    return torch.where(s == 0.0, 1.0, torch.clamp(safe_div(v.x, s), -1.0, 1.0))


def reflect(wi: V3) -> V3:
    """Mirror reflection about local +z."""
    return V3(-wi.x, -wi.y, wi.z)


def reflect_n(wi: V3, n: V3) -> V3:
    return n * (2.0 * wi.dot(n)) - wi


def refract_n(wi: V3, n: V3, eta, cos_theta_t) -> V3:
    return n * (eta * wi.dot(n) + cos_theta_t) - wi * eta


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


# the largest float32 below 1: the top of the sampler's uniforms
ONE_MINUS_EPS = 1.0 - 2.0 ** -24


def uniform_disk_concentric_to_square(x: torch.Tensor, y: torch.Tensor):
    """The inverse of :func:`square_to_uniform_disk_concentric`, wedge by
    wedge: a point of the right or left wedge (|x| > |y|, the forward
    map's ``use_r1``) came from r1 = sign(x) rho, r2 = r1 (4 / pi)
    atan(y / x); one of the top or bottom wedge (ties included, as the
    forward map sends them there) from r2 = sign(y) rho, r1 = r2 (4 / pi)
    atan(x / y).  Returns (u1, u2) in [0, 1), clamped below 1 as the
    sampler's uniforms are; the centre maps to (1/2, 1/2).  The JAX
    package has no such inverse (ROADMAP C3)."""
    rho = torch.sqrt(x * x + y * y)
    use_r1 = torch.abs(x) > torch.abs(y)
    num = torch.where(use_r1, y, x)
    den = torch.where(use_r1, x, y)
    safe = torch.where(den == 0.0, 1.0, den)
    r = torch.where(den < 0.0, -rho, rho)
    r_other = r * torch.atan(num / safe) * (4.0 / PI)
    r1 = torch.where(use_r1, r, r_other)
    r2 = torch.where(use_r1, r_other, r)
    u1 = torch.clamp((r1 + 1.0) * 0.5, 0.0, ONE_MINUS_EPS)
    u2 = torch.clamp((r2 + 1.0) * 0.5, 0.0, ONE_MINUS_EPS)
    return u1, u2


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
