"""Irawan & Marschner woven-cloth BRDF (``mitsuba_im_tpu/bsdf/irawan.py``,
``irawan.cpp``): a weave pattern tiles the uv plane into warp and weft yarn
segments; each segment gets a curved-cylinder specular highlight (filament
or staple yarn) over a diffuse floor, with optional correlated noise on
the inclination angle and per-fiber intensity variation.

The weave description is static scene data: the parser (the reference's
DSL, ``$var`` substitution and ``/* */`` comments included, angles in
degrees) is the reference's host Python, copied; a pattern's per-cell yarn
parameters are select chains of constants over the lane's cell, as in the
reference.  The TEA hash works on uint32 words held in int64 tensors
(masked back to 32 bits after each sum, as ``core/rng.py``), and gives the
reference's words bit for bit; so does the 1-D Perlin noise.  The
specular normalization (:func:`compute_normalization`) averages 10,000
float32 samples of the initialization pass as the reference does, summed
in PyTorch's order on the CPU: it agrees with the reference's within rel
1e-5, not bit for bit (the bridge carries the reference's across).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re

import numpy as np
import torch

from ..core import v3 as v
from ..core.v3 import V3

INV_PI = 1.0 / np.pi
WARP, WEFT = 0, 1
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Yarn:
    """One yarn segment prototype (irawan.h struct Yarn); angles in
    radians, kd/ks as linear-RGB tuples."""
    type: int = WARP
    psi: float = 0.0
    umax: float = 0.0
    kappa: float = 0.0
    width: float = 0.0
    length: float = 0.0
    centerU: float = 0.0
    centerV: float = 0.0
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class WeavePattern:
    """Weave description (irawan.h struct WeavePattern) and the instance's
    repeatU/V and specular normalization; hashable static data."""
    name: str = ""
    alpha: float = 0.0
    beta: float = 0.0
    ss: float = 0.0
    hWidth: float = 0.0
    warpArea: float = 0.0
    weftArea: float = 0.0
    tileWidth: int = 1
    tileHeight: int = 1
    dWarpUmaxOverDWarp: float = 0.0
    dWarpUmaxOverDWeft: float = 0.0
    dWeftUmaxOverDWarp: float = 0.0
    dWeftUmaxOverDWeft: float = 0.0
    fineness: float = 0.0
    period: float = 0.0
    pattern: tuple = (1,)
    yarns: tuple = (Yarn(),)
    repeatU: float = 1.0
    repeatV: float = 1.0
    normalization: float = 1.0

    @staticmethod
    def from_dict(d: dict) -> "WeavePattern":
        """A pattern from ``dataclasses.asdict`` of this or the reference's
        record (yarns as dicts)."""
        d = dict(d)
        d["yarns"] = tuple(Yarn(**{k: tuple(x) if isinstance(x, list) else x
                                   for k, x in y.items()})
                           for y in d["yarns"])
        d["pattern"] = tuple(d["pattern"])
        return WeavePattern(**d)


# ---------------------------------------------------------------------------
# DSL parser (irawan.h SkipGrammar/YarnGrammar/WeavePatternGrammar)
# ---------------------------------------------------------------------------

_DEG_KEYS_YARN = ("psi", "umax")
_DEG_KEYS_WEAVE = ("dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
                   "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft")


def _strip_comments(text: str) -> str:
    return re.sub(r"/\*.*?\*/", " ", text, flags=re.S)


def _value(tok: str, props):
    tok = tok.strip()
    if tok.startswith("$"):
        if props is None:
            raise ValueError(f"weave parameter {tok} needs Properties")
        return props.get_float(tok[1:])
    return float(tok)


def _spectrum(tok: str, props):
    tok = tok.strip()
    if tok.startswith("$"):
        return tuple(float(x) for x in np.asarray(props.get_spectrum(tok[1:])))
    m = re.match(r"\{([^}]*)\}", tok)
    if not m:
        raise ValueError(f"bad spectrum literal: {tok!r}")
    parts = [float(x) for x in m.group(1).split(",")]
    return tuple(parts[:3])


def _split_top(body: str) -> list[str]:
    """Split on commas at brace depth 0."""
    out, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


def _match_block(text: str, start: int) -> tuple[str, int]:
    """Return (contents, end_index) of the brace block opening at/after
    ``start``."""
    i = text.index("{", start)
    depth, j = 1, i + 1
    while depth:
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
        j += 1
    return text[i + 1:j - 1], j


def parse_weave(text: str, props=None, repeatU=1.0,
                repeatV=1.0) -> WeavePattern:
    """Parse the reference weave-pattern DSL into a WeavePattern."""
    text = _strip_comments(text)
    m = re.search(r"\bweave\b", text)
    if not m:
        raise ValueError("no 'weave { ... }' block found")
    body, _ = _match_block(text, m.end())

    fields: dict = {}
    yarns: list[Yarn] = []
    pattern: tuple = ()
    for item in _split_top(body):
        item = item.strip()
        if not item:
            continue
        if item.startswith("yarn"):
            ybody, _ = _match_block(item, 4)
            yf: dict = {}
            for kv in _split_top(ybody):
                if not kv.strip():
                    continue
                k, _, val = kv.partition("=")
                k = k.strip()
                val = val.strip()
                if k == "type":
                    yf["type"] = WARP if val == "warp" else WEFT
                elif k in ("kd", "ks"):
                    yf[k] = _spectrum(val, props)
                else:
                    x = _value(val, props)
                    if k in _DEG_KEYS_YARN:
                        x = x * np.pi / 180.0
                    yf[k] = x
            yarns.append(Yarn(**yf))
        elif item.startswith("pattern"):
            pbody, _ = _match_block(item, 7)
            pattern = tuple(int(x) for x in pbody.replace("\n", " ")
                            .split(",") if x.strip())
        else:
            k, _, val = item.partition("=")
            k = k.strip()
            val = val.strip()
            if k == "name":
                fields["name"] = val.strip().strip('"')
            elif k in ("tileWidth", "tileHeight"):
                fields[k] = int(float(val))
            else:
                x = _value(val, props)
                if k in _DEG_KEYS_WEAVE:
                    x = x * np.pi / 180.0
                fields[k] = x

    pat = WeavePattern(pattern=pattern, yarns=tuple(yarns),
                       repeatU=repeatU, repeatV=repeatV, **fields)
    if len(pat.pattern) != pat.tileWidth * pat.tileHeight:
        raise ValueError("pattern size != tileWidth * tileHeight")
    for pv in pat.pattern:
        if not (0 < pv <= len(pat.yarns)):
            raise ValueError(f"pattern entry {pv} out of yarn range")
    return pat


# A synthetic plain-weave preset (1/1 checkerboard interlacing) so the
# plugin works without an external pattern file; parameter magnitudes
# follow the model's documented ranges (irawan.h comments).
PLAIN_WEAVE = """
weave {
  name = "built-in plain weave",
  /* Fiber scattering */
  alpha = 0.3, beta = 6.0, ss = 0.0, hWidth = 0.5,
  warpArea = 1.0, weftArea = 1.0,
  tileWidth = 2, tileHeight = 2,
  fineness = 0.0, period = 0.0,
  pattern { 1, 2, 2, 1 },
  yarn { type = warp, psi = 0, umax = 35, kappa = 0.5,
         width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
         kd = {0.3, 0.3, 0.3}, ks = {0.4, 0.4, 0.4} },
  yarn { type = weft, psi = 0, umax = 35, kappa = 0.5,
         width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
         kd = {0.3, 0.3, 0.3}, ks = {0.4, 0.4, 0.4} }
}
"""


# ---------------------------------------------------------------------------
# Numeric helpers (qmc.h sampleTEA, libcore noise.cpp Perlin, irawan.cpp
# vonMises/seeliger/radiusOfCurvature)
# ---------------------------------------------------------------------------

def _words(x) -> torch.Tensor:
    return (x.to(torch.int64) if isinstance(x, torch.Tensor)
            else torch.as_tensor(x, dtype=torch.int64)) & MASK32


def sample_tea_float(v0, v1, rounds: int = 8) -> torch.Tensor:
    """TEA-hash uniform in [0, 1) of two uint32 words (qmc.h:146-183;
    irawan uses 8 rounds), the words in int64 tensors."""
    v0, v1 = _words(v0), _words(v1)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & MASK32)
                    ^ ((v1 + s) & MASK32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & MASK32))) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & MASK32)
                    ^ ((v0 + s) & MASK32)
                    ^ (((v0 >> 5) + 0x7E95761E) & MASK32))) & MASK32
    bits = ((v0 >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


# Ken Perlin's reference permutation (public domain, "Improved Noise").
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3,
    64, 52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85,
    212, 207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170,
    213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43,
    172, 9, 129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185,
    112, 104, 218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191,
    179, 162, 241, 81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31,
    181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150,
    254, 138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195,
    78, 66, 215, 61, 156, 180,
], np.int32)
# 1D slice of improved Perlin noise (y=z=0): lattice gradients reduce to
# grad(hash(X), x-lattice) with the standard 12-direction gradient set.
_H0 = _PERM[(_PERM[_PERM % 256] % 256)]  # hash of (X, 0, 0) per lattice X


def _grad1(h, x):
    """grad() of improved noise at y = z = 0: only the gradients with a +-x
    term contribute."""
    h = h & 15
    u = torch.where(h < 8, x, 0.0)
    vv = torch.where((h == 12) | (h == 14), x, 0.0)
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, vv, -vv))


def perlin_noise_1d(x: torch.Tensor) -> torch.Tensor:
    """Improved Perlin noise at (x, 0, 0) (libcore noise.cpp)."""
    xf = torch.floor(x)
    xi = xf.to(torch.int32) & 255
    xr = x - xf
    fade = xr * xr * xr * (xr * (xr * 6.0 - 15.0) + 10.0)
    h0tab = torch.as_tensor(_H0, dtype=torch.int32, device=x.device)
    h0 = h0tab[xi.long()]
    h1 = h0tab[((xi + 1) & 255).long()]
    g0 = _grad1(h0, xr)
    g1 = _grad1(h1, xr - 1.0)
    return g0 + fade * (g1 - g0)


def _von_mises(cos_x, b):
    """Von Mises pdf with I0 by the Abramowitz-Stegun polynomial
    (irawan.cpp vonMises); ``b`` a number."""
    absB = abs(float(b))
    if absB <= 3.75:
        t = (absB / 3.75) ** 2
        i0 = 1.0 + t * (3.5156229 + t * (3.0899424 + t * (1.2067492
              + t * (0.2659732 + t * (0.0360768 + t * 0.0045813)))))
    else:
        t = 3.75 / absB
        i0 = (np.exp(absB) / np.sqrt(absB)) * (0.39894228 + t * (0.01328592
              + t * (0.00225319 + t * (-0.00157565 + t * (0.00916281
              + t * (-0.02057706 + t * (0.02635537 + t * (-0.01647633
              + t * 0.00392377))))))))
    return torch.exp(b * cos_x) / float(2.0 * np.pi * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger attenuation, albedo 1 (irawan.cpp seeliger)."""
    c1 = torch.clamp_min(c1, 0.0)
    c2 = torch.clamp_min(c2, 0.0)
    return torch.where((c1 > 0.0) & (c2 > 0.0),
                       (1.0 / (4.0 * np.pi)) * c1 * c2
                       / torch.clamp_min(c1 + c2, 1e-20), 0.0)


def _smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _atanh(z):
    return 0.5 * torch.log(torch.clamp_min(
        (1.0 + z) / torch.clamp_min(1.0 - z, 1e-20), 1e-20))


def _radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature by the sign of rhat: circle, ellipse,
    hyperbola or parabola (irawan.cpp radiusOfCurvature; thesis 5.3), each
    branch on guarded inputs and the lane's selected."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / torch.tan(umax))
    a = 0.5 * w
    sin_umax = torch.sin(umax)

    r_circle = (0.5 * l - a * sin_umax) / torch.clamp_min(sin_umax, 1e-20)

    rh_e = torch.clamp_min(rhat, 1e-6)
    tmax_e = torch.atan(rh_e * torch.tan(umax))
    bhat_e = (0.5 * l - a * sin_umax) / torch.clamp_min(torch.sin(tmax_e),
                                                        1e-20)
    ahat_e = bhat_e / rh_e
    t_e = torch.atan(rh_e * torch.tan(u))
    r_ellipse = (bhat_e ** 2 * torch.cos(t_e) ** 2
                 + ahat_e ** 2 * torch.sin(t_e) ** 2) ** 1.5 \
        / torch.clamp_min(ahat_e * bhat_e, 1e-20)

    rh_h = torch.clamp_max(rhat, -1e-6)
    th = torch.clamp(rh_h * torch.tan(umax), -0.999999, 0.999999)
    tmax_h = -_atanh(th)
    bhat_h = (0.5 * l - a * sin_umax) / torch.clamp_min(torch.sinh(tmax_h),
                                                        1e-20)
    ahat_h = bhat_h / rh_h
    t_h = -_atanh(torch.clamp(rh_h * torch.tan(u), -0.999999, 0.999999))
    r_hyper = -(bhat_h ** 2 * torch.cosh(t_h) ** 2
                + ahat_h ** 2 * torch.sinh(t_h) ** 2) ** 1.5 \
        / (ahat_h * bhat_h)

    tmax_p = torch.tan(umax)
    ahat_p = (0.5 * l - a * sin_umax) / torch.clamp_min(2.0 * tmax_p, 1e-20)
    t_p = torch.tan(u)
    r_parab = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    return torch.where(
        rhat == 1.0, r_circle,
        torch.where(rhat > 0.0, r_ellipse,
                    torch.where(rhat < 0.0, r_hyper, r_parab)))


# ---------------------------------------------------------------------------
# Per-cell parameter tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cell_tables(pat: WeavePattern):
    """The pattern's cells -> per-cell yarn parameter arrays (numpy)."""
    yid = np.asarray(pat.pattern, np.int32) - 1
    ys = pat.yarns
    col = lambda f: np.asarray([f(ys[i]) for i in yid], np.float32)  # noqa
    return dict(
        is_weft=col(lambda y: float(y.type == WEFT)),
        psi=col(lambda y: y.psi),
        umax=col(lambda y: y.umax),
        kappa=col(lambda y: y.kappa),
        w=col(lambda y: y.width),
        l=col(lambda y: y.length),
        centerU=col(lambda y: y.centerU),
        centerV=col(lambda y: y.centerV),
        kd=np.asarray([ys[i].kd for i in yid], np.float32),
        ks=np.asarray([ys[i].ks for i in yid], np.float32),
    )


def _cell_select(cell, arr):
    """Per-lane select chain over the (small) cell table ``arr``."""
    out = torch.full(cell.shape, float(arr[0]), dtype=torch.float32,
                     device=cell.device)
    for i in range(1, arr.shape[0]):
        out = torch.where(cell == i, float(arr[i]), out)
    return out


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def eval_pattern(pat: WeavePattern, uv_u, uv_v, wi: V3, wo: V3,
                 initialization: bool = False):
    """Cloth BRDF f(wi, wo) cos(wo) of one weave pattern (irawan.cpp eval),
    directions in the local shading frame.  ``initialization`` returns the
    unnormalized specular scalar of the normalization pre-pass."""
    tw, th = pat.tileWidth, pat.tileHeight
    tab = _cell_tables(pat)

    uu = uv_u * pat.repeatU
    vv = (1.0 - uv_v) * pat.repeatV
    x = uu * tw
    y = vv * th
    xi = torch.floor(x)
    yi = torch.floor(y)
    lx = torch.remainder(xi.to(torch.int32), tw)
    ly = torch.remainder(yi.to(torch.int32), th)
    cell = lx + ly * tw

    def g(k):
        return _cell_select(cell, tab[k])

    is_weft = g("is_weft") > 0.5
    psi = g("psi")
    umax = g("umax")
    kappa = g("kappa")
    w_ = g("w")
    l_ = g("l")

    cx = torch.floor(xi / tw) * tw + g("centerU") * tw
    cy = torch.floor(yi / th) * th + (1.0 - g("centerV")) * th
    rx = x - cx
    ry = -(y - cy)

    # weft: rotate coordinates and directions by pi/2 about z
    xx = torch.where(is_weft, -ry, rx)
    yy = torch.where(is_weft, rx, ry)
    om_i = V3(torch.where(is_weft, -wi.y, wi.x),
              torch.where(is_weft, wi.x, wi.y), wi.z)
    om_r = V3(torch.where(is_weft, -wo.y, wo.x),
              torch.where(is_weft, wo.x, wo.y), wo.z)

    if pat.period > 0.0:
        # correlated noise on the inclination angle
        pos_x = cx.to(torch.int64)
        pos_y = cy.to(torch.int64)
        r1 = perlin_noise_1d(
            (cx * (th * pat.repeatV + sample_tea_float(pos_x, 2 * pos_y))
             + cy) / pat.period)
        r2 = perlin_noise_1d(
            (cy * (tw * pat.repeatU + sample_tea_float(pos_x, 2 * pos_y + 1))
             + cx) / pat.period)
        d_warp = torch.where(is_weft, pat.dWeftUmaxOverDWarp,
                             pat.dWarpUmaxOverDWarp)
        d_weft = torch.where(is_weft, pat.dWeftUmaxOverDWeft,
                             pat.dWarpUmaxOverDWeft)
        umax = umax + r1 * d_warp + r2 * d_weft

    u_ = yy / (l_ / 2.0) * umax
    v_ = xx * np.pi / w_

    stap = fil = None
    if any(y.psi != 0.0 for y in pat.yarns):
        stap = _staple_integrand(pat, u_, v_, om_i, om_r, psi, umax, kappa,
                                 w_, l_)
    if any(y.psi == 0.0 for y in pat.yarns):
        fil = _filament_integrand(pat, u_, v_, om_i, om_r, umax, kappa, w_,
                                  l_)
    if stap is None:
        integrand = fil
    elif fil is None:
        integrand = stap
    else:
        integrand = torch.where(psi != 0.0, stap, fil)

    if pat.fineness > 0.0:
        # per-fiber intensity variation
        i1 = ((cx + xx) * pat.fineness).to(torch.int64)
        i2 = ((cy + yy) * pat.fineness).to(torch.int64)
        xi_ = sample_tea_float(i1, i2)
        iv = torch.clamp_max(-torch.log(torch.clamp_min(xi_, 1e-20)), 10.0)
    else:
        iv = 1.0

    ratio = torch.where(
        is_weft,
        (pat.warpArea + pat.weftArea) / max(pat.weftArea, 1e-20),
        (pat.warpArea + pat.weftArea) / max(pat.warpArea, 1e-20))
    spec_scalar = iv * integrand * ratio

    front = (wi.z > 0.0) & (wo.z > 0.0)
    if initialization:
        return torch.where(front, spec_scalar, 0.0)

    ks = V3(*(_cell_select(cell, tab["ks"][:, c]) for c in range(3)))
    kd = V3(*(_cell_select(cell, tab["kd"][:, c]) for c in range(3)))
    out = (ks * (spec_scalar * pat.normalization) + kd * INV_PI) * wo.z
    return v.where(front, out, v.zeros(uv_u.shape, uv_u.device))


def _norm(a: V3):
    return torch.sqrt(a.squared_norm())


def _filament_integrand(pat, u_, v_, om_i, om_r, umax, kappa, w_, l_):
    """irawan.cpp evalFilamentIntegrand (psi = 0 yarns)."""
    ss = pat.ss
    if ss < 0.0 or ss >= 1.0:
        return torch.zeros_like(u_)

    h = (om_r + om_i).normalized()
    u_of_v = torch.atan2(h.y, torch.clamp_min(h.z, 1e-20))
    in_range = torch.abs(u_of_v) < umax

    n = V3(torch.sin(v_), torch.sin(u_of_v) * torch.cos(v_),
           torch.cos(u_of_v) * torch.cos(v_)).normalized()
    t = V3(torch.zeros_like(u_of_v), torch.cos(u_of_v),
           -torch.sin(u_of_v)).normalized()

    R = _radius_of_curvature(
        torch.minimum(torch.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w_, l_)

    a = 0.5 * w_
    s = om_i + om_r
    tch_x = t.cross(h).x
    Gu = a * (R + a * torch.cos(v_)) \
        / torch.clamp_min(_norm(s) * torch.abs(tch_x), 1e-20)

    fc = pat.alpha + _von_mises(-om_i.dot(om_r), pat.beta)
    A = _seeliger(n.dot(om_i), n.dot(om_r))
    if ss == 0.0:
        As = A
    else:
        As = A * (1.0 - _smoothstep(
            (torch.abs(u_of_v) - (1.0 - ss) * umax) / (ss * umax)))
    fs = Gu * fc * As * np.pi * l_

    delta_y = l_ * pat.hWidth
    y_of_v = torch.clamp(u_of_v * 0.5 * l_ / umax,
                         0.5 * (delta_y - l_), 0.5 * (l_ - delta_y))
    on_highlight = torch.abs(y_of_v - u_ * 0.5 * l_ / umax) < 0.5 * delta_y

    ok = (in_range & on_highlight & (w_ * torch.sin(umax) < l_)
          & (kappa >= -1.0))
    return torch.where(ok, fs / torch.clamp_min(delta_y, 1e-20), 0.0)


def _staple_integrand(pat, u_, v_, om_i, om_r, psi, umax, kappa, w_, l_):
    """irawan.cpp evalStapleIntegrand (psi != 0 yarns)."""
    h = (om_i + om_r).normalized()
    su, cu = torch.sin(u_), torch.cos(u_)
    tan_psi = torch.tan(torch.where(psi == 0.0, 1.0, psi))
    D = (h.y * cu - h.z * su) / torch.clamp_min(
        torch.sqrt(h.x ** 2 + (h.y * su + h.z * cu) ** 2)
        * torch.abs(tan_psi), 1e-20) * torch.sign(tan_psi)
    Dc = torch.clamp(D, -1.0, 1.0)
    v_of_u = torch.atan2(-h.y * su - h.z * cu, h.x) + torch.acos(Dc)
    in_range = (torch.abs(D) < 1.0) & (torch.abs(v_of_u) < np.pi / 2.0)

    n = V3(torch.sin(v_of_u), su * torch.cos(v_of_u),
           cu * torch.cos(v_of_u)).normalized()

    R = _radius_of_curvature(torch.abs(u_), umax, kappa, w_, l_)
    a = 0.5 * w_
    s = om_i + om_r
    Gv = a * (R + a * torch.cos(v_of_u)) / torch.clamp_min(
        _norm(s) * torch.abs(n.dot(h)) * torch.abs(torch.sin(psi)), 1e-20)

    fc = pat.alpha + _von_mises(-om_i.dot(om_r), pat.beta)
    A = _seeliger(n.dot(om_i), n.dot(om_r))
    fs = Gv * fc * A * 2.0 * w_ * umax

    delta_x = w_ * pat.hWidth
    x_of_u = torch.clamp(v_of_u * w_ / np.pi,
                         0.5 * (delta_x - w_), 0.5 * (w_ - delta_x))
    on_highlight = torch.abs(x_of_u - v_ * w_ / np.pi) < 0.5 * delta_x

    ok = (in_range & on_highlight & (w_ * torch.sin(umax) < l_)
          & (kappa >= -1.0))
    return torch.where(ok, fs / torch.clamp_min(delta_x, 1e-20), 0.0)


def compute_normalization(pat: WeavePattern, n_samples: int = 10000,
                          seed: int = 0) -> WeavePattern:
    """The specular normalization (irawan.cpp configure()): the mean of the
    raw specular term under cosine-distributed wi/wo and uniform uv, from
    the reference's numpy draws, evaluated in float32 on the CPU."""
    rng = np.random.default_rng(seed)
    us = rng.random((6, n_samples)).astype(np.float32)

    def cos_hemi(u1, u2):
        r = np.sqrt(u1)
        phi = 2.0 * np.pi * u2
        z = np.sqrt(np.maximum(1.0 - u1, 0.0))
        return V3(*(torch.from_numpy(np.asarray(c, np.float32))
                    for c in (r * np.cos(phi), r * np.sin(phi), z)))

    pat0 = dataclasses.replace(pat, normalization=1.0)
    total = float(eval_pattern(
        pat0, torch.from_numpy(us[4]), torch.from_numpy(us[5]),
        cos_hemi(us[0], us[1]), cos_hemi(us[2], us[3]),
        initialization=True).sum())
    norm = 0.0 if total <= 0.0 else n_samples / (total * np.pi)
    return dataclasses.replace(pat, normalization=norm)
