"""Participating media tables and phase functions
(``mitsuba_im_tpu/media/medium.py``), forward only.

The host half (the grid atlas, the microflake and Kajiya-Kay tables, the
phase records) is the reference's numpy, so :func:`build_media` gives the
same leaves bit for bit; :class:`MediumTable` holds them as torch tensors
on one device.  The lane functions are the reference's component-SoA
(``_v``) forms over flat (N,) tensors; every table row lookup goes through
``core/v3.py::gather_row``.

Media: homogeneous sigma_s/sigma_a (channel-averaged free-flight sampling,
Beer-Lambert transmittance), and grid media (heterogeneous.cpp):
sigma_t(x) = scale * density(x), gray, sigma_s = sigma_t * albedo(x), with
delta tracking for distances (:func:`track_distance_v`) and ratio tracking
for shadow transmittance (:func:`track_transmittance_v`).

The tracking loops run, as the reference's ``while_loop``, while any lane
of the whole batch is live (at most ``MAX_TRACK_STEPS``), and every
iteration draws one block from the one shared sampler dimension.  So every
later draw depends on how many iterations the batch took, and the port runs
exactly that many: each iteration reads ``live.any()`` back to the host (a
device-to-host sync, counted in :data:`TRACK_STATS`).  A grid-medium image
therefore depends on the batch: a band of a tiled film draws other numbers
than the full frame, in the reference too.  A lane whose medium id names
a grid medium while its ray runs outside that medium's boundary (a
crossing at an edge or at a grazing angle: one lane of 65,536 a bounce in
``volume_cornell`` at 256^2), or whose path has ended (the reference
marches its shadow segments too, from wherever its last ray went), tracks
on through zero density toward a far surface, or none (t_max 1e30), and
holds the batch's loop to the cap of MAX_TRACK_STEPS iterations.  At iterations 4, 8, 16, ...
the port therefore asks whether each live lane is beyond reach: within
the distance its remaining steps can cover, its ray stays a voxel or more
outside its grid (so no tentative collision is accepted and no
transmittance falls) and cannot reach t_max.  When all are, the batch's
count is the cap, and the port advances the sampler's dimension by the
iterations left without running them: the dimension, the scattered flags,
the transmittances (0 for a lane live at the cap) and the image are the
reference's; a delta-tracked lane's t (read only where it scattered) stays
where it stopped.

Phase convention (ROADMAP C4): ``wi`` points toward the previous vertex,
as a BSDF's does, for every phase function.  Isotropic, HG, Rayleigh, the
mixture and Kajiya-Kay are the reference's.  Kajiya-Kay takes
cos(theta_i) = (-wi).a, the direction of travel's, so its specular cone is
the fibre's mirror cone wo.a = -wi.a.  The reference wrote its microflake
phase for ``wi`` along the propagation direction while its integrator
passes ``-d``, which reflects the lobe through ``wo -> -wo``; the port does
not copy that: microflake mirrors about the flake normal h = wi + wo and
samples wo = 2 (wi.m) m - wi, so port(wi, wo) = reference(wi, -wo) for its
eval and pdf.

``torch`` has no ``cbrt``: Rayleigh sampling takes ``pow(x, 1/3)`` of its
positive argument, and microflake sampling ``torch.erfinv``; both differ
from XLA's in the last bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.types import Float, Int, INVALID, host_tensor
from ..core import v3 as v
from ..core.v3 import V3, safe_sqrt
from ..core import rng as mrng

PH_ISOTROPIC = 0
PH_HG = 1
PH_RAYLEIGH = 2
PH_KKAY = 3         # Kajiya-Kay fiber phase (src/phase/kkay.cpp)
PH_MICROFLAKE = 4   # Gaussian-fiber microflake (src/phase/microflake.cpp)
PH_MIX = 5          # weighted mixture (src/phase/mixturephase.cpp)

MIX_MAX = 4         # mixture component slots
PHASE_TAB = 32      # per-|cos| normalization table resolution

INV_FOURPI = 1.0 / (4.0 * math.pi)

MAX_TRACK_STEPS = 2048  # safety bound on tracking collisions per segment
CHECK_FIRST = 4  # the first beyond-reach check; then at each power of two
# the longest free-flight step, times the majorant: the step of the
# largest uniform the loops admit
_MAX_STEP_MAJ = -math.log1p(-0.999999)

# iterations of the tracking loops as the batch counts them (the sampler's
# dimension moves 4 a iteration), the iterations run (the rest skipped as
# beyond reach), and their device-to-host syncs, since the last reset
TRACK_STATS = dict(iterations=0, executed=0, syncs=0)


def reset_track_stats():
    TRACK_STATS.update(iterations=0, executed=0, syncs=0)


MEDIUM_LEAVES = (
    "sigma_s", "sigma_a", "sigma_t", "phase_type", "g", "hetero", "majorant",
    "grid_offset", "grid_res", "w2g", "albedo_c", "alb_offset", "alb_res",
    "alb_w2g", "density_atlas", "albedo_atlas", "ph_kd", "ph_ks", "ph_exp",
    "ph_c", "ph_inv2s2", "ph_tab", "mix_type", "mix_g", "mix_w",
    "ori_offset", "ori_res", "ori_w2g", "orientation_atlas")
_INT_LEAVES = ("phase_type", "hetero", "grid_offset", "grid_res",
               "alb_offset", "alb_res", "mix_type", "ori_offset", "ori_res")


@dataclasses.dataclass(frozen=True)
class MediumTable:
    sigma_s: torch.Tensor  # (M, 3) homogeneous scattering coeff (0 for hetero)
    sigma_a: torch.Tensor  # (M, 3)
    sigma_t: torch.Tensor  # (M, 3)
    phase_type: torch.Tensor  # (M,)
    g: torch.Tensor  # (M,) HG asymmetry
    # -- heterogeneous grid media ------------------------------------------
    hetero: torch.Tensor  # (M,) int32 0/1
    majorant: torch.Tensor  # (M,) max sigma_t over the grid (scale folded in)
    grid_offset: torch.Tensor  # (M,) int32 into density_atlas
    grid_res: torch.Tensor  # (M, 3) int32 (nx, ny, nz)
    w2g: torch.Tensor  # (M, 12) rows of world->voxel affine
    albedo_c: torch.Tensor  # (M, 3) constant single-scattering albedo
    alb_offset: torch.Tensor  # (M,) int32 into albedo_atlas, -1 = constant
    alb_res: torch.Tensor  # (M, 3) int32
    alb_w2g: torch.Tensor  # (M, 12)
    density_atlas: torch.Tensor  # (D,) f32 sigma_t values (scale * density)
    albedo_atlas: torch.Tensor  # (A, 3) f32
    # -- structured phase functions (kkay / microflake / mixture) ----------
    ph_kd: torch.Tensor  # (M,) kkay diffuse weight
    ph_ks: torch.Tensor  # (M,) kkay specular weight
    ph_exp: torch.Tensor  # (M,) kkay specular exponent
    ph_c: torch.Tensor  # (M,) microflake D(m) normalization constant
    ph_inv2s2: torch.Tensor  # (M,) microflake 1/(2 stddev^2)
    ph_tab: torch.Tensor  # (M*PHASE_TAB,) flat per-|cos| table:
    #   microflake -> projected flake area sigma(c); kkay -> integral of the
    #   unnormalized lobe over the sphere; 1 otherwise
    mix_type: torch.Tensor  # (M, MIX_MAX) int32 component phase types
    mix_g: torch.Tensor  # (M, MIX_MAX)
    mix_w: torch.Tensor  # (M, MIX_MAX) weights (0 in unused slots)
    # -- orientation volumes (fiber axis for kkay/microflake) --------------
    ori_offset: torch.Tensor  # (M,) int32 into orientation_atlas, -1 = none
    ori_res: torch.Tensor  # (M, 3) int32
    ori_w2g: torch.Tensor  # (M, 12)
    orientation_atlas: torch.Tensor  # (O, 3)
    n_media: int = 0
    used_phase: tuple = ()
    has_hetero: bool = False
    has_fancy_phase: bool = False

    @property
    def any(self):
        return self.n_media > 0


def table_from_arrays(arrays: dict, statics: dict, device) -> MediumTable:
    """A MediumTable of numpy leaves (``MEDIUM_LEAVES``) and its statics
    (``n_media``, ``used_phase``, ``has_hetero``, ``has_fancy_phase``) on
    ``device``."""
    return MediumTable(
        **{k: host_tensor(arrays[k], np.int32 if k in _INT_LEAVES
                          else np.float32, device) for k in MEDIUM_LEAVES},
        n_media=int(statics["n_media"]),
        used_phase=tuple(int(x) for x in statics["used_phase"]),
        has_hetero=bool(statics["has_hetero"]),
        has_fancy_phase=bool(statics["has_fancy_phase"]))


def _pack_grid(atlas: list, rec: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """Append a grid record's data to the atlas list; returns
    (offset, res[3], w2g rows[12])."""
    from .volume import grid_world_to_voxel

    data = np.asarray(rec["data"], np.float32)
    zres, yres, xres, _ = data.shape
    off = sum(a.shape[0] for a in atlas)  # row offset (atlas rows are (C,))
    atlas.append(data.reshape(-1, data.shape[-1]))
    m = grid_world_to_voxel(rec)[:3, :]  # 3x4 rows
    return off, np.asarray([xres, yres, zres], np.int32), m.reshape(12)


# ---------------------------------------------------------------------------
# Host-side phase precomputation (microflake sigma / kkay normalization)
# ---------------------------------------------------------------------------

def _flake_norm_const(stddev: float) -> float:
    """Normalization C of D(m) = C exp(-(m.a)^2 / (2 s^2)) over the sphere:
    flake normals concentrated on the equator w.r.t. the fiber axis a (the
    Gaussian fiber distribution of microflake.cpp)."""
    s = max(float(stddev), 1e-4)
    integral = 2.0 * np.pi * s * math.sqrt(2.0 * np.pi) * math.erf(
        1.0 / (s * math.sqrt(2.0)))
    return 1.0 / integral


def _flake_sigma_table(stddev: float, K: int = PHASE_TAB) -> np.ndarray:
    """Projected flake area sigma(c) = int D(m) |w.m| dm as a function of
    c = |w.a| (azimuthal symmetry), by Gauss-Legendre x uniform-phi
    quadrature (the reference's Chebyshev series of microflake_fiber.h as
    a 32-entry lerp table)."""
    s = max(float(stddev), 1e-4)
    C = _flake_norm_const(s)
    t, wt = np.polynomial.legendre.leggauss(128)       # cos-theta over m
    phi = (np.arange(64) + 0.5) * (2.0 * np.pi / 64)
    st = np.sqrt(np.maximum(1.0 - t * t, 0.0))
    mx = st[:, None] * np.cos(phi)[None, :]
    mz = np.broadcast_to(t[:, None], mx.shape)
    D = C * np.exp(-(mz ** 2) / (2.0 * s * s))
    cs = np.linspace(0.0, 1.0, K)
    out = np.empty(K)
    for i, c in enumerate(cs):
        sw = np.sqrt(max(1.0 - c * c, 0.0))
        dot = np.abs(mx * sw + mz * c)                  # w = (sw, 0, c)
        out[i] = float(np.sum(D * dot * wt[:, None]) * (2.0 * np.pi / 64))
    return out


def _kkay_norm_table(kd: float, ks: float, expo: float,
                     K: int = PHASE_TAB) -> np.ndarray:
    """Sphere integral of the unnormalized Kajiya-Kay lobe as a function of
    c = |cos(axis, w_in)| (the reference normalizes by a single Simpson
    integral at theta_i = pi/2, kkay.cpp:60-70; normalizing per incident
    angle keeps the phase function exactly energy-conserving)."""
    x, wt = np.polynomial.legendre.leggauss(256)
    cs = np.linspace(0.0, 1.0, K)
    out = np.empty(K)
    for i, c in enumerate(cs):
        si = np.sqrt(max(1.0 - c * c, 0.0))
        spec = np.maximum(c * x + si * np.sqrt(np.maximum(1 - x * x, 0)), 0.0)
        lobe = kd + ks * np.where(spec > 0, spec ** max(expo, 0.0), 0.0)
        out[i] = float(2.0 * np.pi * np.sum(lobe * wt))
    return np.maximum(out, 1e-9)


def _parse_phase(ph: dict):
    """Flatten a phase record -> per-medium scalar rows + mixture slots."""
    ptype = int(ph.get("type", PH_ISOTROPIC))
    row = dict(type=ptype, g=float(ph.get("g", 0.0)),
               kd=0.0, ks=0.0, exp=1.0, c=0.0, inv2s2=0.0,
               tab=np.ones(PHASE_TAB),
               mix_type=np.zeros(MIX_MAX, np.int32),
               mix_g=np.zeros(MIX_MAX), mix_w=np.zeros(MIX_MAX))
    if ptype == PH_KKAY:
        row["kd"] = float(ph.get("kd", 0.2))
        row["ks"] = float(ph.get("ks", 0.4))
        row["exp"] = float(ph.get("exponent", 4.0))
        row["tab"] = _kkay_norm_table(row["kd"], row["ks"], row["exp"])
    elif ptype == PH_MICROFLAKE:
        s = float(ph.get("stddev", 0.3))
        row["c"] = _flake_norm_const(s)
        row["inv2s2"] = 1.0 / (2.0 * max(s, 1e-4) ** 2)
        row["tab"] = _flake_sigma_table(s)
    elif ptype == PH_MIX:
        comps = ph.get("components", [])[:MIX_MAX]
        for k, (w, sub) in enumerate(comps):
            st = int(sub.get("type", PH_ISOTROPIC))
            if st not in (PH_ISOTROPIC, PH_HG, PH_RAYLEIGH):
                raise ValueError(
                    "mixturephase components must be isotropic/hg/rayleigh")
            row["mix_type"][k] = st
            row["mix_g"][k] = float(sub.get("g", 0.0))
            row["mix_w"][k] = float(w)
        tot = row["mix_w"].sum()
        if tot > 1.0 + 1e-6:
            raise ValueError("mixturephase weights must sum to <= 1")
        if tot <= 0:
            row["mix_type"][0] = PH_ISOTROPIC
            row["mix_w"][0] = 1.0
    return row


def media_arrays(records: list[dict]) -> tuple[dict, dict]:
    """(numpy leaves, statics) of the medium records, the reference's
    ``build_media`` arithmetic (float64, then one cast); no records give
    one vacuum row and ``n_media`` 0."""
    recs = records or [dict(sigma_s=np.zeros(3), sigma_a=np.zeros(3),
                            scale=1.0, phase=dict(type=PH_ISOTROPIC, g=0.0))]
    M = len(recs)
    ss = np.zeros((M, 3))
    sa = np.zeros((M, 3))
    ph_rows = [_parse_phase(r.get("phase", {}) or {}) for r in recs]
    pt = np.asarray([p["type"] for p in ph_rows], np.int32)
    g = np.asarray([p["g"] for p in ph_rows], np.float64)

    hetero = np.zeros(M, np.int32)
    majorant = np.zeros(M, np.float64)
    goff = np.zeros(M, np.int32)
    gres = np.ones((M, 3), np.int32)
    w2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    alb_c = np.full((M, 3), 0.8)
    aoff = np.full(M, -1, np.int32)
    ares = np.ones((M, 3), np.int32)
    aw2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    ooff = np.full(M, -1, np.int32)
    ores = np.ones((M, 3), np.int32)
    ow2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    d_atlas: list = []
    a_atlas: list = []
    o_atlas: list = []

    for i, r in enumerate(recs):
        scale = r.get("scale", 1.0)
        if r.get("kind") == "heterogeneous":
            dg = r.get("density")
            if dg is None:
                continue
            dg = dict(dg)
            dg["data"] = np.asarray(dg["data"], np.float32)[..., :1] * scale
            hetero[i] = 1
            majorant[i] = float(dg["data"].max(initial=0.0))
            goff[i], gres[i], w2g[i] = _pack_grid(d_atlas, dg)
            ag = r.get("albedo")
            if ag is not None:
                adata = np.asarray(ag["data"], np.float32)
                if adata.shape[-1] == 1:
                    adata = np.repeat(adata, 3, axis=-1)
                if ag.get("const") or adata.size <= 3:
                    alb_c[i] = adata.reshape(-1, 3)[0]
                else:
                    ag = dict(ag, data=adata)
                    aoff[i], ares[i], aw2g[i] = _pack_grid(a_atlas, ag)
            og = r.get("orientation")
            if og is not None:
                odata = np.asarray(og["data"], np.float32)
                if odata.shape[-1] == 3 and odata.size > 3:
                    og = dict(og, data=odata)
                    ooff[i], ores[i], ow2g[i] = _pack_grid(o_atlas, og)
        else:
            ss[i] = np.asarray(r["sigma_s"], np.float64) * scale
            sa[i] = np.asarray(r["sigma_a"], np.float64) * scale

    dens = (np.concatenate(d_atlas, axis=0)[:, 0] if d_atlas
            else np.zeros(1, np.float32))
    alb = (np.concatenate(a_atlas, axis=0) if a_atlas
           else np.zeros((1, 3), np.float32))
    ori = (np.concatenate(o_atlas, axis=0) if o_atlas
           else np.zeros((1, 3), np.float32))
    fancy = {PH_KKAY, PH_MICROFLAKE, PH_MIX} & set(int(x) for x in pt)
    arrays = dict(
        sigma_s=ss, sigma_a=sa, sigma_t=ss + sa, phase_type=pt, g=g,
        hetero=hetero, majorant=majorant, grid_offset=goff, grid_res=gres,
        w2g=w2g, albedo_c=alb_c, alb_offset=aoff, alb_res=ares, alb_w2g=aw2g,
        density_atlas=dens, albedo_atlas=alb,
        ph_kd=np.asarray([p["kd"] for p in ph_rows]),
        ph_ks=np.asarray([p["ks"] for p in ph_rows]),
        ph_exp=np.asarray([p["exp"] for p in ph_rows]),
        ph_c=np.asarray([p["c"] for p in ph_rows]),
        ph_inv2s2=np.asarray([p["inv2s2"] for p in ph_rows]),
        ph_tab=np.concatenate([p["tab"] for p in ph_rows]),
        mix_type=np.stack([p["mix_type"] for p in ph_rows]),
        mix_g=np.stack([p["mix_g"] for p in ph_rows]),
        mix_w=np.stack([p["mix_w"] for p in ph_rows]),
        ori_offset=ooff, ori_res=ores, ori_w2g=ow2g, orientation_atlas=ori)
    statics = dict(n_media=len(records or ()),
                   used_phase=tuple(sorted(set(int(x) for x in pt))),
                   has_hetero=bool(hetero.any()), has_fancy_phase=bool(fancy))
    return arrays, statics


def build_media(records: list[dict], device) -> MediumTable:
    """The MediumTable of a SceneBuilder's medium records on ``device``."""
    return table_from_arrays(*media_arrays(records), device)


# ---------------------------------------------------------------------------
# Lane functions (component-SoA)
# ---------------------------------------------------------------------------

def _safe_idx(mid: torch.Tensor) -> torch.Tensor:
    return torch.where(mid == INVALID, 0, mid)


def medium_params_v(media: MediumTable, mid: torch.Tensor):
    """SoA per-lane (sigma_s V3, sigma_t V3, phase_type, g); vacuum for
    INVALID."""
    idx = _safe_idx(mid)
    vac = mid == INVALID
    zero = v.zeros(mid.shape, mid.device)
    ss = v.where(vac, zero, v.gather_v3(media.sigma_s, idx))
    st = v.where(vac, zero, v.gather_v3(media.sigma_t, idx))
    return (ss, st, v.gather_row(media.phase_type, idx),
            v.gather_row(media.g, idx))


def _cols(tab: torch.Tensor, idx: torch.Tensor) -> tuple:
    """The rows ``idx`` of a (M, K) table as K flat columns."""
    return tuple(v.gather_row(tab, idx).unbind(1))


def hetero_rows_v(media: MediumTable, mid: torch.Tensor) -> dict:
    """SoA heterogeneous rows: affines as 12 flat columns."""
    idx = _safe_idx(mid)
    b = dict(
        hetero=v.gather_row(media.hetero, idx),
        majorant=v.gather_row(media.majorant, idx),
        grid_res=_cols(media.grid_res, idx),
        w2g=_cols(media.w2g, idx),
        albedo_c=v.gather_v3(media.albedo_c, idx),
        alb_res=_cols(media.alb_res, idx),
        alb_w2g=_cols(media.alb_w2g, idx),
        grid_offset=v.gather_row(media.grid_offset, idx),
        alb_offset=v.gather_row(media.alb_offset, idx),
    )
    b["is_het"] = (mid != INVALID) & (b["hetero"] > 0)
    return b


def _floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32 for x clamped to a grid, 0 where x is NaN (as
    XLA converts NaN, so that a NaN lane indexes inside its table; its
    value stays NaN through the fraction and is masked as the
    reference's)."""
    return torch.floor(torch.nan_to_num(x, nan=0.0)).to(Int)


def _trilinear_v(atlas, offset, res, w2g, p: V3, vec_out: bool):
    """SoA trilinear grid lookup: res/w2g are column tuples, p is V3; zero
    outside the grid."""
    r = w2g
    gx = r[0] * p.x + r[1] * p.y + r[2] * p.z + r[3]
    gy = r[4] * p.x + r[5] * p.y + r[6] * p.z + r[7]
    gz = r[8] * p.x + r[9] * p.y + r[10] * p.z + r[11]
    nx, ny, nz = res
    fx = nx.to(Float) - 1.0
    fy = ny.to(Float) - 1.0
    fz = nz.to(Float) - 1.0
    inside = ((gx >= 0.0) & (gx <= fx + 1e-4) & (gy >= 0.0)
              & (gy <= fy + 1e-4) & (gz >= 0.0) & (gz <= fz + 1e-4))
    gx = torch.minimum(torch.clamp_min(gx, 0.0), torch.clamp_min(fx, 0.0))
    gy = torch.minimum(torch.clamp_min(gy, 0.0), torch.clamp_min(fy, 0.0))
    gz = torch.minimum(torch.clamp_min(gz, 0.0), torch.clamp_min(fz, 0.0))
    x0 = torch.minimum(_floor_index(gx), torch.clamp_min(nx - 2, 0))
    y0 = torch.minimum(_floor_index(gy), torch.clamp_min(ny - 2, 0))
    z0 = torch.minimum(_floor_index(gz), torch.clamp_min(nz - 2, 0))
    tx = gx - x0.to(Float)
    ty = gy - y0.to(Float)
    tz = gz - z0.to(Float)
    x1 = torch.minimum(x0 + 1, nx - 1)
    y1 = torch.minimum(y0 + 1, ny - 1)
    z1 = torch.minimum(z0 + 1, nz - 1)

    def at(ix, iy, iz):
        flat = offset + ((iz * ny + iy) * nx + ix)
        if vec_out:
            return v.gather_v3(atlas, flat)
        return v.gather_row(atlas, flat)

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(at(x0, y0, z0), at(x1, y0, z0), tx)
    c10 = lerp(at(x0, y1, z0), at(x1, y1, z0), tx)
    c01 = lerp(at(x0, y0, z1), at(x1, y0, z1), tx)
    c11 = lerp(at(x0, y1, z1), at(x1, y1, z1), tx)
    val = lerp(lerp(c00, c10, ty), lerp(c01, c11, ty), tz)
    if vec_out:
        return v.where(inside, val, v.zeros(gx.shape, gx.device))
    return torch.where(inside, val, 0.0)


def sigma_t_at_v(media: MediumTable, rows: dict, p: V3) -> torch.Tensor:
    """Heterogeneous sigma_t (= scale * density, gray) at world points."""
    return _trilinear_v(media.density_atlas, rows["grid_offset"],
                        rows["grid_res"], rows["w2g"], p, vec_out=False)


def albedo_at_v(media: MediumTable, rows: dict, p: V3) -> V3:
    """Single-scattering albedo at world points; constant fallback."""
    grid = _trilinear_v(media.albedo_atlas,
                        torch.clamp_min(rows["alb_offset"], 0),
                        rows["alb_res"], rows["alb_w2g"], p, vec_out=True)
    return v.where(rows["alb_offset"] >= 0, grid, rows["albedo_c"])


def _batch_live(live: torch.Tensor) -> bool:
    """Is any lane live? (the loops' one device-to-host sync)"""
    TRACK_STATS["syncs"] += 1
    return bool(live.any())


def _beyond_reach(rows: dict, o: V3, d: V3, t, t_max, maj,
                  steps_left: int):
    """Lanes whose tracking runs to the cap: within the distance that
    ``steps_left`` of the longest step covers from ``t``, their ray stays
    more than a voxel outside the density grid (so the lookup is 0 there:
    no collision is accepted and no transmittance falls), and it cannot
    reach ``t_max``.  In float64, so that far points do not overflow; a
    NaN ray never enters."""
    reach = steps_left * 1.01 * _MAX_STEP_MAJ / maj.double()
    lo = t.double()
    hi = lo + reach
    r = [c.double() for c in rows["w2g"]]
    ox, oy, oz = (c.double() for c in o)
    dx, dy, dz = (c.double() for c in d)
    for k in range(3):
        a = r[4 * k] * ox + r[4 * k + 1] * oy + r[4 * k + 2] * oz \
            + r[4 * k + 3]
        b = r[4 * k] * dx + r[4 * k + 1] * dy + r[4 * k + 2] * dz
        top = rows["grid_res"][k].double()
        flat = b == 0.0
        bb = torch.where(flat, 1.0, b)
        t1, t2 = (-1.0 - a) / bb, (top - a) / bb
        inside = (a >= -1.0) & (a <= top)
        tn = torch.where(flat, torch.where(inside, -math.inf, math.inf),
                         torch.minimum(t1, t2))
        tf = torch.where(flat, torch.where(inside, math.inf, -math.inf),
                         torch.maximum(t1, t2))
        lo = torch.maximum(lo, tn)
        hi = torch.minimum(hi, tf)
    enters = lo <= hi
    return ~enters & (t.double() + reach < t_max.double())


def _check_now(i: int) -> bool:
    """Ask whether the live lanes are beyond reach at iterations 4, 8, 16,
    ... (at most twice the iterations a loop would need otherwise)."""
    return i >= CHECK_FIRST and i & (i - 1) == 0


def _skip_to_cap(s: mrng.Sampler3, i: int) -> mrng.Sampler3:
    """The sampler after the iterations ``i``..MAX_TRACK_STEPS-1, each a
    block of four dimensions (the dimension is aligned after one)."""
    TRACK_STATS["iterations"] += MAX_TRACK_STEPS - i
    return s.replace(dim=(s.dim + 4 * (MAX_TRACK_STEPS - i)) & mrng.MASK32)


def track_distance_v(media: MediumTable, rows: dict, o: V3, d: V3, t_max,
                     s: mrng.Sampler3, active):
    """Delta (Woodcock) tracking through the heterogeneous lanes.

    Returns (sampler, t_event, scattered).  Exact because sigma_t is gray
    (heterogeneous.cpp model): accepted collisions carry weight albedo(x),
    escapes carry weight 1.  Iterates while any lane of the batch is live,
    and skips to the cap once every live lane is beyond reach (see the
    module note)."""
    n = o.x.shape[0]
    maj = torch.clamp_min(rows["majorant"], 1e-20)
    live = active & rows["is_het"] & (rows["majorant"] > 1e-20)
    t_max = torch.as_tensor(t_max, dtype=Float, device=o.x.device).expand(n)
    t = torch.zeros((n,), dtype=Float, device=o.x.device)
    sc = torch.zeros((n,), dtype=torch.bool, device=o.x.device)
    i = 0
    while i < MAX_TRACK_STEPS and _batch_live(live):
        if _check_now(i) and not _batch_live(
                live & ~_beyond_reach(rows, o, d, t, t_max, maj,
                                      MAX_TRACK_STEPS - i)):
            s = _skip_to_cap(s, i)
            break
        s, blk = mrng.next_block4_v(s)
        step = -torch.log1p(-torch.clamp_max(blk[0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= t_max
        dens = sigma_t_at_v(media, rows, o + d * t2)
        accept = blk[1] < dens / maj
        sc = sc | (live & ~esc & accept)
        t = torch.where(live, torch.minimum(t2, t_max), t)
        live = live & ~esc & ~accept
        i += 1
        TRACK_STATS["iterations"] += 1
        TRACK_STATS["executed"] += 1
    return s, t, sc


def track_transmittance_v(media: MediumTable, rows: dict, o: V3, d: V3,
                          dist, s: mrng.Sampler3, active):
    """Ratio tracking: an unbiased transmittance estimate along shadow
    segments through the heterogeneous lanes; returns (sampler, T).  Lanes
    still live at the cap are opaque; once every live lane is beyond reach
    the port skips to the cap (see the module note)."""
    n = o.x.shape[0]
    maj = torch.clamp_min(rows["majorant"], 1e-20)
    live = active & rows["is_het"] & (rows["majorant"] > 1e-20)
    dist = torch.as_tensor(dist, dtype=Float, device=o.x.device).expand(n)
    t = torch.zeros((n,), dtype=Float, device=o.x.device)
    T = torch.ones((n,), dtype=Float, device=o.x.device)
    i = 0
    while i < MAX_TRACK_STEPS and _batch_live(live):
        if _check_now(i) and not _batch_live(
                live & ~_beyond_reach(rows, o, d, t, dist, maj,
                                      MAX_TRACK_STEPS - i)):
            s = _skip_to_cap(s, i)
            break
        s, blk = mrng.next_block4_v(s)
        step = -torch.log1p(-torch.clamp_max(blk[0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= dist
        dens = sigma_t_at_v(media, rows, o + d * t2)
        T = torch.where(live & ~esc, T * (1.0 - dens / maj), T)
        t = torch.where(live, t2, t)
        live = live & ~esc & (T > 1e-6)
        i += 1
        TRACK_STATS["iterations"] += 1
        TRACK_STATS["executed"] += 1
    # budget exceeded: opaque
    T = torch.where(live, 0.0, torch.clamp_min(T, 0.0))
    return s, T


def transmittance_v(sigma_t: V3, dist) -> V3:
    """Beer-Lambert; sigma_t V3, dist (N,) -> V3."""
    return (sigma_t * (-torch.clamp_max(dist, 1e30))).exp()


def sample_distance_v(sigma_t: V3, u: torch.Tensor):
    """Channel-averaged free flight: sigma_t V3 -> (t, st_bar)."""
    st_bar = torch.clamp_min(sigma_t.mean(), 1e-20)
    t = -torch.log(torch.clamp_min(1.0 - u, 1e-20)) / st_bar
    return t, st_bar


def phase_eval_v(ptype, g, wi: V3, wo: V3):
    """p(wi -> wo) of isotropic, HG and Rayleigh; wi toward the previous
    vertex."""
    cos_theta = (-wi).dot(wo)
    iso = torch.full(cos_theta.shape, INV_FOURPI, dtype=Float,
                     device=cos_theta.device)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    hg = INV_FOURPI * (1.0 - g * g) / torch.clamp_min(
        denom * safe_sqrt(denom), 1e-8)
    ray = (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)
    out = iso
    out = torch.where(ptype == PH_HG, hg, out)
    out = torch.where(ptype == PH_RAYLEIGH, ray, out)
    return out


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The cube root of a positive argument (torch has no ``cbrt``)."""
    return torch.pow(x, 1.0 / 3.0)


def phase_sample_v(ptype, g, wi: V3, u1, u2):
    """Phase sampling of isotropic, HG (exact inverse CDF) and Rayleigh
    (Cardano inversion, phase/rayleigh.cpp); returns (wo V3, pdf)."""
    wo_iso = v.square_to_uniform_sphere(u1, u2)

    safe_g = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_hg = torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * u1, cos_hg)
    cos_hg = torch.clamp(cos_hg, -1.0, 1.0)
    sin_hg = safe_sqrt(1.0 - cos_hg * cos_hg)
    phi = 2.0 * math.pi * u2
    frame = v.frame_from_normal(-wi)
    wo_hg = v.to_world(
        frame, V3(sin_hg * torch.cos(phi), sin_hg * torch.sin(phi), cos_hg))

    z = 2.0 * (2.0 * u1 - 1.0)
    A = _cbrt(z + torch.sqrt(z * z + 1.0))
    cos_r = torch.clamp(A - 1.0 / A, -1.0, 1.0)
    sin_r = safe_sqrt(1.0 - cos_r * cos_r)
    wo_ray = v.to_world(
        frame, V3(sin_r * torch.cos(phi), sin_r * torch.sin(phi), cos_r))

    wo = wo_iso
    wo = v.where(ptype == PH_HG, wo_hg, wo)
    wo = v.where(ptype == PH_RAYLEIGH, wo_ray, wo)
    return wo, phase_eval_v(ptype, g, wi, wo)


# ---------------------------------------------------------------------------
# Structured phase functions: kkay / microflake / mixture (ctx-based).  The
# fiber axis comes from the medium's orientation volume at the scatter
# point (heterogeneous.cpp 'orientation' child), else +z.  All three
# integrate to 1 over wo (the mixture to its weight total).
# ---------------------------------------------------------------------------

def orientation_at_v(media: MediumTable, mid: torch.Tensor, p: V3) -> V3:
    """Fiber axis at world points p: the normalized orientation-volume
    lookup, +z where the medium has no orientation data or the local
    vector vanishes."""
    idx = _safe_idx(mid)
    off = v.gather_row(media.ori_offset, idx)
    vec = _trilinear_v(media.orientation_atlas, torch.clamp_min(off, 0),
                       _cols(media.ori_res, idx), _cols(media.ori_w2g, idx),
                       p, vec_out=True)
    ln = torch.sqrt(vec.squared_norm())
    ok = (off >= 0) & (ln > 1e-6)
    z = torch.zeros_like(ln)
    fallback = V3(z, z, torch.ones_like(ln))
    return v.where(ok, vec * (1.0 / torch.clamp_min(ln, 1e-6)), fallback)


def _tab_interp_v(tab_flat, mid, c):
    """Lerp into the per-medium (PHASE_TAB,) tables over |c| in [0, 1]."""
    cc = torch.clamp(torch.abs(c), 0.0, 1.0) * (PHASE_TAB - 1)
    j0 = torch.clamp_max(_floor_index(cc), PHASE_TAB - 2)
    f = cc - j0.to(Float)
    base = mid * PHASE_TAB
    a = v.gather_row(tab_flat, base + j0)
    b = v.gather_row(tab_flat, base + j0 + 1)
    return a + (b - a) * f


def phase_ctx_v(media: MediumTable, mid: torch.Tensor, p: V3) -> dict:
    """Per-lane phase context at scatter points p; type and g only when
    the scene has no structured phase."""
    idx = _safe_idx(mid)
    ctx = dict(mid=idx, ptype=v.gather_row(media.phase_type, idx),
               g=v.gather_row(media.g, idx))
    if media.has_fancy_phase:
        ctx.update(
            kd=v.gather_row(media.ph_kd, idx),
            ks=v.gather_row(media.ph_ks, idx),
            exp=v.gather_row(media.ph_exp, idx),
            fc=v.gather_row(media.ph_c, idx),
            inv2s2=v.gather_row(media.ph_inv2s2, idx),
            mix_type=_cols(media.mix_type, idx),
            mix_g=_cols(media.mix_g, idx),
            mix_w=_cols(media.mix_w, idx),
            axis=orientation_at_v(media, mid, p),
        )
    return ctx


def _kkay_lobe(ctx, wi: V3, wo: V3):
    """Unnormalized Kajiya-Kay lobe kd + ks cos^e(theta_i - theta_o),
    cos(theta_i) = (-wi).a with wi toward the previous vertex: the lobe
    peaks on the mirror cone wo.a = -wi.a."""
    axis = ctx["axis"]
    u = (-wi).dot(axis)
    vv = wo.dot(axis)
    si = safe_sqrt(1.0 - u * u)
    so = safe_sqrt(1.0 - vv * vv)
    spec = torch.clamp_min(u * vv + si * so, 0.0)
    e = torch.clamp_min(ctx["exp"], 0.0)
    return ctx["kd"] + ctx["ks"] * torch.where(
        spec > 0, torch.exp(e * torch.log(torch.clamp_min(spec, 1e-20))),
        0.0)


def _flake_D(ctx, t):
    """Gaussian fiber-normal distribution D(m) at t = m.axis."""
    return ctx["fc"] * torch.exp(-t * t * ctx["inv2s2"])


def _flake_normal(wi: V3, wo: V3) -> V3:
    """The microflake that mirrors wi into wo: h = (wi + wo) / |wi + wo|."""
    h = wi + wo
    hl = torch.clamp_min(torch.sqrt(h.squared_norm()), 1e-8)
    return h * (1.0 / hl)


def _mix_eval(ctx, wi, wo):
    out = torch.zeros(wi.x.shape, dtype=Float, device=wi.x.device)
    for k in range(MIX_MAX):
        out = out + ctx["mix_w"][k] * phase_eval_v(
            ctx["mix_type"][k], ctx["mix_g"][k], wi, wo)
    return out


def phase_eval_ctx_v(media: MediumTable, ctx: dict, wi: V3, wo: V3):
    """p(wi -> wo) with full dispatch over the scene's phase set."""
    val = phase_eval_v(ctx["ptype"], ctx["g"], wi, wo)
    if not media.has_fancy_phase:
        return val
    axis = ctx["axis"]
    ptype = ctx["ptype"]
    # kkay: per-incident-angle normalized lobe
    norm = _tab_interp_v(media.ph_tab, ctx["mid"], (-wi).dot(axis))
    kk = _kkay_lobe(ctx, wi, wo) / norm
    # microflake: D(h) / (2 sigma(wi)); the reflection map m -> wo is 2-to-1
    # (antipodal flakes coincide), so int D(h) dwo = 2 sigma(wi)
    hn = _flake_normal(wi, wo)
    sigma = _tab_interp_v(media.ph_tab, ctx["mid"], wi.dot(axis))
    mf = _flake_D(ctx, hn.dot(axis)) / (2.0 * torch.clamp_min(sigma, 1e-8))
    mix = _mix_eval(ctx, wi, wo)
    out = val
    out = torch.where(ptype == PH_KKAY, kk, out)
    out = torch.where(ptype == PH_MICROFLAKE, mf, out)
    out = torch.where(ptype == PH_MIX, mix, out)
    return out


def phase_pdf_ctx_v(media: MediumTable, ctx: dict, wi: V3, wo: V3):
    """pdf of :func:`phase_sample_ctx_v` producing wo (for MIS)."""
    pdf = phase_eval_v(ctx["ptype"], ctx["g"], wi, wo)  # value-prop sampling
    if not media.has_fancy_phase:
        return pdf
    ptype = ctx["ptype"]
    axis = ctx["axis"]
    # kkay samples the uniform sphere
    kk = torch.full(pdf.shape, INV_FOURPI, dtype=Float, device=pdf.device)
    # microflake samples m ~ D then mirrors: pdf = D(h) / (2 |wi.h|)
    hn = _flake_normal(wi, wo)
    mf = _flake_D(ctx, hn.dot(axis)) / (
        2.0 * torch.clamp_min(torch.abs(wi.dot(hn)), 1e-6))
    mix_tot = sum(ctx["mix_w"][k] for k in range(MIX_MAX))
    mix = _mix_eval(ctx, wi, wo) / torch.clamp_min(mix_tot, 1e-8)
    pdf = torch.where(ptype == PH_KKAY, kk, pdf)
    pdf = torch.where(ptype == PH_MICROFLAKE, mf, pdf)
    pdf = torch.where(ptype == PH_MIX, mix, pdf)
    return pdf


def phase_sample_ctx_v(media: MediumTable, ctx: dict, wi: V3, u0, u1, u2):
    """Sample wo; returns (wo V3, pdf, weight = eval / pdf)."""
    if not media.has_fancy_phase:
        wo, pdf = phase_sample_v(ctx["ptype"], ctx["g"], wi, u0, u1)
        return wo, pdf, torch.ones_like(pdf)

    ptype = ctx["ptype"]
    axis = ctx["axis"]

    # mixture: pick a component by weight, then value-proportional sampling
    mix_tot = sum(ctx["mix_w"][k] for k in range(MIX_MAX))
    cum = torch.zeros_like(mix_tot)
    sel_t = ctx["mix_type"][0]
    sel_g = ctx["mix_g"][0]
    for k in range(MIX_MAX):
        lo = cum
        cum = cum + ctx["mix_w"][k] / torch.clamp_min(mix_tot, 1e-8)
        inside = (u2 >= lo) & (u2 < torch.clamp_max(cum, 1.0 - 1e-7) + 1e-7)
        pick = inside & (ctx["mix_w"][k] > 0)
        sel_t = torch.where(pick, ctx["mix_type"][k], sel_t)
        sel_g = torch.where(pick, ctx["mix_g"][k], sel_g)
    eff_t = torch.where(ptype == PH_MIX, sel_t, ptype)
    eff_g = torch.where(ptype == PH_MIX, sel_g, ctx["g"])
    wo_s, _ = phase_sample_v(eff_t, eff_g, wi, u0, u1)

    # kkay: uniform sphere
    wo_kk = v.square_to_uniform_sphere(u0, u1)

    # microflake: m ~ D (Gaussian in m.axis via erfinv), wo mirrors wi
    s = 1.0 / torch.sqrt(torch.clamp_min(2.0 * ctx["inv2s2"], 1e-8))
    emax = torch.erf(1.0 / (math.sqrt(2.0) * torch.clamp_min(s, 1e-6)))
    t = math.sqrt(2.0) * s * torch.erfinv(
        torch.clamp((2.0 * u0 - 1.0) * emax, -0.999999, 0.999999))
    t = torch.clamp(t, -1.0, 1.0)
    st_m = safe_sqrt(1.0 - t * t)
    phi = 2.0 * math.pi * u1
    m = v.to_world(v.frame_from_normal(axis),
                   V3(st_m * torch.cos(phi), st_m * torch.sin(phi), t))
    wo_mf = m * (2.0 * wi.dot(m)) - wi

    wo = wo_s
    wo = v.where(ptype == PH_KKAY, wo_kk, wo)
    wo = v.where(ptype == PH_MICROFLAKE, wo_mf, wo)
    pdf = phase_pdf_ctx_v(media, ctx, wi, wo)
    val = phase_eval_ctx_v(media, ctx, wi, wo)
    weight = torch.where(pdf > 1e-12, val / torch.clamp_min(pdf, 1e-12), 0.0)
    # value-proportional families keep weight exactly 1 (the mixture its
    # weight total)
    simple = ((ptype == PH_ISOTROPIC) | (ptype == PH_HG)
              | (ptype == PH_RAYLEIGH))
    weight = torch.where(simple, 1.0, weight)
    weight = torch.where(ptype == PH_MIX, mix_tot, weight)
    return wo, pdf, weight
