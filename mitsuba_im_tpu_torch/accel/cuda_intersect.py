"""Brute-force ray/triangle queries: the CUDA kernels of
``csrc/tri_intersect.cu`` and their plain PyTorch versions.

Replaces ``mitsuba_im_tpu/accel/pallas_intersect.py``: ``closest_tris_v``
stands for ``_closest_planes``/``_closest_kernel`` (:228, :79) and
``anyhit_tris_v`` for ``_anyhit_planes``/``_anyhit_kernel`` (:251, :130).

What bounds them on the H100: each ray reads 8 f32 (32 B) and the closest
query writes 4 x 4 B + 1 B, about 49 B per ray, so 1M rays move ~50 MB,
~15 us at 3.35 TB/s.  The arithmetic is ~40 flops per ray-triangle pair:
at the slice's T = 12 that is ~0.5 GFLOP per 1M rays (~7 us at 67 TFLOP/s
float32), and at T = 512 ~20 GFLOP (~0.3 ms).  So the kernels are bound by
memory and launch at the Cornell box and by issue rate on large soups.  The
soup itself (T <= 512 triangles x 9 f32 = 18 KB) fits in one block's static
shared memory with room to spare, so each block stages it once and every
thread reads it as broadcasts: no padded rays, no lane-replicated copies.

Dispatch: a CPU tensor goes to the plain version, which is the broadcast
Moeller-Trumbore with argmin of ``mitsuba_im_tpu/accel/intersect.py``
(:147-152, :555-559), evaluated in ray chunks; a CUDA tensor goes to the
kernel, or the wrapper raises.  Each wrapper counts its kernel launches in
a plain integer attribute (``closest_tris_v.launches``).

The library is built at first use with ``nvcc`` (sm_90a, -O3, -fmad=false)
by :mod:`.shared_lib` and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import Float, Int
from .shared_lib import SharedLibrary, nvcc

MAX_TRIS = 512
BIG = 3.0e37
_CHUNK_ELEMS = 1 << 22  # rays x tris per plain-version chunk (~16 MB/temp)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tri_closest.argtypes = [p] * 11 + [i, i] + [p] * 5 + [p]
    lib.tri_closest.restype = i
    lib.tri_anyhit.argtypes = [p] * 11 + [i, i] + [p] + [p]
    lib.tri_anyhit.restype = i


LIBRARY = SharedLibrary("tri_intersect.cu", nvcc, NVCC_FLAGS, _bind)


# ---------------------------------------------------------------------------
# argument checks shared by both wrappers
# ---------------------------------------------------------------------------

def _rays(o, d, tmin, tmax):
    """Validate the SoA rays; expand scalar tmin/tmax to (N,) tensors."""
    comps = [o.x, o.y, o.z, d.x, d.y, d.z]
    n = comps[0].shape[0]
    dev = comps[0].device
    out = []
    for c in comps + [tmin, tmax]:
        if not isinstance(c, torch.Tensor):
            c = torch.full((n,), float(c), dtype=Float, device=dev)
        elif c.dim() == 0:
            c = c.to(Float).expand(n)
        if c.shape != (n,) or c.dtype != Float or c.device != dev:
            raise ValueError("rays must be (N,) float32 tensors on one device")
        out.append(c)
    return out, n, dev


def _tris(p0, e1, e2, dev):
    T = p0.shape[0]
    for a in (p0, e1, e2):
        if a.shape != (T, 3) or a.dtype != Float or a.device != dev:
            raise ValueError("triangles must be (T, 3) float32 tensors on the "
                             "rays' device")
    if not 1 <= T <= MAX_TRIS:
        raise ValueError(f"brute-force kernels take 1..{MAX_TRIS} triangles, "
                         f"got {T}")
    return T


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _moeller_trumbore(r, p0, e1, e2, tlim):
    """(R, 1) ray components against (1, T) triangle components; the same
    operations in the same order as the kernel."""
    ox, oy, oz, dx, dy, dz, tmin = r
    p0x, p0y, p0z = p0[:, 0], p0[:, 1], p0[:, 2]
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tlim))
    return hit, t, u, v


def _chunks(n, T):
    step = max(1, _CHUNK_ELEMS // T)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def closest_tris_plain(p0, e1, e2, o, d, tmin, tmax):
    """Closest hit per ray: (t, u, v, prim, found); t = BIG, u = v = 0 and
    prim = 0 where nothing is hit."""
    comps, n, dev = _rays(o, d, tmin, tmax)
    T = _tris(p0, e1, e2, dev)
    t_out = torch.empty(n, dtype=Float, device=dev)
    u_out = torch.empty(n, dtype=Float, device=dev)
    v_out = torch.empty(n, dtype=Float, device=dev)
    prim = torch.empty(n, dtype=Int, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    for a, b in _chunks(n, T):
        r = [c[a:b, None] for c in comps]
        hit, t, u, v = _moeller_trumbore(r[:7], p0, e1, e2, r[7])
        tm = torch.where(hit, t, BIG)
        idx = torch.argmin(tm, dim=1)  # first index on ties
        tbest = torch.amin(tm, dim=1)
        ok = tbest < BIG
        t_out[a:b] = torch.where(ok, tbest, BIG)
        u_out[a:b] = torch.where(ok, u.gather(1, idx[:, None])[:, 0], 0.0)
        v_out[a:b] = torch.where(ok, v.gather(1, idx[:, None])[:, 0], 0.0)
        prim[a:b] = torch.where(ok, idx, 0).to(Int)
        found[a:b] = ok
    return t_out, u_out, v_out, prim, found


def anyhit_tris_plain(p0, e1, e2, o, d, tmin, tmax):
    """Does any triangle block the ray within (tmin, tmax)?  (N,) bool."""
    comps, n, dev = _rays(o, d, tmin, tmax)
    T = _tris(p0, e1, e2, dev)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    for a, b in _chunks(n, T):
        r = [c[a:b, None] for c in comps]
        hit, _, _, _ = _moeller_trumbore(r[:7], p0, e1, e2, r[7])
        blocked[a:b] = hit.any(dim=1)
    return blocked


# ---------------------------------------------------------------------------
# wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

def _kernel_inputs(p0, e1, e2, o, d, tmin, tmax):
    comps, n, dev = _rays(o, d, tmin, tmax)
    T = _tris(p0, e1, e2, dev)
    comps = [c.contiguous() for c in comps]
    tris = [a.contiguous() for a in (p0, e1, e2)]
    return comps, tris, n, T, dev


def closest_tris_v(p0, e1, e2, o, d, tmin, tmax):
    """Closest hit over the soup for SoA rays (o, d: V3 of (N,) tensors).

    Returns (t, u, v, prim, found) as in :func:`closest_tris_plain`."""
    if o.x.device.type == "cpu":
        return closest_tris_plain(p0, e1, e2, o, d, tmin, tmax)
    if o.x.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.x.device}")
    comps, tris, n, T, dev = _kernel_inputs(p0, e1, e2, o, d, tmin, tmax)
    lib = LIBRARY.load()
    t = torch.empty(n, dtype=Float, device=dev)
    u = torch.empty(n, dtype=Float, device=dev)
    v = torch.empty(n, dtype=Float, device=dev)
    prim = torch.empty(n, dtype=Int, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return t, u, v, prim, found
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tri_closest(*_ptrs(comps), *_ptrs(tris), n, T,
                              *_ptrs((t, u, v, prim, found)), stream)
    _check(err, "tri_closest")
    closest_tris_v.launches += 1
    return t, u, v, prim, found


def anyhit_tris_v(p0, e1, e2, o, d, tmin, tmax):
    """Any-hit over the soup for SoA rays -> (N,) bool."""
    if o.x.device.type == "cpu":
        return anyhit_tris_plain(p0, e1, e2, o, d, tmin, tmax)
    if o.x.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.x.device}")
    comps, tris, n, T, dev = _kernel_inputs(p0, e1, e2, o, d, tmin, tmax)
    lib = LIBRARY.load()
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return blocked
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tri_anyhit(*_ptrs(comps), *_ptrs(tris), n, T,
                             blocked.data_ptr(), stream)
    _check(err, "tri_anyhit")
    anyhit_tris_v.launches += 1
    return blocked


closest_tris_v.launches = 0
anyhit_tris_v.launches = 0


def reset_launch_counts():
    closest_tris_v.launches = 0
    anyhit_tris_v.launches = 0
