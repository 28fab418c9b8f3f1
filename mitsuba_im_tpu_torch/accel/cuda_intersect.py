"""Brute-force ray/triangle queries: the CUDA kernels of
``csrc/tri_intersect.cu`` and their plain PyTorch versions.

Replaces ``mitsuba_im_tpu/accel/pallas_intersect.py``: ``closest_tris_v``
and ``closest_hit_v`` stand for ``_closest_planes``/``_closest_kernel``
(:228, :79) and ``anyhit_tris_v`` for ``_anyhit_planes``/``_anyhit_kernel``
(:251, :130).

What bounds them on the H100: on the main path each ray reads its origin
and direction (24 B) and the closest query writes the 24 B hit record (the
any-hit query reads a 4 B tmax and writes 1 B), ~15 us (~9 us) per 2^20
rays at 3.35 TB/s.  The arithmetic is ~40 flops per ray-triangle pair, but
unfused and with an IEEE reciprocal it issues ~80 instructions for a pair
that passes every test, so the card's issue rate sets the floor at the
Cornell box's 12 triangles already, and rules at 512.  The kernel stages
the soup (T <= 512 triangles, 24 KB) in each block's shared memory and
rejects a pair at the first rounded value that rules it out; the source
note says how.

Dispatch: a CPU tensor goes to the plain version, which is the broadcast
Moeller-Trumbore with argmin of ``mitsuba_im_tpu/accel/intersect.py``
(:147-152, :555-559), evaluated in ray chunks; a CUDA tensor goes to the
kernel, or the wrapper raises.  ``closest_tris_v`` returns (t, u, v, prim,
found); ``closest_hit_v`` the hit record of a scene of triangles only, (t,
kind, prim, shape, u, v) in the field order of ``scene.geometry.Hit``,
which the kernel writes itself (plain version: :func:`hit_record_plain`).
Both launch the closest-hit kernel and count it in
``closest_tris_v.launches``; ``anyhit_tris_v.launches`` counts the other.

``tmin`` and ``tmax`` may be numbers, 0-dim tensors or (N,) float32
tensors of any stride.  The kernels take a number as a float32 argument
(``ctypes.c_float`` rounds to nearest, as ``torch.full`` does for the plain
version) and a tensor as a pointer with its stride (0 for a 0-dim or
expanded one): nothing is filled or copied per call.  The outputs of a
call are views of one buffer.

The library is built at first use with ``nvcc`` (sm_90a, -O3, -fmad=false)
by :mod:`.shared_lib` and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import INVALID, Float, Int
from ..scene.geometry import KIND_NONE, KIND_TRI
from .shared_lib import SharedLibrary, nvcc

MAX_TRIS = 512
BIG = 3.0e37
_CHUNK_ELEMS = 1 << 22  # rays x tris per plain-version chunk (~16 MB/temp)
# The version of the C entry points this binding calls (tri_interface).
INTERFACE = 2

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_FLAGS = NVCC_FLAGS + (f"-DKIND_NONE={KIND_NONE}",
                            f"-DKIND_TRI={KIND_TRI}",
                            f"-DINVALID_ID={INVALID}")


def _bind(lib):
    if lib.tri_interface() != INTERFACE:
        raise RuntimeError(f"tri_intersect: interface {lib.tri_interface()}"
                           f", this binding calls {INTERFACE}")
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p] * 6 + [p, ctypes.c_longlong, ctypes.c_float] * 2 + [p] * 3 \
        + [i, i]
    lib.tri_closest.argtypes = args + [p] * 8 + [p]
    lib.tri_closest.restype = i
    lib.tri_anyhit.argtypes = args + [p] + [p]
    lib.tri_anyhit.restype = i


LIBRARY = SharedLibrary("tri_intersect.cu", nvcc, BUILD_FLAGS, _bind)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _rays(o, d, tmin, tmax):
    """Validate the SoA rays; expand scalar tmin/tmax to (N,) tensors (the
    plain versions' and the hierarchy kernels' form)."""
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


def _device(o):
    if o.x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {o.x.device}")
    return o.x.device.type


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _moeller_trumbore(r, p0, e1, e2, tlim):
    """(R, 1) ray components against (1, T) triangle components; the same
    operations in the same order as the kernel.  Returns (hit, t, u, v,
    ok), ``ok`` the determinant test."""
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
    return hit, t, u, v, ok


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
        hit, t, u, v, _ = _moeller_trumbore(r[:7], p0, e1, e2, r[7])
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


def hit_record_plain(tri_shape, t, u, v, prim, found):
    """The closest-hit kernel's record epilogue: (t, kind, prim, shape, u,
    v) from :func:`closest_tris_plain`'s (t, u, v, prim, found), as
    ``accel/intersect.py``'s merge makes it when no sphere or disk can be
    hit (BIG, KIND_NONE, 0, INVALID, 0, 0 on a miss)."""
    return (torch.where(found, t, BIG),
            torch.where(found, KIND_TRI, KIND_NONE).to(Int),
            torch.where(found, prim, 0),
            torch.where(found, tri_shape[prim], INVALID),
            torch.where(found, u, 0.0), torch.where(found, v, 0.0))


def anyhit_tris_plain(p0, e1, e2, o, d, tmin, tmax):
    """Does any triangle block the ray within (tmin, tmax)?  (N,) bool."""
    comps, n, dev = _rays(o, d, tmin, tmax)
    T = _tris(p0, e1, e2, dev)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    for a, b in _chunks(n, T):
        r = [c[a:b, None] for c in comps]
        hit = _moeller_trumbore(r[:7], p0, e1, e2, r[7])[0]
        blocked[a:b] = hit.any(dim=1)
    return blocked


# ---------------------------------------------------------------------------
# wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

def _bound(c, n, dev):
    """tmin or tmax as the kernels take it: (pointer, stride, value) and
    the tensor to keep alive until the launch is queued."""
    if not isinstance(c, torch.Tensor):
        return (None, 0, float(c)), None
    if c.dim() == 0:
        if c.dtype != Float:
            c = c.to(Float)
        stride = 0
    elif c.shape == (n,):
        stride = c.stride(0)
    else:
        stride = None
    if stride is None or c.dtype != Float or c.device != dev:
        raise ValueError("tmin/tmax must be numbers, or 0-dim or (N,) "
                         "float32 tensors on the rays' device")
    return (c.data_ptr(), stride, 0.0), c


def _kernel_args(p0, e1, e2, o, d, tmin, tmax):
    """The entry points' arguments up to n, the tensors to keep alive, n
    and the device."""
    comps = [c.contiguous() for c in (*o, *d)]
    n, dev = comps[0].shape[0], comps[0].device
    for c in comps:
        if c.shape != (n,) or c.dtype != Float or c.device != dev:
            raise ValueError("rays must be (N,) float32 tensors on one device")
    T = _tris(p0, e1, e2, dev)
    tris = [a.contiguous() for a in (p0, e1, e2)]
    lo, keep_lo = _bound(tmin, n, dev)
    hi, keep_hi = _bound(tmax, n, dev)
    args = [*_ptrs(comps), *lo, *hi, *_ptrs(tris), T, n]
    return args, (comps, tris, keep_lo, keep_hi), n, dev


def _launch(entry, args, dev):
    """Queue ``entry`` on the current stream of ``dev``."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = entry(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = entry(*args, stream)
    _check(err, entry.__name__)


def _closest(lib, p0, e1, e2, tri_shape, o, d, tmin, tmax):
    """Launch ``lib``'s closest-hit kernel without counting: (t, u, v,
    prim, found), or with ``tri_shape`` the hit record (t, kind, prim,
    shape, u, v)."""
    args, keep, n, dev = _kernel_args(p0, e1, e2, o, d, tmin, tmax)
    if tri_shape is None:
        buf = torch.empty(17 * n, dtype=torch.uint8, device=dev)
        t, u, v, prim = buf[:16 * n].view(Float).view(4, n).unbind(0)
        prim, found = prim.view(Int), buf[16 * n:].view(torch.bool)
        outs = (t, u, v, prim, found)
        ptrs = [None, *_ptrs(outs), None, None]
    else:
        if (tri_shape.shape != p0.shape[:1] or tri_shape.dtype != Int
                or tri_shape.device != dev):
            raise ValueError("tri_shape must be a (T,) int32 tensor on the "
                             "rays' device")
        tri_shape = tri_shape.contiguous()
        t, u, v, prim, kind, shape = torch.empty(
            (6, n), dtype=Float, device=dev).unbind(0)
        prim, kind, shape = prim.view(Int), kind.view(Int), shape.view(Int)
        outs = (t, kind, prim, shape, u, v)
        ptrs = [tri_shape.data_ptr(), *_ptrs((t, u, v, prim)), None,
                *_ptrs((kind, shape))]
    if n:
        _launch(lib.tri_closest, args + ptrs, dev)
    return outs


def _anyhit(lib, p0, e1, e2, o, d, tmin, tmax):
    """Launch ``lib``'s any-hit kernel without counting -> (N,) bool."""
    args, keep, n, dev = _kernel_args(p0, e1, e2, o, d, tmin, tmax)
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch(lib.tri_anyhit, [*args, blocked.data_ptr()], dev)
    return blocked


def closest_tris_v(p0, e1, e2, o, d, tmin, tmax):
    """Closest hit over the soup for SoA rays (o, d: V3 of (N,) tensors).

    Returns (t, u, v, prim, found) as in :func:`closest_tris_plain`."""
    if _device(o) == "cpu":
        return closest_tris_plain(p0, e1, e2, o, d, tmin, tmax)
    out = _closest(LIBRARY.load(), p0, e1, e2, None, o, d, tmin, tmax)
    if out[0].numel():
        closest_tris_v.launches += 1
    return out


def closest_hit_v(p0, e1, e2, tri_shape, o, d, tmin, tmax):
    """The hit record (t, kind, prim, shape, u, v) of a scene whose only
    primitives are the soup, ``tri_shape`` (T,) giving each triangle's
    shape id; the kernel's launches count in ``closest_tris_v.launches``."""
    if _device(o) == "cpu":
        return hit_record_plain(tri_shape, *closest_tris_plain(
            p0, e1, e2, o, d, tmin, tmax))
    out = _closest(LIBRARY.load(), p0, e1, e2, tri_shape, o, d, tmin, tmax)
    if out[0].numel():
        closest_tris_v.launches += 1
    return out


def anyhit_tris_v(p0, e1, e2, o, d, tmin, tmax):
    """Any-hit over the soup for SoA rays -> (N,) bool."""
    if _device(o) == "cpu":
        return anyhit_tris_plain(p0, e1, e2, o, d, tmin, tmax)
    out = _anyhit(LIBRARY.load(), p0, e1, e2, o, d, tmin, tmax)
    if out.numel():
        anyhit_tris_v.launches += 1
    return out


closest_tris_v.launches = 0
anyhit_tris_v.launches = 0


def reset_launch_counts():
    closest_tris_v.launches = 0
    anyhit_tris_v.launches = 0
