"""Hierarchy traversal: the CUDA kernels of ``csrc/hier_traverse.cu`` and
their plain PyTorch version (:func:`.hierarchy.intersect_hierarchy_plain`).

Replaces ``mitsuba_im_tpu/accel/hier_kernel.py``: both ``hier_closest`` and
``hier_anyhit`` stand for ``_step_kernel`` (:81, reached from ``_round``
:588), ``_step_kernel2`` (:285, ``_round2`` :553) and ``_advance_kernel``
(:439, ``_advance_all`` :522), and for the driver around them: one launch
runs the whole traversal of every ray.

A motion hierarchy (``Hierarchy.has_motion``) goes to the kernel's motion
mode, ``hier_closest_motion`` / ``hier_anyhit_motion``: the same traversal
with each tested cluster row lerped between the two keyframes' tables at
the hierarchy's shutter time, bit for bit with the plain version's lerp;
it counts in the same ``launches`` as the static mode, and in
``motion_launches``.

Dispatch, as in :mod:`.cuda_intersect`: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the wrapper raises.  Each
wrapper counts its kernel launches in a plain integer attribute
(``hier_closest.launches``).  The library is built at first use with
``nvcc`` (sm_90a, -O3, -fmad=false) by :mod:`.shared_lib`, with the
list capacity, the culling-box width and the counter size defined here
(the kernel checks them against its layout at compile time).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import Float, Int
from .cuda_intersect import NVCC_FLAGS, _check, _device, _ptrs, _rays
from .hierarchy import SWEEP_GROUP, Hierarchy, intersect_hierarchy_plain
from .shared_lib import SharedLibrary, nvcc

# The version of the C entry points this binding calls (hier_interface):
# 3 is 2 (hier_closest, hier_anyhit) and the motion mode's two entries.
INTERFACE = 3
# Supers a ray's list holds: a ray whose first sweep enters more keeps full
# sweeps.
LIST_CAPACITY = 64
# Words of the kernel's ray counters: 16 counters and the count of the
# blocks done, one per 128 bytes.
COUNTER_WORDS = (16 + 1) * 32


def bind_static(lib):
    """Bind the static entry points of interface 2 and later."""
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p] * 9 + [i] + [p, p, i, i] + [p] * 7 + [i, i]
    lib.hier_closest.argtypes = args + [p] * 6 + [p, p]
    lib.hier_closest.restype = i
    lib.hier_anyhit.argtypes = args + [p] + [p, p]
    lib.hier_anyhit.restype = i
    return args


def _bind(lib):
    if lib.hier_interface() != INTERFACE:
        raise RuntimeError(f"hier_traverse: interface {lib.hier_interface()}"
                           f", this binding calls {INTERFACE}")
    p, i = ctypes.c_void_p, ctypes.c_int
    args = bind_static(lib) + [p, ctypes.c_float]
    lib.hier_closest_motion.argtypes = args + [p] * 6 + [p, p]
    lib.hier_closest_motion.restype = i
    lib.hier_anyhit_motion.argtypes = args + [p] + [p, p]
    lib.hier_anyhit_motion.restype = i


BUILD_FLAGS = NVCC_FLAGS + (f"-DKLIST={LIST_CAPACITY}",
                            f"-DSWEEP_GROUP={SWEEP_GROUP}",
                            f"-DCOUNTER_WORDS={COUNTER_WORDS}")
LIBRARY = SharedLibrary("hier_traverse.cu", nvcc, BUILD_FLAGS, _bind)
# The ray counters of each (device, stream), zeroed once: every launch
# leaves them zero (its last block resets them).
_COUNTERS: dict = {}


def _kernel_args(h: Hierarchy, o, d, tmin, tmax, active):
    comps, n, dev = _rays(o, d, tmin, tmax)
    if h.device != dev:
        raise ValueError("the hierarchy must lie on the rays' device")
    if active is not None and (active.shape != (n,) or active.dtype
                               != torch.bool or active.device != dev):
        raise ValueError("active must be an (N,) bool tensor on the rays' "
                         "device")
    comps = [c.contiguous() for c in comps]
    act = None if active is None else active.contiguous()
    tabs = [h.swp_lo, h.swp_hi, h.childs, h.blocks, h.sup_inst, h.inst_inv,
            h.sup_blas, h.root, h.sweep_groups, h.blocks1]
    if not all(t.is_contiguous() for t in tabs):
        raise ValueError("hierarchy tables must be contiguous")
    if h.childs.data_ptr() % 8 or h.blocks.data_ptr() % 8 or (
            h.has_motion and h.blocks1.data_ptr() % 8):
        raise ValueError("childs and blocks must be 8-byte aligned (the "
                         "kernel reads their rows as float2)")
    if h.has_motion and h.blocks1.shape != h.blocks.shape:
        raise ValueError("blocks1 must have the shape of blocks")
    args = [*_ptrs(comps), None if act is None else act.data_ptr(), n,
            h.swp_lo.data_ptr(), h.swp_hi.data_ptr(), h.swp_lo.shape[1],
            h.n_supers, *_ptrs(tabs[2:9]), int(h.instanced), int(h.indirect)]
    if h.has_motion:
        args += [h.blocks1.data_ptr(), h.time]
    # keep the contiguous copies alive until the launch is queued
    return args, (comps, act), n, dev


def _launch(entry, args, outs, dev):
    """Queue the C entry point ``entry`` (of interface INTERFACE) with the
    kernel arguments, the outputs and the ray counters on the current
    stream of ``dev``."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _COUNTERS.get((dev, stream))
    if counters is None:
        counters = _COUNTERS[dev, stream] = torch.zeros(
            COUNTER_WORDS, dtype=Int, device=dev)
    with torch.cuda.device(dev):
        err = entry(*args, *_ptrs((*outs, counters)), stream)
    _check(err, entry.__name__)


def hier_closest(h: Hierarchy, o, d, tmin, tmax, active=None):
    """Closest hit of SoA rays over the hierarchy -> (t, u, v, prim, inst,
    found) as in :class:`.hierarchy.HierHits`."""
    if _device(o) == "cpu":
        return intersect_hierarchy_plain(h, o, d, tmin, tmax,
                                         active=active)[0]
    args, keep, n, dev = _kernel_args(h, o, d, tmin, tmax, active)
    lib = LIBRARY.load()
    out = tuple(torch.empty(n, dtype=dt, device=dev) for dt in (
        Float, Float, Float, Int, Int, torch.bool))
    if n:
        _launch(lib.hier_closest_motion if h.has_motion else lib.hier_closest,
                args, out, dev)
        hier_closest.launches += 1
        hier_closest.motion_launches += int(h.has_motion)
    return out


def hier_anyhit(h: Hierarchy, o, d, tmin, tmax, active=None):
    """Does anything block each ray within (tmin, tmax)?  (N,) bool."""
    if _device(o) == "cpu":
        return intersect_hierarchy_plain(h, o, d, tmin, tmax, any_hit=True,
                                         active=active)[0].found
    args, keep, n, dev = _kernel_args(h, o, d, tmin, tmax, active)
    lib = LIBRARY.load()
    blocked = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch(lib.hier_anyhit_motion if h.has_motion else lib.hier_anyhit,
                args, (blocked,), dev)
        hier_anyhit.launches += 1
        hier_anyhit.motion_launches += int(h.has_motion)
    return blocked


def reset_launch_counts():
    for fn in (hier_closest, hier_anyhit):
        fn.launches = 0
        fn.motion_launches = 0


reset_launch_counts()
