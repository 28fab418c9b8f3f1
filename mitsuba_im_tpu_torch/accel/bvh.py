"""Host binned-SAH BVH build (``mitsuba_im_tpu/accel/bvh.py``,
``build_bvh_arrays`` and ``tri_bounds``) over ``csrc/bvh_build.cpp``.

The builder is the reference's C++ one, copied and compiled with the
reference Makefile's flags, so the port's tree (and the cluster hierarchy
packed from it) equals the JAX package's bit for bit.  There is no numpy
fallback: a median split would quietly change the tables, so a failed
build raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .shared_lib import SharedLibrary, cxx

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
LD_FLAGS = ("-shared", "-lpthread")


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int32
    lib.mitpu_build_bvh.argtypes = [i, p, p, p, i, p, p, p, p, p, p]
    lib.mitpu_build_bvh.restype = i
    lib.mitpu_tri_bounds.argtypes = [i, p, p, p, p, p, p]
    lib.mitpu_tri_bounds.restype = None


LIBRARY = SharedLibrary("bvh_build.cpp", cxx, CXX_FLAGS, _bind, LD_FLAGS)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_bvh_arrays(prim_lo: np.ndarray, prim_hi: np.ndarray,
                     leaf_size: int = 4) -> dict:
    """Threaded depth-first BVH over per-primitive AABBs -> dict of numpy
    arrays (node_lo/node_hi/node_start/node_count/node_skip/order)."""
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    cent = np.ascontiguousarray((lo + hi) * 0.5, np.float32)
    n = len(lo)
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    max_nodes = 2 * n
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    node_start = np.empty(max_nodes, np.int32)
    node_count = np.empty(max_nodes, np.int32)
    node_skip = np.empty(max_nodes, np.int32)
    order = np.empty(n, np.int32)
    n_nodes = LIBRARY.load().mitpu_build_bvh(
        n, _ptr(lo), _ptr(hi), _ptr(cent), leaf_size, _ptr(node_lo),
        _ptr(node_hi), _ptr(node_start), _ptr(node_count), _ptr(node_skip),
        _ptr(order))
    return dict(node_lo=node_lo[:n_nodes].copy(),
                node_hi=node_hi[:n_nodes].copy(),
                node_start=node_start[:n_nodes].copy(),
                node_count=node_count[:n_nodes].copy(),
                node_skip=node_skip[:n_nodes].copy(),
                order=order)


def tri_bounds(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Per-triangle AABBs (lo, hi) of a (p0, e1, e2) soup."""
    p0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (p0, e1, e2))
    n = len(p0)
    lo = np.empty((n, 3), np.float32)
    hi = np.empty((n, 3), np.float32)
    cent = np.empty((n, 3), np.float32)
    LIBRARY.load().mitpu_tri_bounds(n, _ptr(p0), _ptr(e1), _ptr(e2),
                                    _ptr(lo), _ptr(hi), _ptr(cent))
    return lo, hi
