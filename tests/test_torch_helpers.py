"""Shared helpers of the port's tests (``tests/test_torch_*.py``), and the
test of the image gate they use.

The JAX package is the reference: it runs on the CPU (``tests/conftest.py``
forces that), where its intersector takes the jnp branch that is the
Pallas kernels' plain reference.  Inputs are made with numpy and handed to
both packages; results come back as numpy arrays.

Tolerances: integer outputs (RNG words, found/kind/prim/shape) must match
exactly, except rays whose best hit ties on t.  Float outputs must agree to
rel 1e-5 (RTOL), with ATOL 1e-6 for values of unit scale near zero: the
transcendentals of XLA and PyTorch on the CPU differ in the last bits.
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RTOL = 1e-5
ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def jax_cornell():
    """The reference's Cornell box (JAX scene, settings)."""
    from __graft_entry__ import _tiny_cornell

    return _tiny_cornell()


def bridged(jscene, device="cpu"):
    from mitsuba_im_tpu_torch.scene.bridge import export_tables, scene_from_numpy

    arrays, statics = export_tables(jscene)
    return scene_from_numpy(arrays, statics, device)


def jax_shapes_scene(sphere_bsdf: dict | None = None,
                     environment: bool = False):
    """A small JAX scene with triangles, two spheres and a disk; the first
    sphere takes the BSDF record ``sphere_bsdf`` when one is given, and a
    unit constant environment joins the area light with ``environment``."""
    from mitsuba_im_tpu.bsdf import common as bc
    from mitsuba_im_tpu.emitter import table as et
    from mitsuba_im_tpu.scene.build import SceneBuilder
    from mitsuba_im_tpu.scene.mesh import TriMesh

    b = SceneBuilder()
    bid = b.add_bsdf(bc.default_record())
    sph = bid if sphere_bsdf is None else b.add_bsdf(sphere_bsdf)
    quad = TriMesh(np.array([[-2, -1, -2], [2, -1, -2], [2, -1, 2],
                             [-2, -1, 2]], float),
                   np.array([[0, 1, 2], [2, 3, 0]]))
    b.add_trimesh(quad, b.new_shape(bid))
    b.add_sphere([0.0, 0.0, 0.0], 0.5, b.new_shape(sph))
    b.add_sphere([0.8, 0.2, -0.5], 0.3, b.new_shape(bid))
    b.add_disk([0.0, 0.0, -1.5], [0, 0, 1], [1, 0, 0], [0, 1, 0], 0.8,
               b.new_shape(bid))
    light = TriMesh(np.array([[-0.3, 1.5, -0.3], [0.3, 1.5, -0.3],
                              [0.3, 1.5, 0.3], [-0.3, 1.5, 0.3]], float),
                    np.array([[0, 2, 1], [0, 3, 2]]))
    lsid = b.new_shape(bid)
    b.add_trimesh(light, lsid)
    b.add_emitter(dict(type=et.EM_AREA, radiance=np.array([5.0, 5.0, 5.0]),
                       shape=lsid))
    b.shape_emitter[lsid] = 0
    if environment:
        from mitsuba_im_tpu.core.properties import Properties
        from mitsuba_im_tpu.core.registry import create

        b.add_emitter(create("emitter", Properties("constant"), b))
    return b.build()[0]


def scene_leaves(scene) -> dict:
    """{"<part>.<field>": tensor or static} of a port Scene, the cluster
    hierarchy's and the deformable motion mirror's included when the scene
    has them, the media table, the shapes' and the camera's media, the
    shapes' subsurface records and the subsurface table but its traced
    irradiance, and the shutter the scene's build read to the host."""
    import dataclasses

    out = {}
    for part in ("geom", "bsdfs", "textures", "emitters", "sensor",
                 "clusters"):
        obj = getattr(scene, part)
        if obj is None:
            out[part] = None
            continue
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = getattr(obj, f.name)
    for f in dataclasses.fields(scene.media):
        out[f"media.{f.name}"] = getattr(scene.media, f.name)
    for k in ("shape_bsdf", "shape_emitter", "shape_interior",
              "shape_exterior", "shape_subsurface"):
        out[f"scene.{k}"] = getattr(scene, k)
    if scene.subsurface is None:
        out["subsurface"] = None
    else:
        # the points' irradiance is traced by each package's own build
        # (held at f32 tolerance in test_torch_subsurface.py)
        for f in dataclasses.fields(scene.subsurface):
            if f.name != "irr":
                out[f"subsurface.{f.name}"] = getattr(scene.subsurface,
                                                      f.name)
    out["scene.shutter"] = scene.shutter
    out["scene.camera_medium"] = scene.camera_medium
    if scene.motion is None:
        out["motion"] = None
    else:
        for k, t in scene.motion.items():
            out[f"motion.{k}"] = t
    return out


def assert_same_scene(port, ref) -> None:
    """Every leaf of the port Scene ``port`` equals ``ref``'s (a bridged
    reference scene) bit for bit, dtypes and statics included."""
    a, b = scene_leaves(ref), scene_leaves(port)
    assert a.keys() == b.keys()
    for key, x in a.items():
        y = b[key]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert torch.equal(x, y), key
        else:
            assert x == y, key


def npy(x) -> np.ndarray:
    """torch tensor / jax array / python value -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words(x) -> np.ndarray:
    """32-bit words of either package as uint64 numpy."""
    return npy(x).astype(np.uint64)


def tv3(a: np.ndarray):
    """(N, 3) numpy -> the port's V3 of float32 tensors."""
    from mitsuba_im_tpu_torch.core.v3 import V3

    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))


def jv3(a: np.ndarray):
    """(N, 3) numpy -> the reference's V3 of float32 jax arrays."""
    import jax.numpy as jnp
    from mitsuba_im_tpu.core.v3 import V3

    a = np.asarray(a, np.float32)
    return V3(*(jnp.asarray(a[:, k]) for k in range(3)))


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(npy(a), npy(b), rtol=rtol, atol=atol)


def close_v3(a, b, rtol=RTOL, atol=ATOL):
    for ca, cb in zip(a, b):
        close(ca, cb, rtol, atol)


def unit_vectors(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def parity_gate(a: np.ndarray, b: np.ndarray) -> dict:
    """parity_check.py's image gate (parity_check.py:137) of a against b."""
    from parity_check import RTOL as SUM_RTOL, _pix_stats

    rel = abs(float(a.sum()) - float(b.sum())) / max(abs(float(b.sum())),
                                                     1e-30)
    st = _pix_stats(a, b)
    st["rel"] = rel
    st["ok"] = rel < SUM_RTOL and st["p999"] < 1e-3 and st["frac_bad"] < 2e-3
    return st


def test_parity_gate_flags_redistribution():
    """The gate passes last-bit noise and fails energy moved between pixels
    (the failure class parity_check.py was written for)."""
    rng = np.random.default_rng(50)
    img = rng.random(4096).astype(np.float32) + 0.1
    noisy = img * (1 + rng.uniform(-1e-6, 1e-6, img.shape)).astype(np.float32)
    assert parity_gate(noisy, img)["ok"]
    moved = img.copy()
    moved[:512] *= 1.3
    moved[512:1024] -= moved[:512] - img[:512]
    assert abs(moved.sum() - img.sum()) / img.sum() < 1e-4
    assert not parity_gate(moved, img)["ok"]
