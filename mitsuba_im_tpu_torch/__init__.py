"""mitsuba_im_tpu_torch — the PyTorch/CUDA port of ``mitsuba_im_tpu``.

The port mirrors the JAX package's module paths (``core/rng.py`` is the
counterpart of ``mitsuba_im_tpu/core/rng.py``, ``accel/cuda_intersect.py``
of ``accel/pallas_intersect.py``) and keeps its component-SoA public
layout, so every stage can be held against the reference on the same
inputs.  It imports ``torch`` and never ``jax``, directly or through
``mitsuba_im_tpu``.

Covered: every integrator of the JAX package (``path`` through
``render/job.py::render_film``; ``volpath``, ``direct``, ``ao``, ``field``
and ``motion`` beside it; the light tracers, photon mapping, VPL, the
irradiance cache, adaptive sampling, multichannel output and the three
Metropolis integrators through ``render/job.py::render``) with every BSDF
family (IRAWAN included), the MASK and BLEND wrappers, textured
parameters, bump and normal maps, every emitter, sampler kind, sensor and
reconstruction filter, participating media and subsurface scattering, on
the Cornell box (brute-force intersection, ``csrc/tri_intersect.cu``) and
on large scenes (the two-level cluster hierarchy,
``csrc/hier_traverse.cu``), both through hand-written CUDA kernels; the
scene files and the command line (``cli/main.py``), rendering across
processes (``parallel/mesh.py``, a ``torch.distributed`` group) and across
render nodes (``parallel/remote.py``, ``cli/mtssrv.py``), the interactive
renderer (``interactive/``); reverse-mode gradients of ``path`` with
respect to BSDF, texture-atlas and emitter parameters by path replay
(``torch.utils.checkpoint``), subsurface scenes included, and the
inverse-rendering loop (``diff/optimize.py``).  Not ported: the host tools
``mtsutil``, ``mtsimport`` and their libraries (``ROADMAP.md`` queue A
item 8); a coating over a non-diffuse substrate raises
``NotImplementedError``.  Public entry points run on the card unless the
CPU is asked for.
"""

__version__ = "0.1.0"
