"""mitsuba_im_tpu_torch — the PyTorch/CUDA port of ``mitsuba_im_tpu``.

The port mirrors the JAX package's module paths (``core/rng.py`` is the
counterpart of ``mitsuba_im_tpu/core/rng.py``, ``accel/cuda_intersect.py``
of ``accel/pallas_intersect.py``) and keeps its component-SoA public
layout, so every stage can be held against the reference on the same
inputs.  It imports ``torch`` and never ``jax``, directly or through
``mitsuba_im_tpu``.

Covered so far: the forward Cornell-box wavefront path tracer
(``integrators/path.py::path_li_v`` driven by ``render/job.py::render_film``)
with diffuse BSDFs, triangle-mesh area emitters, a perspective sensor, the
box-filter film, and brute-force intersection through hand-written CUDA
kernels (``csrc/tri_intersect.cu``).  Everything else raises
``NotImplementedError``.
"""

__version__ = "0.1.0"
