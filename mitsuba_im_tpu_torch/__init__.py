"""mitsuba_im_tpu_torch — the PyTorch/CUDA port of ``mitsuba_im_tpu``.

The port mirrors the JAX package's module paths (``core/rng.py`` is the
counterpart of ``mitsuba_im_tpu/core/rng.py``, ``accel/cuda_intersect.py``
of ``accel/pallas_intersect.py``) and keeps its component-SoA public
layout, so every stage can be held against the reference on the same
inputs.  It imports ``torch`` and never ``jax``, directly or through
``mitsuba_im_tpu``.

Covered so far: the forward wavefront path tracer
(``integrators/path.py::path_li_v`` driven by ``render/job.py::render_film``)
with every untextured BSDF family but IRAWAN, triangle-mesh area emitters,
the constant environment and the lat-long environment map (given as pixels
or baked from the Hosek-Wilkie sky, ``emitter/hosek.py``), a perspective
sensor and the box-filter film, on the
Cornell box (brute-force intersection, ``csrc/tri_intersect.cu``) and on
large scenes (the two-level cluster hierarchy, ``csrc/hier_traverse.cu``),
both through hand-written CUDA kernels; its reverse-mode gradients with
respect to BSDF and emitter parameters by path replay
(``torch.utils.checkpoint``) and the inverse-rendering loop
(``diff/optimize.py``).  Everything else raises ``NotImplementedError``.  Public entry points run on the card unless the
CPU is asked for.
"""

__version__ = "0.1.0"
