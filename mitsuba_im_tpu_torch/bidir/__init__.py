"""Path-space tools (``mitsuba_im_tpu/bidir/``): the verification harness
over the bidirectional path tracer's subpaths (``verification.py``), the
splat sampler that evaluates every bidirectional strategy of a
primary-sample table (``pathsampler.py``, the bidirectional mode of
pssmlt, mlt and erpt) and the batched specular manifold walk behind mlt's
manifold perturbation (``manifold.py``)."""
