"""Path-space tools (``mitsuba_im_tpu/bidir/``): the verification harness
over the bidirectional path tracer's subpaths (``verification.py``) and
the splat sampler that evaluates every bidirectional strategy of a
primary-sample table (``pathsampler.py``, pssmlt's and erpt's
bidirectional mode).  The manifold walk comes with ``mlt`` (ROADMAP queue
A item 7.8)."""
