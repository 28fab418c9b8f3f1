"""Path-space tools (``mitsuba_im_tpu/bidir/``): the verification harness
over the bidirectional path tracer's subpaths (``verification.py``).  The
path sampler and the manifold walk come with the MLT family (ROADMAP
queue A item 7.8), which runs them on the MCMC primary-sample table."""
