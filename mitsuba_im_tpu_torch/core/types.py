"""Dtype policy and renderer constants (``mitsuba_im_tpu/core/types.py``).

Geometry and accumulation are float32, ids int32, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

Float = torch.float32
Int = torch.int32

# reference include/mitsuba/core/constants.h (single precision build)
EPSILON = 1e-4
SHADOW_EPSILON = 1e-3

INVALID = -1  # sentinel index (no shape / no emitter / no texture)


def host_tensor(a, dtype, device) -> torch.Tensor:
    """A numpy value (any rank, 0-d included) copied to a tensor of the
    numpy ``dtype`` on ``device``."""
    return torch.from_numpy(np.array(a, dtype)).to(device)


def entry_device(device) -> torch.device:
    """The device of a public entry point (``"cuda"`` by default there).

    Raises when CUDA is asked for and absent: nothing falls back to the CPU,
    which a caller must ask for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but CUDA is not available; pass "
            "device='cpu' to run on the CPU (the kernels' plain versions)")
    return dev
