"""Host-side indexed triangle mesh (the container of
``mitsuba_im_tpu/scene/mesh.py``; its loaders are not ported).

``scene/build.py`` reads only these four attributes, so a mesh from the
reference's OBJ/PLY/serialized loaders can be passed in as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    positions: np.ndarray  # (V, 3)
    indices: np.ndarray  # (F, 3)
    normals: np.ndarray | None = None  # (V, 3)
    uvs: np.ndarray | None = None  # (V, 2)
