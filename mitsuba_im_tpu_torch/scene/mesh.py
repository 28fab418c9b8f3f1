"""Host-side indexed triangle mesh (the container of
``mitsuba_im_tpu/scene/mesh.py``; its loaders are not ported).

``scene/build.py`` reads only these attributes (``colors`` only for a
vertexcolors texture), so a mesh from the reference's OBJ/PLY/serialized
loaders can be passed in as it is.
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
    colors: np.ndarray | None = None  # (V, 3) linear rgb

    def compute_normals(self) -> "TriMesh":
        """Area-weighted smooth vertex normals (TriMesh::computeNormals),
        accumulated in the reference's order."""
        p = self.positions
        i = self.indices
        fn = np.cross(p[i[:, 1]] - p[i[:, 0]], p[i[:, 2]] - p[i[:, 0]])
        n = np.zeros_like(p)
        for k in range(3):
            np.add.at(n, i[:, k], fn)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = np.divide(n, ln, out=np.zeros_like(n), where=ln > 0)
        return self
