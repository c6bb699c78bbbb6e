"""Watertight-mesh containment test, the SIV metric's core (port of
oakink2_tamf_tpu/eval/inside_mesh.py; the reference's
dev_fn/external/libmesh/inside_mesh.py with its Cython TriangleHash).

Rescale to grid coordinates, hash triangles by their 2-D (x, y) bounding
boxes, cast a +z ray from each point and count barycentric-contained
crossings above and below it: inside = both parities odd.
`impl="native"` (the default) runs the port's C++ library
(native/triangle_hash.cpp), built at first use; a failed build raises.
`impl="numpy"` is the plain version: every point against every triangle in
chunks, the same arithmetic in float64.
"""

from __future__ import annotations

import numpy as np

from ..native import inside_mesh_native

IMPLS = ("native", "numpy")


def check_mesh_contains(
    verts: np.ndarray, faces: np.ndarray, points: np.ndarray, hash_resolution: int = 512,
    impl: str = "native",
) -> np.ndarray:
    """verts [V, 3], faces [F, 3], points [N, 3] -> bool [N]."""
    if impl == "native":
        return inside_mesh_native(verts, faces, points, hash_resolution)
    if impl == "numpy":
        return _inside_mesh_numpy(verts, faces, points, hash_resolution)
    raise ValueError(f"unknown inside-mesh impl {impl!r}: one of {IMPLS}")


def _inside_mesh_numpy(verts, faces, points, resolution=512, chunk: int = 2048) -> np.ndarray:
    """Chunks of points against all triangles at once (SIV queries run
    ~1e6-point grids, so no per-point Python loop)."""
    tri = verts[faces].astype(np.float64)  # [F, 3, 3]
    bmin = tri.reshape(-1, 3).min(axis=0)
    bmax = tri.reshape(-1, 3).max(axis=0)
    ext = np.where(bmax - bmin > 0, bmax - bmin, 1.0)
    scale = (resolution - 1) / ext
    trans = 0.5 - scale * bmin
    tri = scale * tri + trans
    pts = scale * points.astype(np.float64) + trans

    contains = np.zeros(len(pts), dtype=bool)
    in_aabb = np.all((pts >= 0) & (pts <= resolution), axis=1)
    if not in_aabb.any():
        return contains
    q_all = pts[in_aabb]

    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]  # [F, 3]
    A00, A01 = a[:, 0] - c[:, 0], b[:, 0] - c[:, 0]
    A10, A11 = a[:, 1] - c[:, 1], b[:, 1] - c[:, 1]
    det = A00 * A11 - A01 * A10
    s_det = np.sign(det)
    abs_det = np.abs(det)
    n = np.cross(c - a, b - a)  # [F, 3]
    nz = n[:, 2]
    abs_nz = np.abs(nz)
    s_nz = np.sign(nz)
    valid_tri = (det != 0) & (nz != 0)

    res_above = np.zeros(len(q_all), dtype=np.int64)
    res_below = np.zeros(len(q_all), dtype=np.int64)
    for start in range(0, len(q_all), chunk):
        q = q_all[start : start + chunk]  # [P, 3]
        y0 = q[:, 0:1] - c[None, :, 0]  # [P, F]
        y1 = q[:, 1:2] - c[None, :, 1]
        u = (A11 * y0 - A01 * y1) * s_det
        v = (-A10 * y0 + A00 * y1) * s_det
        suv = u + v
        hit = (
            valid_tri[None]
            & (0 < u) & (u < abs_det) & (0 < v) & (v < abs_det)
            & (0 < suv) & (suv < abs_det)
        )
        alpha = n[:, 0] * (a[None, :, 0] - q[:, 0:1]) + n[:, 1] * (a[None, :, 1] - q[:, 1:2])
        depth = a[None, :, 2] * abs_nz + alpha * s_nz  # [P, F]
        up = depth >= q[:, 2:3] * abs_nz[None]
        res_above[start : start + chunk] = (hit & up).sum(axis=1)
        res_below[start : start + chunk] = (hit & ~up).sum(axis=1)

    contains[in_aabb] = (res_above % 2 == 1) & (res_below % 2 == 1)
    return contains
