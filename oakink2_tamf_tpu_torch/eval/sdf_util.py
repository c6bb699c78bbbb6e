"""SDF grid construction and isosurface reconstruction (port of
oakink2_tamf_tpu/eval/sdf_util.py; the reference's dev_fn/util/sdf_util.py).

The reference samples a 100^3 SDF with `pysdf` over an expanded bbox
(process_sdf, sdf_util.py:59-99) and reconstructs the zero isosurface with
skimage's marching cubes (reconstruct_sdf, :110-130). As in the JAX
package, neither is used:

- `process_sdf` keeps the grid/bbox bookkeeping and the SDFData field
  layout, with the field computed as containment sign (positive INSIDE,
  eval/inside_mesh.check_mesh_contains on the port's native triangle hash,
  which raises rather than falling back) times the distance to the nearest
  of `n_surface_samples` surface points (utils/mesh_io.sample_surface,
  seed 0);
- `reconstruct_sdf` runs marching tetrahedra (each grid cell split into 6
  tets, zero crossings interpolated on tet edges): the zero surface of
  marching cubes up to triangulation, oriented outward.

`save_sdf_data` pickles the fields as a plain dict, so the JAX package's
`load_sdf_data` reads the port's files and the port reads the JAX
package's (and the reference's: the same dict layout). Host-side numpy,
the same arithmetic as the JAX package: this is the offline SIV/debug
path, as in the reference.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np

from ..utils.mesh_io import sample_surface
from .inside_mesh import check_mesh_contains


@dataclasses.dataclass
class SDFData:
    mesh_center: np.ndarray
    bbox: np.ndarray
    bbox_centered: np.ndarray
    bbox_centered_expanded: np.ndarray
    bbox_expanded: np.ndarray

    bbox_expand_ratio: float
    resolution: int

    extent: np.ndarray
    extent_expanded: np.ndarray
    tick_unit: np.ndarray

    point: np.ndarray
    sdf: np.ndarray

    def __getitem__(self, key):
        return getattr(self, key)

    def get(self, key, default=None):
        return getattr(self, key, default)


@dataclasses.dataclass
class SDFReconData:
    vert: np.ndarray
    face: np.ndarray
    normal: np.ndarray
    value: np.ndarray


def _min_dists(query: np.ndarray, surf: np.ndarray) -> np.ndarray:
    """Min Euclidean distance from each query point to the surface samples.
    Blocked |q|^2 + |s|^2 - 2 q.s^T in float32 — the naive broadcast
    difference materializes a [Nq, Ns, 3] float64 temporary (~31 GB at the
    documented defaults: 100^3 grid x 20k samples)."""
    q = np.asarray(query, np.float32)
    s = np.asarray(surf, np.float32)
    s2 = np.sum(s * s, axis=1)[None, :]
    out = np.empty(len(q), np.float64)
    for lo in range(0, len(q), 4096):
        qc = q[lo : lo + 4096]
        d2 = np.sum(qc * qc, axis=1)[:, None] + s2 - 2.0 * (qc @ s.T)
        out[lo : lo + len(qc)] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
    return out


def process_sdf(
    verts: np.ndarray,
    faces: np.ndarray,
    bbox_expand_ratio: float = 1.2,
    resolution: int = 100,
    n_surface_samples: int = 20000,
) -> SDFData:
    """Mesh -> SDFData over a centered, expanded-bbox grid (ref :59-99).
    Sign: positive inside (mesh containment); magnitude: distance to the
    nearest of `n_surface_samples` surface points."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)

    lo, hi = verts.min(axis=0), verts.max(axis=0)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    center = 0.5 * (lo + hi)
    corners_centered = corners - center
    corners_expanded = corners_centered * bbox_expand_ratio

    v_c = verts - center  # centered mesh (ref mutates the mesh in place)
    extent = hi - lo
    extent_expanded = extent * bbox_expand_ratio
    tick_unit = extent_expanded / resolution

    tick = np.linspace(-extent_expanded / 2.0, extent_expanded / 2.0, resolution)
    x, y, z = np.meshgrid(tick[:, 0], tick[:, 1], tick[:, 2], indexing="ij")
    query = np.vstack((x.ravel(), y.ravel(), z.ravel())).T  # centered frame

    inside = check_mesh_contains(v_c, faces, query, impl="native")
    surf = sample_surface(v_c, faces, n_surface_samples, seed=0)
    d = _min_dists(query, surf)
    sdf = np.where(inside, d, -d)  # positive inside

    return SDFData(
        mesh_center=center,
        bbox=corners,
        bbox_centered=corners_centered,
        bbox_centered_expanded=corners_expanded,
        bbox_expanded=corners_expanded + center,
        bbox_expand_ratio=bbox_expand_ratio,
        resolution=resolution,
        extent=extent,
        extent_expanded=extent_expanded,
        tick_unit=tick_unit,
        point=query + center,  # object frame (ref :81)
        sdf=sdf,
    )


# cube -> 6 tetrahedra sharing the 0-6 diagonal (corner bit order: x*4+y*2+z)
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]]
)


def _edge_point(p_a, v_a, p_b, v_b):
    """Zero crossing on edge a-b (v_a, v_b of opposite sign). The
    denominator keeps its SIGN (a may be the negative corner) — only its
    magnitude is floored."""
    den = v_a - v_b
    den = np.where(np.abs(den) < 1e-30, 1e-30, den)
    t = np.clip(v_a / den, 0.0, 1.0)
    return p_a + t[:, None] * (p_b - p_a)


def reconstruct_sdf(
    sdf: np.ndarray,
    obj_mesh_center: np.ndarray,
    obj_mesh_extent_expanded: np.ndarray,
    resolution: int,
    level: float = 0.0,
) -> SDFReconData:
    """Zero-isosurface of an SDF grid via marching tetrahedra (ref :110-130
    used skimage marching cubes — same surface, tetrahedral triangulation).

    Grid-spacing deviation (deliberate): vertices land on the SAME linspace
    grid process_sdf sampled the SDF on — spacing extent/(resolution-1),
    centered. The reference's reconstruct feeds skimage spacing
    extent/resolution with a -extent/2 offset (sdf_util.py:110-130), which
    does NOT match its own sample positions — a ~1% scale error at res=100.
    We are self-consistent with our sampling; byte-level parity with
    reference-PRODUCED reconstructions would need its extent/resolution
    spacing reproduced (and would inherit the scale error)."""
    grid = np.asarray(sdf, np.float64).reshape(resolution, resolution, resolution) - level
    tick = np.linspace(
        -np.asarray(obj_mesh_extent_expanded) / 2.0,
        np.asarray(obj_mesh_extent_expanded) / 2.0,
        resolution,
    )

    # all cells' corner indices [Nc, 8, 3]
    base = np.stack(
        np.meshgrid(*([np.arange(resolution - 1)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 1, 3)
    cidx = base + _CUBE_CORNERS[None, :, :]  # [Nc, 8, 3]
    cvals = grid[cidx[..., 0], cidx[..., 1], cidx[..., 2]]  # [Nc, 8]
    cpos = np.stack(
        [tick[cidx[..., k], k] for k in range(3)], axis=-1
    )  # [Nc, 8, 3] centered coords

    # drop cells with no sign change
    keep = ~((cvals > 0).all(axis=1) | (cvals <= 0).all(axis=1))
    cvals, cpos = cvals[keep], cpos[keep]

    tris = []
    for tet in _TETS:
        tv = cvals[:, tet]  # [n, 4]
        tp = cpos[:, tet]  # [n, 4, 3]
        pos = tv > 0
        npos = pos.sum(axis=1)

        # one corner on one side (1 positive or 1 negative): one triangle
        for n_in, flip in ((1, False), (3, True)):
            sel = npos == n_in
            if not sel.any():
                continue
            v, p = tv[sel], tp[sel]
            lone = np.argmax((v > 0) == (not flip), axis=1)  # the isolated corner
            others = np.argsort(np.arange(4)[None, :] == lone[:, None], axis=1)[:, :3]
            rows = np.arange(len(v))[:, None]
            pa, va = p[rows[:, 0], lone], v[rows[:, 0], lone]
            e = [
                _edge_point(pa, va, p[rows[:, 0], others[:, k]], v[rows[:, 0], others[:, k]])
                for k in range(3)
            ]
            tris.append(np.stack(e, axis=1))

        # 2-2 split: quad -> two triangles
        sel = npos == 2
        if sel.any():
            v, p = tv[sel], tp[sel]
            order = np.argsort(~(v > 0), axis=1)  # positives first
            rows = np.arange(len(v))[:, None]
            a, b = order[:, 0], order[:, 1]  # positive
            c, d = order[:, 2], order[:, 3]  # negative
            pa, va = p[rows[:, 0], a], v[rows[:, 0], a]
            pb, vb = p[rows[:, 0], b], v[rows[:, 0], b]
            pc, vc = p[rows[:, 0], c], v[rows[:, 0], c]
            pd, vd = p[rows[:, 0], d], v[rows[:, 0], d]
            e_ac = _edge_point(pa, va, pc, vc)
            e_ad = _edge_point(pa, va, pd, vd)
            e_bc = _edge_point(pb, vb, pc, vc)
            e_bd = _edge_point(pb, vb, pd, vd)
            tris.append(np.stack([e_ac, e_ad, e_bc], axis=1))
            tris.append(np.stack([e_bc, e_ad, e_bd], axis=1))

    if not tris:
        z = np.zeros((0, 3))
        return SDFReconData(vert=z, face=np.zeros((0, 3), np.int64), normal=z, value=np.zeros((0,)))

    tri = np.concatenate(tris, axis=0)  # [T, 3, 3]

    # orient outward: normal should point toward decreasing sdf (outside).
    # estimate the outward direction from the local grid gradient at the
    # triangle centroid via nearest grid value difference — cheap proxy:
    # use the vector from the tet's positive mass; here simply flip so the
    # normal agrees with -grad(sdf) sampled by finite difference on the grid.
    centroid = tri.mean(axis=1)
    tick_unit = np.asarray(obj_mesh_extent_expanded) / resolution
    gi = np.clip(
        np.round((centroid + np.asarray(obj_mesh_extent_expanded) / 2.0) / np.maximum(
            np.asarray(obj_mesh_extent_expanded) / (resolution - 1), 1e-12
        )).astype(int),
        1, resolution - 2,
    )
    grad = np.stack(
        [
            grid[gi[:, 0] + 1, gi[:, 1], gi[:, 2]] - grid[gi[:, 0] - 1, gi[:, 1], gi[:, 2]],
            grid[gi[:, 0], gi[:, 1] + 1, gi[:, 2]] - grid[gi[:, 0], gi[:, 1] - 1, gi[:, 2]],
            grid[gi[:, 0], gi[:, 1], gi[:, 2] + 1] - grid[gi[:, 0], gi[:, 1], gi[:, 2] - 1],
        ],
        axis=1,
    )
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.sum(n * grad, axis=1) > 0  # normal along +grad points INSIDE
    tri[flip] = tri[flip][:, ::-1]

    # dedup vertices
    flat = tri.reshape(-1, 3)
    key = np.round(flat / np.maximum(tick_unit.min(), 1e-12) * 1e4).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    vert = flat[uniq_idx] + np.asarray(obj_mesh_center)
    face = inv.reshape(-1, 3)
    face = face[(face[:, 0] != face[:, 1]) & (face[:, 1] != face[:, 2]) & (face[:, 0] != face[:, 2])]

    vn = np.zeros_like(vert)
    fn = np.cross(vert[face[:, 1]] - vert[face[:, 0]], vert[face[:, 2]] - vert[face[:, 0]])
    for k in range(3):
        np.add.at(vn, face[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)

    return SDFReconData(
        vert=vert, face=face, normal=vn, value=np.zeros(len(vert))
    )


def save_sdf_data(filepath: str, sdf_data: SDFData) -> None:
    with open(filepath, "wb") as f:
        pickle.dump(dataclasses.asdict(sdf_data), f)


def load_sdf_data(filepath: str) -> SDFData:
    """Reads both our pickles and the reference's (same dict field layout)."""
    with open(filepath, "rb") as f:
        d = pickle.load(f)
    return SDFData(**d)
