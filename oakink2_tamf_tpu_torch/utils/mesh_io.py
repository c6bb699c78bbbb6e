"""Minimal Wavefront .obj mesh IO and uniform surface sampling (copy of
oakink2_tamf_tpu/utils/mesh_io.py; the reference dev_fn/util/obj_mesh_io.py
role). `sample_surface` draws choice, then u, then v from one
np.random.default_rng(seed), so a seed gives the JAX package's points."""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read vertices + triangle faces from an .obj (fan-triangulates polygons)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def sample_surface(
    verts: np.ndarray, faces: np.ndarray, n_points: int, seed: int = 0
) -> np.ndarray:
    """Area-weighted uniform surface sampling -> [n_points, 3]."""
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    p = areas / max(areas.sum(), 1e-12)
    pick = rng.choice(len(faces), size=n_points, p=p)
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[pick]
    return (
        t[:, 0] * (1 - u - v)[:, None] + t[:, 1] * u[:, None] + t[:, 2] * v[:, None]
    ).astype(np.float32)
