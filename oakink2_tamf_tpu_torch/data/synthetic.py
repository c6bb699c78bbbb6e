"""Synthetic interaction segments (port of oakink2_tamf_tpu/data/synthetic.py
`synthetic_batch` and `with_perturbed_sample`, and launch/common.py
`SyntheticSegments`), in numpy.

The same numpy calls as the JAX package, so the same seed gives the same
arrays. Shapes follow the static batch contract: pose_repr [bs, L, 99] with
valid rot6d blocks, mask [bs, L], zero-padding past each true length,
obj_traj [bs, nobj, L, 9], spatially sorted obj_points [bs, nobj, P, 3].
"""

from __future__ import annotations

from typing import Any

import numpy as np

import torch

from ..core.transforms import renormalize_pose_repr_rot6d
from ..utils.pc_util import spatial_sort_indices
from .adaptors import ACTION_LIST, NUM_ACTIONS


def _random_rot6d(rng, shape):
    a = rng.normal(size=shape + (3, 3))
    q, r = np.linalg.qr(a)
    d = np.sign(np.diagonal(r, axis1=-2, axis2=-1))
    q = q * d[..., None, :]
    det = np.linalg.det(q)
    q[..., :, 0] *= det[..., None]
    return q[..., :2, :].reshape(shape + (6,)).astype(np.float32)


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    seq_len: int = 160,
    max_nobj: int = 2,
    n_obj_points: int = 512,
    min_len: int = 16,
) -> dict[str, np.ndarray]:
    bs, L = batch_size, seq_len
    tsl = rng.normal(scale=0.2, size=(bs, L, 3)).astype(np.float32)
    rot6d = _random_rot6d(rng, (bs, L, 16)).reshape(bs, L, 96)
    pose_repr = np.concatenate([tsl, rot6d], axis=-1)

    lens = rng.integers(min_len, L + 1, size=(bs,))
    mask = np.zeros((bs, L), np.float32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1.0
    pose_repr = pose_repr * mask[:, :, None]  # zero-pad past the true length

    n_real = rng.integers(1, max_nobj + 1, size=(bs,))
    obj_mask = np.zeros((bs, max_nobj), bool)
    for i, n in enumerate(n_real):
        obj_mask[i, :n] = True

    obj_tsl = rng.normal(scale=0.3, size=(bs, max_nobj, L, 3)).astype(np.float32)
    obj_rot6d = _random_rot6d(rng, (bs, max_nobj, L))
    obj_traj = np.concatenate([obj_tsl, obj_rot6d], axis=-1) * mask[:, None, :, None]

    obj_points = rng.normal(scale=0.1, size=(bs, max_nobj, n_obj_points, 3)).astype(np.float32)
    for i in range(bs):
        for j in range(max_nobj):
            obj_points[i, j] = obj_points[i, j][spatial_sort_indices(obj_points[i, j])]

    return {
        "pose_repr": pose_repr,
        "mask": mask,
        "len": lens.astype(np.int32),
        "shape": rng.normal(scale=0.5, size=(bs, L, 10)).astype(np.float32) * mask[:, :, None],
        "hand_side": rng.integers(0, 2, size=(bs,)).astype(np.int32),
        "text_emb": rng.normal(size=(bs, 512)).astype(np.float32),
        "obj_traj": obj_traj,
        "obj_embedding": rng.normal(size=(bs, max_nobj, 768)).astype(np.float32),
        "obj_mask": obj_mask,
        "obj_points": obj_points,
        "action_label_id": rng.integers(0, 70, size=(bs,)).astype(np.int32),
    }


def with_perturbed_sample(batch: dict, rng: np.random.Generator, sigma_range=(0.02, 0.1)) -> dict:
    """The batch with `sample_pose_repr`, a Gaussian perturbation of
    pose_repr (JAX data/synthetic.py:105; the reference's
    GuassianPerturbSampleAdaptor, dataset/pose_repr_sample.py:55-94): one
    sigma per batch, translation noise at 0.1 sigma, rot6d noise at sigma,
    the rot6d blocks renormalized. Padded frames (mask 0) stay exactly zero,
    as the reference perturbs segments at their true length and zero-pads
    at collate. The same numpy draws in the same order as the JAX package."""
    pr = np.asarray(batch["pose_repr"])
    sigma = rng.uniform(*sigma_range)
    noisy = pr.copy()
    noisy[..., 0:3] += rng.normal(scale=0.1 * sigma, size=pr[..., 0:3].shape)
    noisy[..., 3:] += rng.normal(scale=sigma, size=pr[..., 3:].shape)
    sp = renormalize_pose_repr_rot6d(torch.from_numpy(noisy)).numpy()
    out = dict(batch)
    out["sample_pose_repr"] = sp * (np.asarray(batch["mask"]) > 0)[:, :, None]
    return out


# a box mesh per object, so mesh-consuming paths (the SIV metric) run
_BOX_H = 0.04
_BOX_VERTS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32,
) * np.float32(_BOX_H)
_BOX_FACES = np.array(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
     [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
    np.int32,
)


class SyntheticSegments:
    """Fixed per-index segments in the per-sample dict contract, for runs
    without the OakInk2 data. `info` is (process_key, "<action>:<index>",
    "rh"), as the sample launchers key their outputs; the action cycles
    over 70 ids as in the JAX package, whose ACTION_LIST holds 69 names
    (it raises at id 69, which the port maps to the first name)."""

    def __init__(self, size: int, seq_len: int = 160, max_nobj: int = 2,
                 n_obj_points: int = 512, seed: int = 0):
        self.size = size
        self.seq_len = seq_len
        self.max_nobj = max_nobj
        self.n_obj_points = n_obj_points
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        b = synthetic_batch(
            rng, batch_size=1, seq_len=self.seq_len, max_nobj=self.max_nobj,
            n_obj_points=self.n_obj_points,
        )
        n_real = int(b["obj_mask"][0].sum())
        return {
            "info": (f"synthetic/seq_{index}", f"{ACTION_LIST[index % 70 % NUM_ACTIONS]}:{index:04d}", "rh"),
            "frame_id": list(range(int(b["len"][0]))),
            "len": int(b["len"][0]),
            "mask": b["mask"][0],
            "pose_repr": b["pose_repr"][0],
            "shape": b["shape"][0],
            "hand_side": "rh" if index % 2 == 0 else "lh",
            "text": f"synthetic task {index % 7}",
            "obj_list": [f"obj_{j:02d}" for j in range(n_real)],
            "obj_num": n_real,
            "obj_traj": b["obj_traj"][0][:n_real],
            "obj_embedding": b["obj_embedding"][0][:n_real],
            "obj_pointcloud": b["obj_points"][0][:n_real],
            "obj_verts": [_BOX_VERTS.copy() for _ in range(n_real)],
            "obj_faces": [_BOX_FACES.copy() for _ in range(n_real)],
        }
