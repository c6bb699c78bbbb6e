"""MANO hand layer in PyTorch (port of oakink2_tamf_tpu/core/mano.py).

Contract: per-joint unit quaternions [..., 16, 4] (w, x, y, z), no PCA,
flat hand mean, centred on the wrist joint; 778 verts and 21 joints in
manotorch order (fingertips from verts 745, 317, 444, 556, 673).

`ManoModel` holds the template as host numpy arrays (what the loaders build);
`ManoTensors` is the same data as tensors on a device, optionally stacked
rh/lh on a leading side axis.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from . import transforms as T

N_VERTS = 778
N_KIN_JOINTS = 16
N_JOINTS = 21
N_SHAPE = 10
N_POSEDIRS = 135  # 15 articulated joints x 9 rotmat entries

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIP_VERT_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


class ManoModel(NamedTuple):
    """MANO template data as host numpy arrays."""

    v_template: np.ndarray  # [778, 3]
    shapedirs: np.ndarray  # [778, 3, 10]
    posedirs: np.ndarray  # [778, 3, 135]
    j_regressor: np.ndarray  # [16, 778]
    skin_weights: np.ndarray  # [778, 16]
    faces: np.ndarray  # [F, 3] int32


@dataclasses.dataclass
class ManoTensors:
    """ManoModel on a device; with a leading side axis (0 = rh, 1 = lh) when
    built by models/refine_r.stack_mano_models. `faces` and `template_perm`
    stay host numpy (they are static index data)."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    skin_weights: torch.Tensor
    faces: np.ndarray
    template_perm: np.ndarray | None = None  # hand_template_perm of v_template

    @classmethod
    def from_model(cls, model: ManoModel, device) -> "ManoTensors":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            v_template=t(model.v_template),
            shapedirs=t(model.shapedirs),
            posedirs=t(model.posedirs),
            j_regressor=t(model.j_regressor),
            skin_weights=t(model.skin_weights),
            faces=np.asarray(model.faces, np.int32),
        )

    def side(self, s: int) -> "ManoTensors":
        """One side of a stacked model."""
        return ManoTensors(
            v_template=self.v_template[s],
            shapedirs=self.shapedirs[s],
            posedirs=self.posedirs[s],
            j_regressor=self.j_regressor[s],
            skin_weights=self.skin_weights[s],
            faces=self.faces[s],
        )


# ---------------------------------------------------------------------------
# Asset loading
# ---------------------------------------------------------------------------


class _Stub:
    """Absorbs chumpy objects during unpickling; keeps their ndarray payload."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _ChumpyFreeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _Stub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, _Stub):
        for key in ("x", "_x", "a", "v"):
            if isinstance(x.__dict__.get(key), np.ndarray):
                return x.__dict__[key]
        for v in x.__dict__.values():
            if isinstance(v, np.ndarray):
                return v
        raise ValueError("chumpy stub without ndarray payload")
    if hasattr(x, "toarray"):  # scipy sparse
        return x.toarray()
    return np.asarray(x)


def _find_mano_pkl(mano_assets_root: str, side: str) -> str:
    fname = f"MANO_{side.upper()}.pkl"
    for c in (
        os.path.join(mano_assets_root, fname),
        os.path.join(mano_assets_root, "assets", "mano", fname),
        os.path.join(mano_assets_root, "mano", fname),
        os.path.join(mano_assets_root, "models", fname),
    ):
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"MANO asset {fname} not found under {mano_assets_root}")


def load_mano_model(mano_assets_root: str, side: str = "right") -> ManoModel:
    """Load a MANO pickle (python-2 era, chumpy-laden) without chumpy."""
    from ..utils.integrity import verify_pinned

    path = _find_mano_pkl(mano_assets_root, side)
    verify_pinned(path, what="MANO asset")
    with open(path, "rb") as f:
        data = _ChumpyFreeUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    if "kintree_table" in data:
        parents = np.asarray(_to_np(data["kintree_table"]))[0].astype(np.int64)
        parents[0] = -1  # root is stored as uint32 max
        if tuple(int(p) for p in parents) != PARENTS:
            raise ValueError(f"MANO asset {path} kintree {tuple(parents)} != expected {PARENTS}")
    return ManoModel(
        v_template=np.asarray(_to_np(data["v_template"]), np.float32),
        shapedirs=np.asarray(_to_np(data["shapedirs"])[..., :N_SHAPE], np.float32),
        posedirs=np.asarray(_to_np(data["posedirs"]), np.float32),
        j_regressor=np.asarray(_to_np(data["J_regressor"]), np.float32),
        skin_weights=np.asarray(_to_np(data["weights"]), np.float32),
        faces=_to_np(data["f"]).astype(np.int32),
    )


def synthetic_mano_model(side: str = "right", seed: int = 0) -> ManoModel:
    """Deterministic structurally faithful stand-in for the licensed MANO
    assets: the same arrays as the JAX package's synthetic_mano_model for the
    same (side, seed). NOT anatomically meaningful."""
    rng = np.random.default_rng(seed + (1 if side == "right" else 2))

    rest_joints = np.zeros((N_KIN_JOINTS, 3), dtype=np.float64)
    finger_base = {1: 0.25, 4: 0.10, 7: -0.25, 10: -0.05, 13: 0.45}  # y fan
    for chain_root, y in finger_base.items():
        for i in range(3):
            rest_joints[chain_root + i] = (0.03 + 0.025 * (i + 1), y * 0.05, 0.0)
    rest_joints += rng.normal(scale=1e-3, size=rest_joints.shape)

    seg_centers = []
    for j in range(N_KIN_JOINTS):
        p = PARENTS[j]
        seg_centers.append(rest_joints[j] if p < 0 else 0.5 * (rest_joints[j] + rest_joints[p]))
    seg_centers = np.stack(seg_centers)
    assign = rng.integers(0, N_KIN_JOINTS, size=(N_VERTS,))
    v_template = seg_centers[assign] + rng.normal(scale=0.012, size=(N_VERTS, 3))

    d2 = ((v_template[:, None, :] - rest_joints[None, :, :]) ** 2).sum(-1)
    w = np.exp(-d2 / (2 * 0.015**2))
    skin_weights = w / w.sum(axis=1, keepdims=True)
    jr = np.exp(-d2.T / (2 * 0.008**2))
    jr = jr / jr.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(scale=1e-3, size=(N_VERTS, 3, N_SHAPE))
    posedirs = rng.normal(scale=1e-4, size=(N_VERTS, 3, N_POSEDIRS))

    faces = rng.integers(0, N_VERTS, size=(1538, 3)).astype(np.int32)
    faces[:, 1] = (faces[:, 0] + 1 + faces[:, 1] % (N_VERTS - 1)) % N_VERTS
    faces[:, 2] = (faces[:, 0] + 1 + faces[:, 2] % (N_VERTS - 2)) % N_VERTS

    if side == "left":
        v_template = v_template * np.array([1.0, -1.0, 1.0])
        faces = faces[:, ::-1].copy()

    return ManoModel(
        v_template=np.asarray(v_template, np.float32),
        shapedirs=np.asarray(shapedirs, np.float32),
        posedirs=np.asarray(posedirs, np.float32),
        j_regressor=np.asarray(jr, np.float32),
        skin_weights=np.asarray(skin_weights, np.float32),
        faces=np.asarray(faces, np.int32),
    )


def get_mano_model(mano_assets_root: str | None, side: str = "right") -> ManoModel:
    """Real MANO assets when a path is given (a path that does not resolve
    raises), else the synthetic stand-in with a warning."""
    if mano_assets_root:
        return load_mano_model(mano_assets_root, side)
    logging.getLogger(__name__).warning(
        "mano_path unset: using the SYNTHETIC procedural hand; geometry is NOT "
        "meaningful until the real MANO pickles are given"
    )
    return synthetic_mano_model(side)


# ---------------------------------------------------------------------------
# Forward kinematics + LBS
# ---------------------------------------------------------------------------


def mano_forward(
    model: ManoTensors, pose_quat: torch.Tensor, betas: torch.Tensor, center_idx: int | None = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """MANO LBS for one side. pose_quat [..., 16, 4], betas [..., 10] ->
    (verts [..., 778, 3], joints [..., 21, 3])."""
    lead = pose_quat.shape[:-2]
    B = int(np.prod(lead)) if lead else 1
    q = pose_quat.reshape(B, N_KIN_JOINTS, 4)
    b = torch.broadcast_to(betas, lead + (N_SHAPE,)).reshape(B, N_SHAPE)

    rot = T.quat_to_rotmat(q)  # [B, 16, 3, 3]
    v_shaped = model.v_template[None] + torch.einsum("vcs,bs->bvc", model.shapedirs, b)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)  # [B, 16, 3]

    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feat = (rot[:, 1:] - eye).reshape(B, N_POSEDIRS)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs, pose_feat)

    glob = [T.assemble_T(j_rest[:, 0], rot[:, 0])]
    for k in range(1, N_KIN_JOINTS):
        p = PARENTS[k]
        local = T.assemble_T(j_rest[:, k] - j_rest[:, p], rot[:, k])
        glob.append(torch.matmul(glob[p], local))
    G = torch.stack(glob, dim=1)  # [B, 16, 4, 4]

    posed_joints = G[..., :3, 3]
    t_corr = G[..., :3, 3] - torch.einsum("bkij,bkj->bki", G[..., :3, :3], j_rest)
    R_blend = torch.einsum("vk,bkij->bvij", model.skin_weights, G[..., :3, :3])
    t_blend = torch.einsum("vk,bki->bvi", model.skin_weights, t_corr)
    verts = torch.einsum("bvij,bvj->bvi", R_blend, v_posed) + t_blend

    tips = verts[:, list(TIP_VERT_IDS)]
    joints = torch.cat((posed_joints, tips), dim=1)[:, list(JOINT_REORDER)]
    if center_idx is not None:
        center = joints[:, center_idx : center_idx + 1]
        verts = verts - center
        joints = joints - center
    return verts.reshape(lead + (N_VERTS, 3)), joints.reshape(lead + (N_JOINTS, 3))


def recover_mano_from_pose_repr(
    model: ManoTensors, pose_repr: torch.Tensor, shape: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] + betas [..., 10] -> world-frame (verts, joints)."""
    tsl, quat = T.pose_repr_to_quat(pose_repr)
    verts, joints = mano_forward(model, quat, shape, center_idx=0)
    return verts + tsl[..., None, :], joints + tsl[..., None, :]


def hand_template_perm(v_template: np.ndarray) -> np.ndarray:
    """Static 778-vert permutation whose contiguous 128-vert blocks are
    spatially compact (a spatial sort of the rest template; a stacked rh/lh
    template uses its first side). The culled h2o kernel's 128-row regions
    follow it, which keeps their radii small in every pose."""
    from ..utils.pc_util import spatial_sort_indices

    v = np.asarray(v_template)
    if v.ndim == 3:
        v = v[0]
    return np.asarray(spatial_sort_indices(v, leaf=128), np.int64)


def closed_faces(model: ManoModel) -> np.ndarray:
    """The faces plus a fan sealing each boundary loop (the wrist), so the
    mesh is watertight (JAX core/mano.py:363; manotorch's
    get_mano_closed_faces, which the SIV metric reads). Host numpy: the
    boundary edges (on exactly one face) are chained into loops, each
    fanned from its first vertex with the winding reversed."""
    faces = np.asarray(model.faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    key = np.sort(edges, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    boundary = edges[counts[inv.reshape(-1)] == 1]
    if len(boundary) == 0:
        return faces

    succ = {int(a): int(b) for a, b in boundary}
    new_faces = []
    visited: set[int] = set()
    for start in list(succ.keys()):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = succ.get(start)
        while cur is not None and cur != start and cur not in visited:
            loop.append(cur)
            visited.add(cur)
            cur = succ.get(cur)
        if len(loop) >= 3:
            for i in range(1, len(loop) - 1):
                new_faces.append((loop[0], loop[i + 1], loop[i]))
    if not new_faces:
        return faces
    return np.concatenate([faces, np.asarray(new_faces, dtype=faces.dtype)], axis=0)
