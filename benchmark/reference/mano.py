"""MANO forward kinematics and linear blend skinning, plain PyTorch (frozen copy
of oakink2_tamf_tpu_torch/core/mano.py `mano_forward` and
`recover_mano_from_pose_repr`, and models/refine_r.py `batch_recover_mano`).

The template arrays come from the benchmark (benchmark/lib/assets.py) as a
dict of float32 tensors stacked on a leading side axis (0 = rh, 1 = lh).
"""

from __future__ import annotations

import numpy as np
import torch

from . import transforms as T
from .geometry import vertex_normals

N_VERTS = 778
N_KIN_JOINTS = 16
N_JOINTS = 21
N_SHAPE = 10
N_POSEDIRS = 135

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIP_VERT_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


def mano_forward(model: dict, pose_quat: torch.Tensor, betas: torch.Tensor, center_idx: int | None = 0):
    """One side's LBS. pose_quat [..., 16, 4], betas [..., 10] ->
    (verts [..., 778, 3], joints [..., 21, 3])."""
    lead = pose_quat.shape[:-2]
    B = int(np.prod(lead)) if lead else 1
    q = pose_quat.reshape(B, N_KIN_JOINTS, 4)
    b = torch.broadcast_to(betas, lead + (N_SHAPE,)).reshape(B, N_SHAPE)

    rot = T.quat_to_rotmat(q)
    v_shaped = model["v_template"][None] + torch.einsum("vcs,bs->bvc", model["shapedirs"], b)
    j_rest = torch.einsum("jv,bvc->bjc", model["j_regressor"], v_shaped)

    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feat = (rot[:, 1:] - eye).reshape(B, N_POSEDIRS)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model["posedirs"], pose_feat)

    glob = [T.assemble_T(j_rest[:, 0], rot[:, 0])]
    for k in range(1, N_KIN_JOINTS):
        p = PARENTS[k]
        local = T.assemble_T(j_rest[:, k] - j_rest[:, p], rot[:, k])
        glob.append(torch.matmul(glob[p], local))
    G = torch.stack(glob, dim=1)

    posed_joints = G[..., :3, 3]
    t_corr = G[..., :3, 3] - torch.einsum("bkij,bkj->bki", G[..., :3, :3], j_rest)
    R_blend = torch.einsum("vk,bkij->bvij", model["skin_weights"], G[..., :3, :3])
    t_blend = torch.einsum("vk,bki->bvi", model["skin_weights"], t_corr)
    verts = torch.einsum("bvij,bvj->bvi", R_blend, v_posed) + t_blend

    tips = verts[:, list(TIP_VERT_IDS)]
    joints = torch.cat((posed_joints, tips), dim=1)[:, list(JOINT_REORDER)]
    if center_idx is not None:
        center = joints[:, center_idx : center_idx + 1]
        verts = verts - center
        joints = joints - center
    return verts.reshape(lead + (N_VERTS, 3)), joints.reshape(lead + (N_JOINTS, 3))


def side(stack: dict, s: int) -> dict:
    return {k: v[s] for k, v in stack.items()}


def recover(model: dict, pose_repr: torch.Tensor, shape: torch.Tensor):
    """pose_repr [..., 99] + betas [..., 10] -> world-frame (verts, joints)."""
    tsl, quat = T.pose_repr_to_quat(pose_repr)
    verts, joints = mano_forward(model, quat, shape, center_idx=0)
    return verts + tsl[..., None, :], joints + tsl[..., None, :]


def batch_recover(stack: dict, faces: np.ndarray, pose_repr, shape, hand_side):
    """-> (verts [bs, L, 778, 3], joints [bs, L, 21, 3], normals [bs, L, 778, 3]):
    both sides run on every sample and the sample's side is selected."""
    rh = (hand_side == 0)[:, None, None, None]
    per_side = [recover(side(stack, s), pose_repr, shape) for s in range(2)]
    verts = torch.where(rh, per_side[0][0], per_side[1][0])
    joints = torch.where(rh, per_side[0][1], per_side[1][1])
    normals = torch.where(rh, vertex_normals(verts, faces[0]), vertex_normals(verts, faces[1]))
    return verts, joints, normals
