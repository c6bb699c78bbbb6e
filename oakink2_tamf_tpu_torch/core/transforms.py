"""Rotation and rigid-transform math (port of oakink2_tamf_tpu/core/transforms.py).

Only what G, MANO and R need. Conventions match the JAX package:
- quaternions are (w, x, y, z), real part first;
- rot6d is the first two ROWS of the rotation matrix, flattened;
- homogeneous transforms are 4x4 row-major, translation in the last column;
- tslrot6d = [tsl(3) | rot6d(6)], pose_repr = [tsl(3) | 16 joints x rot6d(6)].
Everything broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

N_JOINT_ROT = 16
POSE_REPR_DIM = 3 + N_JOINT_ROT * 6  # 99


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), eps)


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation -> rotation matrix, Gram-Schmidt on rows. [..., 6] -> [..., 3, 3].

    rot6d(0) maps to the zero matrix (zero-padded frames rely on it)."""
    a1, a2 = d6[..., :3], d6[..., 3:6]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def quat_to_rotmat(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    q = _normalize(quaternions)
    w, x, y, z = q.unbind(-1)
    o = torch.stack(
        (
            1 - 2.0 * (y * y + z * z),
            2.0 * (x * y - z * w),
            2.0 * (x * z + y * w),
            2.0 * (x * y + z * w),
            1 - 2.0 * (x * x + z * z),
            2.0 * (y * z - x * w),
            2.0 * (x * z - y * w),
            2.0 * (y * z + x * w),
            1 - 2.0 * (x * x + y * y),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)), exactly 0 at x <= 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def rotmat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free pytorch3d
    algorithm: four candidates, the one with the largest denominator wins
    (first on ties, as jnp.argmax)."""
    m = matrix.reshape(matrix.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q_abs = _sqrt_positive_part(
        torch.stack(
            (
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ),
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        (
            torch.stack((q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01), dim=-1),
            torch.stack((m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20), dim=-1),
            torch.stack((m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21), dim=-1),
            torch.stack((m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2), dim=-1),
        ),
        dim=-2,
    )  # [..., 4, 4]
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    out = torch.gather(
        quat_candidates, -2, best[..., None, None].expand(best.shape + (1, 4))
    )[..., 0, :]
    return _normalize(out)


def assemble_T(tsl: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
    """tsl [..., 3] + rotmat [..., 3, 3] -> transf [..., 4, 4]."""
    top = torch.cat((rotmat, tsl[..., :, None]), dim=-1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tsl.dtype, device=tsl.device)
    bottom = bottom.expand(tsl.shape[:-1] + (1, 4))
    return torch.cat((top, bottom), dim=-2)


def tslrot6d_to_transf(tslrot6d: torch.Tensor) -> torch.Tensor:
    """[..., 9] -> [..., 4, 4]."""
    return assemble_T(tslrot6d[..., 0:3], rot6d_to_rotmat(tslrot6d[..., 3:9]))


def pose_repr_decode(pose_repr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] -> (tsl [..., 3], joint rotmats [..., 16, 3, 3])."""
    tsl = pose_repr[..., 0:3]
    rot6d = pose_repr[..., 3:POSE_REPR_DIM].reshape(pose_repr.shape[:-1] + (N_JOINT_ROT, 6))
    return tsl, rot6d_to_rotmat(rot6d)


def pose_repr_to_quat(pose_repr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] -> (tsl [..., 3], joint quats [..., 16, 4])."""
    tsl, rotmat = pose_repr_decode(pose_repr)
    return tsl, rotmat_to_quat(rotmat)
