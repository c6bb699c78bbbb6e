"""Frozen copy of oakink2_tamf_tpu_torch/core/transforms.py for the benchmark's plain
reference, which imports nothing of the port; kept as it was copied.

Rotation and rigid-transform math (port of oakink2_tamf_tpu/core/transforms.py).

Both halves of the codecs: decode (rot6d, quaternion -> rotation matrix,
pose_repr -> joints, tslrot6d -> transform) for G, MANO and R, and encode
(rotation matrix -> rot6d/quaternion/axis-angle, Euler angles, rigid
transforms of points) for the real-data dataset and the metrics.
Conventions match the JAX package:
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


def rotmat_to_rot6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D representation (first two rows flattened)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


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


def quat_invert(quat: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return quat * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=quat.dtype, device=quat.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (w,x,y,z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ),
        dim=-1,
    )


def rotvec_to_quat(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> quaternion (w,x,y,z); sin(a/2)/a by its series
    below an angle of 1e-6."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1, keepdim=True)
    half = angle * 0.5
    sin_half_over_angle = torch.where(
        angle < 1e-6, 0.5 - (angle * angle) / 48.0, torch.sin(half) / torch.clamp_min(angle, 1e-12)
    )
    return torch.cat((torch.cos(half), rotvec * sin_half_over_angle), dim=-1)


def quat_to_rotvec(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> axis-angle vector (w >= 0 taken first)."""
    q = _normalize(quat)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    norm_xyz = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm_xyz, w)
    scale = torch.where(norm_xyz < 1e-6, 2.0, angle / torch.clamp_min(norm_xyz, 1e-12))
    return xyz * scale


def rotvec_to_rotmat(rotvec: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(rotvec_to_quat(rotvec))


def rotmat_to_rotvec(matrix: torch.Tensor) -> torch.Tensor:
    return quat_to_rotvec(rotmat_to_quat(matrix))


def _axis_rotmat(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_to_rotmat(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles [..., 3] -> rotation matrix (intrinsic, per-axis compose)."""
    mats = [_axis_rotmat(c, euler[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def assemble_T(tsl: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
    """tsl [..., 3] + rotmat [..., 3, 3] -> transf [..., 4, 4]."""
    top = torch.cat((rotmat, tsl[..., :, None]), dim=-1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tsl.dtype, device=tsl.device)
    bottom = bottom.expand(tsl.shape[:-1] + (1, 4))
    return torch.cat((top, bottom), dim=-2)


def inv_transf(transf: torch.Tensor) -> torch.Tensor:
    """Invert a rigid transform [..., 4, 4]."""
    R_inv = transf[..., :3, :3].transpose(-1, -2)
    return assemble_T(-(R_inv @ transf[..., :3, 3:])[..., 0], R_inv)


def transf_point_array(transf: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Apply transf [..., 4, 4] to points [..., N, 3] -> [..., N, 3] (point @ R^T + t)."""
    return point @ transf[..., :3, :3].transpose(-1, -2) + transf[..., None, :3, 3]


def rotate_point_array(rotmat: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Apply rotmat [..., 3, 3] to points [..., N, 3]."""
    return point @ rotmat.transpose(-1, -2)


def transf_to_tslrot6d(transf: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 9] = [tsl | rot6d]."""
    return torch.cat((transf[..., :3, 3], rotmat_to_rot6d(transf[..., :3, :3])), dim=-1)


def tslrot6d_to_transf(tslrot6d: torch.Tensor) -> torch.Tensor:
    """[..., 9] -> [..., 4, 4]."""
    return assemble_T(tslrot6d[..., 0:3], rot6d_to_rotmat(tslrot6d[..., 3:9]))


def project_point_array(cam_intr: torch.Tensor, point: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pinhole projection: cam_intr [..., 3, 3], point [..., N, 3] -> [..., N, 2]."""
    hom = point @ cam_intr.transpose(-1, -2)
    return hom[..., :2] / torch.clamp_min(hom[..., 2:3], eps)


def pose_repr_encode(tsl: torch.Tensor, joint_rotmat: torch.Tensor) -> torch.Tensor:
    """tsl [..., 3] + joint rotmats [..., 16, 3, 3] -> pose_repr [..., 99]."""
    rot6d = rotmat_to_rot6d(joint_rotmat).reshape(tsl.shape[:-1] + (N_JOINT_ROT * 6,))
    return torch.cat((tsl, rot6d), dim=-1)


def pose_repr_decode(pose_repr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] -> (tsl [..., 3], joint rotmats [..., 16, 3, 3])."""
    tsl = pose_repr[..., 0:3]
    rot6d = pose_repr[..., 3:POSE_REPR_DIM].reshape(pose_repr.shape[:-1] + (N_JOINT_ROT, 6))
    return tsl, rot6d_to_rotmat(rot6d)


def pose_repr_to_quat(pose_repr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] -> (tsl [..., 3], joint quats [..., 16, 4])."""
    tsl, rotmat = pose_repr_decode(pose_repr)
    return tsl, rotmat_to_quat(rotmat)


def renormalize_pose_repr_rot6d(pose_repr: torch.Tensor) -> torch.Tensor:
    """Re-normalize the two 3-vectors of each joint's rot6d block (the
    Gaussian-perturb sample adaptor's last step; reference
    dataset/pose_repr_sample.py:77-86)."""
    lead = pose_repr.shape[:-1]
    d6 = pose_repr[..., 3:POSE_REPR_DIM].reshape(lead + (N_JOINT_ROT, 6))
    a = d6[..., 0:3] / torch.clamp_min(torch.linalg.vector_norm(d6[..., 0:3], dim=-1, keepdim=True), 1e-7)
    b = d6[..., 3:6] / torch.clamp_min(torch.linalg.vector_norm(d6[..., 3:6], dim=-1, keepdim=True), 1e-7)
    d6 = torch.cat((a, b), dim=-1).reshape(lead + (N_JOINT_ROT * 6,))
    return torch.cat((pose_repr[..., 0:3], d6), dim=-1)
