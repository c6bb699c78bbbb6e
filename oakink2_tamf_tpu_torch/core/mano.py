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


# The kinematic tree is five fingers of three joints off the wrist: joint
# 1 + 3f + d hangs off joint 3f + d for d > 0 and off the wrist (0) for d = 0.
# So the joints of depth d + 1 are the strided slice LEVELS[d], whose parents
# are the slice before it, and the chain composes a level of five joints at a
# time. CHAIN_ORDER is the joints in the order the chain makes them.
LEVELS = (slice(1, 16, 3), slice(2, 16, 3), slice(3, 16, 3))
CHAIN_ORDER = (0,) + tuple(j for lvl in LEVELS for j in range(N_KIN_JOINTS)[lvl])
assert all(PARENTS[j] == (0 if d == 0 else j - 1) for d, lvl in enumerate(LEVELS) for j in range(N_KIN_JOINTS)[lvl])
# the 21 output joints (JOINT_REORDER of the posed joints, then the tips) as
# indices into [posed joints in CHAIN_ORDER, tips]
_JOINT_INDEX = tuple(CHAIN_ORDER.index(i) if i < N_KIN_JOINTS else i for i in JOINT_REORDER)


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
    stay host numpy (they are static index data).

    The last six fields are what mano_forward and the normals read, derived
    from the template once (float64 on the host, then float32): the shape
    and pose blend shapes as one basis whose columns are coordinate-major
    (c * 778 + v), the template in that layout, the rest joints of the
    template and of each shape direction (j_regressor applied), the skinning
    weights transposed with their joints in CHAIN_ORDER, and the faces as a
    device index."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    skin_weights: torch.Tensor
    faces: np.ndarray
    template_perm: np.ndarray | None = None  # hand_template_perm of v_template
    blend_basis: torch.Tensor | None = None  # [..., 145, 3 * 778]
    template_cm: torch.Tensor | None = None  # [..., 3 * 778]
    joint_template: torch.Tensor | None = None  # [..., 48]: the 16 rest joints
    joint_dirs: torch.Tensor | None = None  # [..., 10, 48]
    skin_t: torch.Tensor | None = None  # [..., 16, 778]
    faces_t: torch.Tensor | None = None  # [..., F, 3] int64

    @classmethod
    def from_model(cls, model: ManoModel, device) -> "ManoTensors":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        vt, sd, pd, jr, w = (np.asarray(a, np.float64) for a in model[:5])
        lead = vt.shape[:-2]
        basis = np.moveaxis(np.concatenate([sd, pd], axis=-1), (-3, -2, -1), (-1, -2, -3))  # [..., 145, 3, 778]
        return cls(
            v_template=t(vt),
            shapedirs=t(sd),
            posedirs=t(pd),
            j_regressor=t(jr),
            skin_weights=t(w),
            faces=np.asarray(model.faces, np.int32),
            blend_basis=t(basis.reshape(lead + (N_SHAPE + N_POSEDIRS, 3 * N_VERTS))),
            template_cm=t(np.swapaxes(vt, -1, -2).reshape(lead + (3 * N_VERTS,))),
            joint_template=t((jr @ vt).reshape(lead + (3 * N_KIN_JOINTS,))),
            joint_dirs=t(np.moveaxis((jr @ sd.reshape(lead + (N_VERTS, 3 * N_SHAPE))).reshape(
                lead + (N_KIN_JOINTS, 3, N_SHAPE)), -1, -3).reshape(lead + (N_SHAPE, 3 * N_KIN_JOINTS))),
            skin_t=t(np.swapaxes(w[..., list(CHAIN_ORDER)], -1, -2)),
            faces_t=torch.as_tensor(np.asarray(model.faces, np.int64), device=device),
        )

    def side(self, s: int) -> "ManoTensors":
        """One side of a stacked model."""
        return dataclasses.replace(self, template_perm=None, **{
            f.name: getattr(self, f.name)[s] for f in dataclasses.fields(self)
            if f.name != "template_perm" and getattr(self, f.name) is not None})


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


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3x3 over the last two axes as multiply-adds (no batched GEMM)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3 over the last axes as multiply-adds (no batched GEMV)."""
    return (a * v[..., None, :]).sum(-1)


def _lbs(model: ManoTensors, q: torch.Tensor, b: torch.Tensor, side: torch.Tensor | None):
    """LBS of q [S, M, 16, 4] and b [S, M, 10] on the model's one side
    (S = 1) or, with `side` [S], each s on its own side of a stacked model.
    -> (verts [S, M, 3, 778] coordinate-major, joints [S, M, 21, 3]),
    not centred. The blend shapes and the skinning blend are one batched
    GEMM each; the 3x3 products are elementwise."""
    def pick(a):
        return a[None] if side is None else a[side]

    S, M = q.shape[:2]
    rot = T.quat_to_rotmat(q)  # [S, M, 16, 3, 3]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    feat = torch.cat((b, (rot[:, :, 1:] - eye).reshape(S, M, N_POSEDIRS)), dim=-1)  # [S, M, 145]
    v_posed = torch.baddbmm(pick(model.template_cm)[:, None], feat, pick(model.blend_basis))
    j_rest = torch.baddbmm(pick(model.joint_template)[:, None], b, pick(model.joint_dirs))
    j_rest = j_rest.view(S, M, N_KIN_JOINTS, 3)

    # the chain, a level at a time: G_k = G_parent(k) [R_k | j_k - j_parent(k)]
    r_par, t_par, j_par = rot[:, :, :1], j_rest[:, :, :1], j_rest[:, :, :1]
    rs, ts, corr = [r_par], [t_par], [t_par - _mv3(r_par, j_par)]
    for lvl in LEVELS:
        j_l = j_rest[:, :, lvl]
        r_l = _mm3(r_par, rot[:, :, lvl])
        t_l = _mv3(r_par, j_l - j_par) + t_par
        rs.append(r_l)
        ts.append(t_l)
        corr.append(t_l - _mv3(r_l, j_l))
        r_par, t_par, j_par = r_l, t_l, j_l
    posed = torch.cat(ts, dim=2)  # [S, M, 16, 3], CHAIN_ORDER
    # each joint's affine [R | t - R j] coordinate-major: [S, M, 12, 16]
    affine = torch.cat((torch.cat(rs, dim=2).flatten(-2).transpose(-1, -2), torch.cat(corr, dim=2).transpose(-1, -2)),
                       dim=-2)
    blend = torch.bmm(affine.reshape(S, M * 12, N_KIN_JOINTS), pick(model.skin_t)).view(S, M, 12, N_VERTS)
    r_blend = blend[:, :, :9].view(S, M, 3, 3, N_VERTS)
    vp = v_posed.view(S, M, 3, N_VERTS)
    verts = blend[:, :, 9:]
    for c in range(3):
        verts = torch.addcmul(verts, r_blend[:, :, :, c], vp[:, :, c : c + 1])
    tips = verts[..., list(TIP_VERT_IDS)].transpose(-1, -2)
    joints = torch.cat((posed, tips), dim=2)[:, :, list(_JOINT_INDEX)]
    return verts, joints


def mano_forward(
    model: ManoTensors, pose_quat: torch.Tensor, betas: torch.Tensor, center_idx: int | None = 0,
    side: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MANO LBS. pose_quat [..., 16, 4], betas [..., 10] ->
    (verts [..., 778, 3], joints [..., 21, 3]). One side, or with `side`
    (an int tensor [n], lead[0] == n) each of the n rows on its own side of
    a stacked model, the side's arrays gathered on the device."""
    lead = pose_quat.shape[:-2]
    S = 1 if side is None else side.shape[0]
    if side is not None and (side.dim() != 1 or lead[:1] != (S,)):
        raise ValueError(f"side {tuple(side.shape)} must be [n] for poses {tuple(pose_quat.shape)}")
    q = pose_quat.reshape(S, -1, N_KIN_JOINTS, 4)
    b = torch.broadcast_to(betas, lead + (N_SHAPE,)).reshape(S, -1, N_SHAPE)
    verts, joints = _lbs(model, q, b, side)
    verts = verts.transpose(-1, -2)
    if center_idx is not None:
        center = joints[:, :, center_idx : center_idx + 1]
        verts, joints = verts - center, joints - center
    return verts.reshape(lead + (N_VERTS, 3)), joints.reshape(lead + (N_JOINTS, 3))


def recover_mano_from_pose_repr(
    model: ManoTensors, pose_repr: torch.Tensor, shape: torch.Tensor, side: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """pose_repr [..., 99] + betas [..., 10] -> world-frame (verts, joints);
    `side` as mano_forward's."""
    tsl, quat = T.pose_repr_to_quat(pose_repr)
    verts, joints = mano_forward(model, quat, shape, center_idx=0, side=side)
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
