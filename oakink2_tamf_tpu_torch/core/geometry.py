"""Geometry: vertex normals and hand->object nearest distances (port of
oakink2_tamf_tpu/core/geometry.py, the parts the serving path runs).

`point2point_h2o` routes like the JAX package does on the TPU: the
bounds-culled kernel (ops/chamfer_cull.py) when P2 >= CULL_MIN_P2 and
grad_y=False, the all-pairs kernel (ops/chamfer_nn.py) otherwise. CUDA
tensors go to the kernels, CPU tensors to their plain versions.

Forward only: the kernels have no backward yet (the training slices add
them), so a call that would need a gradient raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chamfer_cull, chamfer_nn

CULL_MIN_P2 = 4096

# dense {0, +-1} corner-difference and incidence operators per (faces, V,
# device): D1/D2 [F, V] map verts to the two edge vectors, A [V, F] sums
# face normals into vertices. Bounded: one entry per hand side and device.
_VN_OPS_CACHE: dict[tuple, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _vn_dense_ops(faces: np.ndarray, num_v: int, device: torch.device):
    key = (faces.tobytes(), num_v, str(device))
    ops = _VN_OPS_CACHE.get(key)
    if ops is None:
        F = faces.shape[0]
        d1 = np.zeros((F, num_v), np.float32)
        d2 = np.zeros((F, num_v), np.float32)
        a = np.zeros((num_v, F), np.float32)
        r = np.arange(F)
        np.add.at(d1, (r, faces[:, 1]), 1.0)
        np.add.at(d1, (r, faces[:, 0]), -1.0)
        np.add.at(d2, (r, faces[:, 2]), 1.0)
        np.add.at(d2, (r, faces[:, 0]), -1.0)
        for i in range(3):
            np.add.at(a, (faces[:, i], r), 1.0)
        if len(_VN_OPS_CACHE) >= 8:
            _VN_OPS_CACHE.pop(next(iter(_VN_OPS_CACHE)))
        ops = _VN_OPS_CACHE[key] = tuple(torch.from_numpy(m).to(device) for m in (d1, d2, a))
    return ops


def _apply_vertex_op(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """op [M, N] applied to v [..., N, 3] -> [..., M, 3] as one matmul."""
    lead = v.shape[:-2]
    n = v.shape[-2]
    flat = v.reshape(-1, n, 3).permute(1, 0, 2).reshape(n, -1)  # [N, B*3]
    out = op @ flat
    return out.reshape(op.shape[0], -1, 3).permute(1, 0, 2).reshape(lead + (op.shape[0], 3))


def vertex_normals(verts: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """Area-weighted per-vertex normals, normalized. verts [..., V, 3], faces
    [F, 3] host ints -> [..., V, 3]. Dense-operator path (MANO-sized meshes)."""
    d1, d2, a = _vn_dense_ops(np.asarray(faces), verts.shape[-2], verts.device)
    e1 = _apply_vertex_op(d1, verts)
    e2 = _apply_vertex_op(d2, verts)
    acc = _apply_vertex_op(a, torch.linalg.cross(e1, e2, dim=-1))
    n2 = torch.sum(acc * acc, dim=-1, keepdim=True)
    return acc * torch.rsqrt(torch.clamp_min(n2, 1e-24))


def point2point_h2o(
    x: torch.Tensor,  # [N, P1, 3]
    y: torch.Tensor,  # [N // y_group, P2, 3]
    y_valid: torch.Tensor | None = None,  # [N // y_group, P2] bool
    *,
    x_perm: np.ndarray | None = None,
    grad_y: bool = True,
    y_group: int = 1,
    x_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Unsigned x->y nearest distances [N, P1].

    `x_valid` [N] is a culling hint for the cull route: False frames come out
    BIG there (callers must replace them) and are searched on the all-pairs
    route. `x_perm` (core/mano.hand_template_perm) reorders the rows before
    the cull route so its 128-row regions are compact; distances map back
    through the inverse permutation."""
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise NotImplementedError("the h2o kernels are forward-only")
    if not grad_y and y.shape[1] >= CULL_MIN_P2:
        if x_perm is not None:
            perm = torch.as_tensor(np.asarray(x_perm), device=x.device)
            inv = torch.argsort(perm)
            d2 = chamfer_cull.h2o_cull(
                x[:, perm], y, y_valid, y_group=y_group, x_valid=x_valid
            )[:, inv]
        else:
            d2 = chamfer_cull.h2o_cull(x, y, y_valid, y_group=y_group, x_valid=x_valid)
    else:
        d2, _ = chamfer_nn.h2o_nn(x, y, y_valid, y_group)
    return torch.sqrt(torch.clamp_min(d2, 0.0))
