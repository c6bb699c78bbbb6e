"""Geometry: vertex normals, hand->object nearest distances and signed
hand/object distances (port of oakink2_tamf_tpu/core/geometry.py, the parts
the serving path and G training run).

`point2point_h2o` routes like the JAX package does on the TPU: the
bounds-culled kernel (ops/chamfer_cull.py) when P2 >= CULL_MIN_P2 and
grad_y=False, the all-pairs kernel (ops/chamfer_nn.py) otherwise. Without a
gradient it runs the forward-only kernels (#1, #2). Under autograd with
grad_y=False the forward is the route's dvec kernel (#3 culled, #4
all-pairs) and the backward elementwise; with grad_y=True it is the
all-pairs forward (#1) and the backward kernel (#5,
ops/chamfer_h2o_bwd.py).

`point2point_signed` is the signed bidirectional pair (ops/chamfer_signed.py)
with its backward kernel. CUDA tensors go to the kernels, CPU tensors to
their plain versions.

Both take `backend="cluster"`, the cluster-pruned opt-in route
(ops/chamfer_cluster.py: kernels #10-#13), exact where its certificate
(`point2point_h2o_overflow`, ops/chamfer_cluster.signed_cluster_overflow)
is zero. The JAX package's "xla" scan is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chamfer_cluster, chamfer_cull, chamfer_h2o_bwd, chamfer_nn, chamfer_signed

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
        # normal tensors even when first built under inference_mode (serving):
        # a training step that reuses the cached operators saves them for backward
        with torch.inference_mode(False):
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


class _H2ODvec(torch.autograd.Function):
    """dist [F, P1] with the TPU VJP of the grad_y=False routes (`_cull_fwd`
    / `_cull_bwd`, chamfer_cull.py:368-391; the dvec branch of `_p2h_fwd` /
    `_p2h_bwd`, chamfer_pallas.py:681-717): the forward kernel carries
    dvec = x - y*, so gx = cot / max(dist, 1e-12) * dvec and y gets no
    gradient. A row that took no point has dvec = 0 and gets none either."""

    @staticmethod
    def forward(ctx, x, y, y_valid, x_valid, cull: bool, y_group: int):
        if cull:
            d2, dvec = chamfer_cull.h2o_cull_dvec(x, y, y_valid, y_group=y_group, x_valid=x_valid)
        else:
            d2, dvec = chamfer_nn.h2o_nn_dvec(x, y, y_valid, y_group)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        ctx.save_for_backward(dist, dvec)
        return dist

    @staticmethod
    def backward(ctx, g):
        dist, dvec = ctx.saved_tensors
        xr = g / torch.clamp_min(dist, chamfer_signed.DIST_EPS)
        return xr[..., None] * dvec, None, None, None, None, None


class _H2OGradY(torch.autograd.Function):
    """dist [F, P1] with the TPU VJP of the grad_y=True route (`_p2h_fwd` /
    `_p2h_bwd`, chamfer_pallas.py:697-725): the all-pairs forward (#1)
    keeps the first-min index, and the backward kernel (#5) gives gx and,
    when y needs it, gy; y_group == 1."""

    @staticmethod
    def forward(ctx, x, y, y_valid):
        d2, idx = chamfer_nn.h2o_nn(x, y, y_valid, 1)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        ctx.save_for_backward(x, y, dist, idx)
        return dist

    @staticmethod
    def backward(ctx, g):
        x, y, dist, idx = ctx.saved_tensors
        xr = g / torch.clamp_min(dist, chamfer_signed.DIST_EPS)
        gx, gy = chamfer_h2o_bwd.h2o_backward(x, y, idx, xr, grad_y=ctx.needs_input_grad[1])
        return gx.to(x.dtype), gy, None


def _h2o(x, y, y_valid, x_valid, cull: bool, grad_y: bool, y_group: int) -> torch.Tensor:
    if not (torch.is_grad_enabled() and (x.requires_grad or (grad_y and y.requires_grad))):
        if cull:
            d2 = chamfer_cull.h2o_cull(x, y, y_valid, y_group=y_group, x_valid=x_valid)
        else:
            d2, _ = chamfer_nn.h2o_nn(x, y, y_valid, y_group)
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    if grad_y:
        return _H2OGradY.apply(x, y, y_valid)
    return _H2ODvec.apply(x, y.detach(), y_valid, x_valid, cull, y_group)


def point2point_h2o(
    x: torch.Tensor,  # [N, P1, 3]
    y: torch.Tensor,  # [N // y_group, P2, 3]
    y_valid: torch.Tensor | None = None,  # [N // y_group, P2] bool
    *,
    backend: str = "auto",
    x_perm: np.ndarray | None = None,
    k_cells: int | None = None,
    grad_y: bool = True,
    y_group: int = 1,
    x_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Unsigned x->y nearest distances [N, P1], differentiable in x (and in
    y when grad_y, which requires y_group == 1).

    Backends: "auto" takes the culled route for grad_y=False at
    P2 >= CULL_MIN_P2 and the all-pairs route otherwise; "cull" forces the
    culled route (grad_y=False only); "exact" and "pallas" force the
    all-pairs route; "cluster" is the cluster-pruned opt-in (`k_cells`
    candidate cells per 128-row tile, ops/chamfer_cluster.K_CELLS_DEFAULT
    by default): exact only where `point2point_h2o_overflow` is zero, and
    never below the exact value. The JAX package's "xla" scan is not ported
    (ROADMAP.md).

    `x_valid` [N] is a culling hint for the culled route: False frames come
    out BIG there (callers must replace them) and are searched on the other
    routes. `x_perm` (core/mano.hand_template_perm) reorders the rows before
    the culled and cluster routes so their 128-row tiles are compact;
    distances map back through the inverse permutation (on the culled route
    both gathers stay in the autograd graph; the cluster route un-permutes
    inside its autograd.Function)."""
    if backend == "xla":
        raise NotImplementedError(
            "point2point_h2o backend='xla' is not ported (the JAX package's XLA scan; "
            "ROADMAP.md): use 'auto', 'cull', 'exact' or 'cluster'"
        )
    if backend not in ("auto", "cull", "exact", "pallas", "cluster"):
        raise ValueError(f"unknown point2point_h2o backend {backend!r}")
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if backend == "cluster":
        kw = {} if k_cells is None else {"k_cells": k_cells}
        return chamfer_cluster.point2point_h2o_cluster(
            x, y, y_valid, x_perm=x_perm, grad_y=grad_y, y_group=y_group, **kw
        )
    if backend == "cull" and grad_y:
        raise NotImplementedError("backend='cull' requires grad_y=False")
    cull = backend == "cull" or (backend == "auto" and not grad_y and y.shape[1] >= CULL_MIN_P2)
    if cull and x_perm is not None:
        perm = torch.as_tensor(np.asarray(x_perm), device=x.device)
        inv = torch.argsort(perm)
        return _h2o(x[:, perm], y, y_valid, x_valid, True, grad_y, y_group)[:, inv]
    return _h2o(x, y, y_valid, x_valid, cull, grad_y, y_group)


def point2point_h2o_overflow(
    x: torch.Tensor,  # [N, P1, 3]
    y: torch.Tensor,  # [N // y_group, P2, 3]
    y_valid: torch.Tensor | None = None,
    *,
    backend: str = "auto",
    x_perm: np.ndarray | None = None,
    k_cells: int | None = None,
    y_group: int = 1,
) -> torch.Tensor:
    """Per-frame overflow counts [N] int32 for the route point2point_h2o
    takes on these operands: zero everywhere proves the cluster-pruned
    result exact; all zeros off the cluster route, whose kernels are exact.
    Runs the candidate selection only, no nearest-neighbour kernel. Callers
    that persist h2o values (data/target_cache) recompute overflowed ones
    on an exact route; train_r monitors it at val time."""
    if backend != "cluster":
        return torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    kw = {} if k_cells is None else {"k_cells": k_cells}
    return chamfer_cluster.h2o_cluster_overflow(x, y, y_valid, x_perm=x_perm, y_group=y_group, **kw)


def point2point_signed(
    x: torch.Tensor,  # [N, P1, 3] hand verts
    y: torch.Tensor,  # [N // y_group, P2, 3] object points
    x_normals: torch.Tensor | None = None,  # [N, P1, 3]
    y_valid: torch.Tensor | None = None,  # [N // y_group, P2] bool
    *,
    backend: str = "auto",
    x_perm: np.ndarray | None = None,
    k_cells: int | None = None,
    k_tiles: int | None = None,
    grad_y: bool = True,
    y_group: int = 1,
    y_normals: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Signed distances between two point clouds (the reference's
    model/loss/chamfer_distance.py:point2point_signed).

    Returns (y2x_signed [N, P2], x2y_signed [N, P1], yidx_near [N, P2]):
    y2x is each object point's distance to its nearest hand vert, signed
    by that vert's normal (unsigned without normals, 0 at invalid points);
    x2y is each hand vert's distance to its nearest object point;
    yidx_near is the index of the hand vert nearest to each object point.

    grad_y=False keeps y off the differentiation path (every TaMF loss
    differentiates only the hand verts). y_group > 1 is the shared-cloud
    mode (requires grad_y=False): frame f searches cloud f // y_group.

    Backends: "auto" and "pallas" run the signed pair's kernels;
    "cluster" the cluster-pruned opt-in (ops/chamfer_cluster.py; `k_cells`
    candidate cells per hand tile, `k_tiles` candidate tiles per object
    cell, 0 = all), exact where ops/chamfer_cluster.signed_cluster_overflow
    is zero, one cloud per frame (no y_group). `y_normals` (signing x2y) is
    refused, as the JAX package's kernel routes refuse it; "xla" is not
    ported."""
    if y_normals is not None:
        raise ValueError(
            "point2point_signed: y_normals are not supported (no TaMF call site passes them; "
            "the JAX package signs x2y only on its XLA route)"
        )
    if backend == "xla":
        raise NotImplementedError(
            "point2point_signed backend='xla' is not ported (the JAX package's XLA scan; "
            "ROADMAP.md): use 'auto' or 'cluster'"
        )
    if backend not in ("auto", "pallas", "cluster"):
        raise ValueError(f"unknown point2point_signed backend {backend!r}")
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if backend == "cluster":
        if y_group > 1:
            raise NotImplementedError("backend='cluster' has no y_group support")
        kw = {k: v for k, v in (("k_cells", k_cells), ("k_tiles", k_tiles)) if v is not None}
        return chamfer_cluster.point2point_signed_cluster(
            x, y, x_normals, y_valid, x_perm=x_perm, grad_y=grad_y, **kw
        )
    return chamfer_signed.signed_chamfer(
        x, y, x_normals, y_valid, grad_y=grad_y, y_group=y_group
    )
