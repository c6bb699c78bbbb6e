"""Geometry: vertex normals, hand->object nearest distances and signed
hand/object distances (port of oakink2_tamf_tpu/core/geometry.py).

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
is zero, and `backend="xla"`, the JAX package's streaming scan
(`nearest_neighbor`): y in tiles of `chunk` points, batched matmuls, no
kernel of ops/. It is the only route that signs x2y by `y_normals`, and
"auto" takes it whenever they are given.

`min_cdist`, the Contact Ratio's distance core, runs the all-pairs kernel
(#1) on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chamfer_cluster, chamfer_cull, chamfer_h2o_bwd, chamfer_nn, chamfer_signed
from . import transforms as T

CULL_MIN_P2 = 4096


def _clamp_tile(chunk: int, p2: int) -> int:
    """The y tile of a tiled route (JAX core/geometry.py:184-188): at least
    512 points, at most the point count rounded up to 128, else `chunk`
    (`train.chunk`). The region-culled loss tiles its mask with it."""
    return max(512, min(chunk, -(-p2 // 128) * 128))


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted per-vertex normals, normalized. verts [..., V, 3];
    faces [F, 3] host ints shared by every mesh, or an int64 tensor
    [..., F, 3] whose leading dims broadcast to the verts' (a face set per
    row, as a stacked hand's sides) -> [..., V, 3]. A gather of the
    faces' corners, their cross products, and a scatter-add of each face's
    normal into its three corners."""
    f = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    lead, nf = verts.shape[:-2], f.shape[-2]
    corners = verts.gather(-2, f.reshape(f.shape[:-2] + (3 * nf, 1)).expand(lead + (3 * nf, 3)))
    v0, v1, v2 = corners.unflatten(-2, (nf, 3)).unbind(-2)
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # [..., F, 3]
    acc = torch.zeros_like(verts)
    for i in range(3):
        acc = acc.scatter_add(-2, f[..., i, None].expand(lead + (nf, 3)), fn)
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
    chunk: int = 2048,
) -> torch.Tensor:
    """Unsigned x->y nearest distances [N, P1], differentiable in x (and in
    y when grad_y, which requires y_group == 1).

    Backends: "auto" takes the culled route for grad_y=False at
    P2 >= CULL_MIN_P2 and the all-pairs route otherwise; "cull" forces the
    culled route (grad_y=False only); "exact" and "pallas" force the
    all-pairs route; "cluster" is the cluster-pruned opt-in (`k_cells`
    candidate cells per 128-row tile, ops/chamfer_cluster.K_CELLS_DEFAULT
    by default): exact only where `point2point_h2o_overflow` is zero, and
    never below the exact value; "xla" is the streaming scan (`chunk` points
    of y per tile, no kernel), differentiable in y too when grad_y.

    `x_valid` [N] is a culling hint for the culled route: False frames come
    out BIG there (callers must replace them) and are searched on the other
    routes. On the xla route an all-invalid cloud gives +inf. `x_perm` (core/mano.hand_template_perm) reorders the rows before
    the culled and cluster routes so their 128-row tiles are compact;
    distances map back through the inverse permutation (on the culled route
    both gathers stay in the autograd graph; the cluster route un-permutes
    inside its autograd.Function)."""
    if backend not in ("auto", "cull", "exact", "pallas", "cluster", "xla"):
        raise ValueError(f"unknown point2point_h2o backend {backend!r}")
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if backend == "xla":
        return _h2o_xla(x, y if grad_y else y.detach(), y_valid, y_group, chunk)
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
    y_normals: torch.Tensor | None = None,  # [N, P2, 3]
    chunk: int = 2048,
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
    is zero, one cloud per frame (no y_group); "xla" the streaming scan
    (`chunk` points per tile, no kernel). `y_normals` sign x2y by the
    normal of each hand vert's nearest object point: "auto" then takes the
    xla route, and "pallas" and "cluster" refuse them, as in the JAX
    package. On the xla route an all-invalid cloud gives x2y = +inf (signed
    against its point 0 with y_normals) and padded frames are searched."""
    if backend in ("pallas", "cluster") and y_normals is not None:
        raise ValueError(
            f"backend={backend!r} does not support y_normals (no TaMF call site passes them); "
            "use backend='auto'/'xla'"
        )
    if backend not in ("auto", "pallas", "cluster", "xla"):
        raise ValueError(f"unknown point2point_signed backend {backend!r}")
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if backend == "xla" or (backend == "auto" and y_normals is not None):
        return _signed_xla(x, y if grad_y else y.detach(), x_normals, y_normals, y_valid, y_group, chunk)
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


# the xla route's distance tiles: one [clouds, rows, chunk] float32 tile
# stays near this size, whatever the batch
XLA_TILE_BYTES = 1 << 30


def nearest_neighbor(
    x: torch.Tensor,  # [N, P1, 3] or [P1, 3]
    y: torch.Tensor,  # [N // y_group, P2, 3] or [P2, 3]
    y_valid: torch.Tensor | None = None,  # [N // y_group, P2] or [P2] bool
    chunk: int = 2048,
    *,
    y_group: int = 1,
    tile_bytes: int = XLA_TILE_BYTES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each point of x, the (squared distance, index int32) of its
    nearest point in y; frame f searches cloud f // y_group (JAX
    core/geometry.py:129, vmapped). y is streamed in tiles of `chunk` points
    with a running minimum; squared distances in the expanded form
    max(|x|^2 + |y|^2 - 2 x.y, 0) (one batched matmul per tile); y_valid
    masks points to inf, so an all-invalid cloud gives (inf, 0). Within a
    tile the first minimum wins, across tiles the earlier. The frames of a
    cloud share it (no copy), and clouds and rows go in groups whose
    [clouds, rows, chunk] tile stays within `tile_bytes` (or 128 rows): the
    values do not depend on the grouping. No gradient: the xla route
    attaches it to the chosen pairs (_pair_dist)."""
    if x.ndim == 2:
        d, i = nearest_neighbor(x[None], y[None], None if y_valid is None else y_valid[None], chunk,
                                tile_bytes=tile_bytes)
        return d[0], i[0]
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    if F != G * y_group:
        raise ValueError(f"{F} frames against {G} clouds with y_group {y_group}")
    chunk = max(1, min(chunk, P2))
    M = y_group * P1
    with torch.no_grad():
        xg = x.reshape(G, M, 3)
        x2 = torch.sum(xg * xg, dim=-1, keepdim=True)  # [G, M, 1]
        y2 = torch.sum(y * y, dim=-1)  # [G, P2]
        if y_valid is not None:
            y2 = y2.masked_fill(~y_valid.bool(), torch.inf)  # the tile's entry is then inf
        yT = y.transpose(1, 2)  # [G, 3, P2]
        # rows per tile: at least 128, since BLAS rounds a product of one or
        # two rows otherwise than a taller one
        rows = max(128, tile_bytes // (4 * chunk))
        rb = min(M, rows)
        gb = max(1, rows // M)
        best_d = torch.full((G, M), torch.inf, dtype=x.dtype, device=x.device)
        best_i = torch.zeros((G, M), dtype=torch.int64, device=x.device)
        for g0 in range(0, G, gb):
            for r0 in range(0, M, rb):
                xs, x2s = xg[g0 : g0 + gb, r0 : r0 + rb], x2[g0 : g0 + gb, r0 : r0 + rb]
                bd, bi = best_d[g0 : g0 + gb, r0 : r0 + rb], best_i[g0 : g0 + gb, r0 : r0 + rb]
                for j0 in range(0, P2, chunk):
                    base = x2s + y2[g0 : g0 + gb, None, j0 : j0 + chunk]
                    d = torch.baddbmm(base, xs, yT[g0 : g0 + gb, :, j0 : j0 + chunk], alpha=-2.0)
                    dmin, i = torch.min(d.clamp_min_(0.0), dim=-1)
                    upd = dmin < bd
                    bd.copy_(torch.where(upd, dmin, bd))
                    bi.copy_(torch.where(upd, i + j0, bi))
    return best_d.reshape(F, P1), best_i.reshape(F, P1).to(torch.int32)


def _pair_dist(d2: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(d2) [...] valued exactly as _sqrt_positive_part(d2), the squared
    distance of the pair (a, b) [..., 3] that the search chose, with the
    gradient of the JAX route's expanded distance there: (a - b) / dist
    into a and its negative into b (b is a gather, so its gradient
    scatters into the cloud), none where dist is 0 or inf. The search's
    tiles are not kept: the gradient needs only the pair."""
    dist = T._sqrt_positive_part(d2)
    if not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return dist
    diff = a - b
    coef = torch.where(dist > 0, dist.reciprocal(), 0.0)  # 0 at inf too
    lin = torch.sum(diff * (diff.detach() * coef[..., None]), dim=-1)
    return dist + (lin - lin.detach())


def _cloud_rows(idx: torch.Tensor, y_group: int, P2: int) -> torch.Tensor:
    """Per-frame point indices [F, P] -> rows of the flattened clouds
    [(F // y_group) * P2]."""
    cloud = torch.arange(idx.shape[0], device=idx.device) // y_group
    return cloud[:, None] * P2 + idx.long()


def _h2o_xla(x, y, y_valid, y_group: int, chunk: int) -> torch.Tensor:
    """x->y distances [F, P1] on the xla route (JAX `_point2point_signed_xla`'s
    x2y, geometry.py:446-477)."""
    d2, idx = nearest_neighbor(x, y, y_valid, chunk, y_group=y_group)
    y_near = y.reshape(-1, 3)[_cloud_rows(idx, y_group, y.shape[1])]
    return _pair_dist(d2, x, y_near)


def _signed_xla(x, y, x_normals, y_normals, y_valid, y_group: int, chunk: int):
    """(y2x_signed [F, P2], x2y_signed [F, P1], yidx_near [F, P2]) on the xla
    route (JAX `_point2point_signed_xla`): each direction's search, the
    distance of its chosen pair, signed by sign(normal . offset) of the
    nearest point (sign(0) = 0); y2x is 0 at invalid y points, whose
    yidx_near is still the real nearest index. Frame f's cloud is f //
    y_group: the x2y search shares it, the y2x search queries a per-frame
    copy of its points."""
    F, P1, _ = x.shape
    P2 = y.shape[1]
    d_x2y, i_x2y = nearest_neighbor(x, y, y_valid, chunk, y_group=y_group)
    x_near = y.reshape(-1, 3)[_cloud_rows(i_x2y, y_group, P2)]  # nearest y of each x
    yf = y if y_group == 1 else y.repeat_interleave(y_group, dim=0)  # [F, P2, 3]
    d_y2x, i_y2x = nearest_neighbor(yf, x, None, chunk)
    y_near = x.reshape(-1, 3)[_cloud_rows(i_y2x, 1, P1)]  # nearest x of each y
    x2y = _pair_dist(d_x2y, x, x_near)
    y2x = _pair_dist(d_y2x, yf, y_near)
    if x_normals is not None:
        nn = x_normals.reshape(-1, 3)[_cloud_rows(i_y2x, 1, P1)]
        y2x = y2x * torch.sign(torch.sum(nn * (yf - y_near), dim=-1)).detach()
    if y_normals is not None:
        nn = y_normals.reshape(-1, 3)[_cloud_rows(i_x2y, 1, P2)]
        x2y = x2y * torch.sign(torch.sum(nn * (x - x_near), dim=-1)).detach()
    if y_valid is not None:
        yv = y_valid.bool() if y_group == 1 else y_valid.bool().repeat_interleave(y_group, dim=0)
        y2x = torch.where(yv, y2x, 0.0)
    return y2x, x2y, i_y2x


def min_cdist(hv: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Per-frame min distance from any hand vert to any object point:
    hv [T, Vh, 3], pc [T, Vo, 3] -> [T] (JAX core/geometry.py:481; the
    reference's compute_score_cr.py:140-149 took torch.cdist + min). Each
    row's nearest squared distance comes from the all-pairs kernel
    (ops/chamfer_nn.h2o_nn, one cloud per frame), then the frame's minimum
    and the safe square root."""
    d2, _ = chamfer_nn.h2o_nn(hv, pc, None, 1)
    return T._sqrt_positive_part(d2.amin(dim=1))
