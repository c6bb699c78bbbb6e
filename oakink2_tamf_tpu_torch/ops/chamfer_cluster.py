"""Cluster-pruned hand/object nearest neighbour (port of
oakink2_tamf_tpu/ops/chamfer_cluster.py): the candidate-selection stage,
the overflow certificates, four CUDA kernels with their wrappers, plain
PyTorch versions and launch counts, and the autograd.Functions of the two
entry points.

As in the JAX package the route is an opt-in (`backend="cluster"` of
core/geometry.point2point_h2o and point2point_signed), never taken by
"auto": its candidate budget was tuned on compact grasp scenes, and with a
full-size hand it silently overestimates h2o on clouds of more than
K_CELLS_DEFAULT cells. Its production caller is the val-epoch exactness
certificate of launch/train_r (`make_overflow_probe`).

How it searches (the JAX module's design, steps 1-3 in plain PyTorch here
as XLA runs them there, on the CPU and the GPU alike):
1. y is cut into cells of S_CELL = 128 consecutive points (the collate step
   sorts each canonical cloud spatially, so cells are compact); per cloud,
   `cell_stats` gives each cell's centre, radius and N_REPS real
   representative points.
2. The rows of x are reordered by a static template permutation (`x_perm`,
   core/mano.hand_template_perm for MANO verts) or, without one, a
   per-frame Morton sort (`XPerm`), and cut into tiles of 128 rows.
3. Per (tile t, cell c) the margin
       min_{i in t} d(x_i, centre_c) - r_c - ub_i - (1e-6 + 1e-5 ub_i),
   with ub_i = min over every representative of d(x_i, rep), is <= 0 for
   every cell that can hold a row's nearest point. `h2o_select` keeps the
   K cells with the smallest margins; the search is exact iff at most K
   qualify, and the per-tile overflow bit is the certificate
   (`h2o_cluster_overflow`). The o2h direction selects candidate x tiles
   per y cell the same way (`o2h_select`); with k_tiles = 0 (the default)
   every tile is searched and the o2h side is exact by construction.
   The margins follow the JAX formula (sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0))
   after centring on the cloud's mean), so both packages see the same
   candidate sets and overflow counts; the kernels compute each pair by
   direct differences, like every kernel of the port.
4. Kernels (CUDA C++, csrc/; bounds and designs in the sources):
   #10 `h2o_topk` (csrc/h2o_topk.cu) replaces `_h2o_topk_kernel` (:474):
       each row's min over its tile's K candidate cells, and the first
       point reaching it; it skips the cells without a valid point
       (`cell_flags`), which can never lower a row;
   #11 `h2o_topk_bwd` (csrc/h2o_topk_bwd.cu) replaces
       `_h2o_topk_bwd_kernel(_nogy)` (:558 / :596);
   #12 `o2h_topk` (csrc/o2h_topk.cu) replaces `_o2h_topk_kernel` (:801):
       each object point's min over its cell's candidate tiles, the first
       row reaching it and the sign numerator;
   #13 `o2h_topk_bwd` (csrc/o2h_topk_bwd.cu) replaces
       `_o2h_topk_bwd_kernel(_nogy)` (:944 / :981).

Candidate order decides the index on exact distance ties across cells
(strict < in candidate order, ascending within a cell), and so which point
the backward reads. `lax.top_k` returns equal margins lower index first, and
empty cells all sit at BIG: the selection sorts stably and keeps the first
K; the Morton fallback sorts stably and rep 0 is a first-index argmin.

Index space: the forwards run on the permuted rows, and the wrappers
un-permute their outputs before anything is saved for the backward (h2o
distances and indices back to the caller's row order, o2h row indices
mapped through the permutation and clipped into [0, P1)). The backward
kernels therefore see the caller's order and need neither the permutation
nor the candidate lists: as on the TPU, the forward's indices are the
constants of the backward, and with the global index known the gather is a
load. The h2o index is global in y, in [0, P2) on every row.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which repeats the kernel's per-pair
rounding (the backwards sum in another order than their atomics).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.pc_util import spatial_sort_indices
from . import chamfer_h2o_bwd as HB
from . import chamfer_nn as NN
from . import chamfer_signed as CS
from ._build import Kernel

BIG = NN.BIG
FAR = NN.FAR
S_CELL = 128  # y points per cell, x rows per tile
K_CELLS_DEFAULT = 24  # h2o: cells searched per 128-row tile (clamped to the cell count)
K_TILES_DEFAULT = 0  # o2h: 0 -> every tile (exact)
N_REPS = 8  # representative points per cell / tile for the upper bound ub
H2O_FRAME_CHUNK = 256  # frames per selection pass (the JAX package's chunks)
O2H_FRAME_CHUNK = 128
_PLAIN_CHUNK_ELEMS = 1 << 25  # bound on the plain kernels' pair differences per step

_P = ctypes.c_void_p
_I = ctypes.c_int
H2O_KERNEL = Kernel(
    "h2o_topk", "h2o_topk.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cluster.py:474",
    symbol="h2o_topk_launch",
    argtypes=[_P] * 7 + [_I] * 6 + [_P],
)
H2O_BWD_KERNEL = Kernel(
    "h2o_topk_bwd", "h2o_topk_bwd.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cluster.py:558",
    symbol="h2o_topk_bwd_launch",
    argtypes=[_P] * 6 + [_I] * 5 + [_P],
)
O2H_KERNEL = Kernel(
    "o2h_topk", "o2h_topk.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cluster.py:801",
    symbol="o2h_topk_launch",
    argtypes=[_P] * 8 + [_I] * 5 + [_P],
)
O2H_BWD_KERNEL = Kernel(
    "o2h_topk_bwd", "o2h_topk_bwd.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cluster.py:944",
    symbol="o2h_topk_bwd_launch",
    argtypes=[_P] * 6 + [_I] * 4 + [_P],
)
KERNELS = (H2O_KERNEL, H2O_BWD_KERNEL, O2H_KERNEL, O2H_BWD_KERNEL)


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


# ---------------------------------------------------------------------------
# x permutations
# ---------------------------------------------------------------------------


def template_perm(template_verts: np.ndarray) -> np.ndarray:
    """Static row permutation from rest-pose verts [V, 3]: a spatial sort of
    the template keeps each 128-row tile compact in every pose (for MANO
    this is core/mano.hand_template_perm)."""
    return np.asarray(spatial_sort_indices(np.asarray(template_verts), leaf=S_CELL), np.int64)


def morton_perm(x: torch.Tensor) -> torch.Tensor:
    """x [F, P1, 3] -> [F, P1] sorting each frame's rows along a 3-D Morton
    curve of their bounding box (the fallback without a static permutation),
    with the JAX package's quantisation and a stable sort."""
    mn = x.amin(dim=1, keepdim=True)
    mx = x.amax(dim=1, keepdim=True)
    q = ((x - mn) / torch.clamp_min(mx - mn, 1e-9) * 255.0).to(torch.int32)
    key = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    for b in range(8):
        for c in range(3):
            key = key | (((q[..., c] >> b) & 1) << (3 * b + c))
    return torch.argsort(key, dim=1, stable=True)


class XPerm:
    """The row permutation of x [F, P1, 3]: one static permutation for every
    frame, or a per-frame Morton sort. `apply` reorders rows into tile
    order, `unapply` restores the caller's order, `to_original` maps
    permuted row indices to the caller's."""

    def __init__(self, x: torch.Tensor, static_perm: np.ndarray | None):
        P1 = x.shape[1]
        if static_perm is not None:
            p = np.asarray(static_perm)
            if p.shape != (P1,):
                raise ValueError(f"x_perm shape {p.shape} != ({P1},): pass the permutation of x's rows")
            if not np.array_equal(np.sort(p), np.arange(P1)):
                # duplicates would search some rows twice and make the
                # inverse meaningless: silently wrong distances
                raise ValueError("x_perm is not a permutation of arange(P1)")
            self.perm = torch.as_tensor(p.astype(np.int64), device=x.device)
            self.inv = torch.argsort(self.perm)
        else:
            self.perm = morton_perm(x.detach().to(torch.float32))
            self.inv = torch.argsort(self.perm, dim=1)

    @staticmethod
    def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if idx.dim() == 1:
            return a[:, idx]
        idx = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(idx.shape + a.shape[2:])
        return torch.gather(a, 1, idx)

    def apply(self, a: torch.Tensor) -> torch.Tensor:
        return self._take(a, self.perm)

    def unapply(self, a: torch.Tensor) -> torch.Tensor:
        return self._take(a, self.inv)

    def to_original(self, idx: torch.Tensor) -> torch.Tensor:
        if self.perm.dim() == 1:
            return self.perm[idx.long()]
        return torch.gather(self.perm, 1, idx.long())


# ---------------------------------------------------------------------------
# Stage 1: cell statistics and candidate selection (plain PyTorch)
# ---------------------------------------------------------------------------


def selection_operands(xs, y, y_valid, ctr, y_group: int):
    """(xc [F, P1p, 3], x_valid [P1p], yc [G, P2p, 3], yv [G, P2p]): the
    permuted rows xs and the clouds y centred on the cloud means ctr, padded
    to whole tiles and cells; pads are invalid."""
    F, P1, _ = xs.shape
    G, P2, _ = y.shape
    P1p, P2p = _cdiv(P1, S_CELL) * S_CELL, _cdiv(P2, S_CELL) * S_CELL
    xc = torch.nn.functional.pad(NN.centred_x(xs, ctr, y_group), (0, 0, 0, P1p - P1))
    x_valid = torch.arange(P1p, device=xs.device) < P1
    yc = torch.nn.functional.pad(y.detach().to(torch.float32) - ctr[:, None], (0, 0, 0, P2p - P2))
    yv = torch.ones((G, P2), dtype=torch.bool, device=y.device) if y_valid is None else y_valid.to(torch.bool)
    yv = torch.nn.functional.pad(yv, (0, P2p - P2), value=False)
    return xc, x_valid, yc, yv


def _group_stats(pts, valid, n_reps: int):
    """Stats of 128-point groups: pts [B, M, 128, 3], valid broadcastable to
    [B, M, 128] -> (centre [B, M, 3], radius [B, M], reps [B, M, R, 3]).
    Valid members only; rep 0 is the valid member nearest the centre, reps
    1..R-1 strided members that fall back to rep 0 where invalid (ub must
    only ever see real points)."""
    valid = valid.expand(pts.shape[:3])
    cnt = valid.sum(dim=-1)
    center = (pts * valid[..., None].to(pts.dtype)).sum(dim=2) / torch.clamp_min(cnt, 1)[..., None]
    d2 = ((pts - center[:, :, None]) ** 2).sum(dim=-1)
    radius = torch.sqrt(torch.where(valid, d2, 0.0).amax(dim=-1))
    rep0_i = torch.argmin(torch.where(valid, d2, torch.inf), dim=-1)  # first minimum
    rep0 = torch.gather(pts, 2, rep0_i[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    reps = [rep0]
    for r in range(1, n_reps):
        p = (r * S_CELL) // n_reps  # static strided slot
        reps.append(torch.where(valid[..., p, None], pts[:, :, p], rep0))
    return center, radius, torch.stack(reps, dim=2)


def cell_stats(yc: torch.Tensor, yv: torch.Tensor, n_reps: int = N_REPS):
    """yc [G, P2p, 3], yv [G, P2p] -> (centres [G, C, 3], radius [G, C],
    reps [G, C, R, 3], nonempty [G, C])."""
    G, P2p, _ = yc.shape
    C = P2p // S_CELL
    vr = yv.reshape(G, C, S_CELL)
    center, radius, reps = _group_stats(yc.reshape(G, C, S_CELL, 3), vr, n_reps)
    return center, radius, reps, vr.any(dim=-1)


def x_tile_stats(xc: torch.Tensor, x_valid: torch.Tensor, n_reps: int = N_REPS):
    """xc [F, P1p, 3], x_valid [P1p] -> (centres [F, T, 3], radius [F, T],
    reps [F, T, R, 3], nonempty [T])."""
    F, P1p, _ = xc.shape
    T = P1p // S_CELL
    vr = x_valid.reshape(1, T, S_CELL)
    center, radius, reps = _group_stats(xc.reshape(F, T, S_CELL, 3), vr, n_reps)
    return center, radius, reps, vr[0].any(dim=-1)


def _dist_to(a, asq, b):
    """sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0)) [n, P, M] of a [n, P, 3] (asq its
    squared norms) to b [n, M, 3]: the JAX selection's formula."""
    bsq = (b * b).sum(dim=-1)
    d2 = asq[:, :, None] + bsq[:, None, :] - 2.0 * torch.bmm(a, b.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _margins(a, centers, radius, reps, nonempty):
    """Per-point margins [n, P, M] of points a [n, P, 3] against M groups
    (centres [n, M, 3], radius [n, M], reps [n, M, R, 3], nonempty [n, M]);
    BIG where a group is empty."""
    asq = (a * a).sum(dim=-1)
    d_c = _dist_to(a, asq, centers)
    ub = torch.full(asq.shape, BIG, dtype=a.dtype, device=a.device)
    for r in range(reps.shape[2]):  # one [n, P, M] pass per representative
        d_p = torch.where(nonempty[:, None, :], _dist_to(a, asq, reps[:, :, r]), BIG)
        ub = torch.minimum(ub, d_p.amin(dim=-1))
    # slack keeps fp-borderline groups in: exclusion must be conservative
    margin = d_c - radius[:, None, :] - ub[..., None] - (1e-6 + 1e-5 * ub[..., None])
    return torch.where(nonempty[:, None, :], margin, BIG)


def _smallest(margin: torch.Tensor, k: int):
    """(indices [..., k] int32 of the k smallest margins, equal margins lower
    index first; overflow [...]: more than k margins <= 0)."""
    idx = torch.sort(margin, dim=-1, stable=True).indices[..., :k]
    return idx.to(torch.int32), (margin <= 0.0).sum(dim=-1) > k


def h2o_select(xc, x_valid, centers, radius, reps, nonempty, k: int, y_group: int = 1,
               frame_chunk: int = H2O_FRAME_CHUNK):
    """Top-k candidate cells per x tile: (cidx [F, T, k] int32, overflow
    [F, T] bool). xc [F, P1p, 3] permuted centred rows, x_valid [P1p]; the
    cell stats are per cloud ([G, ...], frame f reads cloud f // y_group).
    Exact iff not overflow: every cell that can hold a nearest point is
    among the k. Frames run in chunks so that [chunk, P1p, C] is the
    largest intermediate."""
    F, P1p, _ = xc.shape
    T = P1p // S_CELL
    cidx = torch.empty((F, T, k), dtype=torch.int32, device=xc.device)
    ovf = torch.empty((F, T), dtype=torch.bool, device=xc.device)
    for f0 in range(0, F, frame_chunk):
        f1 = min(F, f0 + frame_chunk)
        g = torch.arange(f0, f1, device=xc.device) // y_group
        margin = _margins(xc[f0:f1], centers[g], radius[g], reps[g], nonempty[g])
        margin = torch.where(x_valid[None, :, None], margin, BIG)  # pad rows force nothing
        tile_margin = margin.reshape(f1 - f0, T, S_CELL, -1).amin(dim=2)  # [n, T, C]
        cidx[f0:f1], ovf[f0:f1] = _smallest(tile_margin, k)
    return cidx, ovf


def o2h_select(yc, yv, x_centers, x_radius, x_reps, x_nonempty, k: int,
               frame_chunk: int = O2H_FRAME_CHUNK):
    """Top-k candidate x tiles per y cell by per-point margins, reduced over
    the cell's valid points: (cidx_y [F, C, k] int32, overflow [F, C] bool).
    yc [F, P2p, 3], yv [F, P2p]; x tile stats from `x_tile_stats`."""
    F, P2p, _ = yc.shape
    C = P2p // S_CELL
    T = x_nonempty.shape[0]
    cidx = torch.empty((F, C, k), dtype=torch.int32, device=yc.device)
    ovf = torch.empty((F, C), dtype=torch.bool, device=yc.device)
    for f0 in range(0, F, frame_chunk):
        f1 = min(F, f0 + frame_chunk)
        ne = x_nonempty[None].expand(f1 - f0, T)
        margin = _margins(yc[f0:f1], x_centers[f0:f1], x_radius[f0:f1], x_reps[f0:f1], ne)
        margin = torch.where(yv[f0:f1, :, None], margin, BIG)
        cell_margin = margin.reshape(f1 - f0, C, S_CELL, T).amin(dim=2)  # [n, C, T]
        cidx[f0:f1], ovf[f0:f1] = _smallest(cell_margin, k)
    return cidx, ovf


# ---------------------------------------------------------------------------
# Kernel #10: h2o over the candidate cells
# ---------------------------------------------------------------------------


def plain_h2o_topk(xs, y4, ctr, cidx, y_group: int):
    """Kernel #10's function in plain PyTorch: (min d2 [F, P1], global first
    index [F, P1] int32) of each permuted row over its tile's candidate
    cells, in candidate order with a strict < and ascending within a cell.
    Operands as ops/chamfer_nn.prepare makes them (xs uncentred)."""
    F, P1, _ = xs.shape
    G, P2, _ = y4.shape
    T, K = cidx.shape[1:]
    C = _cdiv(P2, S_CELL)
    dev = xs.device
    xc = torch.nn.functional.pad(NN.centred_x(xs, ctr, y_group), (0, 0, 0, T * S_CELL - P1))
    xc = xc.reshape(F, T, S_CELL, 3)
    cells = torch.nn.functional.pad(y4, (0, 0, 0, C * S_CELL - P2), value=FAR).reshape(G, C, S_CELL, 4)
    best = torch.full((F, T, S_CELL), BIG, dtype=torch.float32, device=dev)
    best_j = torch.zeros((F, T, S_CELL), dtype=torch.int64, device=dev)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (T * S_CELL * S_CELL * 3))
    for f0 in range(0, F, chunk):
        f1 = min(F, f0 + chunk)
        g = (torch.arange(f0, f1, device=dev) // y_group)[:, None]
        b, bj = best[f0:f1], best_j[f0:f1]
        for k in range(K):
            c = cidx[f0:f1, :, k].long()  # [n, T]
            yk = cells[g, c]  # [n, T, 128, 4]
            d = NN.sq_norm_rn(xc[f0:f1, :, :, None, :] - yk[:, :, None, :, :3])  # [n, T, rows, points]
            m, a = torch.min(d, dim=-1)  # first point of the cell
            upd = m < b  # strict: the earlier candidate keeps a tie
            b = torch.where(upd, m, b)
            bj = torch.where(upd, c[..., None] * S_CELL + a, bj)
        best[f0:f1], best_j[f0:f1] = b, bj
    return (best.reshape(F, T * S_CELL)[:, :P1],
            best_j.reshape(F, T * S_CELL)[:, :P1].to(torch.int32))


# [G, C] uint8 cell flags of prepared clouds (defined beside #1/#4, which
# skip the same cells); on the selection's operands they are
# `cell_stats(...)[3]`.
cell_flags = NN.cell_flags


def _check_cuda(named: dict, device) -> None:
    for name, (t, dtype) in named.items():
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")


def launch_h2o_topk(xs, y4, ctr, cidx, y_group: int):
    """Launch kernel #10 on prepared operands and candidate lists."""
    F, P1, _ = xs.shape
    G, P2, _ = y4.shape
    f32 = torch.float32
    _check_cuda({"xs": (xs, f32), "y4": (y4, f32), "ctr": (ctr, f32), "cidx": (cidx, torch.int32)},
                xs.device)
    T, K = cidx.shape[1:]
    if F != G * y_group or y4.shape[2] != 4 or ctr.shape != (G, 3) or cidx.shape[0] != F \
            or T != _cdiv(P1, S_CELL) or K < 1:
        raise ValueError(f"bad operand shapes xs {tuple(xs.shape)} y4 {tuple(y4.shape)} "
                         f"cidx {tuple(cidx.shape)}")
    if F * T >= 2**31:
        raise ValueError("too many blocks for one launch")
    live = cell_flags(y4)
    d = torch.empty((F, P1), dtype=f32, device=xs.device)
    idx = torch.empty((F, P1), dtype=torch.int32, device=xs.device)
    with torch.cuda.device(xs.device):
        H2O_KERNEL.launch(
            xs.data_ptr(), y4.data_ptr(), ctr.data_ptr(), cidx.data_ptr(), live.data_ptr(), d.data_ptr(),
            idx.data_ptr(), F, P1, P2, y_group, T, K, torch.cuda.current_stream().cuda_stream,
        )
    return d, idx


def h2o_topk(xs, y4, ctr, cidx, y_group: int):
    """Kernel #10 on a CUDA tensor, its plain version on a CPU tensor."""
    if xs.is_cuda:
        return launch_h2o_topk(xs, y4, ctr, cidx, y_group)
    if xs.device.type != "cpu":
        raise ValueError(f"h2o_topk runs on CUDA or CPU tensors, got {xs.device}")
    return plain_h2o_topk(xs, y4, ctr, cidx, y_group)


# ---------------------------------------------------------------------------
# Kernel #12: o2h over the candidate tiles, with the sign numerator
# ---------------------------------------------------------------------------


def plain_o2h_topk(xs, ns, y4, ctr, cidx_y):
    """Kernel #12's function in plain PyTorch: (o2h_d, o2h_i (permuted row
    index), o2h_dot) [F, P2] of each point over its cell's candidate tiles,
    in candidate order with a strict < and ascending within a tile; an
    invalid point keeps (BIG, 0). One cloud per frame."""
    F, P1, _ = xs.shape
    P2 = y4.shape[1]
    C, Kx = cidx_y.shape[1:]
    T = _cdiv(P1, S_CELL)
    dev = xs.device
    xc = NN.centred_x(xs, ctr, 1)
    tiles = torch.nn.functional.pad(xc, (0, 0, 0, T * S_CELL - P1)).reshape(F, T, S_CELL, 3)
    row_ok = (torch.arange(T * S_CELL, device=dev) < P1).reshape(T, S_CELL)
    pts = torch.nn.functional.pad(y4, (0, 0, 0, C * S_CELL - P2), value=FAR).reshape(F, C, S_CELL, 4)
    best = torch.full((F, C, S_CELL), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((F, C, S_CELL), dtype=torch.int64, device=dev)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (C * S_CELL * S_CELL * 3))
    for f0 in range(0, F, chunk):
        f1 = min(F, f0 + chunk)
        fr = torch.arange(f0, f1, device=dev)[:, None]
        b, bi = best[f0:f1], best_i[f0:f1]
        for k in range(Kx):
            t = cidx_y[f0:f1, :, k].long()  # [n, C]
            d = NN.sq_norm_rn(tiles[fr, t][:, :, :, None, :] - pts[f0:f1, :, None, :, :3])  # [n, C, rows, points]
            d = torch.where(row_ok[t][..., None], d, torch.inf)  # the last tile's pad rows
            m, a = torch.min(d, dim=2)  # first row of the tile
            upd = m < b
            b = torch.where(upd, m, b)
            bi = torch.where(upd, t[..., None] * S_CELL + a, bi)
        best[f0:f1], best_i[f0:f1] = b, bi
    o2h_d = best.reshape(F, C * S_CELL)[:, :P2]
    o2h_i = best_i.reshape(F, C * S_CELL)[:, :P2]
    o2h_dot = CS.sign_numer(CS._rows_at(xc, o2h_i), CS._rows_at(ns, o2h_i), y4[..., :3])
    return o2h_d, o2h_i.to(torch.int32), o2h_dot


def launch_o2h_topk(xs, ns, y4, ctr, cidx_y):
    """Launch kernel #12 on prepared operands (one cloud per frame)."""
    F, P1, _ = xs.shape
    P2 = y4.shape[1]
    f32 = torch.float32
    _check_cuda({"xs": (xs, f32), "ns": (ns, f32), "y4": (y4, f32), "ctr": (ctr, f32),
                 "cidx_y": (cidx_y, torch.int32)}, xs.device)
    C, Kx = cidx_y.shape[1:]
    if y4.shape != (F, P2, 4) or ns.shape != xs.shape or ctr.shape != (F, 3) \
            or cidx_y.shape[0] != F or C != _cdiv(P2, S_CELL) or Kx < 1:
        raise ValueError(f"bad operand shapes xs {tuple(xs.shape)} y4 {tuple(y4.shape)} "
                         f"cidx_y {tuple(cidx_y.shape)}")
    if P1 > CS.MAX_ROWS:
        raise ValueError(f"{P1} rows exceed the {CS.MAX_ROWS} the block stages in shared memory")
    if F * C >= 2**31:
        raise ValueError("too many blocks for one launch")
    dev = xs.device
    o2h_d = torch.empty((F, P2), dtype=f32, device=dev)
    o2h_i = torch.empty((F, P2), dtype=torch.int32, device=dev)
    o2h_dot = torch.empty((F, P2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        O2H_KERNEL.launch(
            xs.data_ptr(), ns.data_ptr(), y4.data_ptr(), ctr.data_ptr(), cidx_y.data_ptr(),
            o2h_d.data_ptr(), o2h_i.data_ptr(), o2h_dot.data_ptr(), F, P1, P2, C, Kx,
            torch.cuda.current_stream().cuda_stream,
        )
    return o2h_d, o2h_i, o2h_dot


def o2h_topk(xs, ns, y4, ctr, cidx_y):
    """Kernel #12 on a CUDA tensor, its plain version on a CPU tensor."""
    if xs.is_cuda:
        return launch_o2h_topk(xs, ns, y4, ctr, cidx_y)
    if xs.device.type != "cpu":
        raise ValueError(f"o2h_topk runs on CUDA or CPU tensors, got {xs.device}")
    return plain_o2h_topk(xs, ns, y4, ctr, cidx_y)


# ---------------------------------------------------------------------------
# Kernels #11 and #13: the backwards (caller's row order)
# ---------------------------------------------------------------------------


def h2o_topk_backward(x, y, idx, xr, grad_y: bool = True, y_group: int = 1):
    """Kernel #11: (gx [F, P1, 3], gy [G, P2, 3] or None) with
    gx_i = xr_i (x_i - y_{idx_i}) and, with grad_y (y_group == 1), gy_j the
    negated sum over its rows. The function of kernel #5 (its plain version
    is ops/chamfer_h2o_bwd.plain); the launch is #11's own library and
    count."""
    if grad_y and y_group != 1:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    ops = [x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(),
           idx.to(torch.int32).contiguous(), xr.to(torch.float32).contiguous()]
    if x.is_cuda:
        return HB.launch(*ops, grad_y, y_group, kernel=H2O_BWD_KERNEL)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_topk_backward runs on CUDA or CPU tensors, got {x.device}")
    return HB.plain(*ops, grad_y, y_group)


def plain_o2h_backward(x, y, o2h_i, yc, grad_y: bool):
    """Kernel #13's function in plain PyTorch: gx_{i*} -= u_j summed over
    the points, gy_j = u_j (grad_y), u_j = yc_j (y_j - x_{o2h_i[j]}); a zero
    cotangent contributes nothing. One cloud per frame."""
    F, P1, _ = x.shape
    u = yc[..., None] * (y - CS._rows_at(x, o2h_i))
    u = torch.where((yc != 0)[..., None], u, 0.0)
    flat = (torch.arange(F, device=x.device)[:, None] * P1 + o2h_i.long()).reshape(-1)
    gx = torch.zeros((F * P1, 3), dtype=x.dtype, device=x.device).index_add_(0, flat, -u.reshape(-1, 3))
    return gx.reshape(F, P1, 3), (u if grad_y else None)


def launch_o2h_backward(x, y, o2h_i, yc, grad_y: bool):
    """Launch kernel #13: (gx [F, P1, 3], gy [F, P2, 3] or None)."""
    F, P1, _ = x.shape
    P2 = y.shape[1]
    f32 = torch.float32
    _check_cuda({"x": (x, f32), "y": (y, f32), "o2h_i": (o2h_i, torch.int32), "yc": (yc, f32)}, x.device)
    if y.shape != (F, P2, 3) or o2h_i.shape != (F, P2) or yc.shape != (F, P2):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y {tuple(y.shape)}")
    if P1 * 3 * 4 > 48 * 1024:
        raise ValueError(f"{P1} rows exceed the shared-memory gx accumulator")
    gx = torch.empty((F, P1, 3), dtype=f32, device=x.device)
    gy = torch.empty((F, P2, 3), dtype=f32, device=x.device) if grad_y else None
    with torch.cuda.device(x.device):
        O2H_BWD_KERNEL.launch(
            x.data_ptr(), y.data_ptr(), o2h_i.data_ptr(), yc.data_ptr(), gx.data_ptr(),
            gy.data_ptr() if grad_y else None, F, P1, P2, int(grad_y),
            torch.cuda.current_stream().cuda_stream,
        )
    return gx, gy


def o2h_topk_backward(x, y, o2h_i, yc, grad_y: bool = True):
    """Kernel #13 on a CUDA tensor, its plain version on a CPU tensor."""
    ops = [x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(),
           o2h_i.to(torch.int32).contiguous(), yc.to(torch.float32).contiguous()]
    if x.is_cuda:
        return launch_o2h_backward(*ops, grad_y)
    if x.device.type != "cpu":
        raise ValueError(f"o2h_topk_backward runs on CUDA or CPU tensors, got {x.device}")
    return plain_o2h_backward(*ops, grad_y)


# ---------------------------------------------------------------------------
# Forwards in the caller's row order, and the certificates
# ---------------------------------------------------------------------------


def _prepare(x, y, y_valid, y_group: int, x_perm):
    """(XPerm, permuted rows xs, y4, ctr) with ops/chamfer_nn.prepare's
    operands (y centred on each cloud's mean, invalid points at FAR)."""
    x, y = x.detach(), y.detach()
    xp = XPerm(x, x_perm)
    xs, y4, ctr = NN.prepare(xp.apply(x.to(torch.float32)), y, y_valid, y_group)
    return xp, xs, y4, ctr


def _check_budget(k: int, name: str) -> None:
    if k < 0 or (name == "k_cells" and k == 0):
        raise ValueError(f"{name} must be positive, got {k}")


def _stage(x, y, y_valid, y_group: int, x_perm, k_cells: int):
    """Operands and the h2o selection: (XPerm, xs, y4, ctr, the selection
    operands (xc, x_valid, yc, yv), cidx [F, T, K], overflow [F, T]) with
    K = min(k_cells, C)."""
    _check_budget(k_cells, "k_cells")
    xp, xs, y4, ctr = _prepare(x, y, y_valid, y_group, x_perm)
    sel = selection_operands(xs, y, y_valid, ctr, y_group)
    xc, x_valid, yc, yv = sel
    cidx, ovf = h2o_select(xc, x_valid, *cell_stats(yc, yv), min(k_cells, yc.shape[1] // S_CELL), y_group)
    return xp, xs, y4, ctr, sel, cidx, ovf


def h2o_candidates(x, y, y_valid=None, *, x_perm=None, k_cells: int = K_CELLS_DEFAULT,
                   y_group: int = 1):
    """The h2o selection stage alone: (cidx [F, T, K] int32 in tile order,
    overflow [F, T] bool), K = min(k_cells, C)."""
    return _stage(x, y, y_valid, y_group, x_perm, k_cells)[-2:]


def h2o_cluster_forward(x, y, y_valid=None, *, x_perm=None, k_cells: int = K_CELLS_DEFAULT,
                        y_group: int = 1):
    """(min d2 [F, P1], index into y [F, P1] int32) of each row of x
    [F, P1, 3] over the candidate cells of its cloud y[f // y_group], in the
    caller's row order: the selection stage, then kernel #10."""
    xp, xs, y4, ctr, _, cidx, _ = _stage(x, y, y_valid, y_group, x_perm, k_cells)
    d2, idx = h2o_topk(xs, y4, ctr, cidx, y_group)
    return xp.unapply(d2), xp.unapply(idx)


def _o2h_candidates(xc, x_valid, yc, yv, k_tiles: int):
    """(cidx_y [F, C, Kx] int32, overflow [F, C]); k_tiles 0 (or >= T)
    takes every tile, in order, and cannot overflow."""
    _check_budget(k_tiles, "k_tiles")
    F = xc.shape[0]
    T = xc.shape[1] // S_CELL
    C = yc.shape[1] // S_CELL
    kx = T if k_tiles <= 0 else min(k_tiles, T)
    if kx == T:
        # every tile is a candidate: the selection would only return 0..T-1
        cidx_y = torch.arange(T, dtype=torch.int32, device=xc.device).expand(F, C, T).contiguous()
        return cidx_y, torch.zeros((F, C), dtype=torch.bool, device=xc.device)
    return o2h_select(yc, yv, *x_tile_stats(xc, x_valid), kx)


def signed_cluster_forward(x, y, x_normals=None, y_valid=None, *, x_perm=None,
                           k_cells: int = K_CELLS_DEFAULT, k_tiles: int = K_TILES_DEFAULT):
    """(h2o_d, h2o_i [F, P1]; o2h_d, o2h_i, o2h_dot [F, P2]) of the signed
    pair in the caller's row order (o2h_i clipped into [0, P1)): the
    selection stage, then kernels #10 and #12. One cloud per frame."""
    P1 = x.shape[1]
    xp, xs, y4, ctr, sel, cidx, _ = _stage(x, y, y_valid, 1, x_perm, k_cells)
    cidx_y, _ = _o2h_candidates(*sel, k_tiles)
    n = torch.zeros_like(xs) if x_normals is None else xp.apply(x_normals.detach().to(torch.float32))
    h2o_d, h2o_i = h2o_topk(xs, y4, ctr, cidx, 1)
    o2h_d, o2h_i, o2h_dot = o2h_topk(xs, n.contiguous(), y4, ctr, cidx_y)
    o2h_i = xp.to_original(torch.clamp(o2h_i, 0, P1 - 1)).to(torch.int32)
    return xp.unapply(h2o_d), xp.unapply(h2o_i), o2h_d, o2h_i, o2h_dot


@torch.no_grad()
def h2o_cluster_overflow(x, y, y_valid=None, *, x_perm=None, k_cells: int = K_CELLS_DEFAULT,
                         y_group: int = 1) -> torch.Tensor:
    """Per-frame count [F] int32 of x tiles whose qualifying cells exceed
    the budget: zero everywhere proves point2point_h2o_cluster's distances
    (and so its gradients) exact for these operands. Indices may still
    differ from the all-pairs search where two points tie exactly. Runs the
    selection stage only."""
    ovf = _stage(x, y, y_valid, y_group, x_perm, k_cells)[-1]
    return ovf.sum(dim=1).to(torch.int32)


@torch.no_grad()
def signed_cluster_overflow(x, y, y_valid=None, *, x_perm=None, k_cells: int = K_CELLS_DEFAULT,
                            k_tiles: int = K_TILES_DEFAULT):
    """(h2o overflow [F], o2h overflow [F]) int32 counts; both zero prove
    point2point_signed_cluster's distances, signs and gradients exact."""
    *_, sel, _, ovf_h = _stage(x, y, y_valid, 1, x_perm, k_cells)
    _, ovf_o = _o2h_candidates(*sel, k_tiles)
    return ovf_h.sum(dim=1).to(torch.int32), ovf_o.sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _H2OCluster(torch.autograd.Function):
    """dist [F, P1] with the TPU VJP (`_p2h_cluster_fwd` / `_p2h_cluster_bwd`,
    chamfer_cluster.py:758-790): the forward's indices are constants, the
    backward is kernel #11; grad_y=False gives y a zero gradient and runs
    #11 without its scatter."""

    @staticmethod
    def forward(ctx, x, y, y_valid, x_perm, k_cells: int, grad_y: bool, y_group: int):
        d2, idx = h2o_cluster_forward(x, y, y_valid, x_perm=x_perm, k_cells=k_cells, y_group=y_group)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        ctx.save_for_backward(x, y, dist, idx)
        ctx.grad_y, ctx.y_group = grad_y, y_group
        return dist

    @staticmethod
    def backward(ctx, g):
        x, y, dist, idx = ctx.saved_tensors
        want_gy = ctx.grad_y and ctx.needs_input_grad[1]
        xr = g / torch.clamp_min(dist, CS.DIST_EPS)
        gx, gy = h2o_topk_backward(x, y, idx, xr, want_gy, ctx.y_group)
        if gy is None and ctx.needs_input_grad[1]:
            gy = torch.zeros_like(y)
        return gx.to(x.dtype), gy, None, None, None, None, None


class _SignedCluster(torch.autograd.Function):
    """(y2x_signed [F, P2], x2y [F, P1], o2h_i [F, P2]) with the TPU VJP
    (`_p2ps_cluster_fwd` / `_p2ps_cluster_bwd`, chamfer_cluster.py:1105-1164):
    indices and sign() are constants, normals get no gradient; the backward
    is kernel #11 (h2o side) plus kernel #13 (o2h side)."""

    @staticmethod
    def forward(ctx, x, y, x_normals, y_valid, x_perm, k_cells: int, k_tiles: int, grad_y: bool):
        h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot = signed_cluster_forward(
            x, y, x_normals, y_valid, x_perm=x_perm, k_cells=k_cells, k_tiles=k_tiles)
        x2y = torch.sqrt(torch.clamp_min(h2o_d, 0.0))
        y2x = torch.sqrt(torch.clamp_min(o2h_d, 0.0))
        sign = torch.sign(o2h_dot) if x_normals is not None else torch.ones_like(y2x)
        if y_valid is not None:
            # an invalid point's sign is 0: y2x * 0 is its signed value and
            # yc's factor in the backward (the TPU's where(y_valid, ...))
            sign = torch.where(y_valid.to(torch.bool), sign, 0.0)
        ctx.save_for_backward(x, y, x2y, y2x, sign.to(torch.int8), h2o_i, o2h_i)
        ctx.grad_y = grad_y
        ctx.mark_non_differentiable(o2h_i)
        return y2x * sign, x2y, o2h_i

    @staticmethod
    def backward(ctx, g_y2x, g_x2y, _):
        x, y, x2y, y2x, sign, h2o_i, o2h_i = ctx.saved_tensors
        want_gy = ctx.grad_y and ctx.needs_input_grad[1]
        xr = g_x2y / torch.clamp_min(x2y, CS.DIST_EPS)
        yc = sign.to(torch.float32) * g_y2x / torch.clamp_min(y2x, CS.DIST_EPS)
        gx, gy = h2o_topk_backward(x, y, h2o_i, xr, want_gy, 1)
        gx_o, gy_o = o2h_topk_backward(x, y, o2h_i, yc, want_gy)
        gx = gx + gx_o
        if want_gy:
            gy = gy + gy_o
        elif ctx.needs_input_grad[1]:
            gy = torch.zeros_like(y)
        return gx.to(x.dtype), gy, None, None, None, None, None, None


def point2point_h2o_cluster(x: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor | None = None, *,
                            x_perm: np.ndarray | None = None, k_cells: int = K_CELLS_DEFAULT,
                            grad_y: bool = True, y_group: int = 1) -> torch.Tensor:
    """Port of `point2point_h2o_cluster` (chamfer_cluster.py:688): unsigned
    distances [F, P1] of the rows x [F, P1, 3] to their clouds
    y [F // y_group, P2, 3], searching the k_cells candidate cells of each
    128-row tile. Exact whenever `h2o_cluster_overflow` is zero; never below
    the exact value. grad_y=False gives y a zero gradient; y_group > 1 (one
    shared cloud per y_group frames) requires it. Pass `x_perm` (the static
    template permutation) where the rows are MANO verts."""
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    return _H2OCluster.apply(x, y, y_valid, x_perm, k_cells, grad_y, y_group)


def point2point_signed_cluster(x: torch.Tensor, y: torch.Tensor, x_normals: torch.Tensor | None = None,
                               y_valid: torch.Tensor | None = None, *, x_perm: np.ndarray | None = None,
                               k_cells: int = K_CELLS_DEFAULT, k_tiles: int = K_TILES_DEFAULT,
                               grad_y: bool = True):
    """Port of `point2point_signed_cluster` (chamfer_cluster.py:1061):
    (y2x_signed [F, P2], x2y [F, P1], yidx_near [F, P2]) of rows x
    [F, P1, 3] (normals [F, P1, 3]) against one cloud y [F, P2, 3] per
    frame. Exact whenever both `signed_cluster_overflow` counts are zero;
    k_tiles = 0 searches every tile on the o2h side. grad_y=False gives y a
    zero gradient."""
    return _SignedCluster.apply(x, y, x_normals, y_valid, x_perm, k_cells, k_tiles, grad_y)
