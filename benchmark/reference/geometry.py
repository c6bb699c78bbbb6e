"""Vertex normals and brute-force nearest-neighbour distances, plain PyTorch.

`vertex_normals` is a frozen copy of oakink2_tamf_tpu_torch/core/geometry.py's
dense route. The searches are the benchmark's own: every (hand vert, object
point) pair of each live frame is scored with one batched matmul of the
expanded form |x|^2 + |y|^2 - 2 x.y per block of frames, the first minimum
of each row (and, for the signed pair, of each column) is kept, and the
chosen pair's distance is then recomputed exactly from its difference,
with the gradient (a - b) / |a - b| into the hand side. Frames that are not
live (padded frames, padded object slots) are not searched: they get index
0, whose distance the callers weight by zero or replace.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 1 << 30  # one [frames, P1, P2] float32 distance block


def _dense_ops(faces: np.ndarray, num_v: int, device):
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
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device) for m in (d1, d2, a))


_OPS: dict = {}


def _apply_vertex_op(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    lead = v.shape[:-2]
    n = v.shape[-2]
    flat = v.reshape(-1, n, 3).permute(1, 0, 2).reshape(n, -1)
    out = op @ flat
    return out.reshape(op.shape[0], -1, 3).permute(1, 0, 2).reshape(lead + (op.shape[0], 3))


def vertex_normals(verts: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """Area-weighted per-vertex normals, normalized: verts [..., V, 3]."""
    faces = np.asarray(faces)
    key = (faces.tobytes(), verts.shape[-2], str(verts.device))
    if key not in _OPS:
        _OPS[key] = _dense_ops(faces, verts.shape[-2], verts.device)
    d1, d2, a = _OPS[key]
    e1 = _apply_vertex_op(d1, verts)
    e2 = _apply_vertex_op(d2, verts)
    acc = _apply_vertex_op(a, torch.linalg.cross(e1, e2, dim=-1))
    n2 = torch.sum(acc * acc, dim=-1, keepdim=True)
    return acc * torch.rsqrt(torch.clamp_min(n2, 1e-24))


@torch.no_grad()
def nearest(x, y, y_valid, y_group: int, rows, both: bool = False):
    """Rows `rows` [n] of x [F, P1, 3], each against cloud f // y_group of y
    [G, P2, 3]; y_valid [G, P2] bool or None. Returns the first-min index of
    each x point [n, P1] and, with `both`, of each y point over x [n, P2]."""
    P1, P2 = x.shape[1], y.shape[1]
    ix = torch.zeros((rows.numel(), P1), dtype=torch.long, device=x.device)
    iy = torch.zeros((rows.numel(), P2), dtype=torch.long, device=x.device) if both else None
    y2 = torch.sum(y * y, dim=-1)
    if y_valid is not None:
        y2 = y2.masked_fill(~y_valid.bool(), torch.inf)
    fb = max(1, BLOCK_BYTES // (4 * P1 * P2))
    for r0 in range(0, rows.numel(), fb):
        f = rows[r0 : r0 + fb]
        c = torch.div(f, y_group, rounding_mode="floor")
        xs, ys = x[f], y[c]
        base = torch.sum(xs * xs, dim=-1)[:, :, None] + y2[c][:, None, :]
        d = torch.baddbmm(base, xs, ys.transpose(1, 2), alpha=-2.0).clamp_min_(0.0)
        ix[r0 : r0 + fb] = torch.argmin(d, dim=2)
        if both:
            iy[r0 : r0 + fb] = torch.argmin(d, dim=1)
    return ix, iy


def pair_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| over the last axis, with the gradient (a - b) / |a - b| (0 at
    coincident points) into both sides."""
    diff = a - b
    dist = torch.sqrt(torch.sum(diff.detach() ** 2, dim=-1))
    if not (torch.is_grad_enabled() and diff.requires_grad):
        return dist
    coef = torch.where(dist > 0, 1.0 / torch.clamp_min(dist, 1e-30), 0.0)
    lin = torch.sum(diff * (diff.detach() * coef[..., None]), dim=-1)
    return dist + (lin - lin.detach())


def _scatter_rows(vals: torch.Tensor, rows: torch.Tensor, F: int) -> torch.Tensor:
    return vals.new_zeros((F,) + tuple(vals.shape[1:])).index_put((rows,), vals)


def h2o(x, y, y_valid, y_group: int, live) -> torch.Tensor:
    """Unsigned hand->object distances [F, P1] of the live frames (0 elsewhere),
    differentiable in x."""
    rows = torch.nonzero(live).flatten()
    ix, _ = nearest(x.detach(), y, y_valid, y_group, rows)
    c = torch.div(rows, y_group, rounding_mode="floor")
    d = pair_dist(x[rows], y[c[:, None], ix])
    return _scatter_rows(d, rows, x.shape[0])


def signed(x, y, x_normals, y_valid, y_group: int, live):
    """(o2h [F, P2], h2o [F, P1]) of the live frames (0 elsewhere): each
    object point's distance to its nearest hand vert signed by sign(normal .
    (point - vert)), 0 at invalid points; each hand vert's distance to its
    nearest object point. Differentiable in x."""
    rows = torch.nonzero(live).flatten()
    ix, iy = nearest(x.detach(), y, y_valid, y_group, rows, both=True)
    c = torch.div(rows, y_group, rounding_mode="floor")
    xl = x[rows]
    h2o_d = pair_dist(xl, y[c[:, None], ix])
    yf = y[c]  # [n, P2, 3]
    n = torch.arange(rows.numel(), device=x.device)[:, None]
    y_near = xl[n, iy]
    o2h = pair_dist(yf, y_near)
    o2h = o2h * torch.sign(torch.sum(x_normals[rows][n, iy] * (yf - y_near.detach()), dim=-1))
    if y_valid is not None:
        o2h = torch.where(y_valid.bool()[c], o2h, 0.0)
    return _scatter_rows(o2h, rows, x.shape[0]), _scatter_rows(h2o_d, rows, x.shape[0])
