"""Fused distance loss of G's extra loss: CUDA kernels (all pairs and
region-culled), wrappers, plain PyTorch versions, launch counts, the
region-cull mask and the autograd.Function.

`KERNEL` (csrc/dist_loss.cu) replaces oakink2_tamf_tpu/ops/chamfer_loss.py
`_dist_loss_kernel` (:129, body `_dist_loss_step` :185; `_dist_loss_forward`,
pallas_call at :391) and the custom VJP around it (`chamfer_dist_loss` /
`_dl_core`, :684-808).

The loss consumes two numbers per frame,
  do_f = sum_j |o2h_j - o2h_g_j| w_j        (w: 1.5 / 1.0 / 0.1 rule)
  dh_f = sum_i ||h2o_i| - |h2o_g_i|| vw2_i,
so one pass computes the per-point integrands AND their gradient rows with
respect to the hand rows (gx_do, gx_dh [F, P1, 3]); the backward is
c_do gx_do + c_dh gx_dh (`_dl_bwd`, :790-805). The [F, P2] signed field of
the predicted hand never exists outside the kernel. Argmins, sign() and the
weight selections are constants of the backward (torch-parity convention).

Kernel (csrc/dist_loss.cu): bound, design and the per-point formulas are in
the source; its search is the signed forward's single-pass bidirectional
one (csrc/bidir_common.cuh), each pair's distance computed once. Bound on
this card: 8 flops per (x, y) pair counted once, at the H100 SXM's 67
TFLOP/s FP32 (~31 ms at the G training shape, 40960 frames x 778 rows x
8192 points). x_valid=False frames cost nothing and
come out zero; invalid points (y_valid) give zero.

`CULL_KERNEL` (csrc/dist_loss_cull.cu) replaces `_dist_loss_cull_kernel`
(:505; `_dist_loss_forward_cull` :656, pallas_call at :673), the
`region_cull=True` route (G's dist_impl "fused_cull"): the same outputs
with only the [128-row region, tile] blocks that `region_cull_mask` keeps
searched. The mask (a copy of `_region_cull_mask`, :405-502, plain XLA
there, plain PyTorch here) is exact: a skipped block holds no row's
minimum and no column's first-min row, so on live frames whose cloud has a
valid point the culled kernel equals the all-pairs one on the same
operands. Both kernels are one kernel body (csrc/dist_loss_common.cuh),
the culled one gating each 128-row region of its single-pass search by the
mask, tile by tile. Rows that searched nothing (x_valid=False frames,
all-invalid clouds) give dh = 0 and a zero gradient row (the TPU's
`hdone`), columns that searched nothing v = 0. Its bound: 8 flops per pair
of the kept blocks on live frames.

On a CUDA tensor the wrappers launch their kernel or raise; on a CPU tensor
they run the plain versions, which share the signed forward's per-pair
rounding (ops/chamfer_nn.pair_d2) and then do the per-point arithmetic in
float32; their gradient scatter sums in another order than the kernels'
atomics.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import chamfer_cull as CU
from . import chamfer_nn as NN
from . import chamfer_signed as CS
from ._build import Kernel

DIST_EPS = 1e-12  # max(dist, eps) guards of chamfer_loss.py:249 / :304
INVALID_Y = 5e14  # an invalid point sits at FAR = 1e15 per coordinate
MAX_ROWS = 1024  # rows, normals, row keys and the gx_do accumulator in 52 KB of shared memory
REGION_ROWS = CU.REGION_ROWS  # one hand region: 128 rows of the template-permuted hand
CULL_EPS = 1e-3  # m, the slack of the region-cull bounds (chamfer_loss.py:461)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "dist_loss", "dist_loss.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_loss.py:391",
    symbol="dist_loss_launch",
    argtypes=[_P] * 12 + [_I] * 4 + [_P],
)
CULL_KERNEL = Kernel(
    "dist_loss_cull", "dist_loss_cull.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_loss.py:673",
    symbol="dist_loss_cull_launch",
    argtypes=[_P] * 13 + [_I] * 7 + [_P],
)


def prepare(x, n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group: int):
    """Kernel operands: (x, n, y4, ctr) as ops/chamfer_signed.prepare, the GT
    fields og [F, P2] / hg [F, P1] and vw [P1] as float32, x_valid as uint8
    [F] (all ones when None)."""
    x, n, y4, ctr = CS.prepare(x, y, n, y_valid, y_group)
    F = x.shape[0]
    xv = (torch.ones((F,), dtype=torch.uint8, device=x.device) if x_valid is None
          else x_valid.to(torch.uint8).contiguous())
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    return x, n, y4, ctr, f32(o2h_g), f32(h2o_g), f32(vw2), xv


# ---------------------------------------------------------------------------
# the region-cull mask
# ---------------------------------------------------------------------------


def region_cull_mask(
    x: torch.Tensor,  # [F, P1, 3] hand rows (template-permuted)
    y: torch.Tensor,  # [G, P2, 3]
    y_valid: torch.Tensor | None,  # [G, P2] bool
    tile: int,
    y_group: int,
    x_valid: torch.Tensor | None = None,  # [F] bool
) -> torch.Tensor:
    """Per-(frame, region, tile) flags [F, R, T] int32 of the culled loss
    kernel, R = ceil(P1/128), T = ceil(P2/tile): 0 = skip the block, 1 = run
    it (it may hold a row's minimum), 3 = run it and it may hold a column's
    first-min row. Port of `_region_cull_mask` (chamfer_loss.py:405-502):
    with region centroids c and radii rr (ops/chamfer_cull.region_stats)
    and d(c, y_j) the centroid-to-point distance,
      h2o:  tile t runs for region r iff d_t - rr <= min_t d_t + rr + eps,
            d_t = min_{j in t} d(c, y_j);
      o2h:  region r is a candidate for tile t iff some valid j in t has
            d(c_r, y_j) - rr_r <= min_r' (d(c_r', y_j) + rr_r') + eps.
    Both are triangle-inequality bounds, exact by construction; eps = 1e-3 m
    absorbs the expansion's rounding (full fp32: no TF32). The [L*R, P2]
    field is computed a few groups at a time; groups whose frames are all
    x_valid=False are skipped (their flags are 0)."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    L = y_group
    T = CU._round_up(P2, tile) // tile
    R = CU._round_up(P1, REGION_ROWS) // REGION_ROWS
    cg, rr, y = CU.region_stats(x, y)
    rr = rr.reshape(G, L, R, 1)
    flags = torch.zeros((G, L, R, T), dtype=torch.int32, device=x.device)
    groups = torch.arange(G, device=x.device)
    if x_valid is not None:
        groups = torch.nonzero(x_valid.to(torch.bool).reshape(G, L).any(dim=1)).flatten()
    gs = max(1, CU._MASK_CHUNK_ELEMS // max(1, L * R * P2))
    for k in range(0, groups.numel(), gs):
        gi = groups[k : k + gs]
        d = CU.centroid_d2(cg[gi], y[gi], None if y_valid is None else y_valid[gi])
        d = d.clamp_min_(0.0).sqrt_().reshape(-1, L, R, P2)
        r = rr[gi]
        ub = (d + r).amin(dim=2, keepdim=True)  # [g, L, 1, P2]
        need = ((d - r) <= ub + CULL_EPS) & torch.isfinite(d)
        cand = torch.stack([need[..., t * tile : (t + 1) * tile].any(dim=-1) for t in range(T)], dim=-1)
        d_tile = torch.stack([d[..., t * tile : (t + 1) * tile].amin(dim=-1) for t in range(T)], dim=-1)
        dmin = d_tile.amin(dim=-1, keepdim=True)
        run = ((d_tile - r) <= (dmin + r) + CULL_EPS) & torch.isfinite(d_tile)
        flags[gi] = (run | cand).to(torch.int32) + 2 * cand.to(torch.int32)
    flags = flags.reshape(F, R, T)
    if x_valid is not None:
        flags = flags * x_valid.to(torch.int32)[:, None, None]
    return flags


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _loss_rows(xc, y4, og, hg, vw, xv, h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot, valid, y_group: int,
               hdone=None):
    """The per-point arithmetic of both kernels (csrc/dist_loss_common.cuh)
    on the searches' results: (v, dh, gx_do, gx_dh). `valid` [F, P2] marks
    the columns that count; `hdone` [F, P1] (when given) the rows that
    searched a pair, the others giving dh = 0 and a zero gradient row."""
    F, P1, _ = xc.shape
    G, P2, _ = y4.shape
    yc = y4[..., :3]
    dist = torch.sqrt(torch.clamp_min(o2h_d, 0.0))
    sgn = torch.sign(o2h_dot)
    o = torch.where(valid, dist * sgn, 0.0)
    w = torch.where((og < 0.01) & (og > -0.005), 1.0, 0.1)
    w = torch.where(o < 0.0, 1.5, w)  # penetration
    diff = o - og
    v = torch.where(valid, torch.abs(diff) * w, 0.0)
    coef = torch.where(valid, w * torch.sign(diff) * sgn / torch.clamp_min(dist, DIST_EPS), 0.0)
    x_at = CS._rows_at(xc, o2h_i)  # [F, P2, 3]
    u = coef[..., None] * (x_at.reshape(G, y_group, P2, 3) - yc[:, None]).reshape(F, P2, 3)
    frames = torch.arange(F, device=xc.device)
    gx_do = torch.zeros((F * P1, 3), dtype=torch.float32, device=xc.device).index_add(
        0, (frames[:, None] * P1 + o2h_i.long()).reshape(-1), u.reshape(-1, 3)
    ).reshape(F, P1, 3)

    hd = torch.sqrt(torch.clamp_min(h2o_d, 0.0))
    hgv = torch.abs(hg)
    dh = torch.abs(hd - hgv) * vw
    cfh = vw * torch.sign(hd - hgv) / torch.clamp_min(hd, DIST_EPS)
    y_at = yc.reshape(G * P2, 3)[((frames // y_group)[:, None] * P2 + h2o_i.long()).reshape(-1)]
    gx_dh = cfh[..., None] * (xc - y_at.reshape(F, P1, 3))
    if hdone is not None:
        dh = torch.where(hdone, dh, 0.0)
        gx_dh = torch.where(hdone[..., None], gx_dh, 0.0)

    live = xv.to(torch.bool)
    return (torch.where(live[:, None], v, 0.0), torch.where(live[:, None], dh, 0.0),
            torch.where(live[:, None, None], gx_do, 0.0), torch.where(live[:, None, None], gx_dh, 0.0))


def _valid_points(y4, y_group: int) -> torch.Tensor:
    return (y4[..., 0] < INVALID_Y).repeat_interleave(y_group, dim=0)  # [F, P2]


def plain(x, n, y4, ctr, og, hg, vw, xv, y_group: int):
    """The kernel's function in plain PyTorch on prepared operands:
    (v [F, P2], dh [F, P1], gx_do [F, P1, 3], gx_dh [F, P1, 3])."""
    h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot = CS.plain(x, n, y4, ctr, y_group)
    return _loss_rows(NN.centred_x(x, ctr, y_group), y4, og, hg, vw, xv, h2o_d, h2o_i,
                      o2h_d, o2h_i, o2h_dot, _valid_points(y4, y_group), y_group)


def _culled_o2h(xc, n, y4, mask, y_group: int, tile: int):
    """(o2h_d, o2h_i, o2h_dot) [F, P2]: each column's first minimum over the
    rows of the regions its tile's flag runs, in ascending row order; a
    column that searched no pair keeps (BIG, -1)."""
    F, P1, _ = xc.shape
    G, P2, _ = y4.shape
    xg = xc.reshape(G, y_group, P1, 3)
    region = torch.arange(P1, device=xc.device) // REGION_ROWS
    o2h_d = torch.full((F, P2), NN.BIG, dtype=torch.float32, device=xc.device)
    o2h_i = torch.full((F, P2), -1, dtype=torch.int32, device=xc.device)
    o2h_dot = torch.zeros((F, P2), dtype=torch.float32, device=xc.device)
    chunk = max(1, NN._PLAIN_CHUNK_ELEMS // max(1, F * P1 * 3))
    for t in range(mask.shape[2]):
        rows = mask[:, region, t] != 0  # [F, P1]
        if not bool(rows.any()):
            continue
        for j0 in range(t * tile, min((t + 1) * tile, P2), chunk):
            j1 = min(j0 + chunk, (t + 1) * tile, P2)
            d = NN.pair_d2(xg, y4[:, j0:j1]).reshape(F, P1, -1)
            m, i = torch.min(torch.where(rows[..., None], d, torch.inf), dim=1)  # first row
            found = m < NN.BIG  # the kernels start at BIG with a strict <
            i = torch.where(found, i, 0)
            yf = y4[:, None, j0:j1, :3].expand(G, y_group, j1 - j0, 3).reshape(F, j1 - j0, 3)
            o2h_d[:, j0:j1] = torch.where(found, m, NN.BIG)
            o2h_i[:, j0:j1] = torch.where(found, i, -1).to(torch.int32)
            o2h_dot[:, j0:j1] = CS.sign_numer(CS._rows_at(xc, i), CS._rows_at(n, i), yf)
    return o2h_d, o2h_i, o2h_dot


def plain_cull(x, n, y4, ctr, og, hg, vw, xv, mask, y_group: int, tile: int):
    """The culled kernel's function in plain PyTorch on prepared operands
    and a mask from `region_cull_mask`: both searches skip the blocks whose
    flag is 0 (ops/chamfer_cull's culled row search for h2o, `_culled_o2h`
    for o2h), then `plain`'s arithmetic, with the rows that searched nothing
    zeroed and the columns that searched nothing dropped."""
    h2o_d, h2o_i, xc = CU._culled_nearest(x, y4, ctr, mask, y_group, tile)
    o2h_d, o2h_i, o2h_dot = _culled_o2h(xc, n, y4, mask, y_group, tile)
    valid = _valid_points(y4, y_group) & (o2h_i >= 0)
    return _loss_rows(xc, y4, og, hg, vw, xv, h2o_d, h2o_i, o2h_d, o2h_i.clamp_min(0), o2h_dot,
                      valid, y_group, hdone=h2o_d < NN.BIG)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _check_launch(x, n, y4, ctr, og, hg, vw, xv, y_group: int):
    F, P1, _ = x.shape
    G, P2, _ = y4.shape
    f32 = torch.float32
    CS._check_cuda({"x": (x, f32), "n": (n, f32), "y4": (y4, f32), "ctr": (ctr, f32),
                    "o2h_g": (og, f32), "h2o_g": (hg, f32), "vw2": (vw, f32),
                    "x_valid": (xv, torch.uint8)}, x.device)
    if F != G * y_group or y4.shape[2] != 4 or ctr.shape != (G, 3) or n.shape != x.shape \
            or og.shape != (F, P2) or hg.shape != (F, P1) or vw.shape != (P1,) or xv.shape != (F,):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y4 {tuple(y4.shape)} "
                         f"o2h_g {tuple(og.shape)} h2o_g {tuple(hg.shape)}")
    if P1 > MAX_ROWS:
        raise ValueError(f"{P1} rows exceed the {MAX_ROWS} the o2h block keeps in shared memory")
    if F * ((P1 + 127) // 128) >= 2**31:
        raise ValueError("too many blocks for one launch")


def _outputs(F: int, P1: int, P2: int, dev):
    f32 = torch.float32
    return (torch.empty((F, P2), dtype=f32, device=dev), torch.empty((F, P1), dtype=f32, device=dev),
            torch.empty((F, P1, 3), dtype=f32, device=dev), torch.empty((F, P1, 3), dtype=f32, device=dev))


def launch(x, n, y4, ctr, og, hg, vw, xv, y_group: int):
    """Launch the kernel on prepared operands (see `prepare`)."""
    F, P1, _ = x.shape
    P2 = y4.shape[1]
    _check_launch(x, n, y4, ctr, og, hg, vw, xv, y_group)
    out = _outputs(F, P1, P2, x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), n.data_ptr(), y4.data_ptr(), ctr.data_ptr(), og.data_ptr(),
            hg.data_ptr(), vw.data_ptr(), xv.data_ptr(), *(t.data_ptr() for t in out),
            F, P1, P2, y_group, torch.cuda.current_stream().cuda_stream,
        )
    return out


def launch_cull(x, n, y4, ctr, og, hg, vw, xv, mask, y_group: int, tile: int):
    """Launch the culled kernel on prepared operands and a mask from
    `region_cull_mask` (the same tile)."""
    F, P1, _ = x.shape
    P2 = y4.shape[1]
    _check_launch(x, n, y4, ctr, og, hg, vw, xv, y_group)
    R = (P1 + REGION_ROWS - 1) // REGION_ROWS
    T = CU._round_up(P2, tile) // tile
    CS._check_cuda({"mask": (mask, torch.int32)}, x.device)
    if mask.shape != (F, R, T):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit F={F} R={R} P2={P2} tile={tile}")
    out = _outputs(F, P1, P2, x.device)
    with torch.cuda.device(x.device):
        CULL_KERNEL.launch(
            x.data_ptr(), n.data_ptr(), y4.data_ptr(), ctr.data_ptr(), og.data_ptr(),
            hg.data_ptr(), vw.data_ptr(), xv.data_ptr(), mask.data_ptr(),
            *(t.data_ptr() for t in out), F, P1, P2, y_group, R, T, tile,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def dist_loss_rows(x, n, y, o2h_g, h2o_g, vw2, y_valid=None, x_valid=None, y_group: int = 1,
                   tile: int = 2048, region_cull: bool = False):
    """(v [F, P2], dh [F, P1], gx_do [F, P1, 3], gx_dh [F, P1, 3]) of rows x
    [F, P1, 3] with normals n against clouds y [F // y_group, P2, 3]; with
    region_cull, through `region_cull_mask` at `tile` points per tile and
    the culled kernel (the all-pairs kernel takes no tile)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dist_loss_rows runs on CUDA or CPU tensors, got {x.device}")
    ops = prepare(x, n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group)
    if region_cull:
        mask = region_cull_mask(x, y, y_valid, tile, y_group, x_valid)
        if x.is_cuda:
            return launch_cull(*ops, mask, y_group, tile)
        return plain_cull(*ops, mask, y_group, tile)
    if x.is_cuda:
        return launch(*ops, y_group)
    return plain(*ops, y_group)


class DistLoss(torch.autograd.Function):
    """(do_f [F], dh_f [F]) with the gradient rows of the forward pass."""

    @staticmethod
    def forward(ctx, x, n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group: int, tile: int,
                region_cull: bool):
        v, dh, gx_do, gx_dh = dist_loss_rows(
            x.detach(), n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group, tile, region_cull
        )
        ctx.save_for_backward(gx_do, gx_dh)
        return v.sum(dim=1), dh.sum(dim=1)

    @staticmethod
    def backward(ctx, c_do, c_dh):
        gx_do, gx_dh = ctx.saved_tensors
        gx = c_do[:, None, None] * gx_do + c_dh[:, None, None] * gx_dh
        return gx, None, None, None, None, None, None, None, None, None, None


def chamfer_dist_loss(x: torch.Tensor, x_normals: torch.Tensor, y: torch.Tensor,
                      o2h_g: torch.Tensor, h2o_g: torch.Tensor, vw2: torch.Tensor,
                      y_valid: torch.Tensor | None = None, *, y_group: int = 1, tile: int = 2048,
                      x_valid: torch.Tensor | None = None, region_cull: bool = False, x_perm=None):
    """Port of `chamfer_dist_loss` (chamfer_loss.py:684): the raw per-frame
    sums (do_f [F], dh_f [F]) of the dist_o / dist_h integrands (the caller
    applies frame masks, means and object weights), differentiable with
    respect to x. Frame f searches cloud y[f // y_group]; x_valid [F] False
    skips a frame and gives it zero sums and gradient.

    region_cull=True takes the culled kernel, its mask tiled at `tile`
    points. x_perm [P1] (the template permutation, core/mano
    hand_template_perm) reorders x, the normals, h2o_g and vw2 first, so
    that the 128-row regions are compact; the gradient maps back through
    the indexing's own backward, and the sums only reorder."""
    if x_perm is not None:
        perm = torch.as_tensor(np.asarray(x_perm), dtype=torch.long, device=x.device)
        x, x_normals, h2o_g, vw2 = x[:, perm], x_normals[:, perm], h2o_g[:, perm], vw2[perm]
    return DistLoss.apply(x, x_normals.detach(), y.detach(), o2h_g.detach(), h2o_g.detach(),
                          vw2, y_valid, x_valid, y_group, tile, region_cull)
