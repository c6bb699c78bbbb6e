"""Bounds-culled exact hand->object nearest distance (h2o): skip mask,
CUDA kernel, wrapper, plain PyTorch version and launch count.

Replaces oakink2_tamf_tpu/ops/chamfer_cull.py `_cull_fwd_kernel` (:179;
`_cull_forward(with_dvec=False)` :261, pallas_call at :307, primal
`_cull_core` :362-365). `cull_mask` is a copy of that module's `_cull_mask`
formula (plain XLA there, plain PyTorch here): for hand region r of frame f
(128 contiguous rows of the template-permuted hand) with centroid c and
radius rr, and object tile t, with d_t = min_{j in t} |c - y_j| and
dmin = min_t d_t, the block runs unless d_t - rr > dmin + rr + 1e-3. A
skipped block holds no pair that could reach a row's minimum, so the values
equal the all-pairs kernel's (ops/chamfer_nn.py) bit for bit: both kernels
share one per-pair function (csrc/h2o_common.cuh).

Kernel (csrc/h2o_cull.cu) design and bound: see the source; its work is
8 flops per pair the mask keeps.

On a CUDA tensor `h2o_cull` launches the kernel or raises; on a CPU tensor
it runs `plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import chamfer_nn as NN
from ._build import Kernel

REGION_ROWS = 128
BIG = NN.BIG
_MASK_CHUNK_ELEMS = 1 << 27  # bound on groups * L*R * P2 per mask step

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "h2o_cull", "h2o_cull.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cull.py:179",
    symbol="h2o_cull_launch",
    argtypes=[_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cull_mask(
    x: torch.Tensor,  # [F, P1, 3]
    y: torch.Tensor,  # [G, P2, 3]
    y_valid: torch.Tensor | None,  # [G, P2] bool
    tile: int,
    y_group: int,
    x_valid: torch.Tensor | None = None,  # [F] bool
) -> torch.Tensor:
    """Compute-flag mask [F, R, T] int32 (1 = run the block); R = ceil(P1/128),
    T = ceil(P2/tile). Bounds only: exactness never depends on it, but the
    centroid-to-point products must be full fp32 (no TF32) so that the upper
    bound never undercuts a true minimum."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    L = y_group
    T = _round_up(P2, tile) // tile
    P1p = _round_up(P1, REGION_ROWS)
    R = P1p // REGION_ROWS
    x = x.detach().to(torch.float32)
    y = y.detach().to(torch.float32)

    # region stats over the real rows
    xr = torch.nn.functional.pad(x, (0, 0, 0, P1p - P1)).reshape(F, R, REGION_ROWS, 3)
    wr = (torch.arange(P1p, device=x.device) < P1).to(torch.float32).reshape(R, REGION_ROWS)
    cnt = torch.clamp_min(wr.sum(dim=1), 1.0)
    c_fr = (xr * wr[None, :, :, None]).sum(dim=2) / cnt[None, :, None]  # [F, R, 3]
    rr = torch.sqrt(
        torch.amax(((xr - c_fr[:, :, None]) ** 2).sum(dim=-1) * wr[None], dim=2)
    )  # [F, R]

    # exact centroid-to-point distances per tile, centred on the group y-mean
    yc = y.mean(dim=1, keepdim=True)  # [G, 1, 3]
    y = y - yc
    cg = c_fr.reshape(G, L * R, 3) - yc
    d_tile = torch.empty((G, L * R, T), dtype=torch.float32, device=x.device)
    gs = max(1, _MASK_CHUNK_ELEMS // max(1, L * R * T * tile))
    for g0 in range(0, G, gs):
        c, yy = cg[g0 : g0 + gs], y[g0 : g0 + gs]
        d2 = (
            (c * c).sum(dim=-1)[..., None]
            - 2.0 * torch.bmm(c, yy.transpose(1, 2))
            + (yy * yy).sum(dim=-1)[:, None, :]
        )  # [g, L*R, P2]
        if y_valid is not None:
            d2 = torch.where(y_valid[g0 : g0 + gs, None, :].to(torch.bool), d2, torch.inf)
        d2 = torch.nn.functional.pad(d2, (0, T * tile - P2), value=torch.inf)
        d_tile[g0 : g0 + gs] = torch.sqrt(
            torch.clamp_min(d2.reshape(d2.shape[0], L * R, T, tile).amin(dim=-1), 0.0)
        )
    d_tile = d_tile.reshape(F, R, T)
    dmin = d_tile.amin(dim=-1)  # [F, R]
    run = d_tile - rr[:, :, None] <= (dmin + rr)[:, :, None] + 1e-3
    # inf <= inf holds: cull all-invalid clouds outright (their rows give BIG)
    run = run & torch.isfinite(d_tile)
    if x_valid is not None:
        run = run & x_valid.to(torch.bool)[:, None, None]
    return run.to(torch.int32)


def plain(x, y4, ctr, mask, y_group: int, tile: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on prepared operands
    (ops/chamfer_nn.prepare) and a mask from `cull_mask`."""
    F, P1, _ = x.shape
    T = mask.shape[2]
    xc = NN.centred_x(x, ctr, y_group)
    region = torch.arange(P1, device=x.device) // REGION_ROWS
    best = torch.full((F, P1), BIG, dtype=torch.float32, device=x.device)
    for t in range(T):
        run = mask[:, region, t].to(torch.bool)  # [F, P1]
        if not bool(run.any()):
            continue
        tile_min, _ = NN.nearest(xc, y4[:, t * tile : (t + 1) * tile], y_group)
        best = torch.where(run, torch.minimum(best, tile_min), best)
    return best


def launch(x, y4, ctr, mask, y_group: int, tile: int) -> torch.Tensor:
    """Launch the CUDA kernel on prepared operands and a mask."""
    F, P1, _ = x.shape
    G, P2, _ = y4.shape
    R = (P1 + REGION_ROWS - 1) // REGION_ROWS
    T = mask.shape[2] if mask.ndim == 3 else -1
    for name, t, dt in (("x", x, torch.float32), ("y4", y4, torch.float32),
                        ("ctr", ctr, torch.float32), ("mask", mask, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if F != G * y_group or y4.shape[2] != 4 or ctr.shape != (G, 3):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y4 {tuple(y4.shape)}")
    if mask.shape != (F, R, T) or T != _round_up(P2, tile) // tile:
        raise ValueError(f"mask {tuple(mask.shape)} does not fit F={F} R={R} P2={P2} tile={tile}")
    if F * R >= 2**31:
        raise ValueError("too many blocks for one launch")
    d = torch.empty((F, P1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), y4.data_ptr(), ctr.data_ptr(), mask.data_ptr(), d.data_ptr(),
            F, P1, P2, y_group, T, tile, torch.cuda.current_stream().cuda_stream,
        )
    return d


def h2o_cull(
    x: torch.Tensor,  # [F, P1, 3]
    y: torch.Tensor,  # [G, P2, 3], G = F // y_group
    y_valid: torch.Tensor | None = None,
    *,
    tile: int = 2048,
    y_group: int = 1,
    x_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Min squared distance [F, P1] of each row over its cloud, with culled
    blocks skipped. Equal to ops/chamfer_nn.h2o_nn's values on frames with
    x_valid=True; x_valid=False frames cull every tile and come out BIG."""
    tile = min(tile, _round_up(y.shape[1], 128))
    mask = cull_mask(x, y, y_valid, tile, y_group, x_valid)
    ops = NN.prepare(x, y, y_valid, y_group)
    if x.is_cuda:
        return launch(*ops, mask, y_group, tile)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_cull runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, mask, y_group, tile)
