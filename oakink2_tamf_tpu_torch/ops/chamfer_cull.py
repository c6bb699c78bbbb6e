"""Bounds-culled exact hand->object nearest distance (h2o): skip mask,
CUDA kernels, wrappers, plain PyTorch versions and launch counts.

Replaces oakink2_tamf_tpu/ops/chamfer_cull.py `_cull_fwd_kernel` (:179;
`_cull_forward(with_dvec=False)` :261, pallas_call at :307, primal
`_cull_core` :362-365). `cull_mask` computes that module's `_cull_mask`
rule (its region statistics, `region_stats`, are shared with the loss's
region-cull mask in ops/chamfer_loss.py, which keeps its own path): for
hand region r of frame f
(128 contiguous rows of the template-permuted hand) with centroid c and
radius rr, and object tile t, with d_t = min_{j in t} |c - y_j| and
dmin = min_t d_t, the block runs unless d_t - rr > dmin + rr + 1e-3. A
skipped block holds no pair that could reach a row's minimum, so the values
equal the all-pairs kernel's (ops/chamfer_nn.py) bit for bit: both kernels
share one per-pair function (csrc/h2o_common.cuh).

Kernel (csrc/h2o_cull.cu) design and bound: see the source; its work is
8 flops per pair the mask keeps. Both kernels of this module run the cell
search of csrc/h2o_cells_common.cuh over the 128-point cells of the tiles
the mask keeps, so the mask's tile must be a multiple of 128 points.

The wrappers' default tile is 128 points, not the JAX kernel's 2048. The
values and first-min indices do not depend on the tile (a culled block's
pairs are strictly farther than each row's minimum), so the tile only
trades the mask's resolution against the cost of a culled block. On the
TPU every grid step costs a pass of the matrix unit, so the coarsest tile
wins there; here a culled cell costs nothing (it is left out of the cell
list), a finer mask culls more pairs, and the mask costs about the same at
any tile (the same centroid pass, reduced per tile). chip_smoke.py's tile
sweep on an NVIDIA H100 80GB HBM3 (700 W), R training shape (40960 frames x
778 rows x 8192 points): the mask keeps 0.743 of the pairs at tile 2048 and
0.339 at 128; #3 takes 46.6 and 23.1 ms, `cull_mask` 3.2 and 3.5 ms.

The mask (`cull_mask`): on a CUDA tensor one hand-written kernel
(csrc/h2o_cull_mask.cu, `MASK_KERNEL`, its own launch count; it replaces
no TPU kernel, since `_cull_mask` is plain XLA) writes the [F, R, T] flags
straight from the region statistics: each thread holds centroids in
registers against the group's points staged in shared memory, keeps each
tile's minimum and writes its flags once dmin is known. Its bound is the
centroid-point distances, 7 instructions per (live centroid, point) pair;
frames with x_valid False and all-invalid clouds are written 0 unsearched.
`plain_mask`, the CPU route and the on-card check, builds the [g, L*R, P2]
field in chunks, about six passes over device memory. At the R shape
(tile 128, y_group 160, every 7th frame dead) the kernel takes 0.935 ms
(issue floor 0.419 ms), `plain_mask` 48.7 ms, `region_stats` 2.5 ms of
`cull_mask`'s 3.4 ms (chip_smoke.check_mask_kernel, same card). The kernel
forms |c - y| by the direct difference, not centroid_d2's expansion, so a
flag can differ from the plain version's only within rounding of the
threshold, which the 1e-3 slack covers; the searches' values cannot move.

`h2o_cull_dvec` (csrc/h2o_cull_dvec.cu, its own kernel and launch count)
replaces `_cull_dvec_kernel` (:204; `_cull_forward(with_dvec=True)`,
pallas_call at :284), the forward of the differentiated culled route
(`_cull_fwd`): the same culled minimum with its first-min index, and
dvec = x - y* there, from which the backward is elementwise
(core/geometry.py).

On a CUDA tensor the wrappers launch their kernel or raise; on a CPU tensor
they run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import profiler as P
from . import chamfer_nn as NN
from ._build import Kernel, build_all

REGION_ROWS = 128
DEFAULT_TILE = 128  # mask tile of the wrappers, in points (module docstring)
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
DVEC_KERNEL = Kernel(
    "h2o_cull_dvec", "h2o_cull_dvec.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_cull.py:204",
    symbol="h2o_cull_dvec_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
MASK_KERNEL = Kernel(
    "h2o_cull_mask", "h2o_cull_mask.cu",
    replaces="none (oakink2_tamf_tpu/ops/chamfer_cull.py:84, `_cull_mask`, is plain XLA)",
    symbol="h2o_cull_mask_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
MAX_MASK_TILES = 256  # object tiles per cloud that the mask kernel's shared memory holds


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def region_stats(x: torch.Tensor, y: torch.Tensor):
    """The region statistics of both cull masks (this module's `cull_mask`
    and ops/chamfer_loss.region_cull_mask), centred on each group's y-mean:
    (c [G, L*R, 3] centroids and rr [F, R] radii of the 128-row regions of
    x [F, P1, 3] over their real rows only, y [G, P2, 3] centred points),
    float32, detached; frame f = g*L + l."""
    x = x.detach().to(torch.float32)
    y = y.detach().to(torch.float32)
    F, P1, _ = x.shape
    P1p = _round_up(P1, REGION_ROWS)
    R = P1p // REGION_ROWS
    xr = torch.nn.functional.pad(x, (0, 0, 0, P1p - P1)).reshape(F, R, REGION_ROWS, 3)
    wr = (torch.arange(P1p, device=x.device) < P1).to(torch.float32).reshape(R, REGION_ROWS)
    cnt = torch.clamp_min(wr.sum(dim=1), 1.0)
    c_fr = (xr * wr[None, :, :, None]).sum(dim=2) / cnt[None, :, None]  # [F, R, 3]
    rr = torch.sqrt(
        torch.amax(((xr - c_fr[:, :, None]) ** 2).sum(dim=-1) * wr[None], dim=2)
    )  # [F, R]
    yc = y.mean(dim=1, keepdim=True)  # [G, 1, 3]
    return c_fr.reshape(y.shape[0], -1, 3) - yc, rr, y - yc


def centroid_d2(c: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor | None) -> torch.Tensor:
    """Squared centroid-to-point distances [g, C, P2] of centroids c
    [g, C, 3] and centred points y [g, P2, 3] by the expansion, inf at
    invalid points. Full fp32: the products must not go through TF32."""
    d2 = (
        (c * c).sum(dim=-1)[..., None]
        - 2.0 * torch.bmm(c, y.transpose(1, 2))
        + (y * y).sum(dim=-1)[:, None, :]
    )
    if y_valid is not None:
        d2 = torch.where(y_valid[:, None, :].to(torch.bool), d2, torch.inf)
    return d2


def plain_mask(cg, rr, y, y_valid, x_valid, tile: int, y_group: int) -> torch.Tensor:
    """The mask kernel's function in plain PyTorch, on `region_stats`'
    outputs (cg [G, L*R, 3], rr [F, R], centred y [G, P2, 3]): the formula
    of the JAX package's `_cull_mask`, flag for flag. It builds the
    centroid-to-point field [g, L*R, P2] a chunk of groups at a time. The
    products must be full fp32 (no TF32) so that the bound never undercuts a
    true minimum."""
    G, P2, _ = y.shape
    F, R = rr.shape
    L = y_group
    T = _round_up(P2, tile) // tile
    d_tile = torch.empty((G, L * R, T), dtype=torch.float32, device=y.device)
    gs = max(1, _MASK_CHUNK_ELEMS // max(1, L * R * T * tile))
    for g0 in range(0, G, gs):
        d2 = centroid_d2(cg[g0 : g0 + gs], y[g0 : g0 + gs],
                         None if y_valid is None else y_valid[g0 : g0 + gs])  # [g, L*R, P2]
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


def _check_mask_operands(cg, rr, y, y_valid, x_valid, tile: int, y_group: int) -> None:
    if tile <= 0 or tile % REGION_ROWS:
        raise ValueError(f"tile {tile} is not a multiple of {REGION_ROWS} points: the mask kernel walks 128-point cells")
    named = [("cg", cg, torch.float32), ("rr", rr, torch.float32), ("y", y, torch.float32)]
    named += [(n, t, torch.bool) for n, t in (("y_valid", y_valid), ("x_valid", x_valid)) if t is not None]
    for name, t, dt in named:
        if t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype}, the mask kernel takes {dt}")
    for name, t, _ in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t, _ in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != cg.device:
            raise ValueError(f"{name} is on {t.device}, cg on {cg.device}")
    G, P2, _ = y.shape
    F, R = rr.shape
    T = _round_up(P2, tile) // tile
    if (cg.shape != (G, y_group * R, 3) or F != G * y_group
            or (y_valid is not None and y_valid.shape != (G, P2))
            or (x_valid is not None and x_valid.shape != (F,))):
        raise ValueError(f"bad operand shapes cg {tuple(cg.shape)} rr {tuple(rr.shape)} y {tuple(y.shape)} "
                         f"y_group {y_group}")
    if T > MAX_MASK_TILES:
        raise ValueError(f"{T} tiles of {tile} points: the mask kernel holds at most {MAX_MASK_TILES} per cloud")
    if F * R * T >= 2**31:
        raise ValueError("too many blocks for one launch")


def launch_mask(cg, rr, y, y_valid, x_valid, tile: int, y_group: int) -> torch.Tensor:
    """Launch the mask kernel on `region_stats`' outputs and the bool masks
    (None: all valid, all live): flags [F, R, T] int32."""
    _check_mask_operands(cg, rr, y, y_valid, x_valid, tile, y_group)
    if MASK_KERNEL._lib is None:  # first use: build the cull route's kernels together, one nvcc each at once
        build_all((MASK_KERNEL, KERNEL, DVEC_KERNEL))
    G, P2, _ = y.shape
    F, R = rr.shape
    T = _round_up(P2, tile) // tile
    flags = torch.empty((F, R, T), dtype=torch.int32, device=y.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(y.device):
        MASK_KERNEL.launch(
            cg.data_ptr(), rr.data_ptr(), y.data_ptr(), ptr(y_valid), ptr(x_valid), flags.data_ptr(),
            G, P2, R, y_group * R, T, tile, torch.cuda.current_stream().cuda_stream,
        )
    return flags


def cull_mask(
    x: torch.Tensor,  # [F, P1, 3]
    y: torch.Tensor,  # [G, P2, 3]
    y_valid: torch.Tensor | None,  # [G, P2] bool
    tile: int,
    y_group: int,
    x_valid: torch.Tensor | None = None,  # [F] bool
) -> torch.Tensor:
    """Compute-flag mask [F, R, T] int32 (1 = run the block); R = ceil(P1/128),
    T = ceil(P2/tile). Bounds only: exactness never depends on it. On a CUDA
    tensor the mask kernel writes it (`tile` a multiple of 128 points), on a
    CPU tensor `plain_mask`."""
    with P.span("cull.mask", device=True):
        F, P1, _ = x.shape
        T = _round_up(y.shape[1], tile) // tile
        R = _round_up(P1, REGION_ROWS) // REGION_ROWS
        cg, rr, yc = region_stats(x, y)  # centred on the group y-mean
        if x.is_cuda:
            run = launch_mask(cg, rr, yc, None if y_valid is None else y_valid.to(torch.bool).contiguous(),
                              None if x_valid is None else x_valid.to(torch.bool).contiguous(), tile, y_group)
        elif x.device.type == "cpu":
            run = plain_mask(cg, rr, yc, y_valid, x_valid, tile, y_group)
        else:
            raise ValueError(f"cull_mask runs on CUDA or CPU tensors, got {x.device}")
        if P.recording():
            P.count("cull.blocks_kept", run)
            P.count("cull.blocks_live", F * R * T if x_valid is None else x_valid.to(torch.bool).sum() * (R * T))
        return run


def _culled_nearest(x, y4, ctr, mask, y_group: int, tile: int):
    """(min d2 [F, P1], first argmin [F, P1] int32, centred x) over the tiles
    the mask runs, in ascending tile order with a strict < (the dvec
    kernel's order)."""
    F, P1, _ = x.shape
    xc = NN.centred_x(x, ctr, y_group)
    region = torch.arange(P1, device=x.device) // REGION_ROWS
    best = torch.full((F, P1), BIG, dtype=torch.float32, device=x.device)
    best_j = torch.zeros((F, P1), dtype=torch.int32, device=x.device)
    for t in range(mask.shape[2]):
        run = mask[:, region, t].to(torch.bool)  # [F, P1]
        if not bool(run.any()):
            continue
        tile_min, tile_j = NN.nearest(xc, y4[:, t * tile : (t + 1) * tile], y_group)
        upd = run & (tile_min < best)
        best = torch.where(upd, tile_min, best)
        best_j = torch.where(upd, tile_j + t * tile, best_j)
    return best, best_j, xc


def plain(x, y4, ctr, mask, y_group: int, tile: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on prepared operands
    (ops/chamfer_nn.prepare) and a mask from `cull_mask`."""
    return _culled_nearest(x, y4, ctr, mask, y_group, tile)[0]


def plain_dvec(x, y4, ctr, mask, y_group: int, tile: int):
    """The dvec kernel's function in plain PyTorch: `plain`'s search with
    the index kept, then a gather of the winning point."""
    best, best_j, xc = _culled_nearest(x, y4, ctr, mask, y_group, tile)
    return best, NN.dvec_at(xc, y4, best, best_j, y_group)


def _check_operands(x, y4, ctr, mask, y_group: int, tile: int) -> None:
    if tile <= 0 or tile % REGION_ROWS:
        raise ValueError(f"tile {tile} is not a multiple of {REGION_ROWS} points: the kernels search 128-point cells")
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


def launch(x, y4, ctr, mask, y_group: int, tile: int) -> torch.Tensor:
    """Launch the CUDA kernel on prepared operands and a mask."""
    F, P1, _ = x.shape
    _check_operands(x, y4, ctr, mask, y_group, tile)
    d = torch.empty((F, P1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), y4.data_ptr(), ctr.data_ptr(), mask.data_ptr(), d.data_ptr(),
            F, P1, y4.shape[1], y_group, mask.shape[2], tile,
            torch.cuda.current_stream().cuda_stream,
        )
    return d


def launch_dvec(x, y4, ctr, mask, y_group: int, tile: int):
    """Launch the dvec kernel on prepared operands and a mask: (min d2
    [F, P1], dvec [F, P1, 3])."""
    F, P1, _ = x.shape
    _check_operands(x, y4, ctr, mask, y_group, tile)
    d = torch.empty((F, P1), dtype=torch.float32, device=x.device)
    dvec = torch.empty((F, P1, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        DVEC_KERNEL.launch(
            x.data_ptr(), y4.data_ptr(), ctr.data_ptr(), mask.data_ptr(), d.data_ptr(),
            dvec.data_ptr(), F, P1, y4.shape[1], y_group, mask.shape[2], tile,
            torch.cuda.current_stream().cuda_stream,
        )
    return d, dvec


def h2o_cull(
    x: torch.Tensor,  # [F, P1, 3]
    y: torch.Tensor,  # [G, P2, 3], G = F // y_group
    y_valid: torch.Tensor | None = None,
    *,
    tile: int = DEFAULT_TILE,
    y_group: int = 1,
    x_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Min squared distance [F, P1] of each row over its cloud, with culled
    blocks skipped. Equal to ops/chamfer_nn.h2o_nn's values on frames with
    x_valid=True; x_valid=False frames cull every tile and come out BIG.
    The result does not depend on `tile` (a multiple of 128 points on the
    card); the default of 128 culls the most (module docstring)."""
    tile = min(tile, _round_up(y.shape[1], 128))
    mask = cull_mask(x, y, y_valid, tile, y_group, x_valid)
    ops = NN.prepare(x, y, y_valid, y_group)
    if x.is_cuda:
        return launch(*ops, mask, y_group, tile)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_cull runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, mask, y_group, tile)


def h2o_cull_dvec(
    x: torch.Tensor,  # [F, P1, 3]
    y: torch.Tensor,  # [G, P2, 3], G = F // y_group
    y_valid: torch.Tensor | None = None,
    *,
    tile: int = DEFAULT_TILE,
    y_group: int = 1,
    x_valid: torch.Tensor | None = None,
):
    """(min squared distance [F, P1], dvec [F, P1, 3]) with culled blocks
    skipped: `h2o_cull`'s values and dvec = x - y* at the first minimum
    (centred). Rows that took no point (x_valid=False frames, all-invalid
    clouds) come out BIG with dvec = 0. Like `h2o_cull`, the result does not
    depend on `tile`."""
    tile = min(tile, _round_up(y.shape[1], 128))
    mask = cull_mask(x, y, y_valid, tile, y_group, x_valid)
    ops = NN.prepare(x, y, y_valid, y_group)
    if x.is_cuda:
        return launch_dvec(*ops, mask, y_group, tile)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_cull_dvec runs on CUDA or CPU tensors, got {x.device}")
    return plain_dvec(*ops, mask, y_group, tile)
