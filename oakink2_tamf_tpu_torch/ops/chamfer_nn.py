"""All-pairs hand->object nearest neighbour (h2o): CUDA kernel, wrapper,
plain PyTorch version and launch count.

Replaces oakink2_tamf_tpu/ops/chamfer_pallas.py `_nn_h2o_kernel` (:354;
`_nn_h2o_forward`, pallas_call at :389, primal `_p2h_core` :673-678). For
frame f of F and hand row i it returns min_j ||x_fi - y_gj||^2 over the
frame's object cloud g = f // y_group, and the first j that reaches it.

Kernel (csrc/h2o_nn.cu) design and bound: see the source. It runs the cell
search of csrc/h2o_cells_common.cuh over the 128-point cells of each cloud
that hold a valid point (`cell_flags`, computed once per call from the
prepared cloud): a cell of invalid points only can never lower a row, so
the skip is exact, and a padded object slot's all-invalid cloud searches
nothing. The work is 8 flops per (row, valid point) pair on the FP32
(non-tensor) pipes; at the serving shape (F = 10240 frames, 778 rows, 2048
points) that is ~1.6e10 pairs, about 1.9 ms at the H100 SXM's published
67 TFLOP/s FP32 peak.

Operands as the TPU wrapper prepares them (`_prep_operands`): every group is
centred on its y-mean, which keeps the coordinates at scene scale; an
invalid y never wins (it sits at 1e15 per coordinate, far above BIG = 1e30
in squared distance), so an all-invalid cloud gives BIG, never inf. As on
the TPU, x_valid is not an operand: padded frames are searched too.

On a CUDA tensor `h2o_nn` launches the kernel or raises; on a CPU tensor it
runs `plain`, the full search over every point, which repeats the kernel's
per-pair rounding in PyTorch.

`h2o_nn_dvec` (csrc/h2o_nn_dvec.cu, its own kernel and launch count)
replaces `_nn_h2o_dvec_kernel` (:408; `_nn_h2o_dvec_forward`, pallas_call
at :476), the forward of the differentiated all-pairs route (`_p2h_fwd`
with grad_y=False): the same minimum, plus dvec = x - y* at the first
minimum, from which the backward is elementwise (core/geometry.py). Its
plain version is `nearest` followed by a gather.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

BIG = 1e30
FAR = 1e15  # coordinate of an invalid y after centring
CELL = 128  # points per cell of the kernels' search (csrc/h2o_cells_common.cuh CELL_PTS)
_PLAIN_CHUNK_ELEMS = 1 << 25  # bound on F * P1 * chunk * 3 per plain step

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "h2o_nn", "h2o_nn.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_pallas.py:354",
    symbol="h2o_nn_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
)
DVEC_KERNEL = Kernel(
    "h2o_nn_dvec", "h2o_nn_dvec.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_pallas.py:408",
    symbol="h2o_nn_dvec_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
)


def prepare(x: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor | None, y_group: int):
    """Kernel operands: (x [F,P1,3] f32, y4 [G,P2,4] f32 centred with invalid
    points at FAR, ctr [G,3] f32 the per-group y-mean). The mean runs over all
    P2 points, valid or not, as the TPU wrapper's does."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    if F != G * y_group:
        raise ValueError(f"frames {F} != groups {G} x y_group {y_group}")
    y = y.to(torch.float32).contiguous()  # one summation order for the mean, whatever the layout
    ctr = y.mean(dim=1)  # [G, 3]
    yc = y - ctr[:, None]
    if y_valid is not None:
        yc = torch.where(y_valid[..., None].to(torch.bool), yc, FAR)
    y4 = torch.nn.functional.pad(yc, (0, 1)).contiguous()
    return x.to(torch.float32).contiguous(), y4, ctr.contiguous()


def centred_x(x: torch.Tensor, ctr: torch.Tensor, y_group: int) -> torch.Tensor:
    """x minus its group's y-mean (the kernel does this as it loads a row)."""
    return x - ctr.repeat_interleave(y_group, dim=0)[:, None, :]


def pair_d2(xc: torch.Tensor, y4: torch.Tensor) -> torch.Tensor:
    """Squared distances [G, yg, P1, n] with the kernel's rounding:
    d = x - y per coordinate in f32, then fl(d0*d0), fma(d1, d1, .),
    fma(d2, d2, .). Each fma is formed exactly in f64 (a product of two f32
    is exact there) and rounded once to f32. xc [G, yg, P1, 3], y4 [G, n, 4].
    The same arithmetic as `sq_norm_rn`, one coordinate at a time so that
    every operand is contiguous (bit-equal, ~1.8x faster on the CPU)."""
    x = xc.permute(3, 0, 1, 2).unsqueeze(-1)  # [3, G, yg, P1, 1]
    y = y4[..., :3].permute(2, 0, 1)[:, :, None, None, :]  # [3, G, 1, 1, n]
    d0 = x[0] - y[0]
    s = (d0 * d0).double()
    d1 = (x[1] - y[1]).double()
    s = d1.mul_(d1).add_(s).float().double()
    d2 = (x[2] - y[2]).double()
    return d2.mul_(d2).add_(s).float()


def sq_norm_rn(d: torch.Tensor) -> torch.Tensor:
    """fma(d2, d2, fma(d1, d1, fl(d0 * d0))) over the last axis of the f32
    differences d [..., 3], with the kernels' rounding (see `pair_d2`)."""
    s = (d[..., 0] * d[..., 0]).to(torch.float64)
    s = (d[..., 1].double() * d[..., 1].double() + s).float().double()
    return (d[..., 2].double() * d[..., 2].double() + s).float()


def nearest(xc: torch.Tensor, y4: torch.Tensor, y_group: int):
    """(min d2 [F, P1], first argmin [F, P1] int32) of centred rows over the
    clouds y4[:, :, :3], streamed in chunks of points."""
    F, P1, _ = xc.shape
    G, P2, _ = y4.shape
    xg = xc.reshape(G, y_group, P1, 3)
    best = torch.full((F, P1), BIG, dtype=torch.float32, device=xc.device)
    best_j = torch.zeros((F, P1), dtype=torch.int32, device=xc.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, F * P1 * 3))
    for j0 in range(0, P2, chunk):
        d = pair_d2(xg, y4[:, j0 : j0 + chunk]).reshape(F, P1, -1)
        m, i = torch.min(d, dim=-1)  # first minimum within the chunk
        upd = m < best  # strict across chunks: the earlier j keeps a tie
        best = torch.where(upd, m, best)
        best_j = torch.where(upd, i.to(torch.int32) + j0, best_j)
    return best, best_j


def plain(x: torch.Tensor, y4: torch.Tensor, ctr: torch.Tensor, y_group: int):
    """The kernel's function in plain PyTorch, on prepared operands: the
    full search over every point, with no cell skipped."""
    return nearest(centred_x(x, ctr, y_group), y4, y_group)


def cell_flags(y4: torch.Tensor) -> torch.Tensor:
    """[G, C] uint8: 1 where a 128-point cell of the prepared clouds y4
    [G, P2, 4] holds a valid point (an invalid one sits at FAR), 0 past P2.
    The cell searches (#1, #4, #10) skip the other cells: their points can
    never lower a row. Derived from y4 itself, so the flags agree with the
    operand the kernel reads."""
    G, P2, _ = y4.shape
    C = -(-P2 // CELL)
    valid = torch.nn.functional.pad(y4[..., 0] < FAR / 2, (0, C * CELL - P2), value=False)
    return valid.reshape(G, C, CELL).any(dim=-1).to(torch.uint8)


def _check_operands(x: torch.Tensor, y4: torch.Tensor, ctr: torch.Tensor, y_group: int) -> None:
    F, P1, _ = x.shape
    G = y4.shape[0]
    for name, t in (("x", x), ("y4", y4), ("ctr", ctr)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if F != G * y_group or y4.shape[2] != 4 or ctr.shape != (G, 3):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y4 {tuple(y4.shape)}")
    if F * ((P1 + 127) // 128) >= 2**31:
        raise ValueError("too many blocks for one launch")


def launch(x: torch.Tensor, y4: torch.Tensor, ctr: torch.Tensor, y_group: int):
    """Launch the CUDA kernel on prepared operands (see `prepare`)."""
    F, P1, _ = x.shape
    P2 = y4.shape[1]
    _check_operands(x, y4, ctr, y_group)
    live = cell_flags(y4)
    d = torch.empty((F, P1), dtype=torch.float32, device=x.device)
    idx = torch.empty((F, P1), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), y4.data_ptr(), ctr.data_ptr(), live.data_ptr(), d.data_ptr(), idx.data_ptr(),
            F, P1, P2, y_group, torch.cuda.current_stream().cuda_stream,
        )
    return d, idx


def h2o_nn(x: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor | None = None,
           y_group: int = 1):
    """(min squared distance [F, P1], first argmin [F, P1] int32) of each row
    of x [F, P1, 3] over its cloud y [F // y_group, P2, 3]."""
    ops = prepare(x, y, y_valid, y_group)
    if x.is_cuda:
        return launch(*ops, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_nn runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, y_group)


# ---------------------------------------------------------------------------
# with the offset to the nearest point (kernel #4)
# ---------------------------------------------------------------------------


def dvec_at(xc: torch.Tensor, y4: torch.Tensor, best: torch.Tensor, best_j: torch.Tensor,
            y_group: int) -> torch.Tensor:
    """dvec [F, P1, 3] = xc - y4[group, best_j, :3] (centred); 0 on rows that
    took no point (best still BIG), as the kernels write it."""
    G, P2, _ = y4.shape
    group = torch.arange(xc.shape[0], device=xc.device) // y_group
    y_at = y4[..., :3].reshape(G * P2, 3)[group[:, None] * P2 + best_j.long()]
    return torch.where((best < BIG)[..., None], xc - y_at, 0.0)


def plain_dvec(x: torch.Tensor, y4: torch.Tensor, ctr: torch.Tensor, y_group: int):
    """The dvec kernel's function in plain PyTorch on prepared operands:
    `nearest` followed by a gather of the winning point."""
    xc = centred_x(x, ctr, y_group)
    best, best_j = nearest(xc, y4, y_group)
    return best, dvec_at(xc, y4, best, best_j, y_group)


def launch_dvec(x: torch.Tensor, y4: torch.Tensor, ctr: torch.Tensor, y_group: int):
    """Launch the dvec kernel on prepared operands: (min d2 [F, P1],
    dvec [F, P1, 3])."""
    F, P1, _ = x.shape
    _check_operands(x, y4, ctr, y_group)
    live = cell_flags(y4)
    d = torch.empty((F, P1), dtype=torch.float32, device=x.device)
    dvec = torch.empty((F, P1, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        DVEC_KERNEL.launch(
            x.data_ptr(), y4.data_ptr(), ctr.data_ptr(), live.data_ptr(), d.data_ptr(), dvec.data_ptr(),
            F, P1, y4.shape[1], y_group, torch.cuda.current_stream().cuda_stream,
        )
    return d, dvec


def h2o_nn_dvec(x: torch.Tensor, y: torch.Tensor, y_valid: torch.Tensor | None = None,
                y_group: int = 1):
    """(min squared distance [F, P1], dvec [F, P1, 3]) of each row of x over
    its cloud: dvec = x - y* at the first minimum (centred on the group's
    y-mean, which cancels), 0 on rows of an all-invalid cloud."""
    ops = prepare(x, y, y_valid, y_group)
    if x.is_cuda:
        return launch_dvec(*ops, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_nn_dvec runs on CUDA or CPU tensors, got {x.device}")
    return plain_dvec(*ops, y_group)
