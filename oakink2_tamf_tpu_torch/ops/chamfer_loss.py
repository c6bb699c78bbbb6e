"""Fused distance loss of G's extra loss: CUDA kernel, wrapper, plain
PyTorch version, launch count and autograd.Function.

Replaces oakink2_tamf_tpu/ops/chamfer_loss.py `_dist_loss_kernel` (:129,
body `_dist_loss_step` :185; `_dist_loss_forward`, pallas_call at :391) and
the custom VJP around it (`chamfer_dist_loss` / `_dl_core`, :684-808).

The loss consumes two numbers per frame,
  do_f = sum_j |o2h_j - o2h_g_j| w_j        (w: 1.5 / 1.0 / 0.1 rule)
  dh_f = sum_i ||h2o_i| - |h2o_g_i|| vw2_i,
so one pass computes the per-point integrands AND their gradient rows with
respect to the hand rows (gx_do, gx_dh [F, P1, 3]); the backward is
c_do gx_do + c_dh gx_dh (`_dl_bwd`, :790-805). The [F, P2] signed field of
the predicted hand never exists outside the kernel. Argmins, sign() and the
weight selections are constants of the backward (torch-parity convention).

Kernel (csrc/dist_loss.cu): bound, design and the per-point formulas are in
the source. Bound on this card: 8 flops per (x, y) pair counted once, at
the H100 SXM's 67 TFLOP/s FP32 (~31 ms at the G training shape, 40960
frames x 778 rows x 8192 points). x_valid=False frames cost nothing and
come out zero; invalid points (y_valid) give zero.

On a CUDA tensor `dist_loss_rows` launches the kernel or raises; on a CPU
tensor it runs `plain`, which shares the signed forward's plain version
(ops/chamfer_signed.plain: the kernels' per-pair rounding) and then does the
per-point arithmetic in float32; its gradient scatter sums in another order
than the kernel's atomics.
"""

from __future__ import annotations

import ctypes

import torch

from . import chamfer_nn as NN
from . import chamfer_signed as CS
from ._build import Kernel

DIST_EPS = 1e-12  # max(dist, eps) guards of chamfer_loss.py:249 / :304
INVALID_Y = 5e14  # an invalid point sits at FAR = 1e15 per coordinate
MAX_ROWS = 1024  # rows, normals and the gx_do accumulator in 48 KB of shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "dist_loss", "dist_loss.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_loss.py:391",
    symbol="dist_loss_launch",
    argtypes=[_P] * 12 + [_I] * 4 + [_P],
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


def plain(x, n, y4, ctr, og, hg, vw, xv, y_group: int):
    """The kernel's function in plain PyTorch on prepared operands:
    (v [F, P2], dh [F, P1], gx_do [F, P1, 3], gx_dh [F, P1, 3])."""
    F, P1, _ = x.shape
    G, P2, _ = y4.shape
    h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot = CS.plain(x, n, y4, ctr, y_group)
    xc = NN.centred_x(x, ctr, y_group)
    yc = y4[..., :3]
    valid = (yc[..., 0] < INVALID_Y).repeat_interleave(y_group, dim=0)  # [F, P2]

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
    frames = torch.arange(F, device=x.device)
    gx_do = torch.zeros((F * P1, 3), dtype=torch.float32, device=x.device).index_add(
        0, (frames[:, None] * P1 + o2h_i.long()).reshape(-1), u.reshape(-1, 3)
    ).reshape(F, P1, 3)

    hd = torch.sqrt(torch.clamp_min(h2o_d, 0.0))
    hgv = torch.abs(hg)
    dh = torch.abs(hd - hgv) * vw
    cfh = vw * torch.sign(hd - hgv) / torch.clamp_min(hd, DIST_EPS)
    y_at = yc.reshape(G * P2, 3)[((frames // y_group)[:, None] * P2 + h2o_i.long()).reshape(-1)]
    gx_dh = cfh[..., None] * (xc - y_at.reshape(F, P1, 3))

    live = xv.to(torch.bool)
    return (torch.where(live[:, None], v, 0.0), torch.where(live[:, None], dh, 0.0),
            torch.where(live[:, None, None], gx_do, 0.0), torch.where(live[:, None, None], gx_dh, 0.0))


def launch(x, n, y4, ctr, og, hg, vw, xv, y_group: int):
    """Launch the kernel on prepared operands (see `prepare`)."""
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
    dev = x.device
    v = torch.empty((F, P2), dtype=f32, device=dev)
    dh = torch.empty((F, P1), dtype=f32, device=dev)
    gx_do = torch.empty((F, P1, 3), dtype=f32, device=dev)
    gx_dh = torch.empty((F, P1, 3), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            x.data_ptr(), n.data_ptr(), y4.data_ptr(), ctr.data_ptr(), og.data_ptr(),
            hg.data_ptr(), vw.data_ptr(), xv.data_ptr(), v.data_ptr(), dh.data_ptr(),
            gx_do.data_ptr(), gx_dh.data_ptr(), F, P1, P2, y_group,
            torch.cuda.current_stream().cuda_stream,
        )
    return v, dh, gx_do, gx_dh


def dist_loss_rows(x, n, y, o2h_g, h2o_g, vw2, y_valid=None, x_valid=None, y_group: int = 1):
    """(v [F, P2], dh [F, P1], gx_do [F, P1, 3], gx_dh [F, P1, 3]) of rows x
    [F, P1, 3] with normals n against clouds y [F // y_group, P2, 3]."""
    ops = prepare(x, n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group)
    if x.is_cuda:
        return launch(*ops, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"dist_loss_rows runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, y_group)


class DistLoss(torch.autograd.Function):
    """(do_f [F], dh_f [F]) with the gradient rows of the forward pass."""

    @staticmethod
    def forward(ctx, x, n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group: int):
        v, dh, gx_do, gx_dh = dist_loss_rows(
            x.detach(), n, y, o2h_g, h2o_g, vw2, y_valid, x_valid, y_group
        )
        ctx.save_for_backward(gx_do, gx_dh)
        return v.sum(dim=1), dh.sum(dim=1)

    @staticmethod
    def backward(ctx, c_do, c_dh):
        gx_do, gx_dh = ctx.saved_tensors
        gx = c_do[:, None, None] * gx_do + c_dh[:, None, None] * gx_dh
        return gx, None, None, None, None, None, None, None, None


def chamfer_dist_loss(x: torch.Tensor, x_normals: torch.Tensor, y: torch.Tensor,
                      o2h_g: torch.Tensor, h2o_g: torch.Tensor, vw2: torch.Tensor,
                      y_valid: torch.Tensor | None = None, *, y_group: int = 1,
                      x_valid: torch.Tensor | None = None):
    """Port of `chamfer_dist_loss` (chamfer_loss.py:684): the raw per-frame
    sums (do_f [F], dh_f [F]) of the dist_o / dist_h integrands (the caller
    applies frame masks, means and object weights), differentiable with
    respect to x. Frame f searches cloud y[f // y_group]; x_valid [F] False
    skips a frame and gives it zero sums and gradient."""
    return DistLoss.apply(x, x_normals.detach(), y.detach(), o2h_g.detach(), h2o_g.detach(),
                          vw2, y_valid, x_valid, y_group)
