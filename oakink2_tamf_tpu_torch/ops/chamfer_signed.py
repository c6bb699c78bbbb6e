"""Signed bidirectional hand/object nearest neighbour: CUDA kernels (forward
and backward), wrappers, plain PyTorch versions, launch counts and the
autograd.Function that joins them.

Forward, kernel `nn_signed` (csrc/nn_signed.cu). Replaces
oakink2_tamf_tpu/ops/chamfer_pallas.py `_nn_kernel` (:97; `_nn_forward`,
pallas_call at :306). Per frame f of F with rows x [P1, 3], normals n and
the cloud y[f // y_group] [P2, 3]:
  h2o_d, h2o_i [F, P1]: min_j ||x_i - y_j||^2 and the first j reaching it;
  o2h_d, o2h_i [F, P2]: min_i ||x_i - y_j||^2 and the first i reaching it;
  o2h_dot [F, P2]: the sign numerator n_{i*} . (y_j - x_{i*}).
Operands are prepared as for the h2o kernels (ops/chamfer_nn.prepare): y
centred on its group's y-mean, invalid points at FAR. An invalid point
never wins a row; its own o2h outputs are (BIG, 0, .) and are masked by
every caller.

Backward, kernel `nn_signed_bwd` (csrc/nn_signed_bwd.cu). Replaces
`_nn_bwd_kernel` / `_nn_bwd_kernel_nogy` (:731 / :788; `_nn_backward`,
pallas_calls at :890 / :904). With the argmins held constant and the
cotangents pre-divided by the distances (xr [F, P1], yc [F, P2]):
  gx_i = xr_i (x_i - y_{h2o_i}) - sum_{j: o2h_i[j] = i} yc_j (y_j - x_i)
  gy_j = yc_j (y_j - x_{o2h_i}) - sum_{i: h2o_i[i] = j} xr_i (x_i - y_j)
gy only with grad_y (y_group == 1); every TaMF call site passes
grad_y=False.

Bounds on this card (H100 SXM, 67 TFLOP/s FP32, 3.35 TB/s): the forward
is pair work, 8 flops per pair counted once (at the G training shape,
40960 frames x 778 rows x 8192 points, ~31 ms); the backward is bytes
(each input once, gx once: ~1.1 ms there). The forward is a single-pass
bidirectional search (csrc/bidir_common.cuh): each pair's distance is
computed once and feeds both directions. Designs: see the sources.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor
they run the plain version, which repeats the forward kernel's per-pair
rounding in PyTorch (the backward's plain version sums in another order).
"""

from __future__ import annotations

import ctypes

import torch

from . import chamfer_nn as NN
from ._build import Kernel

BIG = NN.BIG
DIST_EPS = 1e-12  # the TPU VJP's max(dist, eps) guard (chamfer_pallas.py:1017-1018)
MAX_ROWS = 1536  # rows, normals and row keys staged in 60 KB of shared memory (P1 x 40 B)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "nn_signed", "nn_signed.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_pallas.py:306",
    symbol="nn_signed_launch",
    argtypes=[_P] * 9 + [_I] * 4 + [_P],
)
BWD_KERNEL = Kernel(
    "nn_signed_bwd", "nn_signed_bwd.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_pallas.py:890",
    symbol="nn_signed_bwd_launch",
    argtypes=[_P] * 8 + [_I] * 5 + [_P],
)


def _fma3(a0, b0, a1, b1, a2, b2) -> torch.Tensor:
    """fma(a2, b2, fma(a1, b1, fl(a0 * b0))) in float32, each fma formed in
    float64 (a product of two float32 is exact there) and rounded once."""
    s = (a0 * b0).double()
    s = (a1.double() * b1.double() + s).float().double()
    return (a2.double() * b2.double() + s).float()


def sign_numer(xr: torch.Tensor, nr: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """n . (y - x) over the last axis with the kernels' rounding."""
    d = y - xr
    return _fma3(nr[..., 0], d[..., 0], nr[..., 1], d[..., 1], nr[..., 2], d[..., 2])


def _rows_at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [F, P1, 3] at idx [F, n] -> [F, n, 3]."""
    return torch.gather(rows, 1, idx.long()[..., None].expand(-1, -1, 3))


def prepare(x, y, x_normals, y_valid, y_group: int):
    """Kernel operands (x, n, y4, ctr): ops/chamfer_nn.prepare plus the
    normals (zeros when None) as contiguous float32."""
    n = torch.zeros_like(x) if x_normals is None else x_normals
    x, y4, ctr = NN.prepare(x, y, y_valid, y_group)
    return x, n.to(torch.float32).contiguous(), y4, ctr


def plain(x, n, y4, ctr, y_group: int):
    """The forward kernel's function in plain PyTorch on prepared operands:
    (h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot), streamed in chunks of points."""
    F, P1, _ = x.shape
    G, P2, _ = y4.shape
    xc = NN.centred_x(x, ctr, y_group)
    xg = xc.reshape(G, y_group, P1, 3)
    dev = x.device
    h2o_d = torch.full((F, P1), BIG, dtype=torch.float32, device=dev)
    h2o_i = torch.zeros((F, P1), dtype=torch.int32, device=dev)
    o2h_d = torch.empty((F, P2), dtype=torch.float32, device=dev)
    o2h_i = torch.empty((F, P2), dtype=torch.int32, device=dev)
    o2h_dot = torch.empty((F, P2), dtype=torch.float32, device=dev)
    chunk = max(1, NN._PLAIN_CHUNK_ELEMS // max(1, F * P1 * 3))
    for j0 in range(0, P2, chunk):
        yk = y4[:, j0 : j0 + chunk, :3]
        d = NN.pair_d2(xg, y4[:, j0 : j0 + chunk]).reshape(F, P1, -1)
        m, i = torch.min(d, dim=-1)  # h2o: first minimum within the chunk
        upd = m < h2o_d  # strict across chunks: the earlier j keeps a tie
        h2o_d = torch.where(upd, m, h2o_d)
        h2o_i = torch.where(upd, i.to(torch.int32) + j0, h2o_i)
        m, i = torch.min(d, dim=1)  # o2h: first row reaching each column's min
        keep = m < BIG  # the kernel starts at BIG: an invalid column keeps (BIG, 0)
        i = torch.where(keep, i, 0)
        n_cols = m.shape[1]
        o2h_d[:, j0 : j0 + n_cols] = torch.where(keep, m, BIG)
        o2h_i[:, j0 : j0 + n_cols] = i.to(torch.int32)
        yf = yk[:, None].expand(G, y_group, n_cols, 3).reshape(F, n_cols, 3)
        o2h_dot[:, j0 : j0 + n_cols] = sign_numer(_rows_at(xc, i), _rows_at(n, i), yf)
    return h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot


def _check_cuda(named: dict, device) -> None:
    for name, (t, dtype) in named.items():
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")


def launch(x, n, y4, ctr, y_group: int):
    """Launch the forward kernel on prepared operands (see `prepare`)."""
    F, P1, _ = x.shape
    G, P2, _ = y4.shape
    f32 = torch.float32
    _check_cuda({"x": (x, f32), "n": (n, f32), "y4": (y4, f32), "ctr": (ctr, f32)}, x.device)
    if F != G * y_group or y4.shape[2] != 4 or ctr.shape != (G, 3) or n.shape != x.shape:
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} n {tuple(n.shape)} y4 {tuple(y4.shape)}")
    if P1 > MAX_ROWS:
        raise ValueError(f"{P1} rows exceed the {MAX_ROWS} the o2h block stages in shared memory")
    if F >= 2**31:
        raise ValueError("too many frames for one launch (one block per frame)")
    dev = x.device
    h2o_d = torch.empty((F, P1), dtype=f32, device=dev)
    h2o_i = torch.empty((F, P1), dtype=torch.int32, device=dev)
    o2h_d = torch.empty((F, P2), dtype=f32, device=dev)
    o2h_i = torch.empty((F, P2), dtype=torch.int32, device=dev)
    o2h_dot = torch.empty((F, P2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            x.data_ptr(), n.data_ptr(), y4.data_ptr(), ctr.data_ptr(),
            h2o_d.data_ptr(), h2o_i.data_ptr(), o2h_d.data_ptr(), o2h_i.data_ptr(),
            o2h_dot.data_ptr(), F, P1, P2, y_group, torch.cuda.current_stream().cuda_stream,
        )
    return h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot


def nn_signed(x: torch.Tensor, y: torch.Tensor, x_normals: torch.Tensor | None = None,
              y_valid: torch.Tensor | None = None, y_group: int = 1):
    """(h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot) of rows x [F, P1, 3] (normals
    [F, P1, 3]) against clouds y [F // y_group, P2, 3]; see the module note."""
    ops = prepare(x, y, x_normals, y_valid, y_group)
    if x.is_cuda:
        return launch(*ops, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"nn_signed runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, y_group)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def backward_plain(x, y, h2o_i, o2h_i, xr, yc, grad_y: bool, y_group: int):
    """The backward kernel's function in plain PyTorch: (gx, gy or None)."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    frames = torch.arange(F, device=x.device)
    groups = frames // y_group
    x_at = x.reshape(F * P1, 3)[(frames[:, None] * P1 + o2h_i.long()).reshape(-1)].reshape(F, P2, 3)
    u = yc[..., None] * (y.reshape(G, 1, P2, 3) - x_at.reshape(G, y_group, P2, 3)).reshape(F, P2, 3)
    y_at = y.reshape(G * P2, 3)[(groups[:, None] * P2 + h2o_i.long()).reshape(-1)].reshape(F, P1, 3)
    v = xr[..., None] * (x - y_at)
    gx = v.reshape(F * P1, 3).index_add(
        0, (frames[:, None] * P1 + o2h_i.long()).reshape(-1), -u.reshape(-1, 3)
    ).reshape(F, P1, 3)
    if not grad_y:
        return gx, None
    gy = u.reshape(F * P2, 3).index_add(
        0, (frames[:, None] * P2 + h2o_i.long()).reshape(-1), -v.reshape(-1, 3)
    ).reshape(F, P2, 3)
    return gx, gy


def backward_launch(x, y, h2o_i, o2h_i, xr, yc, grad_y: bool, y_group: int):
    """Launch the backward kernel: (gx [F, P1, 3], gy [F, P2, 3] or None)."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    f32, i32 = torch.float32, torch.int32
    _check_cuda({"x": (x, f32), "y": (y, f32), "h2o_i": (h2o_i, i32), "o2h_i": (o2h_i, i32),
                 "xr": (xr, f32), "yc": (yc, f32)}, x.device)
    if F != G * y_group or h2o_i.shape != (F, P1) or xr.shape != (F, P1) \
            or o2h_i.shape != (F, P2) or yc.shape != (F, P2):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y {tuple(y.shape)}")
    if grad_y and y_group != 1:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if P1 * 3 * 4 > 48 * 1024:
        raise ValueError(f"{P1} rows exceed the shared-memory gx accumulator")
    gx = torch.empty((F, P1, 3), dtype=f32, device=x.device)
    gy = torch.empty((F, P2, 3), dtype=f32, device=x.device) if grad_y else None
    with torch.cuda.device(x.device):
        BWD_KERNEL.launch(
            x.data_ptr(), y.data_ptr(), h2o_i.data_ptr(), o2h_i.data_ptr(), xr.data_ptr(),
            yc.data_ptr(), gx.data_ptr(), gy.data_ptr() if grad_y else None,
            F, P1, P2, y_group, int(grad_y), torch.cuda.current_stream().cuda_stream,
        )
    return gx, gy


def nn_signed_backward(x, y, h2o_i, o2h_i, xr, yc, grad_y: bool = False, y_group: int = 1):
    """(gx, gy or None) of the signed pair; see the module note."""
    ops = [t.to(torch.float32).contiguous() for t in (x, y)]
    ops += [t.to(torch.int32).contiguous() for t in (h2o_i, o2h_i)]
    ops += [t.to(torch.float32).contiguous() for t in (xr, yc)]
    if x.is_cuda:
        return backward_launch(*ops, grad_y, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"nn_signed_backward runs on CUDA or CPU tensors, got {x.device}")
    return backward_plain(*ops, grad_y, y_group)


class SignedChamfer(torch.autograd.Function):
    """(y2x_signed [F, P2], x2y [F, P1], o2h_i [F, P2]) with the TPU VJP's
    gradient (`_p2ps_fwd` / `_p2ps_bwd`, chamfer_pallas.py:970-1028): the
    argmins and sign() are constants; normals get no gradient."""

    @staticmethod
    def forward(ctx, x, y, x_normals, y_valid, grad_y: bool, y_group: int):
        h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot = nn_signed(x, y, x_normals, y_valid, y_group)
        x2y = torch.sqrt(torch.clamp_min(h2o_d, 0.0))
        y2x = torch.sqrt(torch.clamp_min(o2h_d, 0.0))
        sign = torch.sign(o2h_dot) if x_normals is not None else torch.ones_like(y2x)
        if y_valid is not None:
            sign = torch.where(y_valid.to(torch.bool).repeat_interleave(y_group, dim=0), sign, 0.0)
        # an invalid column's sign is 0: y2x * 0 is its signed value and
        # yc's factor below (the TPU's where(y_valid, ...) in both places)
        y2x_signed = y2x * sign
        ctx.save_for_backward(x, y, x2y, y2x, sign.to(torch.int8), h2o_i, o2h_i)
        ctx.grad_y, ctx.y_group = grad_y, y_group
        ctx.mark_non_differentiable(o2h_i)
        return y2x_signed, x2y, o2h_i

    @staticmethod
    def backward(ctx, g_y2x, g_x2y, _):
        x, y, x2y, y2x, sign, h2o_i, o2h_i = ctx.saved_tensors
        xr = g_x2y / torch.clamp_min(x2y, DIST_EPS)
        yc = sign.to(torch.float32) * g_y2x / torch.clamp_min(y2x, DIST_EPS)
        gx, gy = nn_signed_backward(x, y, h2o_i, o2h_i, xr, yc, ctx.grad_y, ctx.y_group)
        return gx.to(x.dtype), gy, None, None, None, None


def signed_chamfer(x: torch.Tensor, y: torch.Tensor, x_normals: torch.Tensor | None = None,
                   y_valid: torch.Tensor | None = None, *, grad_y: bool = True, y_group: int = 1):
    """Port of `point2point_signed_pallas` (chamfer_pallas.py:917): returns
    (y2x_signed [F, P2], x2y [F, P1], o2h_i [F, P2]). y2x is signed by the
    normal of each point's nearest row (unsigned without normals) and is 0
    at invalid points. grad_y=False gives y no gradient (every TaMF call
    site); y_group > 1 (shared clouds) requires it."""
    if y_group > 1 and grad_y:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if not grad_y:
        y = y.detach()
    return SignedChamfer.apply(x, y, x_normals, y_valid, grad_y, y_group)
