"""Backward of the hand->object nearest distance (h2o) with the argmin held
constant: CUDA kernel, wrapper, plain PyTorch version and launch count.

Replaces oakink2_tamf_tpu/ops/chamfer_pallas.py `_nn_h2o_bwd_kernel` and
`_nn_h2o_bwd_kernel_nogy` (:502 / :530; `_nn_h2o_backward`, pallas_calls
at :614 / :629), the backward of `point2point_h2o(grad_y=True)` (`_p2h_bwd`
:719-725), whose forward is kernel #1 (ops/chamfer_nn.py). With idx the
forward's first-min index and xr = cot / max(dist, 1e-12):
  gx_i = xr_i (x_i - y_{idx_i})
  gy_j = - sum_{i : idx_i = j} xr_i (x_i - y_j)     (grad_y, y_group == 1)
x and y are the caller's uncentred coordinates, as the TPU wrapper's are.

Kernel (csrc/h2o_nn_bwd.cu; its device code is csrc/h2o_bwd_common.cuh,
shared with the cluster route's backward #11) design and bound: see the
sources. The work is bytes: each input read once and each output written
once, at 3.35 TB/s on the H100 SXM.

On a CUDA tensor `h2o_backward` launches the kernel or raises; on a CPU
tensor it runs `plain`, which scatters gy with index_add (another
summation order than the kernel's atomics).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

MAX_P2_GRAD_Y = 232448 // 12  # the frame's [P2, 3] gy accumulator in 227 KB of shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "h2o_nn_bwd", "h2o_nn_bwd.cu",
    replaces="oakink2_tamf_tpu/ops/chamfer_pallas.py:502",
    symbol="h2o_nn_bwd_launch",
    argtypes=[_P] * 6 + [_I] * 5 + [_P],
)


def plain(x, y, idx, xr, grad_y: bool, y_group: int):
    """The kernel's function in plain PyTorch: (gx [F, P1, 3], gy [F, P2, 3]
    or None). Rows with a zero cotangent contribute nothing."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    group = torch.arange(F, device=x.device) // y_group
    flat = (group[:, None] * P2 + idx.long()).reshape(-1)
    v = xr[..., None] * (x - y.reshape(G * P2, 3)[flat].reshape(F, P1, 3))
    gx = torch.where((xr != 0)[..., None], v, 0.0)
    if not grad_y:
        return gx, None
    gy = torch.zeros((G * P2, 3), dtype=x.dtype, device=x.device)
    gy.index_add_(0, flat, -gx.reshape(-1, 3))
    return gx, gy.reshape(G, P2, 3)


def launch(x, y, idx, xr, grad_y: bool, y_group: int, kernel: Kernel = KERNEL):
    """Launch the kernel: (gx [F, P1, 3], gy [F, P2, 3] or None). `kernel`
    is #5 or the cluster route's #11 (ops/chamfer_cluster.H2O_BWD_KERNEL),
    whose library holds the same device code under its own symbol."""
    F, P1, _ = x.shape
    G, P2, _ = y.shape
    for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                        ("idx", idx, torch.int32), ("xr", xr, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if F != G * y_group or idx.shape != (F, P1) or xr.shape != (F, P1):
        raise ValueError(f"bad operand shapes x {tuple(x.shape)} y {tuple(y.shape)}")
    if grad_y and y_group != 1:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    if grad_y and P2 > MAX_P2_GRAD_Y:
        raise ValueError(f"{P2} points exceed the shared-memory gy accumulator ({MAX_P2_GRAD_Y})")
    gx = torch.empty((F, P1, 3), dtype=torch.float32, device=x.device)
    gy = torch.empty((F, P2, 3), dtype=torch.float32, device=x.device) if grad_y else None
    with torch.cuda.device(x.device):
        kernel.launch(
            x.data_ptr(), y.data_ptr(), idx.data_ptr(), xr.data_ptr(), gx.data_ptr(),
            gy.data_ptr() if grad_y else None, F, P1, P2, y_group, int(grad_y),
            torch.cuda.current_stream().cuda_stream,
        )
    return gx, gy


def h2o_backward(x, y, idx, xr, grad_y: bool = True, y_group: int = 1):
    """(gx [F, P1, 3], gy [F // y_group, P2, 3] or None) of the h2o distances
    of rows x [F, P1, 3] over clouds y [F // y_group, P2, 3]; see the module
    note. grad_y requires y_group == 1."""
    if grad_y and y_group != 1:
        raise NotImplementedError("y_group > 1 requires grad_y=False")
    ops = [x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(),
           idx.to(torch.int32).contiguous(), xr.to(torch.float32).contiguous()]
    if x.is_cuda:
        return launch(*ops, grad_y, y_group)
    if x.device.type != "cpu":
        raise ValueError(f"h2o_backward runs on CUDA or CPU tensors, got {x.device}")
    return plain(*ops, grad_y, y_group)
