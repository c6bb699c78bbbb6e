"""Device and precision rules shared by every entry point of the port.

- Entry points take `device=` and default to "cuda". Without a GPU they raise
  unless the caller asked for "cpu": there is no silent CPU run.
- TF32 is switched off for matmuls and cuDNN. The h2o bounds pass
  (ops/chamfer_cull.cull_mask) and the MANO/geometry contractions rely on
  full-fp32 products: TF32 keeps ~10 mantissa bits, and near-contact
  distances (~5e-3 m) drown in that rounding (the JAX package pins
  Precision.HIGHEST for the same reason, ops/chamfer_pallas.py `_dot`).
"""

from __future__ import annotations

import torch


def set_fp32_precision() -> None:
    """Full fp32 for float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: "cuda" unless told otherwise.

    Raises when CUDA is asked for (the default) and no GPU is present. Also
    applies the fp32 precision rule above."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' explicitly to run the "
            "port's plain PyTorch paths on the CPU"
        )
    set_fp32_precision()
    return dev
