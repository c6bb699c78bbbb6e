"""Random weights from the seed, made on the device in one draw per model and
written into the program's model and the reference's alike (by parameter
name, in sorted order): matrices N(0, 1/fan_in), LayerNorm scales
1 + N(0, 0.05^2), other vectors N(0, 0.02^2)."""

from __future__ import annotations

import torch

from .seeds import device_generator


def _scale(name: str, p: torch.Tensor) -> tuple[float, float]:
    if p.ndim >= 2:
        return 0.0, p.shape[-1] ** -0.5
    if "norm" in name and name.endswith("weight"):
        return 1.0, 0.05
    return 0.0, 0.02


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, tag: str) -> None:
    named = sorted((n, p) for n, p in module.named_parameters())
    dev = named[0][1].device
    total = sum(p.numel() for _, p in named)
    z = torch.randn(total, generator=device_generator(dev, seed, tag), device=dev, dtype=torch.float32)
    off = 0
    for name, p in named:
        shift, scale = _scale(name, p)
        p.copy_((z[off : off + p.numel()] * scale + shift).view_as(p))
        off += p.numel()
