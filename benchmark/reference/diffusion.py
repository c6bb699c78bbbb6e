"""The TaMF diffusion arithmetic, plain PyTorch: the cosine schedule, q_sample,
the x0-prediction DDPM chain with the fixed-small variance, and the masked
MSE (the arithmetic of oakink2_tamf_tpu_torch/core/diffusion.py for these
settings, written again for the benchmark's reference).

Noise is drawn from the generator in chain order: x_T first, then one draw
per step, each [bs, L, C] float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cosine_schedule(steps: int, device) -> dict[str, torch.Tensor]:
    """The schedule's per-timestep arrays as float32 tensors on `device`."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - abar((i + 1) / steps) / abar(i / steps), 0.999) for i in range(steps)],
                     dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    arrays = {
        "sqrt_ac": np.sqrt(ac),
        "sqrt_1m_ac": np.sqrt(1.0 - ac),
        "post_logvar": np.log(np.append(post_var[1], post_var[1:])),
        "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in arrays.items()}


def _at(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(s: dict, x_start, t, noise):
    return _at(s["sqrt_ac"], t, x_start.ndim) * x_start + _at(s["sqrt_1m_ac"], t, x_start.ndim) * noise


def masked_l2(a, b, mask):
    """Per-sample masked MSE: sum((a-b)^2 * mask) / (sum(mask) * C)."""
    m = mask[..., None].to(a.dtype)
    dims = tuple(range(1, a.ndim))
    return torch.sum((a - b) ** 2 * m, dim=dims) / torch.clamp_min(torch.sum(m, dim=dims) * a.shape[-1], 1e-8)


@torch.no_grad()
def ddpm(model_fn, s: dict, shape, generator, device) -> torch.Tensor:
    """The ancestral chain t = T-1 .. 0 with x0 prediction."""
    steps = s["coef1"].shape[0]
    img = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    for t_scalar in range(steps - 1, -1, -1):
        z = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
        t = torch.full((shape[0],), t_scalar, dtype=torch.int64, device=device)
        x0 = model_fn(img, t)
        mean = _at(s["coef1"], t, img.ndim) * x0 + _at(s["coef2"], t, img.ndim) * img
        nonzero = (t != 0).to(img.dtype).reshape((-1,) + (1,) * (img.ndim - 1))
        img = mean + nonzero * torch.exp(0.5 * _at(s["post_logvar"], t, img.ndim)) * z
    return img
