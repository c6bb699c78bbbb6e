"""Gaussian diffusion engine (port of oakink2_tamf_tpu/core/diffusion.py).

The schedule is computed in float64 numpy, exactly as the JAX package does,
then cast to float32 tensors on the device. The TaMF configuration: cosine
betas, START_X prediction, FIXED_SMALL variance, optional respacing.

The reverse chain (`p_sample_loop`) is a Python loop on the device. It takes
an optional explicit initial noise and per-step noise so a test can feed it
the JAX chain's noise. DDIM, PLMS and the parallel sampler are not ported yet.

Training (`training_losses`): START_X prediction, MSE loss, FIXED_SMALL
variance, the configuration of every TaMF config; the KL / learned-variance
branches of the JAX package are not ported. It takes an explicit `noise=`
so a test can feed both sides the same noise.

Layout: x is [bs, seqlen, C] as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Respacing (guided-diffusion respace.py semantics)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass
class DiffusionSchedule:
    """Per-timestep arrays ([T] float32 tensors) + the respacing map ([T] int64)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def make_schedule(
    betas: np.ndarray, *, use_timesteps: Sequence[int] | set[int] | None = None
) -> DiffusionSchedule:
    """Build the schedule (CPU tensors); with `use_timesteps`, first remap the
    betas onto that subset (SpacedDiffusion semantics)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    if use_timesteps is not None:
        use = sorted(set(int(t) for t in use_timesteps))
        use_set = set(use)
        last_alpha_cumprod = 1.0
        new_betas = []
        for i, a in enumerate(np.cumprod(1.0 - betas)):
            if i in use_set:
                new_betas.append(1 - a / last_alpha_cumprod)
                last_alpha_cumprod = a
        betas = np.array(new_betas, dtype=np.float64)
        timestep_map = np.array(use, dtype=np.int64)
    else:
        timestep_map = np.arange(len(betas), dtype=np.int64)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        timestep_map=torch.from_numpy(timestep_map),
    )


def tamf_schedule(
    steps: int = 1000, noise_schedule: str = "cosine", timestep_respacing: str = ""
) -> DiffusionSchedule:
    """The TaMF factory: cosine betas, START_X, FIXED_SMALL; optional respacing."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    use = space_timesteps(steps, timestep_respacing) if timestep_respacing else None
    return make_schedule(betas, use_timesteps=use)


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] shaped to broadcast against an x of rank `ndim`."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def model_timesteps(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """The timestep the model sees: the respacing map (integer, it indexes
    the model's sinusoidal table)."""
    return sched.timestep_map[t]


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0)."""
    return (
        _extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
        + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    mean = (
        _extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
        + _extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    variance = _extract(sched.posterior_variance, t, x_t.ndim)
    log_variance = _extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def p_mean_variance(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) for START_X prediction with FIXED_SMALL variance and
    no x_0 clipping (the TaMF configuration). `model_fn(x, t_model)` closes
    over the conditioning; t_model is respaced."""
    model_output = model_fn(x, sched.timestep_map[t])
    variance = _extract(sched.posterior_variance, t, x.ndim)
    log_variance = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
    pred_xstart = model_output
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {
        "mean": mean,
        "variance": variance,
        "log_variance": log_variance,
        "pred_xstart": pred_xstart,
        "model_output": model_output,
    }


def p_sample(
    model_fn,
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} with the given unit noise."""
    out = p_mean_variance(model_fn, sched, x, t)
    nonzero_mask = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def p_sample_loop(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The full reverse chain, t = T-1 .. 0. Returns the final sample.

    `noise` [*shape] is the initial x_T and `step_noise` [T, *shape] the unit
    noise of each step in chain order; either one is drawn from `generator`
    on `device` when not given."""
    T = sched.num_timesteps
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if step_noise is not None and tuple(step_noise.shape) != (T,) + tuple(shape):
        raise ValueError(f"step_noise {tuple(step_noise.shape)} != {(T,) + tuple(shape)}")
    img = noise.to(device)
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((shape[0],), t_scalar, dtype=torch.int64, device=device)
        if step_noise is None:
            z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        else:
            z = step_noise[i].to(device)
        img = p_sample(model_fn, sched, img, t, z)["sample"]
    return img


# ---------------------------------------------------------------------------
# Training loss (gd.py masked_l2 and training_losses)
# ---------------------------------------------------------------------------


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked MSE over [bs, seqlen, C] with mask [bs, seqlen]:
    sum((a-b)^2 * mask) / (sum(mask) * C)."""
    m = mask[..., None].to(a.dtype)
    dims = tuple(range(1, a.ndim))
    loss = torch.sum((a - b) ** 2 * m, dim=dims)
    non_zero = torch.sum(m, dim=dims) * a.shape[-1]
    return loss / torch.clamp_min(non_zero, 1e-8)


def training_losses(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    x_start: torch.Tensor,
    t: torch.Tensor,
    mask: torch.Tensor,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked-MSE diffusion loss for START_X prediction: returns (per-sample
    loss [bs], aux with x_t, model_output and target). `noise` is the unit
    noise of q_sample, drawn from `generator` when not given."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                            dtype=x_start.dtype)
    x_t = q_sample(sched, x_start, t, noise)
    model_output = model_fn(x_t, model_timesteps(sched, t))
    mse = masked_l2(x_start, model_output, mask)
    return mse, {"x_t": x_t, "model_output": model_output, "target": x_start}
