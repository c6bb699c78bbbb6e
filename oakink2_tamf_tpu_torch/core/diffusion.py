"""Gaussian diffusion engine (port of oakink2_tamf_tpu/core/diffusion.py).

The schedule is computed in float64 numpy, exactly as the JAX package does,
then cast to float32 tensors on the device. The TaMF configuration: cosine
betas, START_X prediction, FIXED_SMALL variance, MSE loss, optional
respacing. The other branches of the JAX engine are here too: the
PREVIOUS_X and EPSILON mean types, FIXED_LARGE and the learned variances
(LEARNED, LEARNED_RANGE: the model emits 2C channels, split on the last
axis), the KL / RESCALED_KL / RESCALED_MSE losses and the variational
bound (`vb_terms_bpd`, `calc_bpd_loop`, `prior_bpd`).

The samplers are Python loops on the device, one model call per step:
- `p_sample_loop` (DDPM, with const_noise, skip_timesteps and init_image)
  and `p_sample_loop_trajectory` (the chain's states, stacked);
- `ddim_sample_loop` (eta), `plms_sample_loop` (order 1-4);
- `p_sample_loop_parallel`, Picard windows: one model call per sweep on a
  window of steps.
`sample_loop` dispatches on the sampler's name. Each sampler takes its noise
explicitly so a test can feed it the JAX chain's draws: `noise` is x_T,
`step_noise` [S, ...] the per-step noise in chain order (index 0 is the
first step, t = T-1), and the parallel sampler's `t_noise` [T, ...] is
indexed by the timestep t. What is not given is drawn from a
torch.Generator. `clip_denoised`, `denoised_fn` and `cond_fn` act as in the
JAX package.

Training (`training_losses`): the masked MSE of the mean type's target,
or with KL / RESCALED_KL the variational bound; with a learned variance
and an MSE loss the frozen-mean vb term is reported in aux["vb"] and not
added to the loss (the reference's choice). It takes an explicit `noise=`
so a test can feed both sides the same noise.

Layout: x is [bs, seqlen, C] as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..runtime import profiler as P


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED = "learned"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


LEARNED_VARIANCES = (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE)


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


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """q(x_t | x_0): (mean, variance, log_variance)."""
    mean = _extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = _extract(1.0 - sched.alphas_cumprod, t, x_start.ndim)
    log_variance = _extract(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


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


# ---------------------------------------------------------------------------
# Reverse process p: one step, and the x_0 / eps identities
# ---------------------------------------------------------------------------


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - pred_xstart
    ) / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    return (
        _extract(1.0 / sched.posterior_mean_coef1, t, x_t.ndim) * xprev
        - _extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, x_t.ndim) * x_t
    )


def p_mean_variance(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    clip_denoised: bool = False,
    denoised_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
) -> dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t). `model_fn(x, t_model)` closes over the
    conditioning; t_model is respaced. The predicted x_0 passes through
    `denoised_fn`, then is clipped to [-1, 1] with `clip_denoised`.

    With a learned variance the model emits 2C channels, [mean prediction |
    variance values] on the last axis (a wrong count raises): LEARNED reads
    the log variance, LEARNED_RANGE a value in [-1, 1] that interpolates
    [posterior variance, beta] in log space. FIXED_LARGE takes the betas
    with beta_0 replaced by posterior_variance[1]."""
    model_output = model_fn(x, model_timesteps(sched, t))
    if model_var_type in LEARNED_VARIANCES:
        C = x.shape[-1]
        if model_output.shape[-1] != 2 * C:
            raise ValueError(f"learned variance expects model output with {2 * C} channels, "
                             f"got {model_output.shape[-1]}")
        model_output, var_values = torch.split(model_output, C, dim=-1)
        if model_var_type == ModelVarType.LEARNED:
            log_variance = var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
            max_log = _extract(torch.log(sched.betas), t, x.ndim)
            frac = (var_values + 1) / 2
            log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif model_var_type == ModelVarType.FIXED_SMALL:
        variance = _extract(sched.posterior_variance, t, x.ndim)
        log_variance = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
    else:  # FIXED_LARGE
        variance = _extract(torch.cat([sched.posterior_variance[1:2], sched.betas[1:]]), t, x.ndim)
        log_variance = torch.log(variance)

    def process_xstart(xs):
        if denoised_fn is not None:
            xs = denoised_fn(xs)
        if clip_denoised:
            xs = torch.clamp(xs, -1.0, 1.0)
        return xs

    if model_mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        mean = model_output
    else:
        pred_xstart = process_xstart(
            model_output if model_mean_type == ModelMeanType.START_X
            else predict_xstart_from_eps(sched, x, t, model_output)
        )
        mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {
        "mean": mean,
        "variance": variance,
        "log_variance": log_variance,
        "pred_xstart": pred_xstart,
        "model_output": model_output,
    }


def condition_mean(cond_fn, sched: DiffusionSchedule, p_mean_var, x, t) -> torch.Tensor:
    """Classifier guidance: the mean shifted by variance * cond_fn(x, t_model)."""
    gradient = cond_fn(x, model_timesteps(sched, t))
    return p_mean_var["mean"].float() + p_mean_var["variance"] * gradient.float()


def condition_score(cond_fn, sched: DiffusionSchedule, p_mean_var, x, t) -> dict[str, torch.Tensor]:
    """Score conditioning (Song et al.): eps moved by -sqrt(1 - alpha_bar) *
    cond_fn(x, t_model); pred_xstart and the mean follow from it."""
    alpha_bar = _extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, model_timesteps(sched, t))
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return dict(p_mean_var, pred_xstart=pred_xstart, mean=mean)


def p_sample(
    model_fn,
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    clip_denoised: bool = False,
    denoised_fn=None,
    cond_fn=None,
    const_noise: bool = False,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
) -> dict[str, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} with the given unit noise; with
    `const_noise` every sample takes the noise of sample 0."""
    out = p_mean_variance(model_fn, sched, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                          model_mean_type=model_mean_type, model_var_type=model_var_type)
    if const_noise:
        noise = noise[0:1].expand(x.shape)
    nonzero_mask = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    mean = out["mean"]
    if cond_fn is not None:
        mean = condition_mean(cond_fn, sched, out, x, t)
    sample = mean + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


# ---------------------------------------------------------------------------
# The samplers. Each draws from `generator` on `device` whatever noise it
# is not given, in chain order: x_T first, then one draw per step. Every
# draw goes through `draw(shape, generator, device)`, `_randn` unless the
# caller passes another (parallel/mesh.global_randn: this rank's rows of a
# draw over the global batch).
# ---------------------------------------------------------------------------


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def _check_shape(name: str, a: torch.Tensor | None, want: tuple[int, ...]) -> None:
    if a is not None and tuple(a.shape) != tuple(want):
        raise ValueError(f"{name} {tuple(a.shape)} != {tuple(want)}")


def _full_t(t_scalar: int, bs: int, device) -> torch.Tensor:
    return torch.full((bs,), t_scalar, dtype=torch.int64, device=device)


def _chain_start(sched, shape, *, device, generator, noise, skip_timesteps, init_image, draw=_randn):
    """(x at the first step, number of steps). Any `init_image` is
    q-sampled at the first step with the initial noise as the q_sample
    noise; `skip_timesteps` without one starts from a zeros image."""
    _check_shape("noise", noise, shape)
    img = draw(shape, generator, device) if noise is None else noise.to(device)
    t_start = sched.num_timesteps - skip_timesteps
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, dtype=torch.float32, device=device)
    if init_image is not None:
        img = q_sample(sched, init_image.to(device), _full_t(t_start - 1, shape[0], device), img)
    return img, t_start


def _p_sample_steps(model_fn, sched, img, t_start, *, device, generator, step_noise, draw=_randn, **step_kw):
    """Yield each ancestral step's {"sample", "pred_xstart"}, t = t_start-1 .. 0."""
    _check_shape("step_noise", step_noise, (t_start,) + tuple(img.shape))
    for i, t_scalar in enumerate(range(t_start - 1, -1, -1)):
        with P.span("diffusion.step"):
            z = draw(img.shape, generator, device) if step_noise is None else step_noise[i].to(device)
            out = p_sample(model_fn, sched, img, _full_t(t_scalar, img.shape[0], device), z, **step_kw)
        img = out["sample"]
        yield out


def p_sample_loop(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    noise: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
    clip_denoised: bool = False,
    denoised_fn=None,
    cond_fn=None,
    const_noise: bool = False,
    skip_timesteps: int = 0,
    init_image: torch.Tensor | None = None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
) -> torch.Tensor:
    """The ancestral (DDPM) chain, t = T-1-skip_timesteps .. 0. Returns the
    final sample.

    `noise` [*shape] is the initial noise and `step_noise` [S, *shape] the
    unit noise of each of the S = T - skip_timesteps steps in chain order
    (index 0 is the first step). `init_image` and `skip_timesteps` follow
    the reference: any init_image is q-sampled at the first step with the
    initial noise, and skip_timesteps without one starts from a zeros image
    (so x_start = sqrt(1 - alpha_bar) * noise)."""
    img, t_start = _chain_start(sched, shape, device=device, generator=generator, noise=noise,
                                skip_timesteps=skip_timesteps, init_image=init_image, draw=draw)
    for out in _p_sample_steps(model_fn, sched, img, t_start, device=device, generator=generator,
                               step_noise=step_noise, draw=draw, clip_denoised=clip_denoised,
                               denoised_fn=denoised_fn, cond_fn=cond_fn, const_noise=const_noise,
                               model_mean_type=model_mean_type, model_var_type=model_var_type):
        img = out["sample"]
    return img


def p_sample_loop_trajectory(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    noise: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
    clip_denoised: bool = False,
    denoised_fn=None,
    cond_fn=None,
    const_noise: bool = False,
    skip_timesteps: int = 0,
    init_image: torch.Tensor | None = None,
    dump_steps: Sequence[int] | None = None,
    with_pred_xstart: bool = False,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
) -> dict[str, torch.Tensor]:
    """`p_sample_loop` that also returns the chain's states: {"sample":
    [bs, ...], "trajectory": [S, bs, ...] each step's output in chain order
    (index S-1 is the final sample), and with `with_pred_xstart`
    "pred_xstart" stacked the same way}. With `dump_steps` only those step
    indices are kept, in ascending order."""
    img, t_start = _chain_start(sched, shape, device=device, generator=generator, noise=noise,
                                skip_timesteps=skip_timesteps, init_image=init_image, draw=draw)
    keep = sorted(int(i) for i in dump_steps) if dump_steps is not None else range(t_start)
    wanted = set(keep)
    traj, preds = {}, {}
    for i, out in enumerate(_p_sample_steps(
            model_fn, sched, img, t_start, device=device, generator=generator, step_noise=step_noise, draw=draw,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
            const_noise=const_noise, model_mean_type=model_mean_type, model_var_type=model_var_type)):
        img = out["sample"]
        if i in wanted:
            traj[i] = img
            preds[i] = out["pred_xstart"]

    def stack(d):
        return torch.stack([d[i] for i in keep]) if keep else img.new_empty((0,) + tuple(shape))

    res = {"sample": img, "trajectory": stack(traj)}
    if with_pred_xstart:
        res["pred_xstart"] = stack(preds)
    return res


def ddim_sample_loop(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    noise: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
    clip_denoised: bool = False,
    denoised_fn=None,
    cond_fn=None,
    eta: float = 0.0,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
) -> torch.Tensor:
    """The DDIM chain, t = T-1 .. 0, with
    sigma = eta * sqrt((1 - ab_prev) / (1 - ab)) * sqrt(1 - ab / ab_prev)
    (ab_prev = 1 at t = 0). `noise` is x_T; `step_noise` [T, *shape], the
    per-step noise in chain order, is used (and drawn) only when eta > 0."""
    T = sched.num_timesteps
    _check_shape("noise", noise, shape)
    _check_shape("step_noise", step_noise, (T,) + tuple(shape))
    img = draw(shape, generator, device) if noise is None else noise.to(device)
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        with P.span("diffusion.step"):
            t = _full_t(t_scalar, shape[0], device)
            out = p_mean_variance(model_fn, sched, img, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                  model_mean_type=model_mean_type)
            if cond_fn is not None:
                out = condition_score(cond_fn, sched, out, img, t)
            eps = predict_eps_from_xstart(sched, img, t, out["pred_xstart"])
            alpha_bar = _extract(sched.alphas_cumprod, t, img.ndim)
            alpha_bar_prev = _extract(sched.alphas_cumprod_prev, t, img.ndim)
            sigma = (
                eta
                * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
            )
            mean_pred = (
                out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
            )
            if eta > 0:
                z = draw(shape, generator, device) if step_noise is None else step_noise[i].to(device)
                nonzero_mask = (t != 0).to(img.dtype).reshape((-1,) + (1,) * (img.ndim - 1))
                mean_pred = mean_pred + nonzero_mask * sigma * z
            img = mean_pred
    return img


def plms_sample_loop(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    noise: torch.Tensor | None = None,
    clip_denoised: bool = False,
    order: int = 2,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
) -> torch.Tensor:
    """Pseudo linear multistep (PLMS), t = T-1 .. 0; deterministic given
    `noise` (x_T). With order > 1 the first step is the improved-Euler pair
    (a second model call at (mean_pred, max(t-1, 0)), the two eps
    averaged); later steps blend the newest eps with up to order-1 earlier
    ones (Adams-Bashforth); the last step (t = 0) returns the model's
    pred_xstart. Every alpha_bar is looked up on `sched`'s own (respaced)
    arrays; alpha_bar at t = -1 is 1."""
    if not 1 <= order <= 4:
        raise ValueError(f"PLMS order {order} not in 1..4")
    _check_shape("noise", noise, shape)
    img = draw(shape, generator, device) if noise is None else noise.to(device)
    ndim = len(shape)

    def get_eps_x0(x, t):
        out = p_mean_variance(model_fn, sched, x, t, clip_denoised=clip_denoised,
                              model_mean_type=model_mean_type)
        return predict_eps_from_xstart(sched, x, t, out["pred_xstart"]), out["pred_xstart"]

    def ab_next_of(t_next):
        ab = torch.where(t_next >= 0, sched.alphas_cumprod[torch.clamp_min(t_next, 0)],
                         torch.ones((), dtype=torch.float32, device=t_next.device))
        return ab.reshape((-1,) + (1,) * (ndim - 1))

    eps_buf: list[torch.Tensor] = []  # earlier eps, newest first (at most 3)
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        with P.span("diffusion.step"):
            t = _full_t(t_scalar, shape[0], device)
            t_next = t - 1
            e0, pred_x0 = get_eps_x0(img, t)
            ab_next = ab_next_of(t_next)
            if order > 1 and not eps_buf:
                mean_pred = pred_x0 * torch.sqrt(ab_next) + torch.sqrt(1 - ab_next) * e0
                eps_2, _ = get_eps_x0(mean_pred, torch.clamp_min(t_next, 0))
                eps_prime = (e0 + eps_2) / 2.0
            else:
                eff_order = min(len(eps_buf), order - 1)
                if eff_order == 0:
                    eps_prime = e0
                elif eff_order == 1:
                    eps_prime = (3 * e0 - eps_buf[0]) / 2
                elif eff_order == 2:
                    eps_prime = (23 * e0 - 16 * eps_buf[0] + 5 * eps_buf[1]) / 12
                else:
                    eps_prime = (55 * e0 - 59 * eps_buf[0] + 37 * eps_buf[1] - 9 * eps_buf[2]) / 24
            # the deterministic DDIM transfer with eps_prime
            x0 = predict_xstart_from_eps(sched, img, t, eps_prime)
            img_next = x0 * torch.sqrt(ab_next) + torch.sqrt(1 - ab_next) * eps_prime
            nonzero = (t != 0).to(img.dtype).reshape((-1,) + (1,) * (ndim - 1))
            img = img_next * nonzero + pred_x0 * (1 - nonzero)
            eps_buf = [e0] + eps_buf[:2]
    return img


def p_sample_loop_parallel(
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    noise: torch.Tensor | None = None,
    t_noise: torch.Tensor | None = None,
    window: int = 32,
    tol: float = 1e-2,
    clip_denoised: bool = False,
    denoised_fn=None,
    cond_fn=None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
    batch_max: Callable[[torch.Tensor], torch.Tensor] | None = None,
    return_info: bool = False,
):
    """Picard-parallel ancestral sampling (ParaDiGMS, arXiv:2305.16317).

    With the step noise pinned per timestep, the chain is a deterministic
    map, solved over a sliding window of `window` steps (clamped to T) by
    Picard iteration. Each sweep is ONE model call on [W*bs, ...]: the
    window's states flattened window-major, each row with its own
    timestep. `model_fn` must accept a batch that is a multiple of the
    conditioning's and tile the conditioning the same way
    (parallel/train.g_model_fn does). The new guesses are the integral form
    buf[0] + cumsum(g(buf) - buf); the window slides past position s+1
    (exact after every sweep) and each following position whose drift, the
    per-element mean square change of the WORST sample of the batch, is at
    most tol**2 * posterior_variance[t]. tol = 0 is the sequential chain.

    `noise` is x_T; `t_noise` [T, *shape] holds the unit noise of timestep
    t at index t (not in chain order). Without it each timestep's noise is
    drawn from `generator` when the window first reaches it, so in chain
    order. The exit test reads the slide on the host: one sync per sweep.
    `batch_max` maps the window's per-position drift of this process's
    rows to that of the global batch (parallel/mesh.all_reduce_max), so
    that every rank slides as one process on the global batch would.

    Returns the sample, or (sample, {"n_sweeps", "n_model_evals"}) (ints)
    with return_info."""
    T = sched.num_timesteps
    W = min(int(window), T)
    bs = shape[0]
    _check_shape("noise", noise, shape)
    _check_shape("t_noise", t_noise, (T,) + tuple(shape))
    img = draw(shape, generator, device) if noise is None else noise.to(device)
    z_by_t: dict[int, torch.Tensor] = {}

    def z_of(t_scalar: int) -> torch.Tensor:
        if t_scalar not in z_by_t:
            z_by_t[t_scalar] = (draw(shape, generator, device) if t_noise is None
                                else t_noise[t_scalar].to(device))
        return z_by_t[t_scalar]

    # position p in [0, T]: x after p reverse steps, whose next step uses
    # timestep T-1-p. buf[j] is the current guess at position s+j; buf[0]
    # is exact.
    buf = img.unsqueeze(0).expand((W + 1,) + tuple(shape)).clone()
    tol2 = torch.tensor(tol, dtype=torch.float32, device=device) ** 2
    steps = torch.arange(W, device=device)
    fill = torch.arange(W + 1, device=device)
    rows = (W * bs,) + tuple(shape[1:])
    s = sweeps = 0
    while s < T:
        with P.span("diffusion.sweep"):
            ts_win = torch.clamp(T - 1 - (s + steps), 0, T - 1)
            t_rows = ts_win.repeat_interleave(bs)
            x = buf[:W].reshape(rows)
            out = p_mean_variance(model_fn, sched, x, t_rows, clip_denoised=clip_denoised,
                                  denoised_fn=denoised_fn, model_mean_type=model_mean_type,
                                  model_var_type=model_var_type)
            mean = out["mean"]
            if cond_fn is not None:
                mean = condition_mean(cond_fn, sched, out, x, t_rows)
            z = torch.stack([z_of(max(T - 1 - s - j, 0)) for j in range(W)]).reshape(rows)
            nz = (t_rows > 0).to(torch.float32).reshape((-1,) + (1,) * (len(shape) - 1))
            y = (mean + nz * torch.exp(0.5 * out["log_variance"]) * z).reshape(buf[:W].shape)
            new_vals = buf[0] + torch.cumsum(y - buf[:W], dim=0)  # positions s+1 .. s+W
            drift = torch.square(new_vals - buf[1:]).reshape(W, bs, -1).mean(-1).amax(-1)
            if batch_max is not None:
                drift = batch_max(drift)
            ok = drift <= tol2 * sched.posterior_variance[ts_win]
            m = min(1 + int(torch.cumprod(ok[1:].to(torch.int32), 0).sum()), T - s)
            buf = torch.cat([buf[:1], new_vals])[torch.clamp(fill + m, max=W)]
            for t_done in range(T - 1 - s, T - 1 - s - m, -1):  # noise no step needs again
                z_by_t.pop(t_done, None)
            s += m
            sweeps += 1
    if return_info:
        return buf[0], {"n_sweeps": sweeps, "n_model_evals": sweeps * W}
    return buf[0]


SAMPLERS = ("ddpm", "ddim", "plms", "parallel")


def sample_loop(
    sampler: str,
    model_fn,
    sched: DiffusionSchedule,
    shape: tuple[int, ...],
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    noise: dict[str, torch.Tensor] | None = None,
    draw: Callable[..., torch.Tensor] = _randn,
    batch_max: Callable[[torch.Tensor], torch.Tensor] | None = None,
    parallel_window: int = 32,
    parallel_tol: float = 1e-2,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
) -> torch.Tensor:
    """The named sampler's chain with the TaMF settings (no clipping; DDIM
    at eta 0, PLMS at order 2). `noise` holds the sampler's own noise
    keywords, e.g. {"noise": x_T, "step_noise": ...} for "ddpm" or
    {"noise": x_T, "t_noise": ...} for "parallel". DDIM and PLMS take the
    mean type only (their variance is FIXED_SMALL, as in JAX): another
    variance type raises there. `draw` draws what `noise` lacks, and
    `batch_max` is the parallel sampler's (see each sampler)."""
    kw = dict(device=device, generator=generator, draw=draw, model_mean_type=model_mean_type, **(noise or {}))
    if sampler in ("ddim", "plms") and model_var_type != ModelVarType.FIXED_SMALL:
        raise ValueError(f"sampler {sampler!r} takes no model_var_type (got {model_var_type})")
    if sampler == "ddpm":
        return p_sample_loop(model_fn, sched, shape, model_var_type=model_var_type, **kw)
    if sampler == "ddim":
        return ddim_sample_loop(model_fn, sched, shape, **kw)
    if sampler == "plms":
        return plms_sample_loop(model_fn, sched, shape, **kw)
    if sampler == "parallel":
        return p_sample_loop_parallel(model_fn, sched, shape, window=parallel_window, tol=parallel_tol,
                                      batch_max=batch_max, model_var_type=model_var_type, **kw)
    raise ValueError(f"unknown sampler {sampler!r}: one of {SAMPLERS}")


# ---------------------------------------------------------------------------
# Training loss (gd.py masked_l2 and training_losses)
# ---------------------------------------------------------------------------


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.ndim)))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=tuple(range(1, x.ndim)))


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked MSE over [bs, seqlen, C] with mask [bs, seqlen]:
    sum((a-b)^2 * mask) / (sum(mask) * C)."""
    m = mask[..., None].to(a.dtype)
    loss = sum_flat((a - b) ** 2 * m)
    non_zero = sum_flat(m) * a.shape[-1]
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
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
    loss_type: LossType = LossType.MSE,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The diffusion loss per sample [bs] and an aux dict. `noise` is the
    unit noise of q_sample, drawn from `generator` when not given.

    MSE / RESCALED_MSE: the masked MSE of the model output (its mean half
    with a learned variance) against the mean type's target; aux holds x_t,
    model_output and target, and with a learned variance "vb", the
    variational term with the mean prediction detached (x T/1000 with
    RESCALED_MSE), reported and not added to the loss. KL / RESCALED_KL
    (x T): the loss is the variational term; aux holds x_t and
    pred_xstart."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                            dtype=x_start.dtype)
    x_t = q_sample(sched, x_start, t, noise)
    if loss_type in (LossType.KL, LossType.RESCALED_KL):
        vb = vb_terms_bpd(model_fn, sched, x_start, x_t, t, model_mean_type=model_mean_type,
                          model_var_type=model_var_type)
        loss = vb["output"]
        if loss_type == LossType.RESCALED_KL:
            loss = loss * sched.num_timesteps
        return loss, {"x_t": x_t, "pred_xstart": vb["pred_xstart"]}

    model_output = model_fn(x_t, model_timesteps(sched, t))
    aux = {"x_t": x_t}
    if model_var_type in LEARNED_VARIANCES:
        model_output, var_values = torch.split(model_output, x_start.shape[-1], dim=-1)
        frozen = torch.cat([model_output.detach(), var_values], dim=-1)
        vb = vb_terms_bpd(lambda *_: frozen, sched, x_start, x_t, t, model_mean_type=model_mean_type,
                          model_var_type=model_var_type)["output"]
        if loss_type == LossType.RESCALED_MSE:
            vb = vb * (sched.num_timesteps / 1000.0)
        aux["vb"] = vb
    if model_mean_type == ModelMeanType.START_X:
        target = x_start
    elif model_mean_type == ModelMeanType.EPSILON:
        target = noise
    else:
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    mse = masked_l2(target, model_output, mask)
    aux.update(model_output=model_output, target=target)
    return mse, aux


# ---------------------------------------------------------------------------
# The variational bound (losses.py:12-68, gd.py:1079-1262)
# ---------------------------------------------------------------------------


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of x in [-1, 1] under a Gaussian discretised to bins
    of width 2/255 (the edge bins open)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp_min(cdf_plus, 1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp_min(1.0 - cdf_min, 1e-12))
    log_cdf_delta = torch.log(torch.clamp_min(cdf_plus - cdf_min, 1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(model_fn, sched: DiffusionSchedule, x_start, x_t, t, *, clip_denoised: bool = False,
                 model_mean_type: ModelMeanType = ModelMeanType.START_X,
                 model_var_type: ModelVarType = ModelVarType.FIXED_SMALL) -> dict[str, torch.Tensor]:
    """KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) in bits per dimension,
    the decoder NLL where t = 0: {"output" [bs], "pred_xstart"}."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(model_fn, sched, x_t, t, clip_denoised=clip_denoised,
                          model_mean_type=model_mean_type, model_var_type=model_var_type)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
    )
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def prior_bpd(sched: DiffusionSchedule, x_start) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dimension, [bs]."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.int64, device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    kl_prior = normal_kl(qt_mean, qt_log_var, torch.zeros_like(qt_mean), torch.zeros_like(qt_log_var))
    return mean_flat(kl_prior) / math.log(2.0)


def calc_bpd_loop(
    model_fn,
    sched: DiffusionSchedule,
    x_start: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    clip_denoised: bool = False,
    noise: torch.Tensor | None = None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
) -> dict[str, torch.Tensor]:
    """The whole variational bound, one model call per timestep, t = T-1 ..
    0. `noise` [T, *x_start.shape] is each step's q_sample noise in that
    order (index 0 is t = T-1), drawn from `generator` when not given.

    Returns {"total_bpd" [bs], "prior_bpd" [bs], "vb" [bs, T], "xstart_mse"
    [bs, T], "mse" [bs, T]}; column 0 of the [bs, T] arrays is t = T-1."""
    T = sched.num_timesteps
    bs = x_start.shape[0]
    _check_shape("noise", noise, (T,) + tuple(x_start.shape))
    vb, xstart_mse, mse = [], [], []
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        nz = (torch.randn(x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype)
              if noise is None else noise[i].to(x_start.device))
        t = _full_t(t_scalar, bs, x_start.device)
        x_t = q_sample(sched, x_start, t, nz)
        out = vb_terms_bpd(model_fn, sched, x_start, x_t, t, clip_denoised=clip_denoised,
                           model_mean_type=model_mean_type)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        eps = predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        mse.append(mean_flat((eps - nz) ** 2))
    vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
