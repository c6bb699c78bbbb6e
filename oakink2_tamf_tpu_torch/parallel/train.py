"""The G, R and FID-encoder train steps, their optimizer and the G sampler
(port of oakink2_tamf_tpu/parallel/train.py:39-380), on one device or on
each rank of a process group (parallel/mesh.py).

Optimizer parity (reference launch/train.py:469-479, util/net_util.py:13):
- PER-PARAMETER gradient clip to L2 norm 0.1 (each tensor on its own, not a
  global norm), at the JAX package's parameter granularity: flax keeps
  attention's query, key and value projections as three parameters, which
  the packed `in_proj_weight` / `in_proj_bias` hold as three row blocks, so
  each block is clipped on its own (the original torch reference clips the
  packed tensor whole); then
- AdamW(lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 0), then
- MultiStepLR stepped once per optimizer step (the launcher turns epoch
  milestones into step milestones): update k runs at base_lr * gamma^(number
  of milestones <= k), as the JAX package's optax schedule does.

G's step: timesteps from the batch (`t`, `t_weights`: an importance
resampler) or uniform; the GT side of the extra loss under torch.no_grad()
outside the loss; the diffusion loss and the extra loss on the model
output; backward; clip, AdamW, LR step.

Under a live process group of W ranks, each holding b rows of a global
batch, every step computes what one process computes on the W*b rows (the
JAX package's GSPMD step): the gradients are the ranks' mean
(mesh.all_reduce_grads_, before the clip); the metrics are reduced as the
batch means or sums they are; G's in-step timesteps and q_sample noise are
this rank's rows of one draw over the global batch from a generator in the
same state on every rank. G's extra loss sums over the batch where its
diffusion loss means, so its extra terms enter backward() scaled by W: the
mean over the ranks then gives their global sum. Dropout and the cond mask
draw from torch's global generator, seeded per rank (utils/seeding.py):
there W ranks differ from one process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch

from ..core import diffusion as D
from ..core import mano as M
from ..models import losses as LL
from ..models.encoder import COND_KEYS as ENCODER_COND_KEYS
from ..models.refine_r import refine_forward, sample_geometry, target_geometry
from ..runtime import profiler as P
from . import mesh

# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


PACKED_QKV = ("in_proj_weight", "in_proj_bias")  # attention's [q; k; v] row blocks


def per_param_clip_(grads: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale each gradient tensor, in place, to L2 norm <= max_norm."""
    for g in grads:
        n = torch.linalg.vector_norm(g)
        g.mul_(torch.clamp(max_norm / torch.clamp_min(n, 1e-6), max=1.0))


class Optimizer:
    """Per-parameter clip + AdamW + MultiStepLR over optimizer steps.
    `params`: parameters, or (name, parameter) pairs as named_parameters()
    gives them; a name ending in one of PACKED_QKV is clipped per block."""

    def __init__(self, params, base_lr: float = 1e-4, weight_decay: float = 0.0,
                 grad_clip: float = 0.1, milestones_steps: Iterable[int] = (), gamma: float = 0.5):
        named = [item if isinstance(item, tuple) else ("", item) for item in params]
        named = [(n, p) for n, p in named if p.requires_grad]
        self.params = [p for _, p in named]
        self._blocks = [3 if n.endswith(PACKED_QKV) else 1 for n, _ in named]
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.adamw, milestones=sorted(int(m) for m in milestones_steps), gamma=gamma
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip, update, advance the learning-rate schedule."""
        per_param_clip_(
            [g for p, k in zip(self.params, self._blocks) if p.grad is not None
             for g in p.grad.chunk(k, dim=0)],
            self.grad_clip,
        )
        self.adamw.step()
        self.scheduler.step()

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    def state_dict(self) -> dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.scheduler.load_state_dict(sd["scheduler"])


def make_optimizer(params, base_lr: float = 1e-4, weight_decay: float = 0.0,
                   grad_clip: float = 0.1, milestones_steps: Iterable[int] | None = None,
                   gamma: float = 0.5) -> Optimizer:
    return Optimizer(params, base_lr, weight_decay, grad_clip, milestones_steps or (), gamma)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def _step(state: TrainState) -> None:
    """After backward(): the gradients' mean over the ranks (under a
    process group), then clip, AdamW and the LR schedule."""
    mesh.all_reduce_grads_(state.optimizer.params)
    state.optimizer.step()
    state.step += 1


# ---------------------------------------------------------------------------
# G: diffusion train step
# ---------------------------------------------------------------------------


def g_cond_from_batch(batch: dict[str, Any]) -> dict[str, Any]:
    return {k: batch[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}


def g_model_fn(model: torch.nn.Module, cond: dict[str, torch.Tensor]) -> Callable:
    """model_fn(x, t) for the samplers: G under the batch's conditioning. An
    x of k times the conditioning's batch (the parallel sampler's window,
    flattened window-major) sees the conditioning tiled k times in that
    order."""
    bs = cond["hand_side"].shape[0]

    def fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        reps = x.shape[0] // bs
        c = cond if reps == 1 else {k: v.repeat((reps,) + (1,) * (v.ndim - 1)) for k, v in cond.items()}
        return model(x, t, c)

    return fn


def make_g_sampler(
    sched: D.DiffusionSchedule,
    *,
    sampler: str = "ddpm",
    parallel_window: int = 64,
    parallel_tol: float = 1e-2,
) -> Callable[..., torch.Tensor]:
    """The batched G sampler (JAX make_g_sampler, parallel/train.py:227):
    `sampler` is "ddpm", "ddim", "plms" or "parallel" (the Picard-window
    chain, for small batches: `parallel_window` steps per model call,
    slide tolerance `parallel_tol`); an unknown name raises ValueError.

    sample_fn(model, batch, generator, noise=None, global_batch=False) ->
    [bs, L, 99] runs the chain under torch.inference_mode() with dropout
    off, on the batch's device. `noise` holds the sampler's noise keywords
    (core/diffusion.py: "noise" = x_T, "step_noise" in chain order,
    "t_noise" by timestep); what it lacks is drawn from `generator`. With
    `global_batch` under a process group, `batch` is this rank's rows
    [r*b, (r+1)*b) of a global batch and every rank must call together:
    each draw is this rank's rows of one draw over the global batch
    (mesh.global_randn), and the parallel sampler slides on the global
    batch's drift, so the ranks' rows equal one process's on the global
    batch. With one process `global_batch` changes nothing."""
    if sampler not in D.SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}: one of {D.SAMPLERS}")

    @torch.inference_mode()
    def sample_fn(model: torch.nn.Module, batch: dict[str, Any], generator: torch.Generator | None,
                  noise: dict[str, torch.Tensor] | None = None, global_batch: bool = False) -> torch.Tensor:
        was_training = model.training
        model.eval()
        rows = dict(draw=mesh.global_randn, batch_max=mesh.all_reduce_max) if global_batch else {}
        try:
            x = batch["pose_repr"]
            return D.sample_loop(
                sampler, g_model_fn(model, g_cond_from_batch(batch)), sched, tuple(x.shape),
                device=x.device, generator=generator, noise=noise,
                parallel_window=parallel_window, parallel_tol=parallel_tol, **rows,
            )
        finally:
            model.train(was_training)

    return sample_fn


def make_g_train_step(
    sched: D.DiffusionSchedule,
    mano_stack: M.ManoTensors | None = None,
    assets: LL.ContactAssets | None = None,
    extra_cfg: LL.ExtraLossConfig | None = None,
    *,
    chunk: int = 2048,
    dist_impl: str = "auto",
) -> Callable[..., dict[str, torch.Tensor]]:
    """The G train step. With mano_stack, assets and extra_cfg set, the
    geometric extra loss is computed on the model output (the reference's
    loss_callback hook, gd.py:1182). `dist_impl` routes its predicted-side
    dist pass (models/losses.py); `chunk` (train.chunk) tiles the mask of
    its "fused_cull" route.

    step_fn(state, batch, *, generator=None, noise=None) -> metrics updates
    state in place. `generator` (on the batch's device) draws t when the
    batch has none and the q_sample noise unless `noise` (this rank's rows)
    is given; under a process group each is this rank's rows of a draw over
    the global batch. The gradients stay in the parameters' .grad until
    the next step. The metrics are the global batch's: `per_sample_mse` and
    `per_sample_t` hold every rank's rows in rank order."""
    use_extra = mano_stack is not None and assets is not None and extra_cfg is not None
    with_chamfer = use_extra and (extra_cfg.coef_dist_h > 0.0 or extra_cfg.coef_dist_o > 0.0)

    def step_fn(state: TrainState, batch: dict[str, Any], *,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        with P.span("train.g_step", request=state.step):
            return _g_step(state, batch, generator, noise)

    def _g_step(state, batch, generator, noise):
        model = state.model
        model.train()
        x_start = batch["pose_repr"]
        bs = x_start.shape[0]
        W = mesh.world_size()
        if "t" in batch:  # host-provided (importance resampler)
            t = batch["t"].to(torch.int64)
            weights = batch["t_weights"].to(torch.float32)
        else:
            t = mesh.shard_rows(torch.randint(0, sched.num_timesteps, (W * bs,), generator=generator,
                                              device=x_start.device))
            weights = torch.ones((bs,), dtype=torch.float32, device=x_start.device)
        if noise is None:
            noise = mesh.shard_rows(torch.randn((W * bs,) + tuple(x_start.shape[1:]), generator=generator,
                                                device=x_start.device, dtype=x_start.dtype))
        cond = g_cond_from_batch(batch)

        gt_geom = None
        if use_extra:  # batch-only: never differentiated
            with torch.no_grad(), P.span("g.gt_geometry", device=True):
                gt_geom = LL.extra_loss_gt_geometry(mano_stack, batch, with_chamfer=with_chamfer)

        state.optimizer.zero_grad()
        with P.span("g.trunk_loss", device=True):
            mse, aux = D.training_losses(
                lambda x, tt: model(x, tt, cond), sched, x_start, t, batch["mask"],
                noise=noise, generator=generator,
            )
            diffusion_loss = torch.mean(mse * weights)
        total = diffusion_loss
        metrics = {"diffusion_loss": diffusion_loss, "t_mean": t.to(torch.float32).mean(),
                   "per_sample_mse": mse, "per_sample_t": t}
        if use_extra:
            with P.span("g.extra_loss", device=True):
                extra, terms = LL.interaction_segment_extra_loss(
                    mano_stack, assets, extra_cfg, aux["model_output"], batch,
                    chunk=chunk, gt_geom=gt_geom, dist_impl=dist_impl,
                )
            # a batch sum: W times its share, so the ranks' mean is the global sum
            total = total + (extra * W if W > 1 else extra)
            metrics.update({f"extra/{k}": v for k, v in terms.items()})
        metrics["loss"] = total
        with P.span("train.backward", device=True):
            total.backward()
        with P.span("train.optimizer", device=True):
            _step(state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh.is_live():
            metrics = mesh.reduce_metrics(metrics, {k: "sum" for k in metrics if k.startswith("extra/")})
            if use_extra:
                metrics["loss"] = metrics["diffusion_loss"] + metrics["extra/loss"]
            metrics["per_sample_mse"] = mesh.all_gather_rows(metrics["per_sample_mse"])
            metrics["per_sample_t"] = mesh.all_gather_rows(metrics["per_sample_t"])
        return metrics

    return step_fn


# ---------------------------------------------------------------------------
# R: refiner train step
# ---------------------------------------------------------------------------


def make_r_train_step(
    mano_stack: M.ManoTensors,
    assets: LL.ContactAssets,
    loss_cfg: LL.RefineLossConfig,
    *,
    backend: str = "auto",
    chunk: int = 2048,
) -> Callable[..., dict[str, torch.Tensor]]:
    """The R train step (JAX make_r_train_step, parallel/train.py:276-332).

    step_fn(state, batch) -> metrics updates state in place: the target and
    the sample geometry are functions of the batch alone and run under
    torch.no_grad() (the JAX step's stop_gradient regions); only the
    refined branch (the net, MANO of its output and the h2o kernels'
    backward) is differentiated. Dropout draws from torch's global
    generator. `backend` routes every h2o search (core/geometry.py);
    `chunk` (train.chunk) is the xla route's tile of object points."""

    def step_fn(state: TrainState, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        with P.span("train.r_step", request=state.step):
            net = state.model
            net.train()
            mask = batch["mask"]
            with torch.no_grad():
                tgt = target_geometry(mano_stack, batch, backend=backend, frame_mask=mask, chunk=chunk)
                # the padded-frame closed form of the network input (valid under
                # the zero-padding collate and adaptor contract)
                sg = sample_geometry(mano_stack, batch, frame_mask=mask, backend=backend, chunk=chunk)
            state.optimizer.zero_grad()
            out = refine_forward(net, mano_stack, batch, with_target=False, sample_geom=sg,
                                 backend=backend, loss_frame_mask=mask, chunk=chunk)
            out.update(tgt)
            with P.span("r.loss", device=True):
                loss, terms = LL.segment_refine_loss(assets, loss_cfg, out, batch)
            with P.span("train.backward", device=True):
                loss.backward()
            with P.span("train.optimizer", device=True):
                _step(state)
            return mesh.reduce_metrics({k: v.detach() for k, v in terms.items()}, {})  # batch means

    return step_fn


# ---------------------------------------------------------------------------
# FID encoder: action-classification train step
# ---------------------------------------------------------------------------


def make_encoder_train_step() -> Callable[..., dict[str, torch.Tensor]]:
    """The encoder train step (JAX make_encoder_train_step,
    parallel/train.py:340-380).

    step_fn(state, batch) -> metrics updates state in place: cross-entropy
    and accuracy of the action logits (models/losses.segment_encoder_loss)
    on `sample_pose_repr` when the batch has it, else on `pose_repr`
    (reference train_encoder.py:521-523). Dropout draws from torch's global
    generator. The classification token is a buffer, not a parameter, so
    the optimizer never moves it (the JAX step zeroes its update)."""

    def step_fn(state: TrainState, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        model = state.model
        model.train()
        x = batch.get("sample_pose_repr", batch["pose_repr"])
        state.optimizer.zero_grad()
        out = model(x, {k: batch[k] for k in ENCODER_COND_KEYS})
        loss, metrics = LL.segment_encoder_loss(out, batch["action_label_id"])
        loss.backward()
        _step(state)
        return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()}, {})  # batch means

    return step_fn
