"""The G and R train steps and their optimizer (port of
oakink2_tamf_tpu/parallel/train.py:39-332), on one device for now.

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch

from ..core import diffusion as D
from ..core import mano as M
from ..models import losses as LL
from ..models.refine_r import refine_forward, sample_geometry, target_geometry

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


# ---------------------------------------------------------------------------
# G: diffusion train step
# ---------------------------------------------------------------------------


def g_cond_from_batch(batch: dict[str, Any]) -> dict[str, Any]:
    return {k: batch[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}


def make_g_train_step(
    sched: D.DiffusionSchedule,
    mano_stack: M.ManoTensors | None = None,
    assets: LL.ContactAssets | None = None,
    extra_cfg: LL.ExtraLossConfig | None = None,
    *,
    dist_impl: str = "auto",
) -> Callable[..., dict[str, torch.Tensor]]:
    """The G train step. With mano_stack, assets and extra_cfg set, the
    geometric extra loss is computed on the model output (the reference's
    loss_callback hook, gd.py:1182). `dist_impl` routes its predicted-side
    dist pass (models/losses.py).

    step_fn(state, batch, *, generator=None, noise=None) -> metrics updates
    state in place. `generator` (on the batch's device) draws t when the
    batch has none and the q_sample noise unless `noise` is given. The
    gradients stay in the parameters' .grad until the next step."""
    use_extra = mano_stack is not None and assets is not None and extra_cfg is not None
    with_chamfer = use_extra and (extra_cfg.coef_dist_h > 0.0 or extra_cfg.coef_dist_o > 0.0)

    def step_fn(state: TrainState, batch: dict[str, Any], *,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        model = state.model
        model.train()
        x_start = batch["pose_repr"]
        bs = x_start.shape[0]
        if "t" in batch:  # host-provided (importance resampler)
            t = batch["t"].to(torch.int64)
            weights = batch["t_weights"].to(torch.float32)
        else:
            t = torch.randint(0, sched.num_timesteps, (bs,), generator=generator, device=x_start.device)
            weights = torch.ones((bs,), dtype=torch.float32, device=x_start.device)
        cond = g_cond_from_batch(batch)

        gt_geom = None
        if use_extra:  # batch-only: never differentiated
            with torch.no_grad():
                gt_geom = LL.extra_loss_gt_geometry(mano_stack, batch, with_chamfer=with_chamfer)

        state.optimizer.zero_grad()
        mse, aux = D.training_losses(
            lambda x, tt: model(x, tt, cond), sched, x_start, t, batch["mask"],
            noise=noise, generator=generator,
        )
        diffusion_loss = torch.mean(mse * weights)
        total = diffusion_loss
        metrics = {"diffusion_loss": diffusion_loss, "t_mean": t.to(torch.float32).mean(),
                   "per_sample_mse": mse, "per_sample_t": t}
        if use_extra:
            extra, terms = LL.interaction_segment_extra_loss(
                mano_stack, assets, extra_cfg, aux["model_output"], batch,
                gt_geom=gt_geom, dist_impl=dist_impl,
            )
            total = total + extra
            metrics.update({f"extra/{k}": v for k, v in terms.items()})
        metrics["loss"] = total
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

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
) -> Callable[..., dict[str, torch.Tensor]]:
    """The R train step (JAX make_r_train_step, parallel/train.py:276-332).

    step_fn(state, batch) -> metrics updates state in place: the target and
    the sample geometry are functions of the batch alone and run under
    torch.no_grad() (the JAX step's stop_gradient regions); only the
    refined branch (the net, MANO of its output and the h2o kernels'
    backward) is differentiated. Dropout draws from torch's global
    generator. `backend` routes every h2o search (core/geometry.py)."""

    def step_fn(state: TrainState, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        net = state.model
        net.train()
        mask = batch["mask"]
        with torch.no_grad():
            tgt = target_geometry(mano_stack, batch, backend=backend, frame_mask=mask)
            # the padded-frame closed form of the network input (valid under
            # the zero-padding collate and adaptor contract)
            sg = sample_geometry(mano_stack, batch, frame_mask=mask, backend=backend)
        state.optimizer.zero_grad()
        out = refine_forward(net, mano_stack, batch, with_target=False, sample_geom=sg,
                             backend=backend, loss_frame_mask=mask)
        out.update(tgt)
        loss, terms = LL.segment_refine_loss(assets, loss_cfg, out, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in terms.items()}

    return step_fn
