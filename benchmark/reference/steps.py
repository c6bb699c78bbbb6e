"""The reference's G and R train steps and its G -> R generate, plain PyTorch.

The optimizer is the configuration's: each gradient tensor clipped on its
own to L2 norm `grad_clip` (the packed attention in-projection as its three
row blocks), then torch.optim.AdamW, at a constant learning rate.

Random draws follow the configuration's order on the generators the
benchmark seeds: a G step draws its timesteps (randint) and then its
q_sample noise (randn) from the step generator, dropout draws from torch's
global generator in the network's order, and the DDPM chain draws x_T and
then one noise per step.
"""

from __future__ import annotations

import torch

from . import diffusion as D
from . import losses as LL
from .mano import batch_recover

PACKED_QKV = ("in_proj_weight", "in_proj_bias")


class Optimizer:
    def __init__(self, named_params, lr: float, grad_clip: float, weight_decay: float = 0.0):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        self.blocks = [3 if n.endswith(PACKED_QKV) else 1 for n, _ in named]
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        for p, k in zip(self.params, self.blocks):
            if p.grad is None:
                continue
            for g in p.grad.chunk(k, dim=0):
                n = torch.linalg.vector_norm(g)
                g.mul_(torch.clamp(self.grad_clip / torch.clamp_min(n, 1e-6), max=1.0))
        self.adamw.step()


def g_cond(batch):
    return {k: batch[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}


def g_step(model, opt, sched, mano, faces, assets, coef, batch, generator, shards: int = 1,
           before_shard=lambda s: None) -> float:
    """One G train step; returns its loss.

    With `shards` W > 1 it is the step of W data-parallel processes on one
    global batch, each holding an equal block of its rows: the timesteps
    and the q_sample noise are drawn over the whole batch, then block s in
    turn (after `before_shard(s)`, which seeds its dropout) adds to the
    gradient its diffusion loss over W and its extra loss, a batch sum. The
    gradient is then the blocks' mean diffusion gradient plus the sum of
    their extra ones, and the loss the same sum of the blocks' losses."""
    model.train()
    x_start = batch["pose_repr"]
    bs = x_start.shape[0]
    steps = sched["coef1"].shape[0]
    t = torch.randint(0, steps, (bs,), generator=generator, device=x_start.device)
    noise = torch.randn(x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype)
    opt.zero_grad()
    total = 0.0
    b = bs // shards
    for s in range(shards):
        rows = slice(s * b, (s + 1) * b)
        part = {k: v[rows] for k, v in batch.items()}
        before_shard(s)
        gt = LL.gt_geometry(mano, faces, part)
        out = model(D.q_sample(sched, part["pose_repr"], t[rows], noise[rows]), t[rows], g_cond(part))
        loss = torch.mean(D.masked_l2(part["pose_repr"], out, part["mask"]))
        if shards > 1:
            loss = loss / shards
        loss = loss + LL.extra_loss(mano, faces, assets, coef, out, part, gt)
        loss.backward()
        total += float(loss.detach())
    opt.step()
    return total


def r_step(net, opt, mano, faces, assets, coef, batch) -> float:
    """One R train step; returns its loss."""
    net.train()
    mask = batch["mask"]
    with torch.no_grad():
        t_verts, t_joints, _ = batch_recover(mano, faces, batch["pose_repr"], batch["shape"], batch["hand_side"])
        t_h2o = LL.multi_object_h2o(t_verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"], mask)
        s_verts, _, _ = batch_recover(mano, faces, batch["sample_pose_repr"], batch["shape"], batch["hand_side"])
        s_h2o = LL.sample_h2o(s_verts, batch)
    opt.zero_grad()
    cond = {k: batch[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    refined = net(batch["sample_pose_repr"], s_h2o, cond)
    r_verts, r_joints, _ = batch_recover(mano, faces, refined, batch["shape"], batch["hand_side"])
    r_h2o = LL.multi_object_h2o(r_verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"], mask)
    out = {"refine_joints": r_joints, "refine_verts": r_verts, "refine_h2o": r_h2o,
           "target_joints": t_joints, "target_verts": t_verts, "target_h2o": t_h2o}
    loss = LL.refine_loss(assets, coef, out, batch)
    loss.backward()
    opt.step()
    return float(loss.detach())


@torch.no_grad()
def generate(g_model, r_net, sched, mano, faces, batch, generator) -> dict[str, torch.Tensor]:
    """G's DDPM chain, the sample zeroed past each true length, then R."""
    g_model.eval()
    r_net.eval()
    bs, L = batch["pose_repr"].shape[:2]
    cond = g_cond(batch)
    sample = D.ddpm(lambda x, t: g_model(x, t, cond), sched, (bs, L, 99), generator, batch["pose_repr"].device)
    x_in = sample * batch["mask"][:, :, None]
    s_verts, _, _ = batch_recover(mano, faces, x_in, batch["shape"], batch["hand_side"])
    rcond = {k: batch[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    refined = r_net(x_in, LL.sample_h2o(s_verts, batch), rcond)
    verts, joints, _ = batch_recover(mano, faces, refined, batch["shape"], batch["hand_side"])
    return {"refine_pose_repr": refined, "verts": verts, "joints": joints, "g_sample_pose_repr": sample}
