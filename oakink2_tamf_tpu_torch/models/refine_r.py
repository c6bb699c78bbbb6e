"""MF-MDM R, the deterministic refiner (port of oakink2_tamf_tpu/models/refine_r.py).

- `SegmentRefineNet`: tokens [hand_side, shape, obj_embed], a 3-stream input
  merge (pose + object trajectory + h2o feature), trunk, residual output.
- `refine_forward`: geometry of the input sample (MANO + h2o), the network,
  geometry of the refined output (differentiable through the h2o kernels)
  and, for training and evaluation, of the GT target.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn as nn

from ..core import geometry as G
from ..core import mano as M
from ..core import transforms as T
from .trunk import (
    HandShapeProcess,
    InputProcess,
    ObjectEmbedProcess,
    ObjectInputProcess,
    OutputProcess,
    PositionalEncoding,
    TransformerEncoder,
    hand_side_embed,
    input_merge,
)


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    input_dim: int = 99
    obj_input_dim: int = 9
    hand_shape_dim: int = 10
    obj_embed_dim: int = 768
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    n_hand_verts: int = 778


NUM_COND_TOKENS_R = 3
PAD_OBJECT_H2O = 10.0  # finite h2o of a padded object slot (far from everything)


class SegmentRefineNet(nn.Module):
    def __init__(self, cfg: RefineConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.hand_shape_process = HandShapeProcess(cfg.hand_shape_dim, d)
        self.obj_embed_process = ObjectEmbedProcess(cfg.obj_embed_dim, d)
        self.input_process = InputProcess(cfg.input_dim, d)
        self.obj_input_process = ObjectInputProcess(cfg.obj_input_dim, d)
        self.h2o_dist_input_process = InputProcess(cfg.n_hand_verts, d)
        self.input_merge = input_merge(3, d)
        self.sequence_pos_encoder = PositionalEncoding(d, cfg.dropout)
        self.seqTransEncoder = TransformerEncoder(
            d, cfg.num_heads, cfg.ff_size, cfg.num_layers, cfg.dropout, cfg.activation
        )
        self.output_process = OutputProcess(d, cfg.input_dim)

    def forward(self, x_in: torch.Tensor, h2o_dist: torch.Tensor, cond: dict[str, Any]) -> torch.Tensor:
        """x_in [bs, L, 99], h2o_dist [bs, L, 778] -> refined pose_repr [bs, L, 99]."""
        d = self.cfg.latent_dim
        emb = torch.stack(
            [
                hand_side_embed(cond["hand_side"], d),
                self.hand_shape_process(cond["shape"]),
                self.obj_embed_process(cond["obj_embedding"], cond["obj_mask"]),
            ],
            dim=1,
        )
        emb = torch.nan_to_num(emb)
        merged = self.input_merge(
            torch.cat(
                [
                    self.input_process(x_in),
                    self.obj_input_process(cond["obj_traj"], cond["obj_mask"]),
                    self.h2o_dist_input_process(h2o_dist),
                ],
                dim=-1,
            )
        )
        merged = torch.nan_to_num(merged)
        xseq = self.sequence_pos_encoder(torch.cat([emb, merged], dim=1))
        out = self.seqTransEncoder(xseq)[:, NUM_COND_TOKENS_R:]
        return torch.nan_to_num(x_in + self.output_process(out))  # residual


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def stack_mano_models(rh: M.ManoModel, lh: M.ManoModel, device) -> M.ManoTensors:
    """Both hands on a leading side axis (0 = rh, 1 = lh), on `device`, with
    the template permutation of the cull route precomputed."""
    stacked = M.ManoModel(*(np.stack([np.asarray(a), np.asarray(b)]) for a, b in zip(rh, lh)))
    out = M.ManoTensors.from_model(stacked, device)
    out.template_perm = M.hand_template_perm(stacked.v_template)
    return out


def batch_recover_mano(
    mano_stack: M.ManoTensors,
    pose_repr: torch.Tensor,  # [bs, L, 99]
    shape: torch.Tensor,  # [bs, L, 10]
    hand_side: torch.Tensor,  # [bs] int (0 = rh, 1 = lh)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (verts [bs, L, 778, 3], joints [bs, L, 21, 3], normals [bs, L, 778, 3]).

    Both sides run on every sample and the sample's side is selected, as the
    JAX package does for the normals (static per-side faces)."""
    rh = (hand_side == 0)[:, None, None, None]
    per_side = [M.recover_mano_from_pose_repr(mano_stack.side(s), pose_repr, shape) for s in range(2)]
    verts = torch.where(rh, per_side[0][0], per_side[1][0])
    joints = torch.where(rh, per_side[0][1], per_side[1][1])
    normals = torch.where(
        rh,
        G.vertex_normals(verts, mano_stack.faces[0]),
        G.vertex_normals(verts, mano_stack.faces[1]),
    )
    return verts, joints, normals


def _canonical_frame_operands(hand_verts, obj_traj, obj_points):
    """The hand moved into each object's canonical frame (x' = R^T (v - t)),
    flattened to x [bs*nobj*L, 778, 3] and the clouds to y [bs*nobj, P, 3]."""
    transf = T.tslrot6d_to_transf(obj_traj)  # [bs, nobj, L, 4, 4]
    R = transf[..., :3, :3]
    t = transf[..., :3, 3]
    diff = hand_verts[:, None] - t[:, :, :, None, :]  # [bs, nobj, L, 778, 3]
    xc = torch.einsum("bolck,bolvc->bolvk", R, diff)
    bs, nobj, L, nhv, _ = xc.shape
    return xc.reshape(bs * nobj * L, nhv, 3), obj_points.reshape(bs * nobj, -1, 3)


def multi_object_h2o_dist(
    hand_verts: torch.Tensor,  # [bs, L, 778, 3]
    obj_traj: torch.Tensor,  # [bs, nobj, L, 9] tslrot6d
    obj_points: torch.Tensor,  # [bs, nobj, P, 3] canonical clouds
    obj_mask: torch.Tensor,  # [bs, nobj] bool
    x_perm: np.ndarray | None = None,
    frame_mask: torch.Tensor | None = None,  # [bs, L]
    backend: str = "auto",
) -> torch.Tensor:
    """Unsigned hand->object distances [bs, L, 778]: per-object searches in
    each object's canonical frame (one shared cloud per (sample, object),
    y_group = L frames), then a min over the real objects. Padded object
    slots count as PAD_OBJECT_H2O. With `frame_mask`, mask-padded frames are
    culled on the cull route and come out BIG: callers replace them (the
    other routes search them). `x_perm` tiles the hand rows on the culled
    and cluster routes.
    Differentiable in the hand verts (core/geometry.point2point_h2o with
    grad_y=False: the clouds come from the batch)."""
    bs, L, nhv, _ = hand_verts.shape
    nobj, P = obj_points.shape[1:3]
    x, y = _canonical_frame_operands(hand_verts, obj_traj, obj_points)
    y_valid = obj_mask.reshape(bs * nobj, 1).expand(bs * nobj, P)
    x_valid = None
    if frame_mask is not None:
        x_valid = (frame_mask > 0)[:, None, :].expand(bs, nobj, L).reshape(bs * nobj * L)
    h2o = G.point2point_h2o(
        x, y, y_valid, backend=backend, x_perm=x_perm, grad_y=False, y_group=L, x_valid=x_valid
    ).reshape(bs, nobj, L, nhv)
    h2o = torch.where(obj_mask[:, :, None, None], h2o, PAD_OBJECT_H2O)
    return torch.amin(h2o, dim=1)


def multi_object_h2o_overflow(
    hand_verts: torch.Tensor,  # [bs, L, 778, 3]
    obj_traj: torch.Tensor,  # [bs, nobj, L, 9]
    obj_points: torch.Tensor,  # [bs, nobj, P, 3]
    obj_mask: torch.Tensor,  # [bs, nobj] bool
    x_perm: np.ndarray | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Per-sample cluster-overflow counts [bs] int32 for the operands
    multi_object_h2o_dist searches (JAX refine_r.py:255): zero proves its
    result exact on that route, and it is zero off the cluster route.
    Every point counts as valid, as in the JAX package; padded object slots
    are excluded afterwards (their distances never enter the min)."""
    bs, L = hand_verts.shape[:2]
    nobj = obj_points.shape[1]
    if backend != "cluster":  # exact routes: no operands to build
        return torch.zeros((bs,), dtype=torch.int32, device=hand_verts.device)
    with torch.no_grad():
        x, y = _canonical_frame_operands(hand_verts, obj_traj, obj_points)
        ovf = G.point2point_h2o_overflow(x, y, backend=backend, x_perm=x_perm, y_group=L)
    ovf = torch.where(obj_mask[:, :, None], ovf.reshape(bs, nobj, L), 0)
    return ovf.sum(dim=(1, 2)).to(torch.int32)


def target_geometry(
    mano_stack: M.ManoTensors,
    batch: dict[str, Any],
    *,
    backend: str = "auto",
    frame_mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Geometry of the GT target, a function of the batch alone, computed
    without autograd (the JAX package's stop_gradient). When the batch
    carries a precomputed `target_h2o` (data/target_cache.TargetH2OCache)
    the chamfer pass is skipped and only MANO runs. `frame_mask` is the
    loss-side cull hint: culled frames come out BIG, and the loss zeroes
    them."""
    with torch.no_grad():
        t_verts, t_joints, t_normals = batch_recover_mano(
            mano_stack, batch["pose_repr"], batch["shape"], batch["hand_side"]
        )
        if "target_h2o" in batch:
            t_h2o = batch["target_h2o"]
        else:
            t_h2o = multi_object_h2o_dist(
                t_verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"],
                x_perm=mano_stack.template_perm, frame_mask=frame_mask, backend=backend,
            )
    return {
        "target_hand_verts": t_verts,
        "target_hand_joints": t_joints,
        "target_hand_normals": t_normals,
        "target_h2o_dist": t_h2o,
    }


def sample_geometry(
    mano_stack: M.ManoTensors,
    batch: dict[str, Any],
    *,
    frame_mask: torch.Tensor | None = None,
    backend: str = "auto",
) -> dict[str, torch.Tensor]:
    """MANO recovery and h2o of `sample_pose_repr` (the network input).

    With `frame_mask` the h2o search skips mask-padded frames and gives them
    the reference's closed form instead: a zero-padded frame collapses every
    object cloud to the origin, so its h2o is ||v_i|| of the hand at frame
    L-1. Correct only under the zero-padding contract of data/collate.py."""
    s_verts, s_joints, s_normals = batch_recover_mano(
        mano_stack, batch["sample_pose_repr"], batch["shape"], batch["hand_side"]
    )
    s_h2o = multi_object_h2o_dist(
        s_verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"],
        x_perm=mano_stack.template_perm, frame_mask=frame_mask, backend=backend,
    )
    if frame_mask is not None:
        pad_h2o = torch.linalg.vector_norm(s_verts[:, -1:], dim=-1)  # [bs, 1, 778]
        s_h2o = torch.where((frame_mask > 0)[:, :, None], s_h2o, pad_h2o)
    return {
        "sample_hand_verts": s_verts,
        "sample_hand_joints": s_joints,
        "sample_hand_normals": s_normals,
        "sample_h2o_dist": s_h2o,
    }


def refine_forward(
    net: SegmentRefineNet,
    mano_stack: M.ManoTensors,
    batch: dict[str, Any],
    *,
    with_target: bool = True,
    sample_geom: dict[str, torch.Tensor] | None = None,
    backend: str = "auto",
    loss_frame_mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Sample geometry, the network's refinement, the refined geometry and
    (with_target) the GT target's geometry, with the JAX package's result
    keys. The network's mode decides dropout: `net.train()` or `net.eval()`
    (flax's `deterministic`). Pass `sample_geom` (from sample_geometry) to
    reuse a precomputed input branch, as the train step does.

    `loss_frame_mask` marks mask-padded frames: their refine and target h2o
    come out BIG on the cull route (the loss zeroes them; the serving path
    never reads them) and their sample h2o takes sample_geometry's closed
    form."""
    cond = {k: batch[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    if sample_geom is None:
        sample_geom = sample_geometry(mano_stack, batch, frame_mask=loss_frame_mask, backend=backend)
    output = net(batch["sample_pose_repr"], sample_geom["sample_h2o_dist"], cond)
    r_verts, r_joints, r_normals = batch_recover_mano(
        mano_stack, output, batch["shape"], batch["hand_side"]
    )
    r_h2o = multi_object_h2o_dist(
        r_verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"],
        x_perm=mano_stack.template_perm, frame_mask=loss_frame_mask, backend=backend,
    )
    res = {
        "refine_pose_repr": output,
        "refine_hand_verts": r_verts,
        "refine_hand_joints": r_joints,
        "refine_hand_normals": r_normals,
        "refine_h2o_dist": r_h2o,
        **sample_geom,
    }
    if with_target:
        res.update(target_geometry(mano_stack, batch, backend=backend, frame_mask=loss_frame_mask))
    return res
