"""G's geometric extra loss and R's refine loss (port of
oakink2_tamf_tpu/models/losses.py:37-421; reference
model/interaction_segment_extra_loss.py, model/segment_refine_model_loss.py).

Reduction quirks kept from the reference, as the JAX package keeps them:
- G's per-item losses are SUMMED over the batch, R's are MEANED;
- `mask_coef = L / sum(mask)` rescales means taken over the padded length;
- per-object terms are averaged with 1/num_obj over the REAL objects.

The dist_h / dist_o terms run per object in the object's canonical frame:
the hand moves into it (x' = R^T (v - t)) and one canonical cloud serves
all L frames of a (sample, object) (y_group = L). Two routes for the
predicted hand, the same math in another summation order:
- "fused" (and "auto", the route the TPU takes): the fused loss kernel
  (ops/chamfer_loss.py), value and x-gradient in one pass;
- "composed": the signed pair (core/geometry.point2point_signed, kernels in
  ops/chamfer_signed.py) and the loss arithmetic in PyTorch.
"fused_cull" needs kernel #9 (`_dist_loss_cull_kernel`), not ported yet.

GrabNet contact assets (edge list, per-vertex contact weights) load from
the configured .npy files; without them, deterministic synthetic stand-ins.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import geometry as G
from ..core import mano as M
from ..core import transforms as T
from ..ops import chamfer_loss as CL
from .refine_r import batch_recover_mano

DIST_IMPLS = ("auto", "fused", "composed", "fused_cull")


class ContactAssets(NamedTuple):
    vpe: torch.Tensor  # [ne, 2] int64, vertex pairs per edge
    v_weights: torch.Tensor  # [778] contact weight per vertex
    v_weights2: torch.Tensor  # v_weights ** (1 / 2.5)


def load_contact_assets(
    vpe_path: str | None = None, c_weight_path: str | None = None,
    mano_faces: np.ndarray | None = None, device: torch.device | str = "cpu",
) -> ContactAssets:
    """Load the GrabNet vpe / rhand_weight .npy files, else synthesize: edges
    of the MANO triangulation and seeded pseudo contact weights (the JAX
    package's stand-ins, value for value). An explicit path that does not
    resolve raises."""
    if vpe_path or c_weight_path:
        for p, name in ((vpe_path, "vpe_path"), (c_weight_path, "c_weight_path")):
            if not (p and os.path.isfile(p)):
                raise FileNotFoundError(
                    f"contact asset {name}={p!r} was given explicitly but does not exist; "
                    "refusing to substitute synthetic contact weights"
                )
        from ..utils.integrity import verify_pinned

        verify_pinned(vpe_path, what="grabnet contact asset")
        verify_pinned(c_weight_path, what="grabnet contact asset")
        vpe = np.load(vpe_path).astype(np.int64)
        w = np.load(c_weight_path).astype(np.float32)
    else:
        logging.getLogger(__name__).warning(
            "grabnet contact assets unset: using synthetic edges/weights; the "
            "rec_vert/edge_len/dist losses are not reference-faithful"
        )
        if mano_faces is None:
            mano_faces = np.asarray(M.synthetic_mano_model("right").faces)
        e = np.concatenate(
            [mano_faces[:, [0, 1]], mano_faces[:, [1, 2]], mano_faces[:, [2, 0]]], axis=0
        )
        vpe = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
        w = np.random.default_rng(7).random(M.N_VERTS).astype(np.float32)
    w2 = np.power(w, 1.0 / 2.5).astype(np.float32)
    return ContactAssets(
        vpe=torch.from_numpy(vpe).to(device),
        v_weights=torch.from_numpy(w).to(device),
        v_weights2=torch.from_numpy(w2).to(device),
    )


@dataclasses.dataclass(frozen=True)
class ExtraLossConfig:
    """config/loss_param.yml coefficients."""

    coef_rec_joint: float = 1.0
    coef_rec_vert: float = 1.0
    coef_edge_len: float = 0.1
    coef_dist_h: float = 0.1
    coef_dist_o: float = 1.0


@dataclasses.dataclass(frozen=True)
class RefineLossConfig:
    """config/loss_param_refine.yml coefficients."""

    coef_rec_joint: float = 1.0
    coef_rec_vert: float = 1.0
    coef_dist_h: float = 0.1


def _edges(verts: torch.Tensor, vpe: torch.Tensor) -> torch.Tensor:
    """verts [..., V, 3] -> edge vectors [..., ne, 3] (ref _edges_for)."""
    return verts.index_select(-2, vpe[:, 0]) - verts.index_select(-2, vpe[:, 1])


def _canonical_operands(verts, normals, transf, obj_points):
    """The hand in each object's canonical frame: (x [F, 778, 3], n [F, 778, 3],
    y [bs*nobj, P, 3]) with F = bs*nobj*L; frame f searches cloud f // L."""
    bs, nobj, L = transf.shape[:3]
    P = obj_points.shape[2]
    vh = verts.shape[2]
    R = transf[..., :3, :3]  # [bs, nobj, L, 3, 3]
    t = transf[..., :3, 3]  # [bs, nobj, L, 3]
    diff = verts[:, None] - t[:, :, :, None, :]  # [bs, nobj, L, 778, 3]
    x = torch.einsum("bolck,bolvc->bolvk", R, diff).reshape(-1, vh, 3)
    n = torch.einsum("bolck,blvc->bolvk", R, normals).reshape(-1, vh, 3)
    return x, n, obj_points.reshape(bs * nobj, P, 3)


def _per_object_signed(verts, normals, transf, obj_points):
    """Per-object signed distances: (o2h [bs, nobj, L, P], h2o [bs, nobj, L, 778]).
    No y_valid: a padded object slot is an all-zero cloud whose canonical hand
    rows are ~0, and the callers weight it by zero."""
    bs, nobj, L = transf.shape[:3]
    P = obj_points.shape[2]
    vh = verts.shape[2]
    x, n, y = _canonical_operands(verts, normals, transf, obj_points)
    o2h, h2o, _ = G.point2point_signed(x, y, n, grad_y=False, y_group=L)
    return o2h.reshape(bs, nobj, L, P), h2o.reshape(bs, nobj, L, vh)


def _dist_sums_fused(verts, normals, transf, obj_points, o2h_g, h2o_g, vw2,
                     seq_mask=None, obj_mask=None):
    """Per-frame sums (do_f, dh_f), both [bs, nobj, L], from the fused loss
    kernel. Mask-padded frames and padded object slots are skipped in the
    kernel (x_valid) and come out zero: the loss weights them by zero."""
    bs, nobj, L = transf.shape[:3]
    P = obj_points.shape[2]
    vh = verts.shape[2]
    x, n, y = _canonical_operands(verts, normals, transf, obj_points)
    x_valid = None
    if seq_mask is not None or obj_mask is not None:
        dev = verts.device
        fm = (seq_mask > 0)[:, None, :] if seq_mask is not None else torch.ones((bs, 1, L), dtype=torch.bool, device=dev)
        om = (obj_mask.to(torch.bool)[:, :, None] if obj_mask is not None
              else torch.ones((bs, nobj, 1), dtype=torch.bool, device=dev))
        x_valid = (fm & om).expand(bs, nobj, L).reshape(bs * nobj * L)
    do_f, dh_f = CL.chamfer_dist_loss(
        x, n, y, o2h_g.reshape(-1, P), h2o_g.reshape(-1, vh), vw2, y_group=L, x_valid=x_valid
    )
    return do_f.reshape(bs, nobj, L), dh_f.reshape(bs, nobj, L)


def extra_loss_gt_geometry(mano_stack: M.ManoTensors, batch: dict[str, Any], *,
                           with_chamfer: bool = True) -> dict[str, torch.Tensor]:
    """GT side of the extra loss, a function of the batch alone: the train
    step runs it under torch.no_grad(), outside the loss closure."""
    verts_gt, joints_gt, normals_gt = batch_recover_mano(
        mano_stack, batch["pose_repr"], batch["shape"], batch["hand_side"]
    )
    out = {"verts_gt": verts_gt, "joints_gt": joints_gt, "normals_gt": normals_gt}
    if with_chamfer:
        if "gt_o2h" in batch and "gt_h2o" in batch:  # precomputed per sample
            out["o2h_g"] = batch["gt_o2h"].to(torch.float32)
            out["h2o_g"] = batch["gt_h2o"].to(torch.float32)
        else:
            transf = T.tslrot6d_to_transf(batch["obj_traj"])
            out["o2h_g"], out["h2o_g"] = _per_object_signed(
                verts_gt, normals_gt, transf, batch["obj_points"]
            )
    return out


def interaction_segment_extra_loss(
    mano_stack: M.ManoTensors,
    assets: ContactAssets,
    cfg: ExtraLossConfig,
    model_output: torch.Tensor,  # [bs, L, 99] predicted pose_repr
    batch: dict[str, Any],
    *,
    gt_geom: dict[str, torch.Tensor] | None = None,
    dist_impl: str = "auto",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """G's geometric losses (ref extra_loss.py:85-197), batched. Pass `gt_geom`
    (from extra_loss_gt_geometry) to reuse a precomputed GT side."""
    if dist_impl not in DIST_IMPLS:
        raise ValueError(f"dist_impl {dist_impl!r} not in {DIST_IMPLS}")
    if dist_impl == "fused_cull":
        raise NotImplementedError(
            "dist_impl='fused_cull' needs the region-culled loss kernel "
            "(_dist_loss_cull_kernel), which is not ported yet"
        )
    mask = batch["mask"]  # [bs, L]
    L = mask.shape[1]
    mask_coef = L / torch.clamp_min(torch.sum(mask, dim=1), 1.0)  # [bs]

    need_chamfer = cfg.coef_dist_h > 0.0 or cfg.coef_dist_o > 0.0
    if gt_geom is None:
        with torch.no_grad():
            gt_geom = extra_loss_gt_geometry(mano_stack, batch, with_chamfer=need_chamfer)
    verts_gt, joints_gt = gt_geom["verts_gt"], gt_geom["joints_gt"]
    verts_pred, joints_pred, normals_pred = batch_recover_mano(
        mano_stack, model_output, batch["shape"], batch["hand_side"]
    )

    m = mask[:, :, None]
    terms: dict[str, torch.Tensor] = {}
    jd = torch.sum((joints_pred - joints_gt) ** 2, dim=-1) * m  # [bs, L, 21]
    terms["rec_joint"] = torch.sum(mask_coef * torch.mean(jd, dim=(1, 2)))
    vd = torch.sum((verts_pred - verts_gt) ** 2, dim=-1) * m  # [bs, L, 778]
    vd = vd * (assets.v_weights**2)[None, None, :]
    terms["rec_vert"] = torch.sum(mask_coef * torch.mean(vd, dim=(1, 2)))
    ed = torch.abs(_edges(verts_pred, assets.vpe) - _edges(verts_gt, assets.vpe))
    ed = ed * mask[:, :, None, None]
    terms["edge_len"] = torch.sum(mask_coef * torch.mean(ed, dim=(1, 2, 3)))

    if need_chamfer:
        o2h_g, h2o_g = gt_geom["o2h_g"], gt_geom["h2o_g"]
        transf = T.tslrot6d_to_transf(batch["obj_traj"])
        obj_mask = batch["obj_mask"].to(mask.dtype)  # [bs, nobj]
        num_obj = torch.clamp_min(torch.sum(obj_mask, dim=1), 1.0)
        om = obj_mask / num_obj[:, None]  # 1/num_obj weights, 0 for pads
        P = batch["obj_points"].shape[2]
        vh = verts_pred.shape[2]
        if dist_impl in ("auto", "fused"):
            do_f, dh_f = _dist_sums_fused(
                verts_pred, normals_pred, transf, batch["obj_points"],
                o2h_g, h2o_g, assets.v_weights2, seq_mask=mask, obj_mask=batch["obj_mask"],
            )
            m3 = mask[:, None, :]  # [bs, 1, L]
            dh = torch.sum(dh_f * m3, dim=2) / (L * vh)  # [bs, nobj]
            do = torch.sum(do_f * m3, dim=2) / (L * P)
        else:
            o2h_p, h2o_p = _per_object_signed(verts_pred, normals_pred, transf, batch["obj_points"])
            dh = torch.abs(torch.abs(h2o_p) - torch.abs(h2o_g)) * assets.v_weights2
            dh = torch.mean(dh * mask[:, None, :, None], dim=(2, 3))  # [bs, nobj]
            w = torch.where((o2h_g < 0.01) & (o2h_g > -0.005), 1.0, 0.1)
            w = torch.where(o2h_p < 0.0, 1.5, w)
            do = torch.abs(o2h_p - o2h_g) * w * mask[:, None, :, None]
            do = torch.mean(do, dim=(2, 3))
        terms["dist_h"] = torch.sum(mask_coef * torch.sum(dh * om, dim=1))
        terms["dist_o"] = torch.sum(mask_coef * torch.sum(do * om, dim=1))
    else:
        zero = torch.zeros((), device=model_output.device)
        terms["dist_h"] = zero
        terms["dist_o"] = zero

    loss = (
        cfg.coef_rec_joint * terms["rec_joint"]
        + cfg.coef_rec_vert * terms["rec_vert"]
        + cfg.coef_edge_len * terms["edge_len"]
        + cfg.coef_dist_h * terms["dist_h"]
        + cfg.coef_dist_o * terms["dist_o"]
    )
    terms["loss"] = loss
    return loss, terms


def segment_refine_loss(
    assets: ContactAssets,
    cfg: RefineLossConfig,
    output: dict[str, torch.Tensor],
    batch: dict[str, Any],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """R's loss (ref segment_refine_model_loss.py:35-84): joint and vert
    reconstruction against the target and |h2o| matching, meaned over the
    batch. Mask-padded frames weigh zero: the culled route's h2o there is
    finite (sqrt(BIG) = 1e15), so it is 0 in the value and the gradient."""
    mask = batch["mask"]  # [bs, L]
    mask_coef = mask.shape[1] / torch.clamp_min(torch.sum(mask, dim=1), 1.0)  # [bs]
    m = mask[:, :, None]

    jd = torch.sum((output["refine_hand_joints"] - output["target_hand_joints"]) ** 2, dim=-1) * m
    rec_joint = torch.mean(mask_coef * torch.mean(jd, dim=(1, 2)))

    vd = torch.sum((output["refine_hand_verts"] - output["target_hand_verts"]) ** 2, dim=-1) * m
    vd = vd * (assets.v_weights**2)[None, None, :]
    rec_vert = torch.mean(mask_coef * torch.mean(vd, dim=(1, 2)))

    dh = torch.abs(torch.abs(output["refine_h2o_dist"]) - torch.abs(output["target_h2o_dist"])) * m
    dh = dh * assets.v_weights2[None, None, :]
    dist_h = torch.mean(mask_coef * torch.mean(dh, dim=(1, 2)))

    loss = cfg.coef_rec_joint * rec_joint + cfg.coef_rec_vert * rec_vert + cfg.coef_dist_h * dist_h
    return loss, {"loss": loss, "rec_joint": rec_joint, "rec_vert": rec_vert, "dist_h": dist_h}
