"""G's geometric extra loss and R's refine loss, plain PyTorch: the arithmetic
of oakink2_tamf_tpu_torch/models/losses.py ("composed" route, the loss
written out over the signed distances) and models/refine_r.py's h2o
geometry, over the benchmark's brute-force searches (geometry.py).

Reduction quirks as in the program: G's per-item losses are summed over
the batch, R's meaned; mask_coef = L / sum(mask); per-object terms carry
1/num_obj over the real objects.
"""

from __future__ import annotations

import torch

from . import geometry as G
from . import transforms as T
from .mano import batch_recover
from .refine_net import PAD_OBJECT_H2O


def canonical(verts, transf, obj_points):
    """The hand in each object's canonical frame: x [bs*nobj*L, 778, 3], and
    the clouds y [bs*nobj, P, 3]; frame f searches cloud f // L."""
    bs, nobj, L = transf.shape[:3]
    R = transf[..., :3, :3]
    t = transf[..., :3, 3]
    diff = verts[:, None] - t[:, :, :, None, :]
    x = torch.einsum("bolck,bolvc->bolvk", R, diff).reshape(-1, verts.shape[2], 3)
    return x, obj_points.reshape(bs * nobj, -1, 3), R


def live_frames(mask, obj_mask):
    """[bs*nobj*L] bool: a real object slot at a frame inside the true length."""
    bs, L = mask.shape
    nobj = obj_mask.shape[1]
    return ((mask > 0)[:, None, :] & obj_mask.bool()[:, :, None]).reshape(bs * nobj * L)


def per_object_signed(verts, normals, transf, obj_points, live):
    """(o2h [bs, nobj, L, P], h2o [bs, nobj, L, 778]); 0 off the live frames."""
    bs, nobj, L = transf.shape[:3]
    P = obj_points.shape[2]
    x, y, R = canonical(verts, transf, obj_points)
    n = torch.einsum("bolck,blvc->bolvk", R, normals).reshape(-1, verts.shape[2], 3)
    o2h, h2o = G.signed(x, y, n, None, L, live)
    return o2h.reshape(bs, nobj, L, P), h2o.reshape(bs, nobj, L, -1)


def edges(verts, vpe):
    return verts.index_select(-2, vpe[:, 0]) - verts.index_select(-2, vpe[:, 1])


def gt_geometry(mano, faces, batch):
    with torch.no_grad():
        verts, joints, normals = batch_recover(mano, faces, batch["pose_repr"], batch["shape"], batch["hand_side"])
        transf = T.tslrot6d_to_transf(batch["obj_traj"])
        live = live_frames(batch["mask"], batch["obj_mask"])
        o2h, h2o = per_object_signed(verts, normals, transf, batch["obj_points"], live)
    return {"verts": verts, "joints": joints, "o2h": o2h, "h2o": h2o}


def extra_loss(mano, faces, assets, coef, pred, batch, gt):
    """G's geometric losses on the predicted pose_repr (batch sums)."""
    mask = batch["mask"]
    L = mask.shape[1]
    mask_coef = L / torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    verts, joints, normals = batch_recover(mano, faces, pred, batch["shape"], batch["hand_side"])
    m = mask[:, :, None]
    jd = torch.sum((joints - gt["joints"]) ** 2, dim=-1) * m
    rec_joint = torch.sum(mask_coef * torch.mean(jd, dim=(1, 2)))
    vd = torch.sum((verts - gt["verts"]) ** 2, dim=-1) * m * (assets["v_weights"] ** 2)[None, None, :]
    rec_vert = torch.sum(mask_coef * torch.mean(vd, dim=(1, 2)))
    ed = torch.abs(edges(verts, assets["vpe"]) - edges(gt["verts"], assets["vpe"])) * mask[:, :, None, None]
    edge_len = torch.sum(mask_coef * torch.mean(ed, dim=(1, 2, 3)))

    transf = T.tslrot6d_to_transf(batch["obj_traj"])
    obj_mask = batch["obj_mask"].to(mask.dtype)
    om = obj_mask / torch.clamp_min(torch.sum(obj_mask, dim=1), 1.0)[:, None]
    live = live_frames(mask, batch["obj_mask"])
    o2h_p, h2o_p = per_object_signed(verts, normals, transf, batch["obj_points"], live)
    dh = torch.abs(torch.abs(h2o_p) - torch.abs(gt["h2o"])) * assets["v_weights2"]
    dh = torch.mean(dh * mask[:, None, :, None], dim=(2, 3))
    w = torch.where((gt["o2h"] < 0.01) & (gt["o2h"] > -0.005), 1.0, 0.1)
    w = torch.where(o2h_p < 0.0, 1.5, w)
    do = torch.mean(torch.abs(o2h_p - gt["o2h"]) * w * mask[:, None, :, None], dim=(2, 3))
    dist_h = torch.sum(mask_coef * torch.sum(dh * om, dim=1))
    dist_o = torch.sum(mask_coef * torch.sum(do * om, dim=1))
    return (coef["coef_rec_joint"] * rec_joint + coef["coef_rec_vert"] * rec_vert
            + coef["coef_edge_len"] * edge_len + coef["coef_dist_h"] * dist_h + coef["coef_dist_o"] * dist_o)


def multi_object_h2o(verts, obj_traj, obj_points, obj_mask, frame_mask):
    """Unsigned h2o [bs, L, 778]: the min over the real objects (padded
    slots at PAD_OBJECT_H2O), searched on the frames inside the true length
    (0 at the others, which the callers zero or replace)."""
    bs, L, nhv, _ = verts.shape
    nobj = obj_points.shape[1]
    x, y, _ = canonical(verts, T.tslrot6d_to_transf(obj_traj), obj_points)
    live = live_frames(frame_mask, obj_mask)
    d = G.h2o(x, y, None, L, live).reshape(bs, nobj, L, nhv)
    d = torch.where(obj_mask.bool()[:, :, None, None], d, PAD_OBJECT_H2O)
    return torch.amin(d, dim=1)


def sample_h2o(verts, batch):
    """R's input h2o: searched inside the true length, ||v|| of the hand at
    frame L-1 past it (the zero-padding closed form)."""
    mask = batch["mask"]
    d = multi_object_h2o(verts, batch["obj_traj"], batch["obj_points"], batch["obj_mask"], mask)
    pad = torch.linalg.vector_norm(verts[:, -1:], dim=-1)
    return torch.where((mask > 0)[:, :, None], d, pad)


def refine_loss(assets, coef, out, batch):
    mask = batch["mask"]
    mask_coef = mask.shape[1] / torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    m = mask[:, :, None]
    jd = torch.sum((out["refine_joints"] - out["target_joints"]) ** 2, dim=-1) * m
    rec_joint = torch.mean(mask_coef * torch.mean(jd, dim=(1, 2)))
    vd = torch.sum((out["refine_verts"] - out["target_verts"]) ** 2, dim=-1) * m
    vd = vd * (assets["v_weights"] ** 2)[None, None, :]
    rec_vert = torch.mean(mask_coef * torch.mean(vd, dim=(1, 2)))
    dh = torch.abs(torch.abs(out["refine_h2o"]) - torch.abs(out["target_h2o"])) * m
    dh = dh * assets["v_weights2"][None, None, :]
    dist_h = torch.mean(mask_coef * torch.mean(dh, dim=(1, 2)))
    return coef["coef_rec_joint"] * rec_joint + coef["coef_rec_vert"] * rec_vert + coef["coef_dist_h"] * dist_h
