"""G -> R chained inference (port of oakink2_tamf_tpu/models/extract_sample.py;
reference model/extract_sample.py).

`extract_refined_sample` runs the two-stage chain on any number of
segments at once: G's reverse diffusion with the named sampler, then R's
refinement of the sample zeroed past each true length. The bimanual variant
carves one hand's sub-segment out of a bimanual sample via `obj_pair`
before running the same chain. Both run on the device the models sit on,
under torch.inference_mode().
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..core import diffusion as D
from ..data.collate import SegmentCollate
from ..launch.common import attach_text_emb, device_batch
from ..parallel.train import g_cond_from_batch, g_model_fn
from .refine_r import refine_forward


@torch.inference_mode()
def extract_refined_sample(
    g_model,
    sched: D.DiffusionSchedule,
    refine_net,
    mano_stack,
    gt_samples: Sequence[dict[str, Any]],
    clip,
    generator: torch.Generator | None = None,
    *,
    max_nobj: int = 4,
    n_obj_points: int = 2048,
    sampler: str = "ddpm",
    noise: dict[str, torch.Tensor] | None = None,
) -> np.ndarray:
    """Segments -> refined pose_reprs [bs, L, 99] (numpy).

    `sched` lives on the models' device. G's noise comes from `generator`
    (on that device) or from `noise`, the sampler's noise keywords
    (core/diffusion.py). The parallel sampler runs at its default window
    and tolerance. Both models are put in eval mode (dropout off)."""
    device = next(g_model.parameters()).device
    batch = SegmentCollate(max_nobj=max_nobj, n_obj_points=n_obj_points)(list(gt_samples))
    db = device_batch(attach_text_emb(batch, clip), device)
    g_model.eval()
    refine_net.eval()
    bs, L = db["pose_repr"].shape[:2]
    sample = D.sample_loop(sampler, g_model_fn(g_model, g_cond_from_batch(db)), sched, (bs, L, 99),
                           device=device, generator=generator, noise=noise)
    # R sees G's sample zeroed past each true length, as the JAX package's
    # extract_sample.py:70-71 and serving do
    db["sample_pose_repr"] = sample * db["mask"][:, :, None]
    out = refine_forward(refine_net, mano_stack, db, with_target=False, loss_frame_mask=db["mask"])
    return out["refine_pose_repr"].float().cpu().numpy()


def slice_bihand_sample(gt_sample: dict[str, Any], hand_side: str) -> dict[str, Any]:
    """One hand's sub-segment of a bimanual sample: that hand's pose and
    shape, and only the objects `obj_pair` gives it (obj_pair[1] for the
    right hand, obj_pair[0] for the left)."""
    magic = 1 if hand_side == "rh" else 0
    obj_list = gt_sample["obj_list"]
    obj_pair = gt_sample["obj_pair"]
    oid_indices = [obj_list.index(oid) for oid in obj_pair[magic]]
    return {
        "text": gt_sample["text"],
        "len": gt_sample["len"],
        "mask": gt_sample["mask"],
        "hand_side": hand_side,
        "pose_repr": gt_sample["pose_repr_rh" if hand_side == "rh" else "pose_repr_lh"],
        "shape": gt_sample["shape_rh" if hand_side == "rh" else "shape_lh"],
        "obj_num": len(obj_pair[magic]),
        "obj_list": obj_pair[magic],
        "obj_traj": gt_sample["obj_traj"][oid_indices, ...],
        "obj_embedding": gt_sample["obj_embedding"][oid_indices, ...],
        "obj_pointcloud": gt_sample["obj_pointcloud"][oid_indices, ...],
    }


def extract_refined_sample_bihand(
    g_model,
    sched: D.DiffusionSchedule,
    refine_net,
    mano_stack,
    gt_sample: dict[str, Any],
    hand_side: str,
    clip,
    generator: torch.Generator | None = None,
    **kwargs,
) -> np.ndarray:
    """Bimanual segment + hand side -> refined pose_repr [L, 99]."""
    sub = slice_bihand_sample(gt_sample, hand_side)
    return extract_refined_sample(g_model, sched, refine_net, mano_stack, [sub], clip, generator, **kwargs)[0]
