"""Refined sampling: run R over G's saved samples (or perturbed GT) and save
the per-segment `save_dict.pkl` the scoring reads (port of
oakink2_tamf_tpu/launch/sample_r.py; the reference's
launch/sample_refine.py workflow) on one device; under torchrun, one
process per device (launch/common.run_device), each on its own shard and
with no collective after boot.

    python -m oakink2_tamf_tpu_torch.launch.sample_r --cfg config/arch_refine.yml \
        --data.synthetic true --sample.model_filepath R.pt \
        --test.data.pose_repr_sample_dir_list <sample_g's out dir> \
        [--runtime.device cpu] [--commit]

The input is data/adaptors.GeneratedPoseReprSampleAdaptor over the split
when `<split>.data.pose_repr_sample_dir_list` is set (the raw samples, padded
frames as sample_g wrote them), else GaussianPerturbSampleAdaptor(GT, sigma
in (0.02, 0.1), seed 0) with a warning. R runs with the batch mask as its
frame mask. Segments are deduplicated by `info` over the whole split, then
the deduplicated list is split into contiguous shards
(launch/common.resolve_shard). Output layout:
  <run dir>/sample/<save_prefix or exp_id>/<process_key, "/" -> "++">/<info[1]>/<info[2]>/save_dict.pkl
with keys process_key, info, hand_side, joints, verts, faces (closed MANO
faces of the side), obj_list, len, frame_id, refine_pose_repr. A `.pt`
model_filepath runs as sample_g's does, a `.ckpt` (the JAX package's) under
model.activation. Nothing is written without --commit.
"""

from __future__ import annotations

import logging
import os
import pickle

import torch

from ..core import mano as M
from ..data.adaptors import GaussianPerturbSampleAdaptor, GeneratedPoseReprSampleAdaptor
from ..data.collate import SegmentCollate
from ..models.refine_r import refine_forward, stack_mano_models
from ..runtime.ckpt import load_model_weights
from . import common, param
from .train_r import build_refine_net

_logger = logging.getLogger(__name__)

PROG = "sample_r"


def main(argv=None) -> str:
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
            param.reg_mano_param,
            param.reg_model_param,
            param.reg_refine_sample_param,
            param.reg_sample_param,
        ],
        argv,
    )
    sample_cfg = reg.select("sample")
    split = sample_cfg.get("split", "test")
    device = common.run_device(reg)
    _logger.info("device: %s", device)

    base = common.build_dataset(reg, split)
    try:
        sample_dirs = reg.select(f"{split}.data").get("pose_repr_sample_dir_list") or []
    except KeyError:
        sample_dirs = []
    if sample_dirs:
        dataset = GeneratedPoseReprSampleAdaptor(base, sample_dirs)
    else:
        dataset = GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=0)
        _logger.warning("no G-sample dirs given; refining Gaussian-perturbed GT")

    fp = sample_cfg.get("model_filepath") or ""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_refine_net(reg, activation=common.activation_for_checkpoint(reg, fp))
    if fp:
        load_model_weights(net, fp)
        _logger.info("loaded R from %s", fp)
    net.to(device).eval().requires_grad_(False)
    mano_path = reg.select("mano").get("mano_path") or None
    mano_rh = M.get_mano_model(mano_path, "right")
    mano_lh = M.get_mano_model(mano_path, "left")
    mano_stack = stack_mano_models(mano_rh, mano_lh, device)
    faces_closed = {0: M.closed_faces(mano_rh), 1: M.closed_faces(mano_lh)}
    data_cfg = reg.select("data")
    collate = SegmentCollate(
        max_nobj=int(data_cfg.get("max_nobj", 4)),
        n_obj_points=int(data_cfg.get("n_obj_points", 2048)),
    )
    out_root = os.path.join(run_dir.path, "sample", sample_cfg.get("save_prefix") or run_dir.exp_id)

    n_done = 0

    @torch.inference_mode()
    def flush(pending: list[dict]) -> None:
        nonlocal n_done
        db = common.device_batch(collate(pending), device)
        out = refine_forward(net, mano_stack, db, with_target=False, loss_frame_mask=db["mask"])
        refined, verts, joints = (out[k].cpu().numpy() for k in
                                  ("refine_pose_repr", "refine_hand_verts", "refine_hand_joints"))
        for j, s in enumerate(pending):
            info = s["info"]
            save_dict = {
                "process_key": info[0],
                "info": info,
                "hand_side": s["hand_side"],
                "joints": joints[j],
                "verts": verts[j],
                "faces": faces_closed[0 if s["hand_side"] == "rh" else 1],
                "obj_list": s["obj_list"],
                "len": s["len"],
                "frame_id": s["frame_id"],
                "refine_pose_repr": refined[j],
            }
            if run_dir.commit:
                path = os.path.join(out_root, str(info[0]).replace("/", "++"), str(info[1]), str(info[2]),
                                    "save_dict.pkl")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    pickle.dump(save_dict, f)
            n_done += 1
        _logger.info("refined %d segments", n_done)

    # dedup by info over the whole split, then shard the deduplicated list
    seen = set()
    work: list[int] = []
    for i, info in enumerate(common.segment_infos(dataset)):
        if info not in seen:
            seen.add(info)
            work.append(i)
    w, W = common.resolve_shard(sample_cfg)
    n = len(work)
    mine = work[(n * w) // W : (n * (w + 1)) // W]
    _logger.info("shard %d/%d: %d of %d deduplicated segments", w, W, len(mine), n)

    bs = int(sample_cfg.get("batch_size", 8))
    for start in range(0, len(mine), bs):
        flush([dataset[i] for i in mine[start : start + bs]])
    _logger.info("done: %s", out_root if run_dir.commit else "(dry run)")
    return out_root


if __name__ == "__main__":
    main()
