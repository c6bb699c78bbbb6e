"""compute_score: CR, SIV, PSKL-J and FID over refined-sample trees (port of
oakink2_tamf_tpu/eval/compute_score.py; the reference's
script/compute_score/*.py workflows) on one device.

Each reads the `save_dict.pkl` tree that launch/sample_r.py writes and the
split's dataset; the GT hand geometry is recomputed through the port's
MANO on the run's device.

    python -m oakink2_tamf_tpu_torch.eval.compute_score cr --cfg ... \
        --score.sample_dir common/sample_r/<exp>/sample/<name> [--runtime.device cpu]
    python -m oakink2_tamf_tpu_torch.eval.compute_score siv ...    (data.enable_obj_model)
    python -m oakink2_tamf_tpu_torch.eval.compute_score psklj ...
    python -m oakink2_tamf_tpu_torch.eval.compute_score fid --score.encoder_filepath <.pt> ...

Where each runs: CR's distance core on the run's device (kernel #1 on the
card: core/geometry.min_cdist), SIV's containment tests on the host (the
C++ triangle hash of native/, one frame per thread of a pool: the library
call releases the GIL), PSKL-J on the host, FID's encoder forward on
the run's device in batches of 16. `score.encoder_filepath` takes the
port's own checkpoint or the JAX package's `.ckpt` (run under
model.activation) or a reference
state_dict such as encoder__fid_1/save/model_0399.pt (run under
"gelu_exact"); empty = random weights from runtime.seed.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import mano as M
from ..core import transforms as T
from ..data.collate import SegmentCollate
from ..launch import common, param
from ..models.encoder import COND_KEYS
from ..models.refine_r import stack_mano_models
from ..runtime.ckpt import load_model_weights
from . import metrics as ME

_logger = logging.getLogger(__name__)

FID_BATCH = 16


def reg_score_param(reg):
    reg.register("sample_dir", prefix="score", category=str, default="")
    reg.register("split", prefix="score", category=str, default="test")
    reg.register("frame_stride", prefix="score", category=int, default=20, desc="SIV frame stride")
    reg.register("sdf_resolution", prefix="score", category=int, default=100)
    reg.register("encoder_filepath", prefix="score", category=str, default="")
    reg.register("out_json", prefix="score", category=str, default="")


def load_save_dicts(sample_dir: str) -> dict[tuple, dict]:
    """Walk the save_dict tree -> {info tuple: save_dict}."""
    out = {}
    for root, _, files in os.walk(sample_dir):
        for f in files:
            if f == "save_dict.pkl":
                with open(os.path.join(root, f), "rb") as fh:
                    d = pickle.load(fh)
                out[tuple(d["info"])] = d
    return out


def iter_eval_pairs(dataset, save_dicts):
    """Yield (gt_sample, save_dict), each info once (cr.py:210-232)."""
    seen = set()
    for i in range(len(dataset)):
        s = dataset[i]
        info = tuple(s["info"])
        if info in seen or info not in save_dicts:
            continue
        seen.add(info)
        yield s, save_dicts[info]


def _device_of(mano_stack: M.ManoTensors) -> torch.device:
    return mano_stack.v_template.device


def gt_hand_geometry(mano_stack: M.ManoTensors, sample) -> tuple[np.ndarray, np.ndarray]:
    """GT (verts [L, 778, 3], joints [L, 21, 3]) through MANO on the stack's
    device (cr.py:240-266)."""
    dev = _device_of(mano_stack)
    with torch.inference_mode():
        verts, joints = M.recover_mano_from_pose_repr(
            mano_stack.side(0 if sample["hand_side"] == "rh" else 1),
            torch.as_tensor(sample["pose_repr"], device=dev), torch.as_tensor(sample["shape"], device=dev),
        )
    return verts.cpu().numpy(), joints.cpu().numpy()


def run_cr(reg, dataset, save_dicts, mano_stack) -> dict:
    dev = _device_of(mano_stack)
    gt_dists, refined_dists = [], []
    with torch.inference_mode():
        for s, sd in iter_eval_pairs(dataset, save_dicts):
            n = int(s["len"])
            gt_verts, _ = gt_hand_geometry(mano_stack, s)
            merged = ME.transf_merge_obj_pointcloud(s["obj_pointcloud"], np.asarray(s["obj_traj"])[:, :n], dev)
            gt_dists.extend(ME.contact_min_dists(gt_verts[:n], merged).tolist())
            refined_dists.extend(ME.contact_min_dists(np.asarray(sd["verts"])[:n], merged).tolist())
    return {
        "gt_contact_ratio": ME.contact_ratio(np.asarray(gt_dists)),
        "refined_contact_ratio": ME.contact_ratio(np.asarray(refined_dists)),
        "n_frames": len(gt_dists),
    }


def run_siv(reg, dataset, save_dicts, mano_stack) -> dict:
    stride = int(reg.select("score").get("frame_stride", 20))
    res = int(reg.select("score").get("sdf_resolution", 100))

    # interior grids per object id, from the samples' meshes (a point cloud
    # cannot give an interior)
    interior_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    jobs = []  # (hand verts, closed faces, interior points, ticks, transforms): GT, refined, GT, ...
    for s, sd in iter_eval_pairs(dataset, save_dicts):
        if "obj_verts" not in s:
            _logger.warning("SIV requires obj meshes (data.enable_obj_model); skipping %s", s["info"])
            continue
        n = int(s["len"])
        transf_all = T.tslrot6d_to_transf(torch.as_tensor(np.asarray(s["obj_traj"], np.float32))).numpy()
        pts_list, tick_list = [], []
        for k, oid in enumerate(s["obj_list"]):
            if oid not in interior_cache:
                interior_cache[oid] = ME.object_interior_grid(
                    np.asarray(s["obj_verts"][k]), np.asarray(s["obj_faces"][k]), resolution=res
                )
            p, t = interior_cache[oid]
            pts_list.append(p)
            tick_list.append(t)

        gt_verts, _ = gt_hand_geometry(mano_stack, s)
        faces_closed = np.asarray(sd["faces"])
        refined_verts = np.asarray(sd["verts"])
        for f in range(0, n, stride):
            Xs = [transf_all[k, f] for k in range(len(s["obj_list"]))]
            jobs += [(v[f], faces_closed, pts_list, tick_list, Xs) for v in (gt_verts, refined_verts)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        sivs = list(pool.map(lambda job: ME.solid_intersection_volume(*job), jobs))
    gt_sivs, refined_sivs = sivs[0::2], sivs[1::2]
    return {
        "gt_siv_cm3": float(np.mean(gt_sivs)) if gt_sivs else float("nan"),
        "refined_siv_cm3": float(np.mean(refined_sivs)) if refined_sivs else float("nan"),
        "n_frames": len(gt_sivs),
    }


def run_psklj(reg, dataset, save_dicts, mano_stack) -> dict:
    gt_list, md_list = [], []
    for s, sd in iter_eval_pairs(dataset, save_dicts):
        n = int(s["len"])
        _, gt_joints = gt_hand_geometry(mano_stack, s)
        gt_list.append(ME.pad_tail_with_last(gt_joints, n))
        md_list.append(ME.pad_tail_with_last(np.asarray(sd["joints"]), n))
    a, b = ME.psklj(gt_list, md_list)
    return {"psklj_gt_to_model": a, "psklj_model_to_gt": b, "n_segments": len(gt_list)}


def fid_activations(model, collate, pairs, device) -> tuple[np.ndarray, np.ndarray]:
    """The encoder's `encoding` of the GT and of the refined pose_repr of
    each pair, batches of FID_BATCH on `device`: ([n, d], [n, d])."""
    gt_acts, md_acts = [], []
    with torch.inference_mode():
        for start in range(0, len(pairs), FID_BATCH):
            chunk = pairs[start : start + FID_BATCH]
            md_samples = [dict(s, pose_repr=np.asarray(sd["refine_pose_repr"], np.float32)) for s, sd in chunk]
            for samples, acts in (([c[0] for c in chunk], gt_acts), (md_samples, md_acts)):
                db = common.device_batch(collate(samples), device)
                out = model(db["pose_repr"], {k: db[k] for k in COND_KEYS})
                acts.append(out["encoding"].cpu().numpy())
    return np.concatenate(gt_acts, axis=0), np.concatenate(md_acts, axis=0)


def run_fid(reg, dataset, save_dicts, mano_stack) -> dict:
    from ..launch.train_encoder import build_encoder

    device = _device_of(mano_stack)
    enc_fp = reg.select("score").get("encoder_filepath") or ""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(reg.select("runtime").get("seed", 0)))
        model = build_encoder(reg, activation=common.activation_for_checkpoint(reg, enc_fp))
    if enc_fp:
        load_model_weights(model, enc_fp)
        _logger.info("loaded encoder from %s", enc_fp)
    model.to(device).eval().requires_grad_(False)
    data_cfg = reg.select("data")
    collate = SegmentCollate(
        max_nobj=int(data_cfg.get("max_nobj", 4)), n_obj_points=int(data_cfg.get("n_obj_points", 2048))
    )
    pairs = list(iter_eval_pairs(dataset, save_dicts))
    if not pairs:
        raise ValueError(
            f"no save_dict matches any dataset segment: --score.sample_dir yielded {len(save_dicts)} "
            f"save_dicts for a {len(dataset)}-segment {reg.select('score').get('split', 'test')!r} "
            "split (wrong dir, empty tree, or split mismatch)"
        )
    gt_act, md_act = fid_activations(model, collate, pairs, device)
    return {"fid": ME.calculate_fid(gt_act, md_act), "n_segments": len(gt_act)}


RUNNERS = {"cr": run_cr, "siv": run_siv, "psklj": run_psklj, "fid": run_fid}


def main(argv=None, toolkit=None) -> dict:
    """`toolkit` (oakink2_toolkit's interface) goes to common.build_dataset:
    with data.enable_obj_model it gives SIV its object meshes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in RUNNERS:
        raise SystemExit(f"usage: compute_score {{{'|'.join(RUNNERS)}}} [--cfg ...]")
    which = argv.pop(0)

    reg, run_dir = common.boot(
        f"compute_score_{which}",
        [param.reg_base_param, param.reg_mano_param, param.reg_model_param, reg_score_param],
        argv,
    )
    device = common.run_device(reg)
    _logger.info("device: %s", device)
    dataset = common.build_dataset(reg, reg.select("score").get("split", "test"), toolkit=toolkit)
    sample_dir = reg.select("score").get("sample_dir")
    save_dicts = load_save_dicts(sample_dir)
    _logger.info("loaded %d save_dicts from %s", len(save_dicts), sample_dir)

    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )
    result = RUNNERS[which](reg, dataset, save_dicts, mano_stack)
    print(json.dumps({"score": which, **result}))
    out_json = reg.select("score").get("out_json")
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump({"score": which, **result}, f)
    return result


if __name__ == "__main__":
    main()
